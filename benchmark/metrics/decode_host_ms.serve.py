"""decode_host_ms.serve: the host issuing the decode, in ms a chunk: the
change over each chunk of the port's counters make_contexts.host_ns (the
contexts with TSRM) and <loop>.host_ns (the decode loop) less
<loop>.sync_wait_ns (its early exit's waits on the card), where <loop> is
beam_search_batched for beam search and decoder_sample_batched for
greedy (the host's clock, no device barrier), the mean over the chunks
outside the profiled stretch."""


def read(rec):
    loop = "beam_search_batched" if rec["beam_size"] > 1 else "decoder_sample_batched"
    add = ("make_contexts.host_ns", f"{loop}.host_ns")
    sub = f"{loop}.sync_wait_ns"
    cs = [c for c in rec["chunks"] if not c["profiled"]]
    if not cs or any(k not in c["counters"] for c in cs for k in add + (sub,)):
        return None
    ns = sum(sum(c["counters"][k] for k in add) - c["counters"][sub] for c in cs)
    return 1e-6 * ns / len(cs)
