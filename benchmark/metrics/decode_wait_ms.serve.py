"""decode_wait_ms.serve: the host blocked on the card inside the decode
(the early exit's check of each step, the one <loop>.host_syncs counts),
in ms a chunk: the change of the port's counter <loop>.sync_wait_ns over
each chunk, where <loop> is beam_search_batched for beam search and
decoder_sample_batched for greedy (the host's clock), the mean over the
chunks outside the profiled stretch."""


def read(rec):
    loop = "beam_search_batched" if rec["beam_size"] > 1 else "decoder_sample_batched"
    key = f"{loop}.sync_wait_ns"
    cs = [c for c in rec["chunks"] if not c["profiled"]]
    if not cs or any(key not in c["counters"] for c in cs):
        return None
    return 1e-6 * sum(c["counters"][key] for c in cs) / len(cs)
