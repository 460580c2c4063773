"""pad_ms.serve: the chunk's inputs (serve.pad_chunk: the padded feature,
frame-mask and LDA arrays on the host and their copies to the card), in
ms a chunk: the change of the port's counter pad_chunk.host_ns over each
chunk (the host's clock, no device barrier), the mean over the chunks
outside the profiled stretch."""

KEY = "pad_chunk.host_ns"


def read(rec):
    cs = [c for c in rec["chunks"] if not c["profiled"]]
    if not cs or any(KEY not in c["counters"] for c in cs):
        return None
    return 1e-6 * sum(c["counters"][KEY] for c in cs) / len(cs)
