"""decode_ms.serve: the decode (engine/steps.decode_step_batched or
beam_decode_step_batched: the contexts with TSRM, the decoder loop), in
ms a chunk: decode_chunk's span less the prepare_chunk span inside it,
the mean over the chunks outside the profiled stretch."""


def read(rec):
    cs = [c for c in rec["chunks"] if not c["profiled"]]
    return 1e3 * sum(c["decode_s"] - c["prepare_s"] for c in cs) / len(cs) if cs else None
