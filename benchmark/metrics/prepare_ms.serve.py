"""prepare_ms.serve: encode and select (serve.prepare_chunk: the SST
through engine/steps.encode_step_batched, select_topk_batched and the
selection's fetch), in ms a chunk: the span, which ends in a device
barrier, the mean over the chunks outside the profiled stretch."""


def read(rec):
    cs = [c for c in rec["chunks"] if not c["profiled"]]
    return 1e3 * sum(c["prepare_s"] for c in cs) / len(cs) if cs else None
