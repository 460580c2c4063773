"""encode_host_ms.serve: the host issuing the SST
(engine/steps.encode_step_batched: the LSTM's launches frame by frame,
the card running behind), in ms a chunk: the change of the port's counter
encode_step_batched.host_ns over each chunk (the host's clock, no device
barrier), the mean over the chunks outside the profiled stretch."""

KEY = "encode_step_batched.host_ns"


def read(rec):
    cs = [c for c in rec["chunks"] if not c["profiled"]]
    if not cs or any(KEY not in c["counters"] for c in cs):
        return None
    return 1e-6 * sum(c["counters"][KEY] for c in cs) / len(cs)
