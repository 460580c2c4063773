"""select_wait_ms.serve: the host blocked on the card for the selection
(serve.fetch_selection: the copies of the device top-N to the host, the
first of which waits for the SST and the top-N to finish), in ms a
chunk: the change of the port's counter fetch_selection.wait_ns over
each chunk (the host's clock), the mean over the chunks outside the
profiled stretch."""

KEY = "fetch_selection.wait_ns"


def read(rec):
    cs = [c for c in rec["chunks"] if not c["profiled"]]
    if not cs or any(KEY not in c["counters"] for c in cs):
        return None
    return 1e-6 * sum(c["counters"][KEY] for c in cs) / len(cs)
