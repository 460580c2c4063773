"""gc_ms.serve: the interpreter's garbage collector, in ms a request: the
seconds its collections ran (gc.callbacks) during each request outside
the profiled stretch, the mean.  Most of what it walks is the serve
layer's output (a Caption object a proposal, the selections' lists), so
fewer Python objects a request show here first."""


def read(rec):
    reqs = [r for r in rec["requests"] if not r["profiled"] and r["captions"]]
    return 1e3 * sum(r["gc_s"] for r in reqs) / len(reqs) if reqs else None
