"""mfu.serve: the model FLOPs the returned captions need (arith/flops:
the encode of each video's frames, TSRM and the contexts, each caption's
steps and beams up to its END token), over the host-clock wall time of
the traced window's requests (each chunk's spans end in a device
barrier; the profiled requests come after the window and are left
out), over the dense bf16 peak (989 TFLOP/s), in %.  Counted from what
was served, not from what the program ran."""
from benchmark.arith.bound import PEAK_OPS_PER_S


def read(rec):
    reqs = [r for r in rec["requests"] if not r["profiled"] and r["captions"]]
    wall = sum(r["end"] - r["start"] for r in reqs)
    if not reqs or wall <= 0.0:
        return None
    return 100.0 * sum(r["flops"] for r in reqs) / wall / PEAK_OPS_PER_S["bf16"]
