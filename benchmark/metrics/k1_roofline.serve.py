"""k1_roofline.serve: kernel 1 (ops/kernel_attention.py +
csrc/attention_scores.cu, the masked attention scores) in the profiled
stretch: the summed bound of its launches (arith/kernels.k1, the live
(row, frame) pairs of each chunk's windows and frames, times the beam
width, for each of the chunk's attention_scores_masked.launches) over
its device time in the trace (kernels named masked_scores_kernel), in
%."""
from benchmark.arith.kernels import k1

NAMES = ("masked_scores_kernel",)


def read(rec):
    t = rec["timeline"]
    if t is None:
        return None
    dev_s = sum(s for n, s in t["kernels_s"].items() if any(k in n for k in NAMES))
    k, H = rec["beam_size"], rec["spec"].Hatt
    bound_ms = sum(c["counters"]["attention_scores_masked.launches"]
                   * k1(c["B"], c["nb"] * k, c["T"], H, c["live"] * k)["bound_ms"]
                   for c in rec["chunks"] if c["profiled"])
    if dev_s <= 0.0 or bound_ms <= 0.0:
        return None
    return 100.0 * bound_ms / (1e3 * dev_s)
