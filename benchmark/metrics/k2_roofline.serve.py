"""k2_roofline.serve: kernel 2 (ops/kernel_head.py + csrc/greedy_head.cu,
the streaming greedy head) in the profiled stretch: the summed bound of
its launches (greedy_head.launches; arith/kernels.k2 at R = videos x proposal bucket rows, C
the core output's width, V1 = vocab + 1, bf16 operands) over its device
time in the trace (its kernels head_wgmma_kernel or head_f32_kernel and
head_combine_kernel), in %."""
from benchmark.arith.kernels import k2

NAMES = ("head_wgmma_kernel", "head_f32_kernel", "head_combine_kernel")


def read(rec):
    t = rec["timeline"]
    if t is None:
        return None
    dev_s = sum(s for n, s in t["kernels_s"].items() if any(k in n for k in NAMES))
    s = rec["spec"]
    width = 2 if s.compute_dtype in ("bfloat16", "bf16") else 4
    bound_ms = sum(c["counters"]["greedy_head.launches"] * k2(c["B"] * c["nb"], s.logit_in, s.vocab + 1,
                                         width)["bound_ms"]
                   for c in rec["chunks"] if c["profiled"])
    if dev_s <= 0.0 or bound_ms <= 0.0:
        return None
    return 100.0 * bound_ms / (1e3 * dev_s)
