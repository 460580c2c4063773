"""Probe: kernel 8's tile sweep against the dense product and its
reductions, on one H100.

The port of experiments/probe_streaming_head2.py.  Without a vocab split a
block owns TR rows and walks every vocab tile, so the (TR, TV) tiling sets
both how many blocks fill the card (R/TR against 132 SMs) and how often w
is read from L2 (R/TR times).  Every instantiated tiling is checked first
(the argmax must be bit-equal to the plain version's: the greedy fidelity
gate; a tiling that fails raises), then X0 (bf16 torch.matmul + bias,
argmax, amax, logsumexp), XM (the product alone), both again over the
padded vocab (X0p, XMp), and every tiling are timed in interleaved
windows, the least of the windows kept per configuration.

Usage: python -m echr_tpu_torch.experiments.probe_streaming_head2
"""
from __future__ import annotations

from echr_tpu_torch.experiments import device_name, ms_per_step, probe_device
from echr_tpu_torch.experiments.probe_greedy_head import (B, C, N, STEPS, V1, check_head,
                                                          library_rows, probe_inputs, step_update)
from echr_tpu_torch.ops.kernel_probe_head import (TILINGS, pad_probe_head, stream_head,
                                                  stream_head_plain)

WINDOWS = 3


def run(device="cuda", B=B, N=N, C=C, V1=V1, steps=STEPS, seed=0):
    """Check every tiling, then time X0, XM, X0p, XMp and each tiling in
    WINDOWS interleaved windows; print the table and return the record
    (``kernel_calls``: the calls this run made to the kernel's wrapper,
    each a launch on the card)."""
    dev = probe_device(device)
    w, b, out0 = probe_inputs(B, N, C, V1, seed, dev)
    print(f"[{device_name(dev)}] R={B * N} C={C} V1={V1} bf16, tilings (TR, TV) {list(TILINGS)}")

    padded = {tv: pad_probe_head(w, b, tv) for tv in sorted({tv for _, tv in TILINGS})}
    checks = {}
    for tr, tv in TILINGS:
        wp, bp = padded[tv]
        check = check_head(stream_head(out0, wp, bp, tr, tv), stream_head_plain(out0, wp, bp))
        checks[f"{tr}x{tv}"] = check
        print(f"tiling ({tr:4d},{tv:4d}): argmax equal {check['token_mismatches'] == 0}, "
              f"max|diff| {check['max_abs_err_max']:.2e}, lse max|diff| "
              f"{check['max_abs_err_lse']:.2e}", flush=True)
        if check["token_mismatches"]:
            raise RuntimeError(f"tiling {(tr, tv)}: {check['token_mismatches']} argmax "
                               f"mismatches against the plain version")

    def tiled(tr, tv):
        wp, bp = padded[tv]

        def loop():
            o = out0
            for _ in range(steps):
                o = step_update(o, *stream_head(o, wp, bp, tr, tv))
            return o.sum()
        return loop

    wp, bp = padded[max(padded)]
    cases = library_rows(out0, w, b, wp, bp, steps) + [
        (f"{tr}x{tv}", f"K ({tr}x{tv})", tiled(tr, tv)) for tr, tv in TILINGS]
    best = {tag: float("inf") for tag, _, _ in cases}
    for _ in range(WINDOWS):  # interleaved windows, the least per configuration
        for tag, _, loop in cases:
            best[tag] = min(best[tag], ms_per_step(loop, dev, steps))
    for tag, label, _ in cases:
        print(f"{label:>18}: {best[tag]:8.4f} ms/step", flush=True)
    per_tiling = 1 + WINDOWS * 4 * steps  # the check, then one warm-up and three timed loops
    return {"device": device_name(dev), "R": B * N, "C": C, "V1": V1, "steps": steps,
            "checks": checks, "ms_per_step": best,
            "kernel_calls": {"stream_head": per_tiling * len(TILINGS)}}


if __name__ == "__main__":
    run()
