"""Probe: the streaming greedy head (kernel 7) against the dense product
and its reductions, on one H100.

The port of experiments/probe_greedy_head.py.  Greedy decode reads the
[R, V+1] logits only through three row reductions (argmax, max,
logsumexp); kernel 7 streams the vocab tiles through a running (max,
argmax, sumexp) so the logits never reach global memory.  Measures ms per
step over a loop of ``steps`` dependent steps (o = o*0.9 + upd) at the
batched decode's dims:

  X0  torch.matmul in bf16 (cuBLAS) + bias, argmax, amax, logsumexp
  XM  torch.matmul in bf16 alone: the product's floor
  X0p, XMp  the same over the vocab padded to a multiple of 512 (kernel
      7's weights), whose rows cuBLAS's tensor-core kernels can take
  K1  kernel 7, ops.kernel_probe_head.stream_head at its plan (64, 512)
  K2  kernel 2, ops.kernel_head.greedy_head (128 rows, vocab splits)

after checking kernel 7's argmax, max and logsumexp against its plain
version.  X0 and XM are library routes, yardsticks only: the port's decode
never calls them.

Usage: python -m echr_tpu_torch.experiments.probe_greedy_head
"""
from __future__ import annotations

import numpy as np
import torch

from echr_tpu_torch.experiments import device_name, ms_per_step, probe_device
from echr_tpu_torch.ops.kernel_head import greedy_head
from echr_tpu_torch.ops.kernel_probe_head import (PLAN, pad_probe_head, stream_head,
                                                  stream_head_plain)

B, N, C, V1, STEPS = 32, 128, 1536, 6001, 31


def probe_inputs(B, N, C, V1, seed, dev):
    """The probe's draws: w [C, V1] bf16-valued, b [V1], out0 [B*N, C] f32."""
    r = np.random.RandomState(seed)
    w = torch.from_numpy((r.randn(C, V1) * 0.05).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy((r.randn(V1) * 0.1).astype(np.float32))
    out0 = torch.from_numpy((r.randn(B * N, C) * 0.3).astype(np.float32))
    return w.to(dev), b.to(dev), out0.to(dev)


def check_head(got, want):
    """Token mismatches and the max|d| of max and lse between two
    (tok, mx, lse) triples."""
    tok, mx, lse = got
    wtok, wmx, wlse = want
    return {"token_mismatches": int((tok != wtok).sum()),
            "max_abs_err_max": float((mx - wmx).abs().max()),
            "max_abs_err_lse": float((lse - wlse).abs().max())}


def step_update(o, it, mx, lse):
    """The probes' dependent step: o*0.9 plus the head's outputs."""
    return o * 0.9 + ((mx - lse) * 0.01 + it.float() * 1e-9)[:, None]


def yardsticks(out0, w, b, steps):
    """The library routes, as step loops: X0 (the bf16 product, the bias,
    argmax, amax and logsumexp) and XM (the bf16 product alone) over
    w [C, V1] and b as given."""
    bf16 = torch.bfloat16

    def x0():
        o = out0
        for _ in range(steps):
            logits = torch.matmul(o.to(bf16), w) + b
            o = step_update(o, logits.argmax(dim=1), logits.amax(dim=1),
                        torch.logsumexp(logits, dim=1))
        return o.sum()

    def xm():
        o = out0
        for _ in range(steps):
            o = o * 0.9 + torch.matmul(o.to(bf16), w)[:, :1].float() * 0.01
        return o.sum()

    return x0, xm


def library_rows(out0, w, b, wp, bp, steps):
    """X0 and XM at the probe's vocab (V1=6001: rows of w and of the logits
    an odd number of bf16 apart), and X0p and XMp over the padded wp, bp,
    whose rows are 16-byte aligned as cuBLAS's tensor-core kernels want;
    the -1e30 pad bias leaves X0p's argmax, max and logsumexp as X0's."""
    x0, xm = yardsticks(out0, w, b, steps)
    x0p, xmp = yardsticks(out0, wp, bp, steps)
    return [("X0", "X0 dense+reduce", x0), ("XM", "XM pure matmul", xm),
            ("X0p", "X0p padded vocab", x0p), ("XMp", "XMp padded matmul", xmp)]


def run(device="cuda", B=B, N=N, C=C, V1=V1, steps=STEPS, seed=0):
    """Check kernel 7, then time X0, XM, K1 and K2; print the table and
    return the record (``kernel_calls``: the calls this run made to each
    kernel's wrapper, each a launch on the card)."""
    dev = probe_device(device)
    w, b, out0 = probe_inputs(B, N, C, V1, seed, dev)
    tr, tv = PLAN
    wp, bp = pad_probe_head(w, b, tv)
    w_k2 = w.t().contiguous()  # kernel 2 takes the logit layer as [V1, C]

    got = stream_head(out0, wp, bp, tr, tv)
    want = stream_head_plain(out0, wp, bp)
    check = check_head(got, want)
    print(f"[{device_name(dev)}] R={B * N} C={C} V1={V1} VP={wp.shape[1]} bf16, kernel 7 at "
          f"(TR, TV)={PLAN}")
    print(f"argmax equal: {check['token_mismatches'] == 0}  max|diff|: "
          f"{check['max_abs_err_max']:.2e}  lse max|diff|: {check['max_abs_err_lse']:.2e}",
          flush=True)

    def k1():
        o = out0
        for _ in range(steps):
            o = step_update(o, *stream_head(o, wp, bp, tr, tv))
        return o.sum()

    def k2():
        o = out0
        for _ in range(steps):
            o = step_update(o, *greedy_head(o, w_k2, b))
        return o.sum()

    ms = {}
    for tag, label, loop in library_rows(out0, w, b, wp, bp, steps) + [
            ("K1", "K1 kernel 7", k1), ("K2", "K2 kernel 2", k2)]:
        ms[tag] = ms_per_step(loop, dev, steps)
        print(f"{label:>18}: {ms[tag]:8.4f} ms/step", flush=True)
    timed = 4 * steps  # ms_per_step: one warm-up and three timed loops
    return {"device": device_name(dev), "R": B * N, "C": C, "V1": V1, "VP": wp.shape[1],
            "plan": PLAN, "steps": steps, "check": check, "ms_per_step": ms,
            "kernel_calls": {"stream_head": 1 + timed, "greedy_head": timed}}


if __name__ == "__main__":
    run()
