"""Probe: does tensor-core work hide under tanh work inside one kernel on
an H100?

The port of experiments/probe_mxu_vpu_overlap.py.  The decode step is
tanh-heavy attention scores (FMA and SFU pipes) beside LSTM and logit
products (tensor pipe); if a kernel's mma can run under its tanh work,
fusing the LSTM cells' products into the score kernel would hide them.
At the batched decode's shapes (B=32, N=128, T=256, H=512), over a loop of
``steps`` dependent steps (q = q*0.9 + ...), for each product width KD:

  S0  kernel 9: the scores alone                          [the tanh floor]
  S1  kernel 10: the same scores, and in every block the
      bf16 product of its 64 q rows with wd [H, KD] on
      wgmma, beside the score warps                       [fused: overlap?]
  SD  kernel 10's product warps alone                     [the product's own time]
  S2  kernel 9 + the same total product work as two bf16
      torch.matmul with distinct weights (cuBLAS)         [serial reference]

S1 ~ max(S0, SD): the product rides under the tanh.  S1 ~ S0 + SD: the
two serialise.  KD=2048 is the probe's width (17.2 GFLOP a step); at
KD=8192 (69 GFLOP, a 268 MB product) its share is large enough to see.

Usage: python -m echr_tpu_torch.experiments.probe_mxu_vpu_overlap
"""
from __future__ import annotations

import numpy as np
import torch

from echr_tpu_torch.experiments import device_name, ms_per_step, probe_device
from echr_tpu_torch.ops.kernel_probe_scores import probe_scores, probe_scores_plus_dot

B, N, T, H, STEPS = 32, 128, 256, 512, 31
KD = 2048  # the JAX probe's product width
KDS = (KD, 4 * KD)


def run(device="cuda", B=B, N=N, T=T, H=H, steps=STEPS, kds=KDS, seed=0):
    """Time S0, S1, SD and S2 at each KD; print the table and return the
    record (``kernel_calls``: the calls this run made to each kernel's
    wrapper, each a launch on the card)."""
    dev = probe_device(device)
    r = np.random.RandomState(seed)

    def draw(*shape, scale):
        return torch.from_numpy((r.randn(*shape) * scale).astype(np.float32)).to(dev)

    pre, q0 = draw(B, T, H, scale=0.5), draw(B, N, H, scale=0.5)
    w = draw(H, scale=0.05)
    bf16 = torch.bfloat16
    print(f"[{device_name(dev)}] B={B} N={N} T={T} H={H}, {steps} steps, "
          f"{B * N * T * H / 1e6:.0f}M tanh a step")

    def s0():
        q = q0
        for _ in range(steps):
            q = q * 0.9 + probe_scores(pre, q, w)[..., :1] * 0.01
        return q.sum()

    rows, timed = {}, 4 * steps  # ms_per_step: one warm-up and three timed loops
    for kd in kds:
        wd, wd2 = draw(H, kd, scale=0.05).to(bf16), draw(H, kd, scale=0.05).to(bf16)

        def s1():
            q = q0
            for _ in range(steps):
                s, d = probe_scores_plus_dot(pre, q, w, wd)
                q = q * 0.9 + s[..., :1] * 0.01 + d.sum() * 1e-12
            return q.sum()

        def sd():
            q = q0
            for _ in range(steps):
                _, d = probe_scores_plus_dot(pre, q, w, wd, scores=False)
                q = q * 0.9 + d.sum() * 1e-12
            return q.sum()

        def s2():
            q = q0
            for _ in range(steps):
                s = probe_scores(pre, q, w)
                qb = q.to(bf16)  # distinct weights: two products, as the probe's S2
                d = torch.matmul(qb, wd) + torch.matmul(qb, wd2)
                q = q * 0.9 + s[..., :1] * 0.01 + d.sum(dtype=torch.float32) * 1e-12
            return q.sum()

        ms = {}
        print(f"KD={kd}: product {2.0 * B * N * -(-T // 128) * H * kd / 1e9:.1f} GFLOP a step")
        for tag, label, loop in (("S0", "S0 kernel 9 alone", s0),
                                 ("S1", "S1 kernel 10 fused", s1),
                                 ("SD", "SD kernel 10 product only", sd),
                                 ("S2", "S2 kernel 9 + 2 matmuls", s2)):
            ms[tag] = ms_per_step(loop, dev, steps)
            rate = (f"  ({B * N * T * H / (ms[tag] / 1e3) / 1e9:7.1f} Gtanh/s nominal)"
                    if tag != "SD" else "")
            print(f"{label:>26}: {ms[tag]:8.4f} ms/step{rate}", flush=True)
        rows[kd] = ms
    return {"device": device_name(dev), "B": B, "N": N, "T": T, "H": H, "steps": steps,
            "ms_per_step": rows,
            "kernel_calls": {"probe_scores": 2 * timed * len(kds),
                             "probe_scores_plus_dot": 2 * timed * len(kds)}}


if __name__ == "__main__":
    run()
