"""Probe: is there a cheaper accurate tanh for kernels 1 and 4?

Both kernels are bound by the tanh they evaluate.  They take it from
csrc/tanh.cuh (``echr_tanh``: (1 - e) / (1 + e) with e = 2^(-2|x| log2 e),
only its ex2 and rcp).  This probe builds a second library from a copy of
their two sources under _build/, with a tanh.cuh whose ``echr_tanh`` is
CUDA's accurate tanhf, and reports for each build:

  * the SASS of kernel 1's body (cuobjdump): instructions, special-function
    (MUFU) operations, and the instructions saved per tanh site (two MUFU
    a site in both builds);
  * the maximum absolute error against float64 over a dense sweep of
    [-10, 10] and of |x| from 1e-38 to 1, both signs: kernel 1 at H=1 with
    w=1, q=0 and b=0 returns its tanh of pre exactly (the other lanes add
    0), so the sweep reads the device function;
  * kernel 1's time at the beam path's shape (B=32, N*k=512 rows of 128
    proposals' windows repeated 4 times, T=256, H=512, density ~0.5) and
    kernel 4's at the training shape (B=32, N=64, T=256, H=512) with a
    dense cotangent and with one zero outside windows, the two builds in
    turns (tanhf, echr_tanh, echr_tanh, tanhf).

A formulation may replace tanhf only if it costs fewer issue slots, stays
within 2.4e-7 (2 ulp of 1.0) of float64, and chip_smoke.py's parity
phases (5, 10, 14) keep their gates with it.

Usage: python -m echr_tpu_torch.experiments.probe_tanh
"""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from echr_tpu_torch.experiments import device_name, probe_device
from echr_tpu_torch.ops import native
from echr_tpu_torch.ops.kernel_attention import masked_scores_on, scores_bwd_on

TANH_TOL = 2.4e-7  # 2 ulp of 1.0
B, N, K, T, H = 32, 512, 4, 256, 512  # kernel 1: N rows of N / K proposals
TRAIN_N = 64  # kernel 4
TANHF_HEADER = """#pragma once
__device__ __forceinline__ float echr_tanh(float x) { return tanhf(x); }
"""


def tanhf_library():
    """(library, path) of kernels 1, 3 and 4 built from copies of their
    sources whose tanh.cuh makes echr_tanh CUDA's tanhf."""
    work = native.BUILD_DIR / "tanhf_sources"
    work.mkdir(parents=True, exist_ok=True)
    cu = []
    for name in ("attention_scores.cu", "attention_scores_bwd.cu"):
        cu.append(work / name)
        cu[-1].write_text((native.CSRC / name).read_text())
    (work / "tanh.cuh").write_text(TANHF_HEADER)
    so = native.build(cu)
    return native.load(so), so


def sweep_error(dev: torch.device, lib=None):
    """(max |tanh - float64 tanh|, the x where it is largest, points) of
    kernel 1's tanh in ``lib`` (default: the package's library), over
    [-10, 10] and +-[1e-38, 1]."""
    small = np.logspace(-38, 0, 1 << 20)
    x = np.concatenate([np.linspace(-10.0, 10.0, (1 << 22) + 1), small, -small])
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    n = x.numel()
    y = masked_scores_on(lib or native.library(), x.reshape(1, n, 1),
                         torch.zeros(1, 1, 1, device=dev), torch.ones(1, device=dev),
                         torch.zeros(1, device=dev), torch.ones(1, 1, n, device=dev))[0, 0]
    d = (y.double() - torch.tanh(x.double())).abs()
    i = int(d.argmax())
    return float(d[i]), float(x[i]), n


def sass_counts(so: Path):
    """Instructions and MUFU operations in kernel 1's body at H=512
    (masked_scores_kernel<16>), from cuobjdump -sass; None without it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        if "masked_scores_kernelILi16E" in body.split("\n", 1)[0]:
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", body)
            return {"instructions": len(ops), "mufu": ops.count("MUFU")}
    return None


def _inputs(dev: torch.device, seed: int = 0):
    rng = np.random.RandomState(seed)

    def rand(*shape, scale):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    t = np.arange(T)
    s = np.sort(rng.randint(0, T - 8, size=(B, N // K)), axis=1)
    e = np.minimum(s + rng.randint(16, 240, size=s.shape), T)
    mask = ((t >= s[..., None]) & (t < e[..., None])).repeat(K, axis=1).astype(np.float32)
    k1 = (rand(B, T, H, scale=0.5), rand(B, N, H, scale=0.5), rand(H, scale=0.05),
          torch.tensor([0.25], device=dev), torch.from_numpy(mask).to(dev))
    s = np.sort(rng.randint(0, T - 8, size=(B, TRAIN_N)), axis=1)
    e = np.minimum(s + rng.randint(4, 48, size=s.shape), T)
    windows = torch.from_numpy(((t >= s[..., None]) & (t < e[..., None])).astype(np.float32))
    g = rand(B, TRAIN_N, T, scale=1.0)
    k4 = (rand(B, T, H, scale=0.5), rand(B, TRAIN_N, H, scale=0.5), rand(H, scale=0.05))
    return k1, k4 + (g,), k4 + (g * windows.to(dev),)


def _cuda_ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(device="cuda"):
    dev = probe_device(device)
    if dev.type != "cuda":
        raise RuntimeError("probe_tanh measures CUDA builds: it runs on the card only")
    tanhf, tanhf_so = tanhf_library()
    libs = {"tanhf": (tanhf, tanhf_so), "echr_tanh": (native.library(), native.build())}
    k1, k4_dense, k4_windows = _inputs(dev)
    calls = {"kernel 1, beam shape": lambda lib: masked_scores_on(lib, *k1),
             "kernel 4, dense g": lambda lib: scores_bwd_on(lib, *k4_dense),
             "kernel 4, g zero outside windows": lambda lib: scores_bwd_on(lib, *k4_windows)}
    rec = {"device": device_name(dev), "builds": {}}
    for v, (lib, so) in libs.items():
        err, at, n = sweep_error(dev, lib)
        rec["builds"][v] = {"max_abs_err": err, "at": at, "points": n, "sass": sass_counts(so)}
        print(f"{v}: max|tanh - float64| {err:.3e} at x = {at:.9g} over {n} points "
              f"(gate {TANH_TOL}); kernel 1 SASS {rec['builds'][v]['sass']}")
    c0, c1 = (rec["builds"][v]["sass"] for v in libs)
    if c0 and c1:
        rec["saved_per_tanh"] = (c0["instructions"] - c1["instructions"]) / (c1["mufu"] / 2)
        print(f"instructions saved per tanh site: {rec['saved_per_tanh']:.1f}")
    k1_call = calls["kernel 1, beam shape"]
    m = k1[4] > 0
    rec["kernel1_max_abs_diff"] = float((k1_call(tanhf) - k1_call(libs["echr_tanh"][0]))
                                        .abs()[m].max())
    rec["ms"] = {}
    for name, call in calls.items():
        a1 = _cuda_ms(lambda: call(tanhf))
        b1, b2 = (_cuda_ms(lambda: call(libs["echr_tanh"][0])) for _ in range(2))
        a2 = _cuda_ms(lambda: call(tanhf))
        rec["ms"][name] = {"tanhf": [a1, a2], "echr_tanh": [b1, b2]}
        print(f"{name}: tanhf {a1:.4f}, echr_tanh {b1:.4f}, echr_tanh {b2:.4f}, tanhf {a2:.4f} "
              f"ms [{rec['device']}]")
    print(f"kernel 1 at the beam shape, the two builds' scores: max|d| where mask==1 "
          f"{rec['kernel1_max_abs_diff']:.3e}")
    return rec


if __name__ == "__main__":
    run()
