"""Kernels 9 and 10: the overlap probe's scores, alone and with an
independent bf16 product (csrc/probe_score_overlap.cu).

    s [B, N, T]           = tanh(q[:, :, None] + pre[:, None]) @ w            (f32)
    dot [B, T/128, N, KD] = bf16(q) @ wd, f32 sums, once per 128-frame block

Kernel 9, ``probe_scores``, replaces the Pallas TPU kernel
experiments/probe_mxu_vpu_overlap.py::_score_kernel (pallas_call at :88):
the additive scores with no bias and no mask.  Kernel 10,
``probe_scores_plus_dot``, replaces ::_score_plus_dot_kernel (pallas_call
at :95): the same scores, and in every (proposal tile, 128-frame tile)
block the product of the tile's q rows with wd, written to that frame
tile's copy, so dot holds ceil(T/128) copies as the probe's does.  The two
share one score tile and tanh loop, so kernel 10 - kernel 9 measures the
product alone; whether tensor-core work hides under the tanh work is the
question they answer (experiments/probe_mxu_vpu_overlap.py's S0 and S1).
"""
from __future__ import annotations

import torch

from echr_tpu_torch.ops import native, use_plain

TILE_T = 128  # frames of one block, and of one copy of the product


def _copies(T: int) -> int:
    return -(-T // TILE_T)


def probe_scores_plain(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel 9's plain version: tanh(q[:, :, None] + pre[:, None]) @ w,
    f32, materialising the [B, N, T, H] tanh."""
    return torch.matmul(torch.tanh(q[:, :, None] + pre[:, None]), w)


def probe_dot_plain(q: torch.Tensor, wd: torch.Tensor, T: int) -> torch.Tensor:
    """Kernel 10's product, plain: bf16(q) @ wd summed in f32, repeated
    ceil(T/128) times -> [B, ceil(T/128), N, KD]."""
    d = torch.matmul(q.to(torch.bfloat16).float(), wd.float())
    return d[:, None].expand(-1, _copies(T), -1, -1).contiguous()


def _check(fn, pre, q, w):
    B, T, H = pre.shape
    N = q.shape[1]
    f32, dev = torch.float32, pre.device
    native.check_arg(fn, "pre", pre, (B, T, H), f32, dev)
    native.check_arg(fn, "q", q, (B, N, H), f32, dev)
    native.check_arg(fn, "w", w, (H,), f32, dev)
    if B > 65535:
        raise ValueError(f"{fn}: B={B} videos exceed the grid's 65535")
    return B, N, T, H


def probe_scores(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel 9: pre [B, T, H], q [B, N, H], w [H] -> s [B, N, T], all f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if use_plain(pre):
        return probe_scores_plain(pre, q, w)
    B, N, T, H = _check("probe_scores", pre, q, w)
    s = torch.empty(B, N, T, device=pre.device, dtype=torch.float32)
    if s.numel() == 0:
        return s
    rc = native.library().echr_probe_scores(
        pre.data_ptr(), q.data_ptr(), w.data_ptr(), None, s.data_ptr(), None, B, N, T, H, 0, 1,
        torch.cuda.current_stream(pre.device).cuda_stream)
    native.check(rc, "echr_probe_scores")
    probe_scores.launches += 1
    return s


probe_scores.launches = 0


def probe_scores_plus_dot(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                          wd: torch.Tensor, scores: bool = True):
    """Kernel 10: (s, dot): kernel 9's scores and dot [B, ceil(T/128), N, KD]
    f32, the product of bf16(q) with wd [H, KD] bf16 in every 128-frame
    block.  ``scores=False`` runs the kernel's product warps alone and
    returns (None, dot): the product's own time inside the kernel, which
    the overlap probe needs to read S1.  On CUDA, H must be a multiple of
    16 and KD of 128.  CPU tensors take the plain versions; CUDA tensors
    launch the kernel."""
    if use_plain(pre):
        s = probe_scores_plain(pre, q, w) if scores else None
        return s, probe_dot_plain(q, wd, pre.shape[1])
    fn = "probe_scores_plus_dot"
    B, N, T, H = _check(fn, pre, q, w)
    kd = wd.shape[1]
    native.check_arg(fn, "wd", wd, (H, kd), torch.bfloat16, pre.device)
    if H % 16 or kd % 128:
        raise ValueError(f"{fn}: needs H a multiple of 16 and KD of 128 (H={H}, KD={kd})")
    if wd.data_ptr() % 16:
        raise ValueError(f"{fn}: wd must start on a 16-byte boundary (cp.async)")
    s = torch.empty(B, N, T, device=pre.device, dtype=torch.float32) if scores else None
    dot = torch.empty(B, _copies(T), N, kd, device=pre.device, dtype=torch.float32)
    if B * N * T == 0 or kd == 0:
        return s, dot
    rc = native.library().echr_probe_scores(
        pre.data_ptr(), q.data_ptr(), w.data_ptr(), wd.data_ptr(),
        s.data_ptr() if scores else None, dot.data_ptr(), B, N, T, H, kd, int(scores),
        torch.cuda.current_stream(pre.device).cuda_stream)
    native.check(rc, "echr_probe_scores")
    probe_scores_plus_dot.launches += 1
    return s, dot


probe_scores_plus_dot.launches = 0
