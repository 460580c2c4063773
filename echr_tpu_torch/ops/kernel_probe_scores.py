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

The block plan, a model of the kernel's own indexing that the CPU tests
check: a block owns (video b, TILE_N proposals, TILE_T frames), grid
``grid(B, N, T)``.  Score warp g, lane l writes s at proposals
n0 + RN g + i and frames t0 + l + 32 j (``score_writes``); the product's
consumer warpgroup writes its block's copy of dot in wgmma's accumulator
layout, one KD_TILE-column tile after another (``dot_writes``).  The
constants are the source's; ``smem_bytes`` and ``check_dims`` are its
limits, checked before any launch.
"""
from __future__ import annotations

import numpy as np
import torch

from echr_tpu_torch.ops import native, use_plain

# csrc/probe_score_overlap.cu: TN, TT, SCORE_WARPS, HC, BUFS, KN, STAGES
TILE_N = 64  # proposals of a block: wgmma's M
TILE_T = 128  # frames of a block, and of one copy of the product
SCORE_WARPS = 8
HC = 16  # hidden units of a staged chunk
BUFS = 3  # staged chunks in flight
KD_TILE = 128  # columns of a product tile: wgmma's n
STAGES = 4  # wd's TMA ring
RN, RT = TILE_N // SCORE_WARPS, TILE_T // 32  # a score thread's proposals and frames
_BK = 64  # hidden units of a ring stage: one 128-byte swizzle row
_SMEM_LIMIT = 232448


def _copies(T: int) -> int:
    return -(-T // TILE_T)


def grid(B: int, N: int, T: int):
    """The launch grid (frame tiles, proposal tiles, videos)."""
    return _copies(T), -(-N // TILE_N), B


def smem_bytes(H: int, dot: bool) -> int:
    """Dynamic shared memory of a block: the staged chunks of pre, q and w;
    with the product also 1024 bytes of alignment slack, wd's ring, A (64
    q rows in bf16, H padded to 64) and the ring's barriers."""
    staged = BUFS * (TILE_T * (HC + 4) + TILE_N * HC + HC) * 4
    if not dot:
        return staged
    hp = -(-H // _BK) * _BK
    return 1024 + STAGES * _BK * KD_TILE * 2 + TILE_N * hp * 2 + staged + 16 * STAGES


def check_dims(fn: str, H: int, KD=None) -> None:
    """Raise unless the kernel takes H (and, for kernel 10, KD): H a
    positive multiple of 4 (16-byte copies of pre and q rows); KD a
    positive multiple of KD_TILE and A's 64 x H bf16 within the block's
    227 KB of shared memory (H <= 896)."""
    if H < 1 or H % 4:
        raise ValueError(f"{fn}: needs H a positive multiple of 4 (H={H})")
    if KD is None:
        return
    if KD < KD_TILE or KD % KD_TILE:
        raise ValueError(f"{fn}: needs KD a positive multiple of {KD_TILE} (KD={KD})")
    if smem_bytes(H, True) > _SMEM_LIMIT:
        raise ValueError(f"{fn}: H={H} needs {smem_bytes(H, True)} bytes of shared memory, "
                         f"more than a block's {_SMEM_LIMIT}")


def score_writes(N: int, T: int, block) -> np.ndarray:
    """The (n, t) of s that block (x, y, b) of the grid writes, [k, 2], as
    the score warps index them."""
    x, y, _ = block
    g, i, lane, j = np.meshgrid(np.arange(SCORE_WARPS), np.arange(RN), np.arange(32),
                                np.arange(RT), indexing="ij")
    n = (y * TILE_N + RN * g + i).ravel()
    t = (x * TILE_T + lane + 32 * j).ravel()
    keep = (n < N) & (t < T)
    return np.stack([n[keep], t[keep]], axis=1)


def dot_writes(N: int, KD: int, block) -> np.ndarray:
    """The (copy, n, k) of dot[b] that block (x, y, b) writes, [k, 3]: copy
    x, rows of its proposal tile, from the consumer warpgroup's
    accumulators (thread u: rows 16 (u // 32) + (u % 32) // 4 + 8 h,
    register 4 jj + 2 h + e column 8 jj + 2 (u % 4) + e), KD_TILE columns
    a tile."""
    x, y, _ = block
    tile, u, h, jj, e = np.meshgrid(np.arange(KD // KD_TILE), np.arange(128), np.arange(2),
                                    np.arange(KD_TILE // 8), np.arange(2), indexing="ij")
    n = (y * TILE_N + 16 * (u // 32) + (u % 32) // 4 + 8 * h).ravel()
    k = (tile * KD_TILE + 8 * jj + 2 * (u % 4) + e).ravel()
    keep = n < N
    return np.stack([np.full(int(keep.sum()), x), n[keep], k[keep]], axis=1)


def l2_bytes(B: int, N: int, T: int, H: int, KD: int, tile_n: int = TILE_N) -> int:
    """The bytes of wd [H, KD] bf16 that kernel 10 reads through L2 by the
    plan, a model and not a measurement: once a block, so once per
    (video, tile_n-proposal tile, 128-frame tile)."""
    return B * -(-N // tile_n) * _copies(T) * H * KD * 2


def probe_scores_plain(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel 9's plain version: tanh(q[:, :, None] + pre[:, None]) @ w,
    f32, materialising the [B, N, T, H] tanh."""
    return torch.matmul(torch.tanh(q[:, :, None] + pre[:, None]), w)


def probe_dot_plain(q: torch.Tensor, wd: torch.Tensor, T: int) -> torch.Tensor:
    """Kernel 10's product, plain: bf16(q) @ wd summed in f32, repeated
    ceil(T/128) times -> [B, ceil(T/128), N, KD]."""
    d = torch.matmul(q.to(torch.bfloat16).float(), wd.float())
    return d[:, None].expand(-1, _copies(T), -1, -1).contiguous()


def probe_scores_on(lib, pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                    wd: torch.Tensor | None = None, scores: bool = True):
    """Kernels 9 (wd None) and 10 through ``lib`` (native.library(), or
    another build of the C entry point): (s, dot), s None when ``scores``
    is False, dot None for kernel 9.  H and KD are checked first, then the
    tensors; the launch is not counted."""
    fn = "probe_scores" if wd is None else "probe_scores_plus_dot"
    B, T, H = pre.shape
    N = q.shape[1]
    check_dims(fn, H, None if wd is None else wd.shape[1])
    f32, dev = torch.float32, pre.device
    native.check_arg(fn, "pre", pre, (B, T, H), f32, dev)
    native.check_arg(fn, "q", q, (B, N, H), f32, dev)
    native.check_arg(fn, "w", w, (H,), f32, dev)
    if wd is not None:
        native.check_arg(fn, "wd", wd, (H, wd.shape[1]), torch.bfloat16, dev)
    if any(x.data_ptr() % 16 for x in (pre, q, w) + (() if wd is None else (wd,))):
        raise ValueError(f"{fn}: pre, q, w and wd must start on a 16-byte boundary")
    if B > 65535:
        raise ValueError(f"{fn}: B={B} videos exceed the grid's 65535")
    s = torch.empty(B, N, T, device=dev, dtype=f32) if scores else None
    dot = None if wd is None else torch.empty(B, _copies(T), N, wd.shape[1], device=dev,
                                              dtype=f32)
    if B * N * T == 0:
        return s, dot
    rc = lib.echr_probe_scores(
        pre.data_ptr(), q.data_ptr(), w.data_ptr(), None if wd is None else wd.data_ptr(),
        None if s is None else s.data_ptr(), None if dot is None else dot.data_ptr(),
        B, N, T, H, 0 if wd is None else wd.shape[1], int(scores),
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "echr_probe_scores")
    return s, dot


def probe_scores(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel 9: pre [B, T, H], q [B, N, H], w [H] -> s [B, N, T], all f32;
    on CUDA H a multiple of 4.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if use_plain(pre):
        return probe_scores_plain(pre, q, w)
    s, _ = probe_scores_on(native.library(), pre, q, w)
    if s.numel():  # an empty s launched nothing
        probe_scores.launches += 1
    return s


probe_scores.launches = 0


def probe_scores_plus_dot(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                          wd: torch.Tensor, scores: bool = True):
    """Kernel 10: (s, dot): kernel 9's scores and dot [B, ceil(T/128), N, KD]
    f32, the product of bf16(q) with wd [H, KD] bf16 in every 128-frame
    block.  ``scores=False`` runs the kernel's product warps alone and
    returns (None, dot): the product's own time inside the kernel, which
    the overlap probe needs to read S1.  On CUDA, H must be a multiple of 4
    and at most 896, KD a multiple of 128 (``check_dims``).  CPU tensors
    take the plain versions; CUDA tensors launch the kernel."""
    if use_plain(pre):
        s = probe_scores_plain(pre, q, w) if scores else None
        return s, probe_dot_plain(q, wd, pre.shape[1])
    s, dot = probe_scores_on(native.library(), pre, q, w, wd, scores)
    if dot.numel():  # an empty dot launched nothing
        probe_scores_plus_dot.launches += 1
    return s, dot


probe_scores_plus_dot.launches = 0
