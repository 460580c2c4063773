"""The whole no-grad attention step in one kernel, two forms, and their
plain PyTorch versions:

    att_res [B, N, D] = masked_softmax(w . tanh(pre + q) + b, mask) @ feats

Kernel 5, ``attention_fused`` (csrc/attention_fused.cu), replaces the
Pallas TPU kernel echr_tpu/ops/pallas_attention.py::_fused_kernel
(pallas_call at :260, wrapper attention_fused :284): the window mask as a
[B, N, T] tensor, the softmax over T from each row's max, AV in bf16
with f32 sums.
Kernel 6, ``windowed_attention`` (csrc/windowed_attention.cu), replaces
echr_tpu/ops/pallas_windowed_attention.py::_kernel (pallas_call at :96,
wrapper windowed_attention :137): each proposal's window as [s, e) frame
bounds, only the window's frames scored, all f32.  What bounds each on an
H100 and what its design does about it: the note at the top of its
source.  Both are bound by their tanh, which both evaluate only at live
(n, t), as kernel 1.

Each launch fits its grid to the card from the shapes alone (no value of
the tensors is read on the host): ``fused_splits`` splits kernel 5's
frame tiles over up to 8 blocks of a cluster when its row tiles are too
few to fill the SMs, and ``windowed_rows`` gives kernel 6's blocks 4, 2
or 1 adjacent rows.  ``fused_on`` and ``windowed_on`` launch a given
library's kernel with the plan; kernel_turns.py passes another build.

As in echr_tpu, neither is wired into a decode loop: kernel 5 is reached
through ``ops.attention.additive_attention_step(fused=True)``, which no
decoder passes, and kernel 6 only by direct calls.  The TPU losses of both
had TPU causes (8-row tiles underfilling the MXU; per-proposal DMA issue
overhead), so both are measured again on the H100 (chip_smoke.py phases 11
and 12, and at the SOTA_TEP and per-video decode steps, phases 27 and 29).
"""
from __future__ import annotations

import torch

from echr_tpu_torch.ops import count_launch, native, use_plain
from echr_tpu_torch.ops.core import round_to
from echr_tpu_torch.ops.kernel_attention import attention_scores_plain
from echr_tpu_torch.ops.masked import masked_softmax, segment_window_mask

_NEG_INF = -1e30
FUSED_ROWS, FUSED_COLUMNS = 32, 512  # kernel 5's block: rows, and columns of D
FRAME_TILE = 32  # kernel 5's frames a tile
MAX_SPLITS = 8  # a portable thread-block cluster
SPLIT_TILES = 16  # the frame tiles whose scores one block of kernel 5 keeps
FUSED_MAX_T = 4096  # kernel 5's frames: its block's mask bits and scores fit shared memory
WINDOWED_ROWS = (4, 2, 1)  # kernel 6's rows a block, most first


def fused_splits(B: int, N: int, T: int, D: int, sms: int) -> int:
    """Kernel 5's frame split: the blocks over which each 32-row tile's
    live frame tiles are shared, one cluster a row tile.  One while the
    grid without a split has a block for every SM; else as many as the
    SMs left for each block, at most 8 (a portable cluster) and at most
    the frame tiles; and at least as many as keep a block to 16 tiles'
    scores (T > 512)."""
    blocks = B * -(-N // FUSED_ROWS) * -(-D // FUSED_COLUMNS)
    tiles = -(-T // FRAME_TILE)
    fill = max(1, min(MAX_SPLITS, tiles, sms // max(blocks, 1)))
    return max(fill, -(-tiles // SPLIT_TILES))


def windowed_rows(B: int, N: int, sms: int) -> int:
    """Kernel 6's adjacent rows a block: the most of 4, 2 and 1 whose grid
    still has two blocks an SM (the k beam copies of a proposal are
    adjacent and share a window); 1 below that."""
    for g in WINDOWED_ROWS:
        if B * -(-N // g) >= 2 * sms:
            return g
    return 1


def windowed_smem_bytes(H: int, D: int, rows: int) -> int:
    """Kernel 6's shared memory a block (csrc/windowed_attention.cu
    smem_bytes): q of its rows, w, two 8-frame chunks of pre (H padded to
    128) and of feats (up to 2048 columns, in steps of 256)."""
    cols = 256 * (1 << max(0, (-(-min(D, 2048) // 256) - 1).bit_length()))
    return 4 * ((rows + 17) * -(-H // 128) * 128 + 16 * cols)


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_on(lib, pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             mask: torch.Tensor, feats: torch.Tensor, splits: int) -> torch.Tensor:
    """Kernel 5 of ``lib`` (checked CUDA tensors) with ``splits``."""
    B, T, H = pre.shape
    N, D = q.shape[1], feats.shape[2]
    out = torch.empty(B, N, D, device=pre.device, dtype=torch.float32)
    if out.numel():
        rc = lib.echr_attention_fused_splits(
            pre.data_ptr(), q.data_ptr(), w.data_ptr(), b.data_ptr(), mask.data_ptr(),
            feats.data_ptr(), out.data_ptr(), B, N, T, H, D, splits,
            torch.cuda.current_stream(pre.device).cuda_stream)
        native.check(rc, "echr_attention_fused_splits")
    return out


def windowed_on(lib, pre: torch.Tensor, feats: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, soi: torch.Tensor, rows: int) -> torch.Tensor:
    """Kernel 6 of ``lib`` (checked CUDA tensors), ``rows`` rows a block."""
    B, T, H = pre.shape
    N, D = q.shape[1], feats.shape[2]
    out = torch.empty(B, N, D, device=pre.device, dtype=torch.float32)
    if out.numel():
        rc = lib.echr_windowed_attention_rows(
            pre.data_ptr(), feats.data_ptr(), q.data_ptr(), w.data_ptr(), b.data_ptr(),
            soi.data_ptr(), out.data_ptr(), B, N, T, H, D, rows,
            torch.cuda.current_stream(pre.device).cuda_stream)
        native.check(rc, "echr_windowed_attention_rows")
    return out


def attention_fused_plain(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, mask: torch.Tensor, feats: torch.Tensor
                          ) -> torch.Tensor:
    """Kernel 5's plain version: the scores, p = exp(s - rowmax) on
    mask == 1, then bf16(p) @ bf16(feats) summed in f32 and divided by
    sum(p); a fully-masked row gives zeros.  The kernel takes p from the
    row max too, its sums in another order (atol 2e-3, as echr_tpu's gate
    for its fused kernel, which rounds p from its running max)."""
    s = attention_scores_plain(pre, q, w, b, mask)
    live = mask > 0
    s = torch.where(live, s, torch.full_like(s, _NEG_INF))
    p = torch.where(live, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(round_to(p, torch.bfloat16), round_to(feats, torch.bfloat16))
    return torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)),
                       torch.zeros_like(acc))


def attention_fused(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    mask: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Kernel 5: pre [B, T, H], q [B, N, H], w [H], b [1], mask [B, N, T],
    feats [B, T, D] -> att_res [B, N, D] f32.  CPU tensors take the plain
    version; CUDA tensors (all f32) launch the kernel."""
    if use_plain(pre):
        return attention_fused_plain(pre, q, w, b, mask, feats)
    fn = "attention_fused"
    B, T, H = pre.shape
    N, D = q.shape[1], feats.shape[2]
    f32, dev = torch.float32, pre.device
    native.check_arg(fn, "pre", pre, (B, T, H), f32, dev)
    native.check_arg(fn, "q", q, (B, N, H), f32, dev)
    native.check_arg(fn, "w", w, (H,), f32, dev)
    native.check_arg(fn, "b", b, (1,), f32, dev)
    native.check_arg(fn, "mask", mask, (B, N, T), f32, dev)
    native.check_arg(fn, "feats", feats, (B, T, D), f32, dev)
    if B > 65535:
        raise ValueError(f"{fn}: B={B} videos exceed the grid's 65535")
    if T > FUSED_MAX_T:
        raise ValueError(f"{fn}: T={T} frames exceed the {FUSED_MAX_T} a block's shared memory "
                         f"holds")
    out = fused_on(native.library(), pre, q, w, b, mask, feats,
                   fused_splits(B, N, T, D, _sms(dev)))
    if out.numel():
        count_launch(attention_fused)
    return out


attention_fused.launches = 0


def windowed_attention_plain(pre: torch.Tensor, feats: torch.Tensor, q: torch.Tensor,
                             w: torch.Tensor, b: torch.Tensor, soi: torch.Tensor,
                             W: int) -> torch.Tensor:
    """Kernel 6's plain version, all f32: segment_window_mask -> scores ->
    masked_softmax -> AV.  ``W`` is unused, as in the kernel."""
    mask = segment_window_mask(soi, pre.shape[1])
    weights = masked_softmax(attention_scores_plain(pre, q, w, b, mask), mask, dim=-1)
    return torch.matmul(weights, feats.float())


def windowed_attention(pre: torch.Tensor, feats: torch.Tensor, q: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor, soi: torch.Tensor,
                       W: int) -> torch.Tensor:
    """Kernel 6: pre [B, T, H], feats [B, T, D], q [B, N, H], w [H], b [1],
    soi [B, N, 2] int32 windows [s, e) -> att_res [B, N, D] f32, equal to
    the full masked attention.  ``W`` is echr_tpu's bound on e - s; the
    kernel streams each window in chunks, so every length is exact and W
    is kept for parity of the signature only.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if use_plain(pre):
        return windowed_attention_plain(pre, feats, q, w, b, soi, W)
    fn = "windowed_attention"
    B, T, H = pre.shape
    N, D = q.shape[1], feats.shape[2]
    f32, dev = torch.float32, pre.device
    native.check_arg(fn, "pre", pre, (B, T, H), f32, dev)
    native.check_arg(fn, "feats", feats, (B, T, D), f32, dev)
    native.check_arg(fn, "q", q, (B, N, H), f32, dev)
    native.check_arg(fn, "w", w, (H,), f32, dev)
    native.check_arg(fn, "b", b, (1,), f32, dev)
    native.check_arg(fn, "soi", soi, (B, N, 2), torch.int32, dev)
    if B > 65535:
        raise ValueError(f"{fn}: B={B} videos exceed the grid's 65535")
    rows = windowed_rows(B, N, _sms(dev))
    if windowed_smem_bytes(H, D, rows) > 227 * 1024:
        raise ValueError(f"{fn}: H={H}, D={D} need more shared memory than a block has")
    out = windowed_on(native.library(), pre, feats, q, w, b, soi, rows)
    if out.numel():
        count_launch(windowed_attention)
    return out


windowed_attention.launches = 0
