"""The whole no-grad attention step in one kernel, two forms, and their
plain PyTorch versions:

    att_res [B, N, D] = masked_softmax(w . tanh(pre + q) + b, mask) @ feats

Kernel 5, ``attention_fused`` (csrc/attention_fused.cu), replaces the
Pallas TPU kernel echr_tpu/ops/pallas_attention.py::_fused_kernel
(pallas_call at :260, wrapper attention_fused :284): the window mask as a
[B, N, T] tensor, an online softmax over T, AV in bf16 with f32 sums.
Kernel 6, ``windowed_attention`` (csrc/windowed_attention.cu), replaces
echr_tpu/ops/pallas_windowed_attention.py::_kernel (pallas_call at :96,
wrapper windowed_attention :137): each proposal's window as [s, e) frame
bounds, only the window's frames scored, all f32.  What bounds each on an
H100 and what its design does about it: the note at the top of its
source.

As in echr_tpu, neither is wired into a decode loop: kernel 5 is reached
through ``ops.attention.additive_attention_step(fused=True)``, which no
decoder passes, and kernel 6 only by direct calls.  The TPU losses of both
had TPU causes (8-row tiles underfilling the MXU; per-proposal DMA issue
overhead), so both are measured again on the H100 (chip_smoke.py phases 11
and 12).
"""
from __future__ import annotations

import torch

from echr_tpu_torch.ops import native, use_plain
from echr_tpu_torch.ops.core import round_to
from echr_tpu_torch.ops.kernel_attention import attention_scores_plain
from echr_tpu_torch.ops.masked import masked_softmax, segment_window_mask

_NEG_INF = -1e30


def attention_fused_plain(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, mask: torch.Tensor, feats: torch.Tensor
                          ) -> torch.Tensor:
    """Kernel 5's plain version: the scores, p = exp(s - rowmax) on
    mask == 1, then bf16(p) @ bf16(feats) summed in f32 and divided by
    sum(p); a fully-masked row gives zeros.  The kernel rounds p taken from
    its running max instead of the row max (atol 2e-3, as echr_tpu's gate
    for its fused kernel)."""
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
    out = torch.empty(B, N, D, device=dev, dtype=f32)
    if out.numel() == 0:
        return out
    rc = native.library().echr_attention_fused(
        pre.data_ptr(), q.data_ptr(), w.data_ptr(), b.data_ptr(), mask.data_ptr(),
        feats.data_ptr(), out.data_ptr(), B, N, T, H, D,
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "echr_attention_fused")
    attention_fused.launches += 1
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
    if (2 * H + D) * 4 > 227 * 1024:
        raise ValueError(f"{fn}: H={H}, D={D} need more shared memory than a block has")
    out = torch.empty(B, N, D, device=dev, dtype=f32)
    if out.numel() == 0:
        return out
    rc = native.library().echr_windowed_attention(
        pre.data_ptr(), feats.data_ptr(), q.data_ptr(), w.data_ptr(), b.data_ptr(),
        soi.data_ptr(), out.data_ptr(), B, N, T, H, D,
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "echr_windowed_attention")
    windowed_attention.launches += 1
    return out


windowed_attention.launches = 0
