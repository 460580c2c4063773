"""Kernel 1: masked additive-attention scores (csrc/attention_scores.cu).

    s[b, n, t] = w . tanh(pre[b, t, :] + q[b, n, :]) + b_alpha

for every proposal n and frame t of every video b, in one launch per
decode step.  It replaces the Pallas TPU kernel
echr_tpu/ops/pallas_attention.py::_kernel_skip (pallas_call at :153, via
attention_scores_masked :179 and tile_any_mask :170), which launched per
video under vmap on (8, 128) tiles.

What bounds it on an H100: the throughput of the accurate tanhf, not
bytes.  At serving dims (B=32, N=128, T=256, H=512) a step needs
B*N*T*H = 537M tanh before any skipping, against ~4 MB of scores out.
The design: one block per (video, 16-proposal tile, 32-frame tile)
stages the tile's q rows and pre rows in shared memory, chunked over H,
and each thread reduces over H for two outputs.  A block first ORs its
tile of the window mask; with no 1 in it, it writes zeros and computes
no tanh.  Proposals sorted by window start (decoder.sort_ctxs_by_window)
make most tiles empty.  Any N, T and H are taken: the block masks its
own ragged edges.

Exactness: equal to the plain version wherever mask == 1 (the sum over H
runs in another order); masked entries are zero or the score, and the
caller's masked softmax never reads them.
"""
from __future__ import annotations

import torch

from echr_tpu_torch.ops import native, use_plain

_FN = "attention_scores_masked"


def attention_scores_plain(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: scores everywhere, f32.
    pre [B, T, H], q [B, N, H], w [H], b [1], mask [B, N, T] -> [B, N, T]."""
    y = torch.tanh(pre.float()[:, None, :, :] + q.float()[:, :, None, :])
    return torch.matmul(y, w.float()) + b.float()


def attention_scores_masked(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scores [B, N, T]; exact wherever mask == 1.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if use_plain(pre):
        return attention_scores_plain(pre, q, w, b, mask)
    B, T, H = pre.shape
    N = q.shape[1]
    f32, dev = torch.float32, pre.device
    native.check_arg(_FN, "pre", pre, (B, T, H), f32, dev)
    native.check_arg(_FN, "q", q, (B, N, H), f32, dev)
    native.check_arg(_FN, "w", w, (H,), f32, dev)
    native.check_arg(_FN, "b", b, (1,), f32, dev)
    native.check_arg(_FN, "mask", mask, (B, N, T), f32, dev)
    out = torch.empty(B, N, T, device=dev, dtype=f32)
    if out.numel() == 0:
        return out
    rc = native.library().echr_attention_scores(
        pre.data_ptr(), q.data_ptr(), w.data_ptr(), b.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B, N, T, H, torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "echr_attention_scores")
    attention_scores_masked.launches += 1
    return out


attention_scores_masked.launches = 0
