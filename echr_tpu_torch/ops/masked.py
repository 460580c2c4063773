"""Masked primitives (echr_tpu/ops/masked.py), for any leading batch dims."""
from __future__ import annotations

import torch

from echr_tpu_torch.ops.core import matmul, round_to

_NEG_INF = -1e30


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` restricted to mask==1 entries; a fully-masked
    row gives zeros."""
    mask = mask.bool()
    masked_logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = masked_logits.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(masked_logits - m), torch.zeros_like(logits))
    denom = e.sum(dim=dim, keepdim=True)
    return e / torch.where(denom == 0.0, torch.ones_like(denom), denom)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim: int = 0, eps: float = 0.0,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mean of x over ``dim`` counting only mask==1 rows; ``mask`` has x's
    leading dims up to ``dim``.  x is rounded to ``dtype`` first."""
    x = round_to(x, dtype)
    mask = mask.to(x.dtype)
    while mask.ndim < x.ndim:
        mask = mask[..., None]
    num = (x * mask).sum(dim=dim)
    den = mask.sum(dim=dim)
    return num / torch.clamp(den, min=1.0 if eps == 0.0 else eps)


def segment_window_mask(soi: torch.Tensor, T: int) -> torch.Tensor:
    """[..., N, T] mask, 1 where s <= t < e for each window [s, e) of
    soi [..., N, 2]."""
    t = torch.arange(T, device=soi.device)
    s = soi[..., 0:1]
    e = soi[..., 1:2]
    return ((t >= s) & (t < e)).float()


def segment_mean(feats: torch.Tensor, soi: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-window mean of feats [..., T, D] over soi [..., N, 2] windows,
    as one mask matmul: [..., N, D]."""
    T = feats.shape[-2]
    m = segment_window_mask(soi, T)
    lengths = torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
    return matmul(round_to(m / lengths, dtype), round_to(feats, dtype), dtype)


def window_mean_padded(feats: torch.Tensor, soi: torch.Tensor, prop_mask: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Window sums divided by the longest real window of the video (the
    reference's padded clip mean): feats [..., T, D], soi [..., N, 2],
    prop_mask [..., N] -> [..., N, D]."""
    T = feats.shape[-2]
    m = segment_window_mask(soi, T)
    lengths = m.sum(dim=-1)
    real = torch.where(prop_mask > 0, lengths, torch.zeros_like(lengths))
    max_len = torch.clamp(real.amax(dim=-1, keepdim=True), min=1.0)
    pooled = matmul(round_to(m, dtype), round_to(feats, dtype), dtype)
    return pooled / max_len[..., None]
