"""Training criteria (echr_tpu/losses.py), per video over leading batch dims.

Every loss returns one value per video (shape = the leading dims); the
step takes the mean over videos afterwards, as the JAX step takes the
mean of its vmapped per-video losses.  Pooling frames or tokens across
videos would give another loss and other gradients.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

# torch BCELoss clamps each log term at -100; saturated sigmoids give the
# clamp instead of inf
_LOG_CLAMP = -100.0
_TINY = 1e-38


def _safe_log(x: torch.Tensor, use: torch.Tensor) -> torch.Tensor:
    """log(x) where ``use`` (clamped at -100 for x < 1e-38) and 0 elsewhere,
    with no NaN in the gradient: torch.where back-propagates 0 * inf = NaN
    from the branch it does not select, so the log never sees a 0 (the
    double where of echr_tpu/losses.py:44-54)."""
    one = torch.ones_like(x)
    small = torch.where(use, x, one) < _TINY
    logged = torch.log(torch.where(use, torch.clamp(x, min=_TINY), one))
    return torch.where(small, torch.full_like(x, _LOG_CLAMP), logged)


def tap_loss(scores: torch.Tensor, masks: torch.Tensor, labels: torch.Tensor,
             w1: torch.Tensor, n_valid_frames: torch.Tensor) -> torch.Tensor:
    """Class-weighted BCE over the proposal grid divided by the video's real
    frame count: scores / masks / labels [..., T, K], w1 [..., K],
    n_valid_frames [...] -> [...]."""
    w0 = 1.0 - w1
    labels = labels * masks
    weights = labels * w0[..., None, :] + (1.0 - labels) * w1[..., None, :]
    scores = scores * masks
    pos = labels > 0
    log_p = _safe_log(scores, pos)
    log_1mp = _safe_log(1.0 - scores, ~pos)
    bce = -(labels * log_p + (1.0 - labels) * log_1mp)
    return (weights * bce).sum(dim=(-2, -1)) / torch.clamp(n_valid_frames, min=1.0)


def language_model_loss(logprobs: torch.Tensor, targets: torch.Tensor,
                        masks: torch.Tensor) -> torch.Tensor:
    """Masked NLL divided by the video's token count: logprobs
    [..., N, L, V+1], targets / masks [..., N, >= L] -> [...]."""
    L = logprobs.shape[-2]
    targets = targets[..., :L].long()
    masks = masks[..., :L].float()
    gathered = torch.gather(logprobs, -1, targets[..., None])[..., 0]
    return -(gathered * masks).sum(dim=(-2, -1)) / (masks.sum(dim=(-2, -1)) + 1e-6)


def reward_loss(sample_logprobs: torch.Tensor, gen_seq: torch.Tensor, reward: torch.Tensor,
                prop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-critical policy gradient over generated tokens plus one trailing
    position: sample_logprobs / gen_seq / reward [..., N, L], prop_mask
    [..., N] (padded proposals count nothing) -> [...]."""
    m = (gen_seq > 0).float()
    mask = torch.cat([torch.ones_like(m[..., :1]), m[..., :-1]], dim=-1)
    if prop_mask is not None:
        mask = mask * prop_mask[..., None].float()
    out = -sample_logprobs * reward * mask
    return out.sum(dim=(-2, -1)) / torch.clamp(mask.sum(dim=(-2, -1)), min=1.0)


@torch.no_grad()
def clip_grads_elementwise(grads: Iterable[Optional[torch.Tensor]], clip_value: float) -> None:
    """Clamp every gradient element to [-clip_value, clip_value], in place
    (the reference's clip_gradient; not a global-norm clip)."""
    for g in grads:
        if g is not None:
            g.clamp_(-clip_value, clip_value)
