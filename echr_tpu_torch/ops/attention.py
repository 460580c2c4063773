"""Additive (Bahdanau) attention over clip frames (echr_tpu/ops/attention.py),
batched over videos.

All proposals of a video attend over its shared [T, D] frame sequence
through a per-proposal window mask; ctx2att(feats) is computed once per
decode.  The routes for the scores, as in the reference:

  * plain: the [B, N, T, Hatt] tanh in memory, ``dense`` in the compute
    dtype; with ``remat`` (training) under torch.utils.checkpoint, so the
    backward recomputes the tanh instead of saving it (1.07 GB per
    teacher-forced step at B=32, N=64, T=256, Hatt=512);
  * kernel, no grad (decode): kernel 1, f32, the tanh evaluated only
    where the window mask is 1;
  * kernel with ``remat`` (training): attention_scores_diff, f32, kernel 3
    forward (the tanh only where the window mask is 1, as kernel 1) and
    kernel 4 backward;
  * kernel with ``fused``, no grad, bf16 compute: the whole step in kernel
    5 (ops/kernel_attention_step.attention_fused), which returns no
    weights.  As in the reference, no decoder passes ``fused``; an f32
    caller takes the unfused route, whose AV follows the compute dtype.

The port's kernels take any N, T and Hatt, so the route does not depend
on the reference's N % 8, T % 128 and Hatt % 128 gates.

The grouped route (echr_tpu/ops/attention.py:74-154, ``grouping=``): each
group of ng proposals, sorted by window start, scores one shared [tg, Hatt]
slice of the projected frames instead of all T.  It is plain PyTorch, as
echr_tpu's is plain jnp, and, as there, infrastructure that no decoder
calls.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from echr_tpu_torch.ops.core import Dense, dense, matmul, round_to
from echr_tpu_torch.ops.kernel_attention import attention_scores_diff, attention_scores_masked
from echr_tpu_torch.ops.kernel_attention_step import attention_fused
from echr_tpu_torch.ops.masked import masked_softmax


class AdditiveAttention(nn.Module):
    def __init__(self, feat_dim: int, query_dim: int, hid_dim: int):
        super().__init__()
        self.ctx2att = Dense(feat_dim, hid_dim)
        self.h2att = Dense(query_dim, hid_dim)
        self.alpha_net = Dense(hid_dim, 1)

    def init_uniform(self, gen: torch.Generator):
        for m in (self.ctx2att, self.h2att, self.alpha_net):
            m.init_uniform(gen)
        return self


def additive_attention_precompute(p: AdditiveAttention, feats: torch.Tensor,
                                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Project the frame features once: [B, T, D] -> [B, T, Hatt]."""
    return dense(p.ctx2att, feats, dtype)


def _additive_scores(w: torch.Tensor, b: torch.Tensor, pre_att: torch.Tensor,
                     att_h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dense(alpha_net, tanh(pre + q)) in the compute dtype: [B, N, T]."""
    y = torch.tanh(pre_att[:, None, :, :] + att_h[:, :, None, :])  # [B, N, T, Hatt]
    return (matmul(round_to(y, dtype), w.t(), dtype) + b)[..., 0]


def grouped_tg_required(soi, n_group: int) -> int:
    """The slice length a grouped step needs for these windows, [N, 2] or
    [B, N, 2] (the largest over the videos), in groups of n_group
    proposals sorted by start: the longest span of a group.  A grouped
    step is exact only with tg at least this.  Raises where n_group does
    not divide N, as grouped_attention_precompute needs."""
    soi = np.asarray(soi)
    if soi.ndim == 3:
        return max(int(grouped_tg_required(x, n_group)) for x in soi)
    if len(soi) % n_group != 0:
        raise ValueError(f"n_group={n_group} must divide the proposal count {len(soi)}")
    order = np.argsort(soi[:, 0], kind="stable")
    gs = soi[order, 0].reshape(-1, n_group)
    ge = soi[order, 1].reshape(-1, n_group)
    return int((ge.max(1) - gs.min(1)).max(initial=1))


def grouped_attention_precompute(clip_mask: torch.Tensor, tg: int, ng: int
                                 ) -> Dict[str, torch.Tensor]:
    """The grouping of each video's windows, once per decode: clip_mask
    [B, N, T] (contiguous windows) -> the start-sorted proposal order
    [B, N] and its inverse, each group's slice start [B, N/ng] (clamped
    into [0, T - tg]) and the windows relative to the slices, rel
    [B, N/ng, ng, tg].  ng must divide N; the caller checks tg against
    grouped_tg_required."""
    B, N, T = clip_mask.shape
    idx = torch.arange(T, device=clip_mask.device)
    start = torch.where(clip_mask > 0, idx, T).amin(dim=-1)  # [B, N]
    end = torch.where(clip_mask > 0, idx + 1, 0).amax(dim=-1)
    order = torch.argsort(start, dim=-1, stable=True)
    inv_order = torch.argsort(order, dim=-1, stable=True)
    g = N // ng
    gs = torch.gather(start, 1, order).reshape(B, g, ng)
    ge = torch.gather(end, 1, order).reshape(B, g, ng)
    slice_start = torch.clamp(gs.amin(dim=-1), 0, T - tg)  # [B, g]
    pos = torch.arange(tg, device=clip_mask.device)
    rel_lo = (gs - slice_start[..., None])[..., None]
    rel_hi = (ge - slice_start[..., None])[..., None]
    rel = ((pos >= rel_lo) & (pos < rel_hi)).float()  # [B, g, ng, tg]
    return {"order": order, "inv_order": inv_order, "slice_start": slice_start, "rel": rel}


def grouped_attention_step(p: AdditiveAttention, h: torch.Tensor, feats: torch.Tensor,
                           pre_att: torch.Tensor, grp: Dict[str, torch.Tensor],
                           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The windowed attention step through group-shared slices: each group
    of ng start-sorted proposals scores the tanh over one [tg, Hatt] slice
    of pre_att, takes the masked softmax over its windows and the weighted
    sum of the same slice of feats.  h [B, N, Hq], feats [B, T, D],
    pre_att [B, T, Hatt] -> att_res [B, N, D]; equal to the full-T masked
    step where every window fits its group's slice."""
    B, N = h.shape[:2]
    _, g, ng, tg = grp["rel"].shape
    att_h = dense(p.h2att, h, dtype)  # [B, N, Hatt]
    ah = torch.gather(att_h, 1, grp["order"][..., None].expand(att_h.shape))
    ah = ah.reshape(B, g, ng, -1)
    frames = grp["slice_start"][..., None] + torch.arange(tg, device=h.device)  # [B, g, tg]

    def rows(x):  # [B, T, C] -> the groups' slices [B, g, tg, C]
        flat = frames.reshape(B, g * tg, 1).expand(B, g * tg, x.shape[-1])
        return torch.gather(x, 1, flat).reshape(B, g, tg, x.shape[-1])

    pslice, fslice = rows(pre_att), rows(feats)
    y = torch.tanh(pslice[:, :, None] + ah[:, :, :, None])  # [B, g, ng, tg, Hatt]
    scores = dense(p.alpha_net, y, dtype)[..., 0]
    w = masked_softmax(scores, grp["rel"], dim=-1)
    att = matmul(round_to(w, dtype), round_to(fslice, dtype), dtype).reshape(B, N, -1)
    return torch.gather(att, 1, grp["inv_order"][..., None].expand(att.shape))


def additive_attention_step(
    p: AdditiveAttention,
    h: torch.Tensor,  # [B, N, Hq]
    feats: torch.Tensor,  # [B, T, D]
    pre_att: torch.Tensor,  # [B, T, Hatt]
    frame_mask: torch.Tensor,  # [B, N, T] window mask
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
    remat: bool = False,
    fused: bool = False,
    grouping: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One attention step for all proposals: (att_res [B, N, D],
    weights [B, N, T], or None from the fused and the grouped routes).
    ``remat`` selects the training routes, ``fused`` kernel 5, ``grouping``
    (from grouped_attention_precompute) the grouped route (see the module
    docstring)."""
    if grouping is not None:
        return grouped_attention_step(p, h, feats, pre_att, grouping, dtype), None
    att_h = dense(p.h2att, h, dtype)  # [B, N, Hatt]
    alpha = p.alpha_net
    if use_kernel and fused and not remat and dtype == torch.bfloat16:
        return attention_fused(pre_att.contiguous(), att_h.contiguous(),
                               alpha.weight.reshape(-1), alpha.bias, frame_mask.contiguous(),
                               feats.contiguous()), None
    if use_kernel and remat:
        scores = attention_scores_diff(pre_att.contiguous(), att_h.contiguous(),
                                       alpha.weight.reshape(-1), alpha.bias,
                                       frame_mask.contiguous())
    elif use_kernel:
        scores = attention_scores_masked(pre_att.contiguous(), att_h.contiguous(),
                                         alpha.weight.reshape(-1), alpha.bias,
                                         frame_mask.contiguous())
    elif remat:
        # the tanh recomputed in the backward (echr_tpu's _additive_scores_remat);
        # the weights are inputs, so the recompute sees the tensors the forward saw
        scores = checkpoint(_additive_scores, alpha.weight, alpha.bias, pre_att, att_h, dtype,
                            use_reentrant=False)
    else:
        scores = _additive_scores(alpha.weight, alpha.bias, pre_att, att_h, dtype)
    weights = masked_softmax(scores, frame_mask, dim=-1)
    att_res = matmul(round_to(weights, dtype), round_to(feats, dtype), dtype)
    return att_res, weights
