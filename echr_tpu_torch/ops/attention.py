"""Additive (Bahdanau) attention over clip frames (echr_tpu/ops/attention.py),
batched over videos.

All proposals of a video attend over its shared [T, D] frame sequence
through a per-proposal window mask; ctx2att(feats) is computed once per
decode.  Two routes for the scores: the eager one (the [B, N, T, Hatt]
tanh in memory, ``dense`` in the compute dtype) and the kernel one
(ops/kernel_attention: f32, fully-masked tiles skipped), as in the
reference.  The grouped and fused routes are not ported.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from echr_tpu_torch.ops.core import Dense, dense, matmul, round_to
from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
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


def additive_attention_step(
    p: AdditiveAttention,
    h: torch.Tensor,  # [B, N, Hq]
    feats: torch.Tensor,  # [B, T, D]
    pre_att: torch.Tensor,  # [B, T, Hatt]
    frame_mask: torch.Tensor,  # [B, N, T] window mask
    dtype: torch.dtype = torch.float32,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention step for all proposals: (att_res [B, N, D],
    weights [B, N, T])."""
    att_h = dense(p.h2att, h, dtype)  # [B, N, Hatt]
    if use_kernel:
        scores = attention_scores_masked(pre_att.contiguous(), att_h.contiguous(),
                                         p.alpha_net.weight.reshape(-1),
                                         p.alpha_net.bias, frame_mask.contiguous())
    else:
        y = torch.tanh(pre_att[:, None, :, :] + att_h[:, :, None, :])  # [B, N, T, Hatt]
        scores = dense(p.alpha_net, y, dtype)[..., 0]
    weights = masked_softmax(scores, frame_mask, dim=-1)
    att_res = matmul(round_to(weights, dtype), round_to(feats, dtype), dtype)
    return att_res, weights
