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
on the reference's N % 8, T % 128 and Hatt % 128 gates.  The grouped
route is not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One attention step for all proposals: (att_res [B, N, D],
    weights [B, N, T], or None from the fused route).  ``remat`` selects
    the training routes, ``fused`` kernel 5 (see the module docstring)."""
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
