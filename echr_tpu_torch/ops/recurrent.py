"""LSTM primitives (echr_tpu/ops/recurrent.py).

torch LSTMCell layout and math (gate order i, f, g, o; two bias vectors)
in the JAX form: h and c stay f32, the matmul operands are rounded to the
compute dtype, and x @ W_ih of a whole sequence is one matmul hoisted out
of the recurrence.  The recurrence over T is kernel 11
(ops/kernel_recurrence.py) where an eval-mode layer runs on CUDA in bf16
with grad off (serving, eval, SCST's greedy baseline), and otherwise its
plain loop: training under autograd, the train-mode encodes (SCST's
sampled rollout runs without grad but its replay with it, and the two
must sum alike), the f32 parity runs, the CPU.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from echr_tpu_torch.ops.core import dropout, parameter, matmul, round_to, uniform_
from echr_tpu_torch.ops.kernel_recurrence import (lstm_recurrence, lstm_recurrence_plain,
                                                  lstm_update)


class LSTMCell(nn.Module):
    """weight_ih [4H, in], weight_hh [4H, H], bias_ih / bias_hh [4H]."""

    def __init__(self, input_dim: int, hidden_dim: int, bias: bool = True):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.weight_ih = parameter(4 * hidden_dim, input_dim)
        self.weight_hh = parameter(4 * hidden_dim, hidden_dim)
        self.bias_ih = parameter(4 * hidden_dim) if bias else None
        self.bias_hh = parameter(4 * hidden_dim) if bias else None

    def init_uniform(self, gen: torch.Generator):
        """U(-1/sqrt(H), 1/sqrt(H)) for every tensor (lstm_cell_init)."""
        bound = 1.0 / math.sqrt(self.hidden_dim)
        for p in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
            if p is not None:
                uniform_(p, bound, gen)
        return self


def lstm_cell(p: LSTMCell, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step; x [..., in], h/c [..., H] -> (h', c')."""
    pre = matmul(round_to(x, dtype), p.weight_ih.t(), dtype)
    pre = pre + matmul(round_to(h, dtype), p.weight_hh.t(), dtype)
    if p.bias_ih is not None:
        pre = pre + p.bias_ih + p.bias_hh
    return lstm_update(pre, c, p.hidden_dim)


def lstm_cell_pre(p: LSTMCell, pre_x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step from a precomputed input projection (x @ W_ih.T + biases)."""
    pre = pre_x + matmul(round_to(h, dtype), p.weight_hh.t(), dtype)
    return lstm_update(pre, c, p.hidden_dim)


def lstm_input_proj(p: LSTMCell, x: torch.Tensor, col_start: int = 0,
                    dtype: torch.dtype = torch.float32, with_bias: bool = False) -> torch.Tensor:
    """x @ W_ih[:, col_start : col_start + x_dim].T (+ both biases)."""
    w = p.weight_ih[:, col_start:col_start + x.shape[-1]]
    out = matmul(round_to(x, dtype), w.t(), dtype)
    if with_bias and p.bias_ih is not None:
        out = out + p.bias_ih + p.bias_hh
    return out


def takes_kernel(xs: torch.Tensor, dtype: torch.dtype, train: bool = False) -> bool:
    """Whether lstm_layer runs its recurrence as kernel 11: xs on CUDA,
    bf16 products, grad off, eval mode.  Training needs the loop's
    autograd; a train-mode forward without grad (SCST's rollout) needs the
    loop too, so that its replay under autograd sums alike; the f32 runs
    need their f32 products."""
    return (xs.device.type == "cuda" and dtype == torch.bfloat16 and not train
            and not torch.is_grad_enabled())


def lstm_layer(p: LSTMCell, xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
               c0: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32,
               train: bool = False) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One layer over xs [T, B, in] -> ([T, B, H], (hT, cT))."""
    pre_x = lstm_input_proj(p, xs, dtype=dtype, with_bias=True)
    if takes_kernel(xs, dtype, train):
        return lstm_recurrence(pre_x, p.weight_hh, h0, c0)
    return lstm_recurrence_plain(pre_x, p.weight_hh, h0, c0, dtype)


def lstm_stack(layers: Sequence[LSTMCell], xs: torch.Tensor,
               dtype: torch.dtype = torch.float32, train: bool = False,
               gen: Optional[torch.Generator] = None, dropout_rate: float = 0.0
               ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Stacked LSTM over [T, B, in] with torch nn.LSTM's inter-layer
    dropout: every layer's output but the last, at train time only."""
    finals = []
    h = xs
    for l, p in enumerate(layers):
        h, hc = lstm_layer(p, h, dtype=dtype, train=train)
        finals.append(hc)
        if l < len(layers) - 1:
            h = dropout(h, dropout_rate, gen, train)
    return h, finals
