"""LSTM primitives (echr_tpu/ops/recurrent.py).

torch LSTMCell layout and math (gate order i, f, g, o; two bias vectors),
written as a plain loop over T in the JAX form: h and c stay f32, the
matmul operands are rounded to the compute dtype, and x @ W_ih of a whole
sequence is one matmul hoisted out of the loop.  cuDNN's nn.LSTM is a
later performance question.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from echr_tpu_torch.ops.core import dropout, parameter, matmul, round_to, uniform_


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


def _update(pre: torch.Tensor, c: torch.Tensor, H: int):
    """Gates i, f, g, o of pre [..., 4H] -> (h', c'); one sigmoid over all
    four gates (g's is unused) keeps the launches per step few."""
    sig = torch.sigmoid(pre)
    i, f, o = sig[..., :H], sig[..., H:2 * H], sig[..., 3 * H:]
    g = torch.tanh(pre[..., 2 * H:3 * H])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def lstm_cell(p: LSTMCell, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step; x [..., in], h/c [..., H] -> (h', c')."""
    pre = matmul(round_to(x, dtype), p.weight_ih.t(), dtype)
    pre = pre + matmul(round_to(h, dtype), p.weight_hh.t(), dtype)
    if p.bias_ih is not None:
        pre = pre + p.bias_ih + p.bias_hh
    return _update(pre, c, p.hidden_dim)


def lstm_cell_pre(p: LSTMCell, pre_x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step from a precomputed input projection (x @ W_ih.T + biases)."""
    pre = pre_x + matmul(round_to(h, dtype), p.weight_hh.t(), dtype)
    return _update(pre, c, p.hidden_dim)


def lstm_input_proj(p: LSTMCell, x: torch.Tensor, col_start: int = 0,
                    dtype: torch.dtype = torch.float32, with_bias: bool = False) -> torch.Tensor:
    """x @ W_ih[:, col_start : col_start + x_dim].T (+ both biases)."""
    w = p.weight_ih[:, col_start:col_start + x.shape[-1]]
    out = matmul(round_to(x, dtype), w.t(), dtype)
    if with_bias and p.bias_ih is not None:
        out = out + p.bias_ih + p.bias_hh
    return out


def lstm_layer(p: LSTMCell, xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
               c0: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.float32
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One layer over xs [T, B, in] -> ([T, B, H], (hT, cT))."""
    T, B, _ = xs.shape
    H = p.hidden_dim
    h = torch.zeros(B, H, device=xs.device) if h0 is None else h0
    c = torch.zeros(B, H, device=xs.device) if c0 is None else c0
    pre_x = lstm_input_proj(p, xs, dtype=dtype, with_bias=True)
    w_hh_t = p.weight_hh.t()
    hs = []
    for t in range(T):
        pre = pre_x[t] + matmul(round_to(h, dtype), w_hh_t, dtype)
        h, c = _update(pre, c, H)
        hs.append(h)
    return torch.stack(hs), (h, c)


def lstm_stack(layers: Sequence[LSTMCell], xs: torch.Tensor,
               dtype: torch.dtype = torch.float32, train: bool = False,
               gen: Optional[torch.Generator] = None, dropout_rate: float = 0.0
               ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Stacked LSTM over [T, B, in] with torch nn.LSTM's inter-layer
    dropout: every layer's output but the last, at train time only."""
    finals = []
    h = xs
    for l, p in enumerate(layers):
        h, hc = lstm_layer(p, h, dtype=dtype)
        finals.append(hc)
        if l < len(layers) - 1:
            h = dropout(h, dropout_rate, gen, train)
    return h, finals
