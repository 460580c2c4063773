"""SST temporal action proposal model (echr_tpu/models/sst.py).

A stacked LSTM over the frame features and a K-way sigmoid scorer:
score[t, k] is the confidence that the anchor (t-k-1, t] is an event.
The LSTM hidden sequence doubles as the frame representation (tap_feats)
the context builder consumes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from echr_tpu_torch.ops.core import Dense, dense
from echr_tpu_torch.ops.recurrent import LSTMCell, lstm_stack


class SST(nn.Module):
    def __init__(self, video_dim: int, hidden_dim: int, K: int, num_layers: int,
                 raw_input_dim: int = 0):
        super().__init__()
        self.rnn = nn.ModuleList(
            LSTMCell(video_dim if l == 0 else hidden_dim, hidden_dim)
            for l in range(num_layers))
        self.scores = Dense(hidden_dim, K)
        self.reduce_dim = Dense(raw_input_dim, video_dim) if raw_input_dim else None


def sst_forward_batched(sst: SST, feats: torch.Tensor, dtype: torch.dtype = torch.float32,
                        train: bool = False, gen: Optional[torch.Generator] = None,
                        dropout_rate: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats [B, T, D] -> (tap_feats [B, T, H], proposal scores [B, T, K]);
    at train time with a generator, dropout between the LSTM layers."""
    if sst.reduce_dim is not None:
        feats = dense(sst.reduce_dim, feats, dtype)
    hs, _ = lstm_stack(sst.rnn, feats.transpose(0, 1), dtype=dtype, train=train, gen=gen,
                       dropout_rate=dropout_rate)
    tap_feats = hs.transpose(0, 1)
    return tap_feats, torch.sigmoid(dense(sst.scores, tap_feats, dtype))


def sst_forward(sst: SST, feats: torch.Tensor, dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single video, eval mode: feats [T, D] -> (tap_feats [T, H], scores [T, K])."""
    tap_feats, scores = sst_forward_batched(sst, feats[None], dtype)
    return tap_feats[0], scores[0]
