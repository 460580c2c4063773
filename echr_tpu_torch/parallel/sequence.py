"""Frame-axis (sequence) sharding of the SST encoder, the long-video
escape hatch (echr_tpu/parallel/sequence.py).

The n ranks of a group hold consecutive chunks of one video's frames:
rank k the frames [k T/n, (k+1) T/n).  The input projection x @ W_ih and
the K-way scorer are frame-parallel and run on each rank's chunk alone;
the LSTM recurrence is sequential, so its (h, c) carry travels the ring:
rank k receives it from rank k - 1 (rank 0 starts from zeros), runs its
chunk's recurrence (``ops.recurrent.lstm_layer``) and sends the carry on
to rank k + 1.  Each rank stores only its chunk's activations, so memory
falls as 1/n while the recurrence stays serial in wall-clock time.  A
gloo group carries the carry through host memory; NCCL sends device
tensors.

The ring is forward only, as every caller in echr_tpu uses it: a call
under autograd raises (ROADMAP.md A.13).  Imports torch only.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from echr_tpu_torch.models.sst import SST
from echr_tpu_torch.ops.core import dense
from echr_tpu_torch.ops.recurrent import LSTMCell, lstm_layer


def local_frames(feats: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's chunk [k T/n, (k+1) T/n) of a video's [T, ...] frames;
    raises where n does not divide T (echr_tpu's assertion)."""
    n, k = dist.get_world_size(group), dist.get_rank(group)
    T = feats.shape[0]
    if T % n:
        raise ValueError(f"the frame axis {T} must divide over the group's {n} ranks")
    return feats[k * (T // n):(k + 1) * (T // n)]


def _peer(group, k: int) -> int:
    """The global rank of the group's rank k."""
    return k if group is None else dist.get_global_rank(group, k)


def _carry_device(t: torch.Tensor, group) -> torch.device:
    """Where the carry crosses: the tensor's device under NCCL, the host
    under gloo."""
    return t.device if dist.get_backend(group) == "nccl" else torch.device("cpu")


def sequence_sharded_lstm_layer(layer: LSTMCell, xs_local: torch.Tensor, group=None,
                                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One LSTM layer over the rank's chunk xs_local [T/n, B, in] of a
    frame axis sharded over ``group`` (None: the default group), its carry
    passed around the ring.  Returns the chunk's hidden states [T/n, B, H]."""
    if torch.is_grad_enabled() and (xs_local.requires_grad
                                    or any(p.requires_grad for p in layer.parameters())):
        raise RuntimeError("the sequence ring is forward only (ROADMAP.md A.13): call it "
                           "under torch.no_grad() or torch.inference_mode()")
    n, k = dist.get_world_size(group), dist.get_rank(group)
    B, H = xs_local.shape[1], layer.hidden_dim
    h0 = c0 = None
    if k > 0:
        carry = torch.empty(2, B, H, device=_carry_device(xs_local, group))
        dist.recv(carry, src=_peer(group, k - 1), group=group)
        h0, c0 = (x.to(xs_local.device) for x in carry)
    hs, (h, c) = lstm_layer(layer, xs_local, h0, c0, dtype)
    if k < n - 1:
        carry = torch.stack([h, c]).to(_carry_device(xs_local, group))
        dist.send(carry.contiguous(), dst=_peer(group, k + 1), group=group)
    return hs


def sequence_sharded_sst(sst: SST, feats_local: torch.Tensor, group=None,
                         dtype: torch.dtype = torch.float32
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SST encoder (eval mode) on the rank's chunk [T/n, D] of one
    video's frames: the stacked layers through the ring, then the
    frame-parallel scorer.  Returns (tap_feats_local [T/n, H],
    scores_local [T/n, K]), the rank's rows of sst_forward's."""
    feats = feats_local
    if sst.reduce_dim is not None:
        feats = dense(sst.reduce_dim, feats, dtype)
    h = feats[:, None, :]
    for layer in sst.rnn:
        h = sequence_sharded_lstm_layer(layer, h, group, dtype)
    tap_feats = h[:, 0, :]
    return tap_feats, torch.sigmoid(dense(sst.scores, tap_feats, dtype))

