"""TSRM — temporal-semantic relation module (echr_tpu/models/tsrm.py).

Grouped QK attention over all event pairs, modulated by a learned
affinity of pairwise relative-position sinusoid embeddings (the fST modes
combine the two), with no V projection and a grouped 1x1 output
projection.  Every function takes any leading batch dims before the
event axis N; padded events (prop_mask == 0) are masked out as keys.

Head parallelism (echr_tpu/parallel/mesh.py:99-142): a TSRM whose output
projection ``parallel.mesh.shard_modules`` cut over its heads holds the
rows of heads [m g/tp, (m+1) g/tp) and a ``TPShard`` (``p.tp``); each rank
projects its heads' rows, and the outputs are gathered over the tp group
along the feature axis.  The other weights, and the relation weights of
every head, stay replicated.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from echr_tpu_torch.config import Config
from echr_tpu_torch.ops.core import Dense, dense, dropout, parameter, round_to, uniform_
from echr_tpu_torch.ops.masked import masked_softmax
from echr_tpu_torch.parallel.tensor import copy_to_tp, gather_from_tp, shard_of
from echr_tpu_torch.utils.profiling import span


class GroupedProjection(nn.Module):
    """The reference's nn.Conv2d(groups=g) 1x1 projection, stored as the
    conv weight without its 1x1 tail: weight [d_o, d_in], where rows
    [i * d_o/g, (i+1) * d_o/g) belong to group i, and bias [d_o]."""

    def __init__(self, groups: int, d_in: int, d_out: int):
        super().__init__()
        self.groups = groups
        self.weight = parameter(d_out, d_in)
        self.bias = parameter(d_out)


class TSRM(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        f = cfg.fusion
        d = f.d_feats
        self.event_emb = Dense(cfg.tsrm_input_dim, d)
        self.query = Dense(d, d)
        self.key = Dense(d, d)
        self.out = GroupedProjection(f.n_head, d, f.d_o)
        self.pair_pos_fc1 = Dense(d, d) if f.use_posit else None
        self.pair_pos_fc2 = Dense(d, f.n_head) if f.use_posit else None

    def init_uniform(self, gen: torch.Generator):
        """The bounds of echr_tpu.models.tsrm.init_tsrm."""
        for m in (self.event_emb, self.query, self.key):
            m.init_uniform(gen)
        bound = 1.0 / math.sqrt(self.out.weight.shape[1])
        uniform_(self.out.weight, bound, gen)
        uniform_(self.out.bias, bound, gen)
        if self.pair_pos_fc1 is not None:
            self.pair_pos_fc1.init_uniform(gen)
            self.pair_pos_fc2.init_uniform(gen)
        return self


def position_matrix(soi: torch.Tensor) -> torch.Tensor:
    """Pairwise (|delta center| / length, log length ratio):
    [..., N, 2] -> [..., N, N, 2]."""
    s = soi[..., 0].float()
    e = soi[..., 1].float()
    center = 0.5 * (s + e)
    length = torch.clamp(e - s, min=1.0)
    delta_center = (center[..., :, None] - center[..., None, :]) / length[..., :, None]
    delta_center = torch.clamp(delta_center.abs(), min=1e-3)
    delta_length = torch.log(length[..., None, :] / length[..., :, None])
    return torch.stack([delta_center, delta_length], dim=-1)


def position_embedding(pos_mat: torch.Tensor, feat_dim: int,
                       wave_length: float = 10000.0) -> torch.Tensor:
    """Sinusoid embedding, f32: [..., N, N, 2] -> [..., N, N, feat_dim]
    in the layout [dc_sin | dc_cos | dl_sin | dl_cos]."""
    n_freq = feat_dim // 4
    feat_range = torch.arange(n_freq, dtype=torch.float32, device=pos_mat.device)
    dim_mat = torch.full_like(feat_range, wave_length).pow((4.0 / feat_dim) * feat_range)
    div = (100.0 * pos_mat)[..., None] / dim_mat  # [..., N, N, 2, n_freq]
    emb = torch.cat([torch.sin(div), torch.cos(div)], dim=-1)
    return emb.reshape(*pos_mat.shape[:-1], feat_dim)


def tsrm_forward(p: TSRM, feats: torch.Tensor, soi: torch.Tensor, prop_mask: torch.Tensor,
                 cfg: Config, dtype: torch.dtype = torch.float32, train: bool = False,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """feats [..., N, in], soi [..., N, 2], prop_mask [..., N] -> [..., N, d_o].
    Rows with prop_mask == 0 are padding; their outputs are unspecified.
    At train time with a generator, dropout 0.3 on the relation weights."""
    with span("decode.tsrm"):
        f = cfg.fusion
        N = feats.shape[-2]
        lead = feats.shape[:-2]
        g = f.n_head
        dg = f.d_feats // g  # floor division, as the reference

        soi_feats = dense(p.event_emb, feats, dtype)  # [..., N, d]
        q = dense(p.query, soi_feats, dtype).reshape(*lead, N, g, dg)
        k = dense(p.key, soi_feats, dtype).reshape(*lead, N, g, dg)
        aff_scale = torch.einsum("...qgd,...kgd->...qgk", round_to(q, dtype),
                                 round_to(k, dtype)) * (1.0 / math.sqrt(dg))

        if f.use_posit:
            pos_emb = position_embedding(position_matrix(soi), f.d_feats)
            pos1 = dense(p.pair_pos_fc1, pos_emb, dtype)
            aff_weight = dense(p.pair_pos_fc2, torch.tanh(pos1), dtype)
            aff_weight = aff_weight.transpose(-1, -2)  # [..., N(q), g, N(k)]
            if f.fST_type == "fST0":
                weighted = aff_weight * aff_scale
            elif f.fST_type == "fST1":
                weighted = aff_weight + aff_scale
            elif f.fST_type == "fST2":
                weighted = torch.log(torch.clamp(aff_weight, min=1e-6)) + aff_scale
            elif f.fST_type == "fST3":
                weighted = aff_weight
            else:
                raise ValueError(f"unknown fST_type {f.fST_type!r}")
        else:
            weighted = aff_scale

        key_mask = prop_mask[..., None, None, :].expand(weighted.shape)
        att = masked_softmax(weighted, key_mask, dim=-1)
        att = dropout(att, 0.3, gen, train)

        tp = shard_of(p)
        if tp is not None:
            # the rank's heads: their relation weights and values take their
            # gradient summed over the tp group
            g = g // tp.tp
            att = copy_to_tp(att, tp)[..., tp.m * g:(tp.m + 1) * g, :]
            soi_feats = copy_to_tp(soi_feats, tp)
        # heads attend over the raw embedded values (no V projection)
        head_out = torch.einsum("...qgk,...kd->...qgd", round_to(att, dtype),
                                round_to(soi_feats, dtype))  # [..., N, g, d]
        w = p.out.weight.reshape(g, f.d_o // f.n_head, f.d_feats)
        out = torch.einsum("...qgd,god->...qgo", round_to(head_out, dtype), w)
        out = out.reshape(*lead, N, g * (f.d_o // f.n_head))
        if tp is not None:
            out = gather_from_tp(out, tp, -1)
        return out + p.out.bias
