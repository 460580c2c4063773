"""Caption generator: hierarchical contexts + decoder
(echr_tpu/models/captioner.py), eval mode."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from echr_tpu.config import Config
from echr_tpu_torch.models.contexts import Contexts, build_contexts
from echr_tpu_torch.models.decoder import Decoder
from echr_tpu_torch.models.tsrm import TSRM


class ProposalBatch(NamedTuple):
    """Statically shaped proposal selection, batched over videos."""

    ind_select: torch.Tensor  # [B, N] int
    soi: torch.Tensor  # [B, N, 2] int
    prop_mask: torch.Tensor  # [B, N] float


class Captioner(nn.Module):
    """Fusion (TSRM, when the config routes events through it) + decoder."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.fusion = TSRM(cfg) if cfg.uses_tsrm else None
        self.decoder = Decoder(cfg)


def make_contexts(
    cg: Captioner,
    cfg: Config,
    tap_feats: torch.Tensor,
    c3d_feats: torch.Tensor,
    lda_feats: torch.Tensor,
    props: ProposalBatch,
    frame_mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
) -> Contexts:
    return build_contexts(cg.fusion, cfg, tap_feats, c3d_feats, lda_feats,
                          props.ind_select, props.soi, props.prop_mask,
                          frame_mask=frame_mask, dtype=dtype)
