"""Hierarchical video / event / clip context builder
(echr_tpu/models/contexts.py), batched over videos.

  video:  VL = LDA topic vector | VC = mean C3D | VH = mean SST hidden.
  event:  EC = per-window mean C3D | EH = SST hidden at the window end |
          ER1/ER2/ER3 route EC / EH / [EC|EH] through TSRM.
  clip:   the shared [T, D] frame sequence (CC = C3D, CH = SST hidden)
          plus a [N, T] window mask the decoder's attention reads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from echr_tpu_torch.config import Config
from echr_tpu_torch.models.tsrm import TSRM, tsrm_forward
from echr_tpu_torch.ops.masked import masked_mean, segment_mean, segment_window_mask


class Contexts(NamedTuple):
    """Batched, statically shaped; ``prop_mask`` marks real proposals."""

    video: Optional[torch.Tensor]  # [B, Dv]
    event: Optional[torch.Tensor]  # [B, N, De]
    clip_feats: Optional[torch.Tensor]  # [B, T, Dc]
    clip_mask: Optional[torch.Tensor]  # [B, N, T]
    prop_mask: torch.Tensor  # [B, N]


def build_contexts(
    fusion: Optional[TSRM],
    cfg: Config,
    tap_feats: torch.Tensor,  # [B, T, H]
    c3d_feats: torch.Tensor,  # [B, T, D]
    lda_feats: torch.Tensor,  # [B, lda_dim]
    ind_select: torch.Tensor,  # [B, N] window end frame
    soi: torch.Tensor,  # [B, N, 2] windows [start, end)
    prop_mask: torch.Tensor,  # [B, N]
    frame_mask: Optional[torch.Tensor] = None,  # [B, T]; None = all valid
    dtype: torch.dtype = torch.float32,
    train: bool = False,
    gen: Optional[torch.Generator] = None,  # TSRM's train-time dropout
) -> Contexts:
    B, T = c3d_feats.shape[:2]
    if frame_mask is None:
        frame_mask = torch.ones(B, T, device=c3d_feats.device)

    vparts = []
    vt = cfg.context.video_context_type
    if "VL" in vt:
        vparts.append(lda_feats)
    if "VC" in vt:
        vparts.append(masked_mean(c3d_feats, frame_mask, dim=1, dtype=dtype))
    if "VH" in vt:
        vparts.append(masked_mean(tap_feats, frame_mask, dim=1, dtype=dtype))
    video = torch.cat(vparts, dim=-1) if vparts else None

    et = cfg.context.event_context_type
    need_ec = ("EC" in et) or ("ER1" in et) or ("ER3" in et)
    need_eh = ("EH" in et) or ("ER2" in et) or ("ER3" in et)
    EC = segment_mean(c3d_feats, soi, dtype) if need_ec else None
    if need_eh:
        b_idx = torch.arange(B, device=tap_feats.device)[:, None]
        EH = tap_feats[b_idx, ind_select.long()]
    else:
        EH = None

    if "ER1" in et:
        event = tsrm_forward(fusion, EC, soi, prop_mask, cfg, dtype, train, gen)
    elif "ER2" in et:
        event = tsrm_forward(fusion, EH, soi, prop_mask, cfg, dtype, train, gen)
    elif "ER3" in et:
        event = tsrm_forward(fusion, torch.cat([EC, EH], dim=-1), soi, prop_mask, cfg, dtype,
                             train, gen)
    elif need_ec and need_eh:
        raise ValueError(
            "event_context_type EC+EH without ER is not a usable reference "
            "configuration (the reference concatenates along the proposal axis)")
    elif need_ec:
        event = EC
    elif need_eh:
        event = EH
    else:
        event = None

    ct = cfg.context.clip_context_type
    cparts = []
    if "CC" in ct:
        cparts.append(c3d_feats)
    if "CH" in ct:
        cparts.append(tap_feats)
    if cparts:
        clip_feats = torch.cat(cparts, dim=-1) if len(cparts) > 1 else cparts[0]
        clip_mask = segment_window_mask(soi, T) * frame_mask[:, None, :]
    else:
        clip_feats, clip_mask = None, None

    return Contexts(video, event, clip_feats, clip_mask, prop_mask)
