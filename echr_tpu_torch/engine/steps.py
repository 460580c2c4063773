"""The batched eval / serving steps (echr_tpu/engine/steps.py), greedy.

Each step takes modules already cast once with
``ops.core.cast_compute_dtype(module, cfg.runtime.compute_dtype)`` (the
reference casts inside every jitted step; here CaptionService casts at
construction) and runs under ``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from echr_tpu.config import Config
from echr_tpu.data.labels import featstamps_to_times
from echr_tpu_torch.models.captioner import Captioner, ProposalBatch, make_contexts
from echr_tpu_torch.models.decoder import decoder_sample_batched
from echr_tpu_torch.models.sst import SST, sst_forward_batched
from echr_tpu_torch.ops.core import compute_dtype


@torch.inference_mode()
def encode_step_batched(sst: SST, feats: torch.Tensor, cfg: Config
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode SST over [B, T, D] -> (tap_feats [B, T, H], scores [B, T, K])."""
    return sst_forward_batched(sst, feats, compute_dtype(cfg.runtime.compute_dtype))


@torch.inference_mode()
def select_topk_batched(pred_props: torch.Tensor, n_frames: torch.Tensor, topN: int,
                        nb: int, val_score_thres: float = 0.0):
    """Device-side top-N anchor selection, selection-identical to
    echr_tpu.engine.proposals.top_proposals: threshold = the topN-th largest
    masked score of the [n_frames, K] grid (at least val_score_thres), then
    every anchor >= threshold with the t >= k guard, in row-major (t, k)
    order, truncated to nb slots.

    pred_props [B, T, K], n_frames [B] -> (flat_idx [B, nb] int32 into the
    [T, K] grid with fill T*K, count [B] int32, confidence [B, nb])."""
    B, T, K = pred_props.shape
    dev = pred_props.device
    t = torch.arange(T, device=dev)[:, None]
    k = torch.arange(K, device=dev)[None, :]
    amask = (k < torch.clamp(t, max=K)).to(pred_props.dtype)  # anchor_mask
    valid_t = (torch.arange(T, device=dev)[None, :] < n_frames[:, None])[:, :, None]
    masked = pred_props * amask * valid_t
    flat = masked.reshape(B, T * K)
    # frames past n_frames are zero and scores are >= 0, so the topN-th
    # largest over T*K equals the host's over n_frames*K
    thr = torch.topk(flat, min(topN, T * K), dim=1).values[:, -1]
    thr = torch.clamp(thr, min=val_score_thres)
    sel = (masked >= thr[:, None, None]) & (t >= k) & valid_t
    sel = sel.reshape(B, T * K)
    pos = torch.arange(T * K, device=dev).expand(B, T * K)
    key = torch.where(sel, pos, T * K)
    idx = torch.sort(key, dim=1).values[:, :nb]
    if idx.shape[1] < nb:
        idx = torch.cat([idx, torch.full((B, nb - idx.shape[1]), T * K, device=dev,
                                         dtype=idx.dtype)], dim=1)
    conf = torch.where(idx < T * K, torch.gather(flat, 1, torch.clamp(idx, max=T * K - 1)),
                       torch.zeros((), device=dev, dtype=flat.dtype))
    return idx.to(torch.int32), sel.sum(dim=1).to(torch.int32), conf


def unpack_topk_selection(idx_row, count, nb: int, K: int, n_frames: int,
                          duration: float, conf_row):
    """Host decode of one video's select_topk_batched row into the
    (ind, soi, timestamps, confidence) lists of the serving path."""
    n = int(min(int(count), nb))
    flat = np.asarray(idx_row)[:n].astype(np.int64)
    tt, kk = flat // K, flat % K
    soi = np.stack([tt - kk, tt + 1], axis=1)
    ts = featstamps_to_times(soi, n_frames, duration).tolist()
    tp = np.asarray(conf_row)[:n].astype(float).tolist()
    return tt.tolist(), soi.tolist(), ts, tp


@torch.inference_mode()
def decode_step_batched(cg: Captioner, cfg: Config, tap_feats: torch.Tensor,
                        feats: torch.Tensor, lda: torch.Tensor, frame_mask: torch.Tensor,
                        props: ProposalBatch):
    """Greedy decode of B videos' proposals with the batch-wide early exit.
    Returns (seq [B, N, L], logps [B, N, L], active [B, L]).  Multinomial
    decode is not ported yet (ROADMAP.md A.10)."""
    ctxs = make_contexts(cg, cfg, tap_feats, feats, lda, props, frame_mask=frame_mask)
    return decoder_sample_batched(cg.decoder, cfg, ctxs,
                                  compute_dtype(cfg.runtime.compute_dtype))
