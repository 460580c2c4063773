"""Host-side label synthesis for temporal action proposals
(echr_tpu/data/labels.py), the port's copy.

The reference builds a dense [T, K] IoU matrix between every anchor
``(t-k-1, t]`` and every ground-truth event with a Python triple loop
(reference: dataloader.py:320-365); here the grid is a C++ loop or one
numpy broadcast, with the reference's semantics:

  * the +-0.01 nudge applied to GT boundaries (dataloader.py:271-272),
  * the ``>=`` running-max tie-break: the *last* GT achieving the max IoU
    wins, and an all-zero row selects the last GT (dataloader.py:276-278),
  * Python-2 ``round()`` (half away from zero) in timestamp conversion
    (dataloader.py:292-296).

``iou_grid`` runs the C++ grid of echr_tpu_torch/native wherever it is
available, as echr_tpu runs its own (echr_tpu/data/labels.py:121-124);
``iou_grid_numpy`` is its numpy version, bit-equal
(tests/test_torch_native.py).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from echr_tpu_torch import native


def _py2_round(x: float) -> int:
    """Python-2 round: half away from zero (Python 3 rounds half to even)."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def timestamp_to_featstamp(timestamp: Sequence[float], nfeats: int,
                           duration: float) -> Tuple[int, int]:
    """Seconds -> feature indices (reference: dataloader.py:292-296)."""
    start, end = timestamp
    start_f = max(min(_py2_round(start / duration * nfeats), nfeats - 2), 0)
    end_f = min(max(_py2_round(end / duration * nfeats), start_f + 1), nfeats - 1)
    return start_f, end_f


def featstamp_to_time(start_f: float, end_f: float, nfeats: int,
                      duration: float) -> Tuple[float, float]:
    """Feature indices -> seconds (reference: dataloader.py:298-302)."""
    time_per_feat = duration / nfeats
    start = min(max(0, start_f * time_per_feat), duration - time_per_feat)
    end = max(end_f * time_per_feat, start + time_per_feat)
    return start, end


def featstamps_to_times(soi, nfeats: int, duration: float) -> np.ndarray:
    """featstamp_to_time over an [n, 2] window array -> [n, 2] seconds."""
    soi = np.asarray(soi, np.float64)
    time_per_feat = duration / nfeats
    start = np.clip(soi[:, 0] * time_per_feat, 0, duration - time_per_feat)
    end = np.maximum(soi[:, 1] * time_per_feat, start + time_per_feat)
    return np.stack([start, end], axis=1)


def anchor_mask(nfeats: int, K: int) -> np.ndarray:
    """[T, K] validity mask: anchor (t-k-1, t] is valid iff t >= k+1
    (reference: dataloader.py:347-348)."""
    t = np.arange(nfeats)[:, None]
    k = np.arange(K)[None, :]
    return (k < np.minimum(K, t)).astype(np.float32)


def iou_grid(featstamps: Sequence[Sequence[int]], nfeats: int, K: int):
    """Dense anchor/GT IoU grid (reference: dataloader.py:350-357):
    (iou_scores [T, K] f32, gts_index [T, K] f32, tap_masks [T, K] f32),
    from the C++ grid where native.active(), else from iou_grid_numpy."""
    if native.active():
        return native.iou_grid(featstamps, nfeats, K)
    return iou_grid_numpy(featstamps, nfeats, K)


def iou_grid_numpy(featstamps: Sequence[Sequence[int]], nfeats: int, K: int):
    """iou_grid as one numpy broadcast over [T, K, G]."""
    T = int(nfeats)
    mask = anchor_mask(T, K)
    G = len(featstamps)
    if G == 0:
        z = np.zeros((T, K), dtype=np.float32)
        return z, z.copy(), mask

    gt = np.asarray(featstamps, dtype=np.float64)  # [G, 2]
    gs = gt[:, 0] - 0.01
    ge = gt[:, 1] + 0.01
    t = np.arange(T, dtype=np.float64)[:, None, None]  # anchor end
    k = np.arange(K, dtype=np.float64)[None, :, None]
    a_start = t - k - 1.0
    inter = np.clip(np.minimum(ge, t) - np.maximum(gs, a_start), 0.0, None)
    union = np.minimum(np.maximum(ge, t) - np.minimum(gs, a_start), (ge - gs) + (k + 1.0))
    iou = inter / (union + 1e-8)  # [T, K, G]

    best = iou.max(axis=2)
    gts_index = (G - 1) - np.argmax(iou[:, :, ::-1], axis=2)  # the last max wins
    valid = mask.astype(bool)
    iou_scores = np.where(valid, best, 0.0).astype(np.float32)
    gts_f = np.where(valid, gts_index.astype(np.float64), 0.0).astype(np.float32)
    return iou_scores, gts_f, mask


def flatten_good_proposals(tap_gts_for_good_proposal: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All 'good' anchors as (end index, caption index, [start, end))
    triples in row-major (t, then k) order (reference: dataloader.py:615-639).
    The input is the [T, K] grid of matched caption indices, -1 elsewhere."""
    grid = np.asarray(tap_gts_for_good_proposal)
    tt, kk = np.nonzero(grid != -1)
    tap_list = tt.astype(np.int64)
    lm_list = grid[tt, kk].astype(np.int64)
    soi_list = np.stack([tt - kk, tt + 1], axis=1).astype(np.int64)
    return tap_list, lm_list, soi_list


def sample_proposals(proposal_num: int, prop_sample_num: int,
                     rng: np.random.RandomState) -> np.ndarray:
    """Uniformly sample proposal rows (reference: dataloader.py:626-629)."""
    ids = np.arange(proposal_num, dtype=np.int64)
    rng.shuffle(ids)
    return ids[: min(proposal_num, prop_sample_num)]


def good_proposal_count(featstamps: Sequence[Sequence[int]], nfeats: int, K: int,
                        thr: float) -> int:
    """The number of valid anchors whose best IoU with a GT is >= thr, without
    the [T, K, G] grid: the labels-off batch's bad-video check (equal to
    counting iou_grid's scores >= thr).

    An anchor of length la reaches IoU >= thr with a GT of length lg only
    when thr*lg <= la <= lg/thr and its end lies within lg*(1-thr^2)/thr of
    the GT, so each GT yields a small candidate sub-grid; exact IoUs are
    computed there and the per-GT hits unioned.  At thr <= 0.65 the windows
    are not small and the full grid is counted."""
    T, G = int(nfeats), len(featstamps)
    if G == 0:
        return 0
    if thr <= 0.65:
        iou, _, _ = iou_grid(featstamps, T, K)
        return int((iou >= thr).sum())
    hits = []
    for s, e in featstamps:
        gs, ge = s - 0.01, e + 0.01  # iou_grid's nudges
        lg = ge - gs
        k_lo = max(0, int(thr * lg) - 4)
        k_hi = min(K, int(lg / thr) + 5)
        m = lg * (1.0 - thr * thr) / thr
        t_lo = max(1, int(gs) - 4)
        t_hi = min(T, int(ge + m) + 5)
        if k_lo >= k_hi or t_lo >= t_hi:
            continue
        t = np.arange(t_lo, t_hi, dtype=np.float64)[:, None]
        k = np.arange(k_lo, k_hi, dtype=np.float64)[None, :]
        a_start = t - k - 1.0
        inter = np.clip(np.minimum(ge, t) - np.maximum(gs, a_start), 0.0, None)
        union = np.minimum(np.maximum(ge, t) - np.minimum(gs, a_start), lg + k + 1.0)
        iou = (inter / (union + 1e-8)).astype(np.float32)  # the grid compares in f32
        valid = k < np.minimum(K, t)
        tt, kk = np.nonzero((iou >= thr) & valid)
        if len(tt):
            hits.append((tt + t_lo) * K + (kk + k_lo))
    if not hits:
        return 0
    return int(np.unique(np.concatenate(hits)).size)
