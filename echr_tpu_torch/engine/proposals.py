"""Host-side proposal selection (echr_tpu/engine/proposals.py), the port's
numpy copy: score-threshold top-N selection over the [T, K] anchor grid
and greedy temporal NMS (reference: eval_utils.py:259-331), with the
reference's order and tie-breaks.  echr_tpu's optional C++ NMS is not
copied: the numpy loop is its reference and selects the same anchors.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def top_proposals(pred_proposals: np.ndarray, tap_masks: np.ndarray,
                  cg_gts: Optional[np.ndarray], duration: float,
                  featstamp_to_time: Callable, val_score_thres: float = 0.0,
                  topN: int = 1000):
    """`gettop1000` (reference: eval_utils.py:259-287) on [T, K] scores.
    Returns (index_select_list, featstamp_list, cg_select_list,
    timestamp_list, confidence) in row-major (t, k) grid order."""
    nfeats, K = pred_proposals.shape
    masked = pred_proposals * tap_masks
    flat = np.sort(masked.reshape(-1))
    thr = max(flat[-min(len(flat), topN)], val_score_thres)

    n_idx, k_idx = np.nonzero(masked >= thr)
    keep = n_idx >= k_idx  # reference guard (:278)
    n_idx, k_idx = n_idx[keep], k_idx[keep]

    featstamps = np.stack([n_idx - k_idx, n_idx + 1], axis=1).astype(np.int64)
    has_gts = cg_gts is not None and len(cg_gts)
    cg_select = cg_gts[n_idx, k_idx].astype(np.int64).tolist() if has_gts else []
    timestamps = [featstamp_to_time(int(s), int(e), nfeats, duration) for s, e in featstamps]
    confidence = masked[n_idx, k_idx].astype(np.float64)
    return (n_idx.astype(np.int64).tolist(), featstamps.tolist(), cg_select, timestamps,
            confidence.tolist())


def top_proposals_nms(pred_proposals: np.ndarray, tap_masks: np.ndarray,
                      cg_gts: Optional[np.ndarray], duration: float,
                      featstamp_to_time: Callable, overlap: float = 0.8,
                      topN: int = 1000):
    """Greedy temporal NMS over all valid anchors (reference:
    gettop1000_nms, eval_utils.py:290-331).  ``tap_masks`` is unused, as in
    the reference's signature."""
    nfeats, K = pred_proposals.shape
    # every valid anchor, k < min(n, K), in row-major order
    n_idx, k_idx = np.nonzero(np.arange(K)[None, :] < np.minimum(np.arange(nfeats), K)[:, None])
    props = np.stack([n_idx - k_idx, n_idx + 1], axis=1).astype(np.int64)
    scores = pred_proposals[n_idx, k_idx].astype(np.float64)
    prop_gts = (cg_gts[n_idx, k_idx].astype(np.int64)
                if cg_gts is not None and len(cg_gts) else None)

    t1, t2 = props[:, 0].astype(np.float64), props[:, 1].astype(np.float64)
    area = t2 - t1 + 1.0
    ind = np.argsort(scores, kind="stable")
    pick = []
    while len(ind) > 0 and len(pick) < topN:
        i = ind[-1]
        pick.append(i)
        ind = ind[:-1]
        tt1 = np.maximum(t1[i], t1[ind])
        tt2 = np.minimum(t2[i], t2[ind])
        wh = np.maximum(0.0, tt2 - tt1 + 1.0)
        o = wh / (area[i] + area[ind] - wh)
        ind = ind[o <= overlap]

    nms_props = props[pick]
    timestamps = [featstamp_to_time(int(s), int(e), nfeats, duration) for s, e in nms_props]
    return ((nms_props[:, 1] - 1).astype(np.int64).tolist(), nms_props.tolist(),
            prop_gts[pick].tolist() if prop_gts is not None else [], timestamps,
            scores[pick].tolist())
