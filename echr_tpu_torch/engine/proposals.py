"""Host-side proposal selection (echr_tpu/engine/proposals.py), the port's
copy: score-threshold top-N selection over the [T, K] anchor grid, greedy
temporal NMS (reference: eval_utils.py:259-331), the external proposals'
NMS (:230-256) and the top-10 reranking (:334-345), with the reference's
order and tie-breaks.  The two NMS run the C++ loops of
echr_tpu_torch/native wherever they are available, as echr_tpu runs its
own (echr_tpu/engine/proposals.py:78-81, :127-130); ``nms_temporal_numpy``
and ``nms_external_numpy`` are their numpy versions and pick the same
proposals (tests/test_torch_native.py).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from echr_tpu_torch import native


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

    if native.active():
        pick = native.nms_temporal(props, scores, overlap, topN).tolist()
    else:
        pick = nms_temporal_numpy(props, scores, overlap, topN)

    nms_props = props[pick]
    timestamps = [featstamp_to_time(int(s), int(e), nfeats, duration) for s, e in nms_props]
    return ((nms_props[:, 1] - 1).astype(np.int64).tolist(), nms_props.tolist(),
            prop_gts[pick].tolist() if prop_gts is not None else [], timestamps,
            scores[pick].tolist())


def external_proposals_nms(props: Sequence[Sequence[float]], prop_scores: Sequence[float],
                           sent_score: Sequence[float], nms_overlap: float = 0.999,
                           topN: int = 1000):
    """NMS over external (SOTA) proposals in the order of their scores,
    keeping from each overlap cluster the member of the best sentence
    score (reference: gettopN_nms, eval_utils.py:230-256).  Returns
    (props, scores, pick)."""
    props = np.asarray(props, dtype=np.float64)
    prop_scores = np.asarray(prop_scores, dtype=np.float64)
    sent_score = np.asarray(sent_score, dtype=np.float64)
    if native.active():
        pick = native.nms_external(props, prop_scores, sent_score, nms_overlap, topN).tolist()
    else:
        pick = nms_external_numpy(props, prop_scores, sent_score, nms_overlap, topN)
    return props[pick].tolist(), prop_scores[pick].tolist(), pick


def nms_temporal_numpy(props: np.ndarray, scores: np.ndarray, overlap: float,
                       topN: int) -> List[int]:
    """top_proposals_nms's picks by numpy: props [n, 2] int [start, end),
    scores [n] f64, the areas padded by 1."""
    t1, t2 = props[:, 0].astype(np.float64), props[:, 1].astype(np.float64)
    area = t2 - t1 + 1.0
    ind = np.argsort(scores, kind="stable")
    pick: List[int] = []
    while len(ind) > 0 and len(pick) < topN:
        i = ind[-1]
        pick.append(int(i))
        ind = ind[:-1]
        tt1 = np.maximum(t1[i], t1[ind])
        tt2 = np.minimum(t2[i], t2[ind])
        wh = np.maximum(0.0, tt2 - tt1 + 1.0)
        o = wh / (area[i] + area[ind] - wh)
        ind = ind[o <= overlap]
    return pick


def nms_external_numpy(props: np.ndarray, prop_scores: np.ndarray, sent_score: np.ndarray,
                       nms_overlap: float, topN: int) -> List[int]:
    """external_proposals_nms's picks by numpy: props [n, 2] f64 seconds,
    the areas padded by 1e-3."""
    t1, t2 = props[:, 0], props[:, 1]
    ind = np.argsort(prop_scores, kind="stable")
    area = t2 - t1 + 1e-3
    pick: List[int] = []
    while len(ind) > 0 and len(pick) < topN:
        i = ind[-1]
        tt1 = np.maximum(t1[i], t1[ind])
        tt2 = np.minimum(t2[i], t2[ind])
        wh = np.maximum(0.0, tt2 - tt1 + 1e-3)
        o = wh / (area[i] + area[ind] - wh)
        same = ind[o >= nms_overlap]
        pick.append(int(same[np.argmax(sent_score[same])]))
        ind = ind[o <= nms_overlap]
    return pick


def rerank_top10(vid_info: List[dict]) -> List[dict]:
    """The predictions whose re_score is at least the 10th largest, in
    their order (reference: reranking, eval_utils.py:334-345)."""
    rs = np.sort(np.array([v["re_score"] for v in vid_info]))
    thr = rs[-min(len(rs), 10)]
    return [v for v in vid_info if v["re_score"] >= thr]
