"""Static-shape batch assembly (echr_tpu/data/batcher.py), the port's copy.

Fixed-shape numpy arrays replace the reference's ragged per-video batch
dict (reference: dataloader.py:367-572): the frame axis is padded to a
length bucket, the proposal axis to ``prop_sample_num``, captions to the
dataset's seq_length, and every padded entry carries a 0 mask.
``make_batch(..., labels=False)`` is the decode-only form the eval's fast
path takes; both forms pack a video's external (SOTA) proposals into
``BatchMeta.SOTA_*`` when given a ``sota_fn``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from echr_tpu_torch.config import Config
from echr_tpu_torch.data import labels as L
from echr_tpu_torch.data.dataset import VideoExample


class VideoBatch(NamedTuple):
    """One video's statically shaped arrays (a leading [B] once collated)."""

    feats: np.ndarray  # [T_pad, D]
    frame_mask: np.ndarray  # [T_pad]
    n_frames: np.ndarray  # scalar f32, the real T
    lda: np.ndarray  # [lda_dim]
    tap_labels: np.ndarray  # [T_pad, K]
    tap_masks: np.ndarray  # [T_pad, K]
    w1: np.ndarray  # [K]
    # sampled good proposals (training path)
    ind_select: np.ndarray  # [N] int32
    soi: np.ndarray  # [N, 2] int32
    prop_mask: np.ndarray  # [N]
    cg_labels: np.ndarray  # [N, L] int32, caption rows of the sampled proposals
    cg_masks: np.ndarray  # [N, L]
    # GT-proposal path ('cg' / 'gt_tap_cg' phases)
    gts_ind: np.ndarray  # [N] int32
    gts_soi: np.ndarray  # [N, 2] int32
    gts_mask: np.ndarray  # [N]
    gts_cg_labels: np.ndarray  # [N, L] int32
    gts_cg_masks: np.ndarray  # [N, L]


@dataclass
class BatchMeta:
    """Host-side metadata the device step never sees."""

    vid: str
    duration: float
    timestamps: List[Tuple[float, float]]
    sentences: List[str]
    gt_featstamps: List[Tuple[int, int]]
    proposal_num: int
    n_frames: int
    t_bucket: int
    ncap: int
    iou_scores: np.ndarray  # [T, K] (unpadded)
    gts_index: np.ndarray  # [T, K] int
    cg_select: np.ndarray  # [n_sampled] caption index per sampled proposal
    sampled_ids: np.ndarray
    wrapped: bool = False
    # external (SOTA) proposals (reference: dataloader.py:509-528)
    SOTA_featstamps: Optional[List] = None
    SOTA_scores: Optional[List] = None
    SOTA_timestamps: Optional[List] = None
    SOTA_ind: Optional[List] = None
    SOTA_soi: Optional[List] = None
    SOTA_cg_select: Optional[List] = None


def _class_weights(w1, K: int, reverse_w0: bool) -> np.ndarray:
    """TAP class-weight vector; --reverse_w0 flips it (dataloader.py:476)."""
    if w1 is None:
        return np.zeros((K,), np.float32)
    w1 = np.asarray(w1, np.float32)
    return (1.0 - w1) if reverse_w0 else w1


def pick_bucket(T: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= T, else the largest."""
    for b in buckets:
        if T <= b:
            return b
    return buckets[-1]


def caption_masks(cap_labels: np.ndarray, mode: str, rng: np.random.RandomState):
    """Caption labels and masks with the optional sentence augmentation
    (reference: dataloader.py:412-442, modes nodrop / insert / truncate)."""
    lab = cap_labels.astype(np.int64).copy()
    ncap, Lw = lab.shape
    lab = np.concatenate([lab, np.zeros((1, Lw), np.int64)], 0)  # reference :414
    lab[:, -1] = 0
    mask = np.zeros((ncap, Lw), np.float32)
    if mode == "insert":
        for i in range(ncap):
            nz = int((lab[i] != 0).sum() + 2)
            if nz > 12 and rng.random_sample() > 0.7:
                crop = int(rng.randint(12, nz))
                lab[i, crop + 1:] = lab[i, crop:-1]
                lab[i, crop] = 0
            mask[i, :nz + 1] = 1
    elif mode == "truncate":
        for i in range(ncap):
            nz = int((lab[i] != 0).sum() + 2)
            crop = nz
            if nz > 12 and rng.random_sample() > 0.7:
                crop = int(rng.randint(12, nz))
                lab[i, crop:] = 0
            mask[i, :min(nz, crop + 1)] = 1
    else:
        for i in range(ncap):
            nz = int((lab[i] != 0).sum() + 2)
            mask[i, :nz] = 1
    lab[:, -1] = 0
    return lab.astype(np.int32), mask


def _sota_select(fs_scores_ts, K: int, rng: np.random.RandomState, cg_select_fn) -> dict:
    """The external proposals' BatchMeta fields (reference:
    dataloader.py:509-528); a window longer than K anchors is randomly
    cropped to K (:515-520)."""
    s_fs, s_scores, s_ts = fs_scores_ts
    if s_fs is None:
        return {}
    fs = [list(f) for f in s_fs]
    for i2, (x, y) in enumerate(fs):
        assert y > x
        if y - x >= K + 1:
            r = int(rng.randint(0, y - x - (K - 1)))
            fs[i2] = [x + r, x + r + K]
    return dict(SOTA_featstamps=fs, SOTA_scores=list(s_scores), SOTA_timestamps=list(s_ts),
                SOTA_ind=[f[1] for f in fs], SOTA_soi=[[f[0], f[1] + 1] for f in fs],
                SOTA_cg_select=[cg_select_fn(f) for f in fs])


def _make_batch_nolabels(ex: VideoExample, cfg: Config, sota_rng, feats, frame_mask,
                         featstamps, grid_featstamps, T_use: int, T_pad: int,
                         dur_use: float, sota_fn) -> Tuple[VideoBatch, BatchMeta]:
    """Decode-only batch: the geometry and an exact proposal_num, no label
    grids; every label field is zero."""
    tapc = cfg.tap
    K, N = tapc.K, tapc.prop_sample_num
    tap_masks = np.zeros((T_pad, K), np.float32)
    tap_masks[:T_use] = L.anchor_mask(T_use, K)
    proposal_num = L.good_proposal_count(grid_featstamps, T_use, K,
                                         tapc.iou_threshold_for_good_proposal)
    Lw = ex.cap_labels.shape[1]
    zi = np.zeros((N,), np.int32)
    zs = np.tile(np.array([[0, 1]], np.int32), (N, 1))
    zm = np.zeros((N,), np.float32)
    zl = np.zeros((N, Lw), np.int32)
    zk = np.zeros((N, Lw), np.float32)
    batch = VideoBatch(
        feats=feats, frame_mask=frame_mask, n_frames=np.float32(T_use),
        lda=ex.lda.astype(np.float32), tap_labels=np.zeros((T_pad, K), np.float32),
        tap_masks=tap_masks, w1=np.zeros((K,), np.float32),
        ind_select=zi, soi=zs, prop_mask=zm, cg_labels=zl, cg_masks=zk,
        gts_ind=zi.copy(), gts_soi=zs.copy(), gts_mask=zm.copy(),
        gts_cg_labels=zl.copy(), gts_cg_masks=zk.copy())
    sota_kw = {}
    if sota_fn is not None:
        sota_kw = _sota_select(sota_fn(T_use, dur_use), K, sota_rng, cg_select_fn=lambda f: 0)
    meta = BatchMeta(
        vid=ex.vid, duration=dur_use, timestamps=ex.timestamps, sentences=ex.sentences,
        gt_featstamps=featstamps, proposal_num=proposal_num, n_frames=T_use,
        t_bucket=T_pad, ncap=ex.cap_labels.shape[0],
        iou_scores=np.zeros((T_use, K), np.float32),
        gts_index=np.zeros((T_use, K), np.int64),
        cg_select=np.zeros((0,), np.int64), sampled_ids=np.zeros((0,), np.int64), **sota_kw)
    return batch, meta


def make_batch(ex: VideoExample, cfg: Config, rng: np.random.RandomState,
               w1: Optional[np.ndarray] = None, sota_fn=None, labels: bool = True
               ) -> Tuple[VideoBatch, BatchMeta]:
    """One video's training batch: the padded features, the TAP label grid,
    the sampled good proposals and the GT proposals with their captions.

    ``labels=False`` is the decode-only eval path: the IoU grid, the
    proposal sampling and the caption packing are skipped; the geometry
    mask and an exact ``proposal_num`` (the bad-video check) remain, and
    the label fields come back zeroed.  Valid only for the eval modes
    'tap', 'tap_cg' and 'SOTA_TEP' without val losses.

    ``sota_fn(T_use, dur_use)`` gives the external proposals
    (``BaseDataset.get_sota``).  Their crop draws from a substream seeded
    from ``rng`` before the labels fork, so both forms crop alike."""
    tapc = cfg.tap
    K, N = tapc.K, tapc.prop_sample_num
    T_real = int(ex.feats.shape[0])
    T_pad = pick_bucket(T_real, cfg.data.time_buckets)
    T_use = min(T_real, T_pad)  # an over-long video is cut to the largest bucket
    # a cut keeps the real frame clock: the prefix covers duration*T_use/T_real s
    dur_use = ex.duration * (T_use / T_real) if T_use < T_real else ex.duration

    feats = np.zeros((T_pad, ex.feats.shape[1]), np.float32)
    feats[:T_use] = ex.feats[:T_use]
    frame_mask = np.zeros((T_pad,), np.float32)
    frame_mask[:T_use] = 1.0

    # clamped stamps (always valid indices, for the GT selection lists); events
    # wholly past the cut get an impossible grid stamp, never matched
    featstamps = [L.timestamp_to_featstamp(t, T_use, dur_use) for t in ex.timestamps]
    grid_featstamps = featstamps
    if T_use < T_real:
        grid_featstamps = [(T_use + 1, T_use + 2) if t[0] >= dur_use else f
                           for f, t in zip(featstamps, ex.timestamps)]
    # the crop's substream is drawn here, at a fixed position, so the labels
    # and labels-off forms crop alike (the reference draws the crop from its
    # one global stream, dataloader.py:515-520)
    sota_rng = None
    if sota_fn is not None:
        sota_rng = np.random.RandomState(rng.randint(0, 2**31 - 1))
    if not labels:
        return _make_batch_nolabels(ex, cfg, sota_rng, feats, frame_mask, featstamps,
                                    grid_featstamps, T_use, T_pad, dur_use, sota_fn)
    iou_scores, gts_index_f, tap_masks_r = L.iou_grid(grid_featstamps, T_use, K)
    gts_index = gts_index_f.astype(np.int64)

    tap_labels = np.zeros((T_pad, K), np.float32)
    tap_labels[:T_use] = (iou_scores >= tapc.iou_threshold).astype(np.float32)
    tap_masks = np.zeros((T_pad, K), np.float32)
    tap_masks[:T_use] = tap_masks_r

    good = iou_scores >= tapc.iou_threshold_for_good_proposal
    # reference: dataloader.py:124, the matched caption index per good anchor
    tap_gts_for_good = (good * (gts_index + 1) - 1).astype(np.int64)
    proposal_num = int((tap_gts_for_good >= 0).sum())

    tap_list, lm_list, soi_list = L.flatten_good_proposals(tap_gts_for_good)
    sampled = L.sample_proposals(len(tap_list), N, rng)

    cap_lab, cap_mask = caption_masks(ex.cap_labels, cfg.data.dropsent_mode, rng)
    Lw = cap_lab.shape[1]

    def pack_selection(ind, soi, cgsel):
        n = min(len(ind), N)
        pi = np.zeros((N,), np.int32)
        ps = np.tile(np.array([[0, 1]], np.int32), (N, 1))
        pm = np.zeros((N,), np.float32)
        pl = np.zeros((N, Lw), np.int32)
        pmk = np.zeros((N, Lw), np.float32)
        pi[:n] = ind[:n]
        ps[:n] = soi[:n]
        pm[:n] = 1.0
        pl[:n] = cap_lab[cgsel[:n]]
        pmk[:n] = cap_mask[np.minimum(cgsel[:n], cap_mask.shape[0] - 1)]
        return pi, ps, pm, pl, pmk

    ind_sel, soi_sel, pmask, cg_lab_sel, cg_mask_sel = pack_selection(
        tap_list[sampled], soi_list[sampled], lm_list[sampled])

    # GT-proposal selection lists (reference: dataloader.py:494-503):
    # ind = end frame, soi = [start, end+1)
    gts_ind_r = np.array([f[1] for f in featstamps], np.int64)
    gts_soi_r = np.array([[f[0], f[1] + 1] for f in featstamps], np.int64).reshape(-1, 2)
    gts_sel_r = np.arange(len(featstamps), dtype=np.int64)
    g_ind, g_soi, g_mask, g_lab, g_mk = pack_selection(gts_ind_r, gts_soi_r, gts_sel_r)

    batch = VideoBatch(
        feats=feats, frame_mask=frame_mask, n_frames=np.float32(T_use),
        lda=ex.lda.astype(np.float32), tap_labels=tap_labels, tap_masks=tap_masks,
        w1=_class_weights(w1, K, cfg.train.reverse_w0),
        ind_select=ind_sel, soi=soi_sel, prop_mask=pmask, cg_labels=cg_lab_sel,
        cg_masks=cg_mask_sel, gts_ind=g_ind, gts_soi=g_soi, gts_mask=g_mask,
        gts_cg_labels=g_lab, gts_cg_masks=g_mk)
    sota_kw = {}
    if sota_fn is not None:
        sota_kw = _sota_select(
            sota_fn(T_use, dur_use), K, sota_rng,
            cg_select_fn=lambda f: int(tap_gts_for_good[f[1], f[1] - f[0] - 1]))
    meta = BatchMeta(
        vid=ex.vid, duration=dur_use, timestamps=ex.timestamps, sentences=ex.sentences,
        gt_featstamps=featstamps, proposal_num=proposal_num, n_frames=T_use,
        t_bucket=T_pad, ncap=ex.cap_labels.shape[0], iou_scores=iou_scores,
        gts_index=gts_index, cg_select=lm_list[sampled], sampled_ids=sampled, **sota_kw)
    return batch, meta
