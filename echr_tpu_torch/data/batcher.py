"""Static-shape batch assembly (echr_tpu/data/batcher.py), the port's copy.

Fixed-shape numpy arrays replace the reference's ragged per-video batch
dict (reference: dataloader.py:367-572): the frame axis is padded to a
length bucket, the proposal axis to ``prop_sample_num``, captions to the
dataset's seq_length, and every padded entry carries a 0 mask.  The
decode-only (labels off) and external-proposal forms are not copied: no
path of the port builds them yet.
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


def make_batch(ex: VideoExample, cfg: Config, rng: np.random.RandomState,
               w1: Optional[np.ndarray] = None) -> Tuple[VideoBatch, BatchMeta]:
    """One video's training batch: the padded features, the TAP label grid,
    the sampled good proposals and the GT proposals with their captions."""
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
    meta = BatchMeta(
        vid=ex.vid, duration=dur_use, timestamps=ex.timestamps, sentences=ex.sentences,
        gt_featstamps=featstamps, proposal_num=proposal_num, n_frames=T_use,
        t_bucket=T_pad, ncap=ex.cap_labels.shape[0], iou_scores=iou_scores,
        gts_index=gts_index, cg_select=lm_list[sampled], sampled_ids=sampled)
    return batch, meta
