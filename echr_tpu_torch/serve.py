"""Batched caption serving on one GPU (echr_tpu/serve.py).

Hand it raw C3D feature arrays, get dense captions with timestamps back.
Requests are grouped by time bucket and chunked into batches; each chunk
runs encode -> top-N proposal selection -> contexts -> greedy or beam
decode on ``device``, and the host renders the token ids.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from echr_tpu_torch.config import Config
from echr_tpu_torch.data.batcher import pick_bucket
from echr_tpu_torch.data.labels import anchor_mask, featstamp_to_time
from echr_tpu_torch.engine import proposals as P
from echr_tpu_torch.engine.evaluate import PROP_BUCKETS, _prop_bucket
from echr_tpu_torch.utils.text import decode_sequence
from echr_tpu_torch.bridge import captioner_from_jax, tap_from_jax
from echr_tpu_torch.engine.steps import (
    beam_decode_step_batched,
    decode_step_batched,
    encode_step_batched,
    select_topk_batched,
    unpack_topk_selection,
)
from echr_tpu_torch.models.captioner import Captioner, ProposalBatch
from echr_tpu_torch.models.sst import SST
from echr_tpu_torch.ops.core import cast_compute_dtype


@dataclasses.dataclass
class CaptionRequest:
    vid: str
    feats: np.ndarray  # [T, D] C3D features (normalised)
    duration: float
    lda: Optional[np.ndarray] = None  # scene topic vector; zeros if absent


@dataclasses.dataclass
class Caption:
    timestamp: Tuple[float, float]
    sentence: str
    proposal_score: float
    sentence_confidence: float


def _effective_duration(r: CaptionRequest, T_use: int) -> float:
    """Duration of the retained frame prefix: a request longer than the
    largest time bucket is cut to a prefix, and frame i still spans
    duration * i / T_real seconds."""
    T_real = len(r.feats)
    return r.duration * (T_use / T_real) if T_use < T_real else r.duration


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"CaptionService(device={device!r}): CUDA is not available")
    return dev


class CaptionService:
    """Batched captioner: greedy with ``beam_size`` 1, else beam search
    ranked with the length penalty ``cfg.eval.beam_length_alpha``; a
    caption's sentence_confidence is the summed logprob of its tokens (the
    best beam's, for beam search).  Parameters move to ``device`` and are
    cast to the compute dtype once, here."""

    def __init__(self, cfg: Config, tap: SST, cg: Captioner, vocab: Dict[str, str],
                 device="cuda", batch_videos: int = 32, topN: int = 100,
                 nms_threshold: float = 0.0, beam_size: int = 1):
        if beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam_size}")
        self.beam_size = beam_size
        self.cfg = cfg
        self.device = _device(device)
        dt = cfg.runtime.compute_dtype
        self.tap = cast_compute_dtype(tap.to(self.device), dt)
        self.cg = cast_compute_dtype(cg.to(self.device), dt)
        self.vocab = vocab
        self.batch_videos = batch_videos
        self.topN = topN
        self.nms_threshold = nms_threshold

    def caption(self, requests: Sequence[CaptionRequest]) -> Dict[str, List[Caption]]:
        """Caption a batch of requests: {vid: [Caption, ...]}."""
        out: Dict[str, List[Caption]] = {}
        groups: Dict[int, List[CaptionRequest]] = {}
        for r in requests:
            groups.setdefault(pick_bucket(len(r.feats), self.cfg.data.time_buckets), []).append(r)
        for bucket, reqs in groups.items():
            for i0 in range(0, len(reqs), self.batch_videos):
                chunk = reqs[i0:i0 + self.batch_videos]
                sels, nb, seq, score = self.decode_chunk(chunk, bucket)
                seq_np = seq.cpu().numpy()
                score_np = score.cpu().numpy()
                for i, (r, (ind, soi, ts, tp)) in enumerate(zip(chunk, sels)):
                    n = min(len(ind), nb)
                    sents = decode_sequence(self.vocab, seq_np[i][:n])
                    out[r.vid] = [
                        Caption(timestamp=tuple(ts[j]), sentence=sents[j],
                                proposal_score=float(tp[j]),
                                sentence_confidence=float(score_np[i][j]))
                        for j in range(n)
                    ]
        return out

    def decode_chunk(self, chunk: Sequence[CaptionRequest], bucket: int):
        """Encode, select proposals for and decode one chunk of requests
        padded to ``bucket`` frames.  Returns (selections, nb, seq [B, nb, L],
        score [B, nb]), where score is each caption's summed logprob (the
        best beam's, for beam search).  selections[i] is video i's (ind,
        soi, timestamps, confidence)."""
        sels, nb, args = self.prepare_chunk(chunk, bucket)
        if self.beam_size > 1:
            seq, score = beam_decode_step_batched(
                *args, self.beam_size, length_alpha=float(self.cfg.eval.beam_length_alpha))
        else:
            seq, logps, _ = decode_step_batched(*args)
            score = logps.sum(dim=2)
        return sels, nb, seq, score

    def prepare_chunk(self, chunk: Sequence[CaptionRequest], bucket: int):
        """Encode and select proposals for one chunk: (selections, nb, args),
        where args are the decode steps' (cg, cfg, tap_feats, feats, lda,
        frame_mask, props) on the device."""
        cfg = self.cfg
        dev = self.device
        B = len(chunk)
        D = chunk[0].feats.shape[1]
        feats = np.zeros((B, bucket, D), np.float32)
        fmask = np.zeros((B, bucket), np.float32)
        lda = np.zeros((B, cfg.data.lda_dim), np.float32)
        for i, r in enumerate(chunk):
            T = min(len(r.feats), bucket)
            feats[i, :T] = r.feats[:T]
            fmask[i, :T] = 1.0
            if r.lda is not None:
                lda[i] = r.lda
        nfr = fmask.sum(axis=1).astype(np.int32)
        feats_d = torch.from_numpy(feats).to(dev)
        if cfg.runtime.transfer_dtype == "bfloat16":
            feats_d = feats_d.to(torch.bfloat16).float()
        tap_feats, pred_props = encode_step_batched(self.tap, feats_d, cfg)

        sels = self._select(chunk, pred_props, nfr)
        nb = _prop_bucket(max([1] + [len(s[0]) for s in sels]))
        pi = np.zeros((B, nb), np.int32)
        ps = np.tile(np.array([[0, 1]], np.int32), (B, nb, 1))
        pm = np.zeros((B, nb), np.float32)
        for i, (ind, soi, _, _) in enumerate(sels):
            n = min(len(ind), nb)
            if n:
                pi[i, :n] = np.asarray(ind)[:n]
                ps[i, :n] = np.asarray(soi)[:n]
                pm[i, :n] = 1.0
        props = ProposalBatch(*(torch.from_numpy(x).to(dev) for x in (pi, ps, pm)))
        return sels, nb, (self.cg, cfg, tap_feats, feats_d, torch.from_numpy(lda).to(dev),
                          torch.from_numpy(fmask).to(dev), props)

    def _select(self, chunk, pred_props: torch.Tensor, nfr: np.ndarray):
        """Per-video (ind, soi, timestamps, confidence): top-N on the device,
        or the host NMS path when nms_threshold is set."""
        K = self.cfg.tap.K
        sels = []
        if not self.nms_threshold:
            nb_sel = PROP_BUCKETS[-1]  # the ceiling keeps threshold ties exactly
            idx, cnt, conf = select_topk_batched(
                pred_props, torch.from_numpy(nfr).to(pred_props.device),
                topN=self.topN, nb=nb_sel)
            idx, cnt, conf = idx.cpu().numpy(), cnt.cpu().numpy(), conf.cpu().numpy()
            for i, r in enumerate(chunk):
                sels.append(unpack_topk_selection(
                    idx[i], cnt[i], nb_sel, K, int(nfr[i]),
                    _effective_duration(r, int(nfr[i])), conf[i]))
            return sels
        pp = pred_props.float().cpu().numpy()
        for i, r in enumerate(chunk):
            T = int(nfr[i])
            ind, soi, _, ts, tp = P.top_proposals_nms(
                pp[i][:T], anchor_mask(T, K), None, _effective_duration(r, T),
                featstamp_to_time, overlap=self.nms_threshold, topN=self.topN)
            sels.append((ind, soi, ts, tp))
        return sels


def load_checkpoint_params(path: str):
    """(cfg, tap_params, cg_params, vocab) of a format-v2 echr_tpu checkpoint,
    read with pickle alone: params are numpy trees, the config comes from
    the .config.json sidecar or the embedded config_json."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    version = payload.get("format_version", 1)
    if version != 2:
        raise ValueError(
            f"checkpoint {path} has format_version {version}; echr_tpu_torch "
            "reads format 2 only (re-save a v1 checkpoint with echr_tpu)")
    sidecar = path + ".config.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            cfg = Config.from_json(f.read())
    elif payload.get("config_json"):
        cfg = Config.from_json(payload["config_json"])
    else:
        raise ValueError(f"checkpoint {path} has neither a .config.json sidecar "
                         "nor an embedded config_json")
    state = payload["state"]
    return cfg, state["tap_params"], state["cg_params"], payload.get("vocab")


def from_checkpoint(path: str, device="cuda", **kw) -> CaptionService:
    """A service from an echr_tpu format-v2 training checkpoint."""
    cfg, tap_params, cg_params, vocab = load_checkpoint_params(path)
    if not vocab:
        raise ValueError(
            f"checkpoint {path} carries no vocab: the caption service cannot "
            "render token ids to words")
    dev = _device(device)
    return CaptionService(cfg, tap_from_jax(tap_params, cfg, dev),
                          captioner_from_jax(cg_params, cfg, dev), vocab, device=dev, **kw)
