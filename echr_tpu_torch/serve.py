"""Batched caption serving on one GPU (echr_tpu/serve.py).

Hand it raw C3D feature arrays, get dense captions with timestamps back.
Requests are grouped by time bucket and chunked into batches; each chunk
runs encode -> top-N proposal selection -> contexts -> greedy or beam
decode on ``device``, and the host renders the token ids.

The serving path is marked with ``utils.profiling.span``s: under
torch.profiler each part of a request shows in the trace on the kernels'
clock (``serve.caption`` > ``serve.pad``, ``sst.encode``, ``select.*``,
``decode.*``, ``serve.fetch_tokens``, ``serve.render``; ``gc.gen<N>`` for a
collection), and the host's nanoseconds in the chunk's padding and
upload, the wait for the selection and its unpacking accumulate in
``pad_chunk.host_ns``, ``fetch_selection.wait_ns`` and
``unpack_selections.host_ns``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from echr_tpu_torch.config import Config
from echr_tpu_torch.data.batcher import pick_bucket
from echr_tpu_torch.data.labels import anchor_mask, featstamp_to_time
from echr_tpu_torch.engine import proposals as P
from echr_tpu_torch.engine.checkpoint import load_checkpoint_params
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
from echr_tpu_torch.utils.profiling import span, trace_gc


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


def pad_chunk(chunk: Sequence[CaptionRequest], bucket: int, cfg: Config, device):
    """A chunk's inputs padded to ``bucket`` frames and copied to ``device``:
    (feats [B, bucket, D] (through bf16 where runtime.transfer_dtype says
    so), lda [B, lda_dim], frame mask [B, bucket], frames [B] int32 on the
    device, and the frames on the host)."""
    with span("serve.pad", pad_chunk):
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
        feats_d = torch.from_numpy(feats).to(device)
        if cfg.runtime.transfer_dtype == "bfloat16":
            feats_d = feats_d.to(torch.bfloat16).float()
        up = [torch.from_numpy(x).to(device) for x in (lda, fmask, nfr)]
        # releasing the host copy of the features (an unmap of B x bucket x D
        # floats, milliseconds at serving sizes) is the padding's cost too
        del feats
        return (feats_d, *up, nfr)


def fetch_selection(idx: torch.Tensor, cnt: torch.Tensor, conf: torch.Tensor):
    """The device top-N selection on the host, as numpy: the first copy
    waits for the SST and the top-N to finish on the card."""
    with span("select.fetch", fetch_selection, "wait_ns"):
        return idx.cpu().numpy(), cnt.cpu().numpy(), conf.cpu().numpy()


def unpack_selections(chunk: Sequence[CaptionRequest], idx: np.ndarray, cnt: np.ndarray,
                      conf: np.ndarray, nfr: np.ndarray, nb_sel: int, K: int, device):
    """Each video's (ind, soi, timestamps, confidence) from the fetched
    top-N rows, and the proposals packed for the decode:
    (selections, nb, ProposalBatch on ``device``)."""
    with span("select.unpack", unpack_selections):
        sels = [unpack_topk_selection(idx[i], cnt[i], nb_sel, K, int(nfr[i]),
                                      _effective_duration(r, int(nfr[i])), conf[i])
                for i, r in enumerate(chunk)]
        return (sels, *pack_proposals(sels, device))


def pack_proposals(sels, device) -> Tuple[int, ProposalBatch]:
    """The selections' windows padded to their proposal bucket nb:
    (nb, ProposalBatch [B, nb] on ``device``)."""
    B = len(sels)
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
    return nb, ProposalBatch(*(torch.from_numpy(x).to(device) for x in (pi, ps, pm)))


# the host's ns in each, over all calls
pad_chunk.host_ns = 0
fetch_selection.wait_ns = 0
unpack_selections.host_ns = 0


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
        trace_gc()

    def caption(self, requests: Sequence[CaptionRequest]) -> Dict[str, List[Caption]]:
        """Caption a batch of requests: {vid: [Caption, ...]}."""
        with span("serve.caption"):
            out: Dict[str, List[Caption]] = {}
            groups: Dict[int, List[CaptionRequest]] = {}
            for r in requests:
                groups.setdefault(pick_bucket(len(r.feats), self.cfg.data.time_buckets),
                                  []).append(r)
            for bucket, reqs in groups.items():
                for i0 in range(0, len(reqs), self.batch_videos):
                    chunk = reqs[i0:i0 + self.batch_videos]
                    sels, nb, seq, score = self.decode_chunk(chunk, bucket)
                    with span("serve.fetch_tokens"):
                        seq_np = seq.cpu().numpy()
                        score_np = score.cpu().numpy()
                    with span("serve.render"):
                        self._render(out, chunk, sels, nb, seq_np, score_np)
            return out

    def _render(self, out, chunk, sels, nb, seq_np, score_np) -> None:
        """The chunk's captions into ``out``: the token ids as words, with
        each proposal's timestamps and scores."""
        for i, (r, (ind, soi, ts, tp)) in enumerate(zip(chunk, sels)):
            n = min(len(ind), nb)
            sents = decode_sequence(self.vocab, seq_np[i][:n])
            out[r.vid] = [
                Caption(timestamp=tuple(ts[j]), sentence=sents[j],
                        proposal_score=float(tp[j]),
                        sentence_confidence=float(score_np[i][j]))
                for j in range(n)
            ]

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
        feats_d, lda_d, fmask_d, nfr_d, nfr = pad_chunk(chunk, bucket, cfg, dev)
        tap_feats, pred_props = encode_step_batched(self.tap, feats_d, cfg)
        if self.nms_threshold:
            sels = self._select_nms(chunk, pred_props, nfr)
            nb, props = pack_proposals(sels, dev)
        else:
            nb_sel = PROP_BUCKETS[-1]  # the ceiling keeps threshold ties exactly
            sel = select_topk_batched(pred_props, nfr_d, topN=self.topN, nb=nb_sel)
            sels, nb, props = unpack_selections(chunk, *fetch_selection(*sel), nfr, nb_sel,
                                                cfg.tap.K, dev)
        return sels, nb, (self.cg, cfg, tap_feats, feats_d, lda_d, fmask_d, props)

    def _select_nms(self, chunk, pred_props: torch.Tensor, nfr: np.ndarray):
        """Per-video (ind, soi, timestamps, confidence) by the host NMS path
        (nms_threshold set)."""
        K = self.cfg.tap.K
        pp = pred_props.float().cpu().numpy()
        sels = []
        for i, r in enumerate(chunk):
            T = int(nfr[i])
            ind, soi, _, ts, tp = P.top_proposals_nms(
                pp[i][:T], anchor_mask(T, K), None, _effective_duration(r, T),
                featstamp_to_time, overlap=self.nms_threshold, topN=self.topN)
            sels.append((ind, soi, ts, tp))
        return sels


def from_checkpoint(path: str, device="cuda", **kw) -> CaptionService:
    """A service from a format-v2 training checkpoint of either package."""
    cfg, tap_params, cg_params, vocab = load_checkpoint_params(path)
    if not vocab:
        raise ValueError(
            f"checkpoint {path} carries no vocab: the caption service cannot "
            "render token ids to words")
    dev = _device(device)
    return CaptionService(cfg, tap_from_jax(tap_params, cfg, dev),
                          captioner_from_jax(cg_params, cfg, dev), vocab, device=dev, **kw)
