"""Per-video examples from disk or synthesis (echr_tpu/data/dataset.py),
the port's copy.

``VideoExample`` is the raw per-video record; ``data.batcher`` turns it
into statically shaped arrays and ``data.loader`` owns iteration and
prefetch.  ``get_sota`` gives a video's external (SOTA) proposals, from
``data.SOTA_json`` on disk or synthesised for ``SOTA_json == "synthetic"``.
The HDF5 label and LDA files are read through ``data.hdf5.open_h5``:
h5py where it is installed, the port's own reader otherwise.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from echr_tpu_torch.config import Config
from echr_tpu_torch.data.hdf5 import open_h5
from echr_tpu_torch.data.labels import timestamp_to_featstamp

# reference: dataloader.py:49-50, the C3D normalisation moments
C3D_MEAN = -0.001915027447565527
C3D_VAR = 1.9239444588254049


@dataclass
class VideoExample:
    vid: str
    feats: np.ndarray  # [T, D] float32 (already normalised)
    lda: np.ndarray  # [lda_dim] float32
    duration: float
    timestamps: List[Tuple[float, float]]  # GT events in seconds
    sentences: List[str]
    cap_labels: np.ndarray  # [ncap, L] int32, col 0 == 0 (BOS), 0-padded
    split: str


class BaseDataset:
    """Vocab, split indices and per-index example access."""

    ix_to_word: Dict[str, str]
    seq_length: int
    w1: np.ndarray  # [K] per-anchor-length positive rate
    split_ix: Dict[str, List[int]]
    sota_proposals: Optional[Dict] = None  # vid (no 'v_' prefix) -> [{segment, score}]

    def __len__(self) -> int:
        raise NotImplementedError

    def get_example(self, ix: int) -> VideoExample:
        raise NotImplementedError

    @property
    def vocab_size(self) -> int:
        return len(self.ix_to_word)

    def get_sota(self, vid: str, nfeats: int, duration: float):
        """A video's external (SOTA) proposals as featstamps (reference:
        get_SOTA_TEP_label, dataloader.py:304-318; the keys are the video id
        without its 'v_' prefix).  Returns (featstamps, scores, timestamps)
        or (None, None, None)."""
        if not self.sota_proposals or vid[2:] not in self.sota_proposals:
            return None, None, None
        events = self.sota_proposals[vid[2:]]
        timestamps = [e["segment"] for e in events]
        featstamps = [timestamp_to_featstamp(t, nfeats, duration) for t in timestamps]
        scores = [e["score"] for e in events]
        return featstamps, scores, timestamps


class ActivityNetDataset(BaseDataset):
    """The on-disk ActivityNet Captions layout of the reference inputs
    (reference: dataloader.py:159-263): per-video C3D .npy features,
    caption-label HDF5s with label_start_ix / label_end_ix, the vocab and
    splits JSON, the annotation JSON, the LDA HDF5 and the w1 JSON."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        d = cfg.data
        with open(d.w1_json) as f:
            self.w1 = np.asarray(json.load(f), dtype=np.float32)
        with open(d.video_json) as f:
            self.annotations = json.load(f)
        with open(d.video_data_for_cg) as f:
            self.info = json.load(f)
        self.ix_to_word = self.info["ix_to_word"]

        def load_h5(path):
            with open_h5(path, "r") as h5:
                return {k: np.asarray(h5[k]) for k in h5.keys()}

        self.train_labels = load_h5(d.train_label_for_cg)
        self.val_labels = load_h5(d.val_label_for_cg)
        self.seq_length = int(self.train_labels["labels"].shape[1])
        self.train_videos = int(self.train_labels["label_start_ix"].shape[0])

        self.lda: Optional[Dict[str, np.ndarray]] = None
        if d.use_lda:
            with open_h5(d.input_lda_path, "r") as h5:
                self.lda = {k: np.asarray(h5[k]) for k in h5.keys()}

        self.split_ix = {"train": [], "val": [], "test": []}
        for ix, video in enumerate(self.info["videos"]):
            split = video.get("split", "train")
            if split in self.split_ix:
                self.split_ix[split].append(ix)
            elif d.train_only == 0:  # restval (reference: dataloader.py:239)
                self.split_ix["train"].append(ix)

        self.sota_proposals = None
        if d.SOTA_json and os.path.exists(d.SOTA_json):
            with open(d.SOTA_json) as f:
                self.sota_proposals = json.load(f)["results"]

    def __len__(self) -> int:
        return len(self.info["videos"])

    def _load_twostream(self, vid: str) -> np.ndarray:
        """Two-stream CSV features, [::2]-strided (reference:
        dataloader.py:55-69,84-87); missing CSVs give zeros."""
        d = self.cfg.data
        path = os.path.join(d.input_twostream_dir, "spatial", "csv_action", vid + ".csv")
        if not os.path.exists(path):
            c3d = np.load(os.path.join(d.input_c3d_dir2, vid + ".npy"))
            return np.zeros((c3d.shape[0], 400), np.float32)[::2]
        import pandas as pd

        spatial = pd.read_csv(path).to_numpy()
        of = pd.read_csv(
            os.path.join(d.input_twostream_dir, "OF", "csv_action", vid + ".csv")).to_numpy()
        n = min(spatial.shape[0], of.shape[0])
        return np.concatenate([spatial[:n], of[:n]], 1).astype(np.float32)[::2]

    def get_example(self, ix: int) -> VideoExample:
        d = self.cfg.data
        video = self.info["videos"][ix]
        vid = video["video_id"]
        parts = []
        if d.use_c3d_feature:
            f = np.load(os.path.join(d.input_c3d_dir2, vid + ".npy")).astype(np.float32)
            parts.append((f - C3D_MEAN) / np.sqrt(C3D_VAR))
        if d.use_2stream_feature:
            parts.append(self._load_twostream(vid))
        # multi-stream concat truncates to the shortest stream (dataloader.py:91-96)
        n = min(p.shape[0] for p in parts)
        feats = np.concatenate([p[:n] for p in parts], 1).astype(np.float32)
        ann = self.annotations[vid]
        if ix < self.train_videos:
            lab = self.train_labels
            s_ix, e_ix = lab["label_start_ix"][ix], lab["label_end_ix"][ix]
        else:
            lab = self.val_labels
            off = ix - self.train_videos
            s_ix, e_ix = lab["label_start_ix"][off], lab["label_end_ix"][off]
        cap = lab["labels"][int(s_ix):int(e_ix)].astype(np.int32)
        lda = (np.asarray(self.lda[vid], dtype=np.float32) if self.lda is not None
               else np.zeros((d.lda_dim,), np.float32))
        return VideoExample(vid=vid, feats=feats, lda=lda, duration=float(ann["duration"]),
                            timestamps=[tuple(t) for t in ann["timestamps"]],
                            sentences=list(ann["sentences"]), cap_labels=cap,
                            split=video.get("split", "train"))


class SyntheticDataset(BaseDataset):
    """Deterministic synthetic ActivityNet-shaped data for tests and
    benchmarks: every video comes from a per-index seed, with C3D-like
    features carrying event-correlated patterns, 2-6 GT events, and
    captions rendered as 'w<i>' sentences.  With
    ``data.synthetic_learnable`` each event's caption is a fixed token
    sequence of its visual pattern, so captioning is learnable."""

    def __init__(self, cfg: Config, num_videos: Optional[int] = None, seed: int = 1234):
        self.cfg = cfg
        d = cfg.data
        self.num_videos = num_videos or d.synthetic_num_videos
        self.seed = seed
        self.seq_length = d.synthetic_seq_length
        self._vocab = d.synthetic_vocab_size
        self.ix_to_word = {str(i): f"w{i}" for i in range(1, self._vocab + 1)}
        k = np.arange(cfg.tap.K)
        self.w1 = (0.02 + 0.2 * np.exp(-k / 32.0)).astype(np.float32)
        n_train = int(self.num_videos * 0.75)
        self.split_ix = {"train": list(range(n_train)),
                         "val": list(range(n_train, self.num_videos)), "test": []}
        self._synthetic_sota = d.SOTA_json == "synthetic"
        # LRU cache of generated examples; the prefetch threads share it
        self._cache: "collections.OrderedDict[int, VideoExample]" = collections.OrderedDict()
        self._cache_cap = max(0, int(d.synthetic_cache_videos))
        self._cache_lock = threading.Lock()

    def _geometry(self, ix: int):
        """The event-geometry prefix of a video's rng stream: (rng, T,
        duration, n_events, timestamps).  ``_generate_example`` goes on
        drawing from the returned rng; ``get_sota`` needs only the
        timestamps, without synthesising the features."""
        rng = np.random.RandomState(self.seed * 100003 + ix)
        T = int(rng.randint(40, 220))
        duration = float(T * (0.5 + rng.rand()))
        n_events = int(rng.randint(2, 7))
        starts = np.sort(rng.rand(n_events) * duration * 0.8)
        lengths = (0.05 + rng.rand(n_events) * 0.4) * duration
        timestamps = [(float(s), float(min(s + l, duration))) for s, l in zip(starts, lengths)]
        return rng, T, duration, n_events, timestamps

    def get_sota(self, vid: str, nfeats: int, duration: float):
        """Synthetic external proposals: each GT event jittered three times,
        with uniform scores."""
        if not self._synthetic_sota:
            return None, None, None
        ix = int(vid[-5:])
        rng = np.random.RandomState(self.seed * 7919 + ix)
        _, _, ex_duration, _, ex_timestamps = self._geometry(ix)
        timestamps = []
        scores = []
        for s, e in ex_timestamps:
            for _ in range(3):
                j = (rng.rand(2) - 0.5) * 0.2 * (e - s)
                timestamps.append([max(0.0, s + j[0]),
                                   min(ex_duration, max(s + j[0] + 0.5, e + j[1]))])
                scores.append(float(rng.rand()))
        featstamps = [timestamp_to_featstamp(t, nfeats, duration) for t in timestamps]
        return featstamps, scores, timestamps

    def __len__(self) -> int:
        return self.num_videos

    def get_example(self, ix: int) -> VideoExample:
        if self._cache_cap:
            with self._cache_lock:
                hit = self._cache.get(ix)
                if hit is not None:
                    self._cache.move_to_end(ix)
            if hit is not None:
                return self._clone_example(hit)
        ex = self._generate_example(ix)
        if self._cache_cap:
            with self._cache_lock:
                self._cache[ix] = ex
                self._cache.move_to_end(ix)
                while len(self._cache) > self._cache_cap:
                    self._cache.popitem(last=False)
            return self._clone_example(ex)
        return ex

    @staticmethod
    def _clone_example(ex: VideoExample) -> VideoExample:
        """A copy of the mutable pieces: a cached example is never handed out."""
        return dataclasses.replace(ex, feats=ex.feats.copy(), lda=ex.lda.copy(),
                                   cap_labels=ex.cap_labels.copy(),
                                   timestamps=list(ex.timestamps),
                                   sentences=list(ex.sentences))

    def _generate_example(self, ix: int) -> VideoExample:
        cfg = self.cfg
        rng, T, duration, n_events, timestamps = self._geometry(ix)
        D = cfg.tap.video_dim
        # noise plus per-event bias patterns, so the proposal model has signal
        feats = rng.randn(T, D).astype(np.float32) * 0.5
        pattern_ids = rng.randint(0, 16, size=n_events)
        for ei, (s, e) in enumerate(timestamps):
            fs = int(s / duration * T)
            fe = max(fs + 1, int(e / duration * T))
            pattern = np.random.RandomState(1000 + int(pattern_ids[ei])).randn(D)
            feats[fs:fe] += 0.5 * pattern.astype(np.float32)
        lda = rng.randn(cfg.data.lda_dim).astype(np.float32) * 0.3
        L = self.seq_length
        cap = np.zeros((n_events, L), np.int32)
        sentences = []
        for i in range(n_events):
            if cfg.data.synthetic_learnable:
                crng = np.random.RandomState(7000 + int(pattern_ids[i]))
                ln = int(crng.randint(3, min(L - 2, 8)))
                words = crng.randint(1, min(self._vocab, 40) + 1, size=ln)
            else:
                ln = int(rng.randint(3, min(L - 2, 14)))
                words = rng.randint(1, self._vocab + 1, size=ln)
            cap[i, 1:1 + ln] = words  # column 0 stays 0 (BOS)
            sentences.append(" ".join(f"w{w}" for w in words))
        split = "train" if ix < len(self.split_ix["train"]) else "val"
        return VideoExample(vid=f"v_synth{ix:05d}", feats=feats, lda=lda, duration=duration,
                            timestamps=timestamps, sentences=sentences, cap_labels=cap,
                            split=split)


def build_dataset(cfg: Config, **kw) -> BaseDataset:
    if cfg.data.synthetic:
        return SyntheticDataset(cfg, **kw)
    return ActivityNetDataset(cfg)
