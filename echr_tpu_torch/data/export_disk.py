"""The synthetic corpus on disk in the reference's ActivityNet layout
(echr_tpu/data/export_disk.py), the port's copy.

``export_synthetic_corpus`` writes a config's ``SyntheticDataset`` as the
reference's input files (reference: dataloader.py:38-96,159-263):
per-video C3D ``.npy``, the train / val caption-label HDF5s, the vocab and
splits JSON, the annotation JSON, ``w1.json`` and the LDA HDF5.
``disk_cfg`` points a config at that tree, so a run reads it through
``ActivityNetDataset``.  The HDF5 files go through ``data.hdf5.open_h5``
(h5py where it is installed, the port's own writer otherwise).

The disk reader normalises with the reference's C3D moments, so the
exporter writes ``feats * sqrt(C3D_VAR) + C3D_MEAN`` and the reader gives
the synthetic features back to f32 rounding.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from echr_tpu_torch.config import Config
from echr_tpu_torch.data.dataset import C3D_MEAN, C3D_VAR, SyntheticDataset
from echr_tpu_torch.data.hdf5 import open_h5


def _paths(out_dir: str) -> Dict[str, str]:
    return {
        "video_json": os.path.join(out_dir, "anno.json"),
        "input_c3d_dir2": os.path.join(out_dir, "c3d_npy"),
        "input_lda_path": os.path.join(out_dir, "lda.h5"),
        "video_data_for_cg": os.path.join(out_dir, "info.json"),
        "train_label_for_cg": os.path.join(out_dir, "train_lm.h5"),
        "val_label_for_cg": os.path.join(out_dir, "val_lm.h5"),
        "w1_json": os.path.join(out_dir, "w1.json"),
    }


def export_synthetic_corpus(cfg: Config, out_dir: str, num_videos: Optional[int] = None,
                            seed: int = 1234, log_every: int = 1000) -> Dict[str, str]:
    """Write cfg's synthetic corpus to ``out_dir`` in the reference layout
    and return its data paths (see ``disk_cfg``).  A manifest matching
    (num_videos, seed, vocab, seq_length, learnable, video_dim, lda_dim)
    skips the export."""
    ds = SyntheticDataset(cfg, num_videos=num_videos, seed=seed)
    n = len(ds)
    paths = _paths(out_dir)
    manifest_path = os.path.join(out_dir, "manifest.json")
    manifest = {"num_videos": n, "seed": seed, "vocab": ds._vocab,
                "seq_length": ds.seq_length, "learnable": bool(cfg.data.synthetic_learnable),
                "video_dim": int(cfg.tap.video_dim), "lda_dim": int(cfg.data.lda_dim)}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            if json.load(f) == manifest:
                return paths

    os.makedirs(paths["input_c3d_dir2"], exist_ok=True)
    annotations = {}
    videos = []
    cap_rows = {"train": [], "val": []}
    cap_index = {"train": [], "val": []}
    lda_by_vid = {}
    sqrt_var = np.sqrt(C3D_VAR)
    # train first, then val: the order ActivityNetDataset's val offset
    # (ix - train_videos) assumes
    for split in ("train", "val"):
        for ix in ds.split_ix[split]:
            ex = ds.get_example(ix)
            np.save(os.path.join(paths["input_c3d_dir2"], ex.vid + ".npy"),
                    (ex.feats * sqrt_var + C3D_MEAN).astype(np.float32))
            annotations[ex.vid] = {"duration": ex.duration,
                                   "timestamps": [list(t) for t in ex.timestamps],
                                   "sentences": list(ex.sentences)}
            videos.append({"video_id": ex.vid, "split": split})
            start = sum(len(r) for r in cap_rows[split])
            cap_rows[split].append(ex.cap_labels.astype(np.int64))
            cap_index[split].append((start, start + len(ex.cap_labels)))
            lda_by_vid[ex.vid] = ex.lda
            if log_every and (ix + 1) % log_every == 0:
                print(f"export_synthetic_corpus: {ix + 1}/{n}", flush=True)

    with open(paths["video_json"], "w") as f:
        json.dump(annotations, f)
    with open(paths["video_data_for_cg"], "w") as f:
        json.dump({"ix_to_word": ds.ix_to_word, "videos": videos}, f)
    with open(paths["w1_json"], "w") as f:
        json.dump(np.asarray(ds.w1, dtype=np.float64).tolist(), f)
    for split, h5_path in (("train", paths["train_label_for_cg"]),
                           ("val", paths["val_label_for_cg"])):
        with open_h5(h5_path, "w") as h5:
            h5["labels"] = (np.concatenate(cap_rows[split], axis=0) if cap_rows[split]
                            else np.zeros((0, ds.seq_length), np.int64))
            h5["label_start_ix"] = np.array([s for s, _ in cap_index[split]], np.int64)
            h5["label_end_ix"] = np.array([e for _, e in cap_index[split]], np.int64)
    with open_h5(paths["input_lda_path"], "w") as h5:
        for vid, lda in lda_by_vid.items():
            h5[vid] = lda.astype(np.float32)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    return paths


def disk_cfg(cfg: Config, out_dir: str) -> Config:
    """The exported corpus's config: the same model and training sections,
    the data read from ``out_dir`` through ActivityNetDataset."""
    return cfg.replace_in("data", synthetic=False, **_paths(out_dir)).validate()
