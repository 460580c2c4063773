"""Validate an on-disk ActivityNet Captions asset tree against the layout
the port's ActivityNetDataset (and the reference, dataloader.py:38-69,
159-263) expects; echr_tpu/cli/validate_data.py's checks, messages and
exit codes.  HDF5 files are opened through ``data.hdf5.open_h5`` (h5py
where it is installed, the port's own reader otherwise).

    python -m echr_tpu_torch.cli.validate_data \
        --video_json data/anno.json --video_data_for_cg data/info.json \
        --train_label_for_cg ... --val_label_for_cg ... --w1_json ... \
        --input_c3d_dir2 data/c3d_npy [--input_lda_path ...] [--SOTA_json ...]

Checks, per asset:
  - vocab/splits JSON: videos listed train-then-val (the val h5 offset
    assumption), ix_to_word 1-based contiguous
  - label h5s: labels/label_start_ix/label_end_ix present, monotone,
    consistent row counts, token ids within vocab, col 0 == 0 (BOS)
  - annotation JSON: every video has duration/timestamps/sentences with
    matching counts; caption count == h5 row count per video; events
    within [0, duration]
  - C3D .npy per video: present, 2-D [T, video_dim], finite
  - w1 JSON: length K, finite, in [0, 1]
  - LDA h5: keyed by video_id, vector length lda_dim
  - SOTA JSON: results keyed WITHOUT the 'v_' prefix, segment/score fields

Exit code 0 = usable; 1 = hard errors (printed).  Warnings don't fail.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

import numpy as np

from echr_tpu_torch.data.hdf5 import open_h5

OK, WARN, ERR = "ok", "WARN", "ERROR"


class Report:
    def __init__(self):
        self.lines: List[str] = []
        self.errors = 0
        self.warnings = 0

    def add(self, level: str, msg: str) -> None:
        if level == ERR:
            self.errors += 1
        elif level == WARN:
            self.warnings += 1
        self.lines.append(f"[{level:5s}] {msg}")

    def dump(self) -> None:
        print("\n".join(self.lines))
        print(f"\n{self.errors} error(s), {self.warnings} warning(s)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("echr_tpu_torch.validate_data")
    p.add_argument("--video_json", required=True)
    p.add_argument("--video_data_for_cg", required=True)
    p.add_argument("--train_label_for_cg", required=True)
    p.add_argument("--val_label_for_cg", required=True)
    p.add_argument("--w1_json", required=True)
    p.add_argument("--input_c3d_dir2", required=True)
    p.add_argument("--input_lda_path", default=None)
    p.add_argument("--input_twostream_dir", default=None)
    p.add_argument("--SOTA_json", default=None)
    p.add_argument("--K", type=int, default=256)
    p.add_argument("--video_dim", type=int, default=500)
    p.add_argument("--lda_dim", type=int, default=None)
    p.add_argument("--sample_videos", type=int, default=20,
                   help="how many videos' .npy files to open (0 = all)")
    return p


def _check_label_h5(rep: Report, path: str, name: str, vocab_size: int):
    if not os.path.exists(path):
        rep.add(ERR, f"{name}: missing file {path}")
        return None
    with open_h5(path, "r") as h5:
        missing = [k for k in ("labels", "label_start_ix", "label_end_ix") if k not in h5]
        if missing:
            rep.add(ERR, f"{name}: missing datasets {missing}")
            return None
        labels = np.asarray(h5["labels"])
        start = np.asarray(h5["label_start_ix"])
        end = np.asarray(h5["label_end_ix"])
    if start.shape != end.shape:
        rep.add(ERR, f"{name}: start/end shape mismatch {start.shape} vs {end.shape}")
        return None
    if not (end >= start).all():
        rep.add(ERR, f"{name}: label_end_ix < label_start_ix somewhere")
    if start.size and (int(start.min()) < 0 or int(end.max()) > labels.shape[0]):
        # an out-of-bounds labels[start:end] slice is an hour-0 crash (or a
        # silently empty caption set) in the reference's get_data
        # (reference: dataloader.py:193-214)
        rep.add(ERR, f"{name}: label ix out of bounds — start min "
                     f"{int(start.min())}, end max {int(end.max())}, "
                     f"label rows {labels.shape[0]}")
    if not (start[1:] >= end[:-1]).all():
        rep.add(WARN, f"{name}: caption rows not contiguous/monotone across videos")
    if len(end) and int(end[-1]) != labels.shape[0]:
        rep.add(WARN, f"{name}: last end ix {int(end[-1])} != label rows {labels.shape[0]}")
    if labels.size and labels.max() > vocab_size:
        rep.add(ERR, f"{name}: token id {int(labels.max())} exceeds vocab size {vocab_size}")
    if labels.size and (labels[:, 0] != 0).any():
        rep.add(WARN, f"{name}: labels column 0 is not all 0 (BOS)")
    rep.add(OK, f"{name}: {start.shape[0]} videos, {labels.shape[0]} captions, "
                f"seq_length {labels.shape[1]}")
    return labels, start, end


def _check_twostream(rep: Report, root: str, vids, sample_n: int) -> None:
    """Two-stream CSV tree (reference: dataloader.py:55-69): per video,
    spatial/csv_action/<vid>.csv and OF/csv_action/<vid>.csv, read with
    pd.read_csv and concatenated after truncating to the shorter stream.
    Hour-0 failure modes checked: unparseable/truncated CSV (ragged rows,
    non-numeric cells), non-finite values, stream width drift across
    videos (the concat feeds a fixed other_dim1 input layer)."""
    import pandas as pd

    if not os.path.isdir(root):
        rep.add(ERR, f"input_twostream_dir: not a directory: {root}")
        return
    widths = {"spatial": set(), "OF": set()}
    n_present, n_fallback, n_bad = 0, 0, 0
    for v in vids[:sample_n]:
        vid = v["video_id"]
        frames = {}
        for stream in ("spatial", "OF"):
            path = os.path.join(root, stream, "csv_action", vid + ".csv")
            if not os.path.exists(path):
                continue  # per-video absence = zeros fallback, not an error
            try:
                df = pd.read_csv(path)
            except Exception as e:
                rep.add(ERR, f"twostream {stream}/{vid}.csv: unparseable "
                             f"(truncated or corrupt): {e}")
                n_bad += 1
                continue
            arr = df.to_numpy()
            if arr.ndim != 2 or arr.shape[1] < 2:
                rep.add(ERR, f"twostream {stream}/{vid}.csv: shape "
                             f"{arr.shape}, expected [T, stream_dim]")
                n_bad += 1
                continue
            if arr.dtype == object or not np.issubdtype(arr.dtype, np.number):
                rep.add(ERR, f"twostream {stream}/{vid}.csv: non-numeric "
                             f"cells (truncated mid-row?)")
                n_bad += 1
                continue
            if not np.isfinite(arr).all():
                rep.add(ERR, f"twostream {stream}/{vid}.csv: non-finite values")
                n_bad += 1
                continue
            widths[stream].add(arr.shape[1])
            frames[stream] = arr.shape[0]
        if len(frames) == 2:
            n_present += 1
            if frames["spatial"] != frames["OF"]:
                # the reference truncates to the shorter stream — legal,
                # but a large gap usually means a truncated file
                ratio = min(frames.values()) / max(frames.values())
                lvl = WARN if ratio >= 0.9 else ERR
                rep.add(lvl, f"twostream {vid}: spatial {frames['spatial']} "
                             f"vs OF {frames['OF']} rows "
                             f"({'reference truncates' if lvl == WARN else 'likely truncated file'})")
        elif len(frames) == 1:
            only = next(iter(frames))
            if only == "spatial":
                # the loader's existence check only tests the SPATIAL path;
                # with spatial present, read_csv(OF) crashes at hour 0
                # (reference: dataloader.py:56-62)
                rep.add(ERR, f"twostream {vid}: spatial present but OF "
                             f"missing — the reference's fallback only "
                             f"checks spatial, so read_csv(OF) crashes")
                n_bad += 1
            else:
                # OF alone: the spatial existence check routes to the zeros
                # fallback, silently ignoring the OF data
                rep.add(WARN, f"twostream {vid}: OF present but spatial "
                              f"missing — data silently unused (zeros "
                              f"fallback)")
        else:
            n_fallback += 1
    for stream, ws in widths.items():
        if len(ws) > 1:
            rep.add(ERR, f"twostream {stream}: column width drifts across "
                         f"videos: {sorted(ws)} (concat feeds a fixed-dim "
                         f"input layer)")
    if not n_bad:
        rep.add(OK, f"input_twostream_dir: {n_present} sampled videos with "
                    f"both streams, {n_fallback} on the zeros fallback")


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    rep = Report()

    # vocab + splits
    try:
        with open(ns.video_data_for_cg) as f:
            info = json.load(f)
    except Exception as e:
        rep.add(ERR, f"video_data_for_cg: cannot read ({e})")
        rep.dump()
        return 1
    vocab = info.get("ix_to_word", {})
    vids = info.get("videos", [])
    if not vocab or not vids:
        rep.add(ERR, "video_data_for_cg: needs ix_to_word and videos")
        rep.dump()
        return 1
    keys = sorted(int(k) for k in vocab)
    if keys and (keys[0] != 1 or keys[-1] != len(keys)):
        rep.add(WARN, f"ix_to_word ids not 1..{len(keys)} contiguous")
    splits = [v.get("split", "?") for v in vids]
    n_train_like = sum(1 for s in splits if s != "val" and s != "test")
    first_val = next((i for i, s in enumerate(splits) if s == "val"), len(splits))
    if any(s != "val" and s != "test" for s in splits[first_val:]):
        rep.add(ERR, "videos list is not train-then-val ordered — the val "
                     "label h5 offset (ix - train_videos) would misindex")
    rep.add(OK, f"video_data_for_cg: {len(vids)} videos "
                f"({n_train_like} train/restval, {splits.count('val')} val), "
                f"vocab {len(vocab)}")

    tr = _check_label_h5(rep, ns.train_label_for_cg, "train_label_for_cg", len(vocab))
    va = _check_label_h5(rep, ns.val_label_for_cg, "val_label_for_cg", len(vocab))
    if tr is not None and tr[1].shape[0] != n_train_like:
        rep.add(ERR, f"train h5 has {tr[1].shape[0]} videos but splits json "
                     f"lists {n_train_like} train/restval")
    if va is not None and va[1].shape[0] != splits.count("val"):
        rep.add(ERR, f"val h5 has {va[1].shape[0]} videos but splits json "
                     f"lists {splits.count('val')} val")
    if tr is not None and va is not None and tr[0].shape[1] != va[0].shape[1]:
        rep.add(ERR, f"seq_length differs: train {tr[0].shape[1]} vs val {va[0].shape[1]}")

    # annotations
    try:
        with open(ns.video_json) as f:
            anno = json.load(f)
    except Exception as e:
        rep.add(ERR, f"video_json: cannot read ({e})")
        anno = {}
    n_missing_anno = 0
    for vi, v in enumerate(vids):
        vid = v["video_id"]
        a = anno.get(vid)
        if a is None:
            n_missing_anno += 1
            continue
        ts, sents, dur = a.get("timestamps", []), a.get("sentences", []), a.get("duration")
        if len(ts) != len(sents):
            rep.add(ERR, f"{vid}: {len(ts)} timestamps vs {len(sents)} sentences")
        if dur is None or any(not (0 <= s <= dur + 1e-6 and e <= dur * 1.5) for s, e in ts):
            rep.add(WARN, f"{vid}: event timestamps outside [0, duration]")
        # caption count vs h5 rows (the reference's ncap assert,
        # dataloader.py:568-571)
        h5 = tr if v.get("split") != "val" else va
        off = vi if v.get("split") != "val" else vi - n_train_like
        if h5 is not None and 0 <= off < h5[1].shape[0]:
            ncap_h5 = int(h5[2][off] - h5[1][off])
            if ncap_h5 != len(ts):
                rep.add(ERR, f"{vid}: {ncap_h5} caption rows in h5 vs "
                             f"{len(ts)} annotated events")
    if n_missing_anno:
        rep.add(ERR, f"video_json: {n_missing_anno} videos from splits json missing")
    else:
        rep.add(OK, f"video_json: all {len(vids)} videos annotated")

    # C3D features
    if not os.path.isdir(ns.input_c3d_dir2):
        rep.add(ERR, f"input_c3d_dir2: not a directory: {ns.input_c3d_dir2}")
    else:
        sample = vids if not ns.sample_videos else vids[: ns.sample_videos]
        n_missing, n_bad = 0, 0
        for v in sample:
            path = os.path.join(ns.input_c3d_dir2, v["video_id"] + ".npy")
            if not os.path.exists(path):
                n_missing += 1
                continue
            arr = np.load(path, mmap_mode="r")
            if arr.ndim != 2 or arr.shape[1] != ns.video_dim:
                rep.add(ERR, f"{v['video_id']}.npy: shape {arr.shape}, "
                             f"expected [T, {ns.video_dim}]")
                n_bad += 1
            elif not np.isfinite(np.asarray(arr[:2])).all():
                rep.add(ERR, f"{v['video_id']}.npy: non-finite values")
                n_bad += 1
        if n_missing:
            rep.add(ERR, f"input_c3d_dir2: {n_missing}/{len(sample)} sampled .npy missing")
        if not n_missing and not n_bad:
            rep.add(OK, f"input_c3d_dir2: {len(sample)} sampled .npy files OK")

    # w1
    try:
        with open(ns.w1_json) as f:
            w1 = np.asarray(json.load(f), dtype=np.float64)
        if w1.shape[0] != ns.K:
            rep.add(ERR, f"w1_json: length {w1.shape[0]} != K {ns.K}")
        elif not np.isfinite(w1).all() or (w1 < 0).any() or (w1 > 1).any():
            rep.add(WARN, "w1_json: values outside [0, 1]")
        else:
            rep.add(OK, f"w1_json: {w1.shape[0]} per-anchor positive rates")
    except Exception as e:
        rep.add(ERR, f"w1_json: cannot read ({e})")

    # LDA
    if ns.input_lda_path:
        try:
            with open_h5(ns.input_lda_path, "r") as h5:
                missing = [v["video_id"] for v in vids if v["video_id"] not in h5]
                dims = {h5[k].shape[-1] for k in list(h5.keys())[:50]}
            if missing:
                rep.add(ERR, f"input_lda_path: {len(missing)} videos missing "
                             f"(e.g. {missing[:3]})")
            if ns.lda_dim and dims and dims != {ns.lda_dim}:
                rep.add(ERR, f"input_lda_path: vector dims {dims} != lda_dim {ns.lda_dim}")
            if not missing:
                rep.add(OK, f"input_lda_path: all videos keyed, dims {dims}")
        except Exception as e:
            rep.add(ERR, f"input_lda_path: cannot read ({e})")

    # two-stream CSVs (optional tree; a missing per-video CSV is the
    # reference's zeros fallback, dataloader.py:55-58 — never an error)
    if ns.input_twostream_dir:
        _check_twostream(rep, ns.input_twostream_dir, vids,
                         ns.sample_videos or len(vids))

    # SOTA proposals
    if ns.SOTA_json:
        try:
            with open(ns.SOTA_json) as f:
                sota = json.load(f)["results"]
            prefixed = sum(1 for k in list(sota)[:100] if k.startswith("v_"))
            if prefixed:
                rep.add(ERR, "SOTA_json: keys carry the 'v_' prefix — the "
                             "loader strips it (reference dataloader.py:304-318)")
            bad = 0
            for k, props in list(sota.items())[:100]:
                for pr in props:
                    if "segment" not in pr or "score" not in pr or len(pr["segment"]) != 2:
                        bad += 1
            if bad:
                rep.add(ERR, f"SOTA_json: {bad} proposals missing segment/score")
            else:
                rep.add(OK, f"SOTA_json: {len(sota)} videos of external proposals")
        except Exception as e:
            rep.add(ERR, f"SOTA_json: cannot read ({e})")

    rep.dump()
    return 1 if rep.errors else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
