"""Batch caption-serving CLI (echr_tpu/cli/serve.py), the port's copy.

Loads a format-v2 training checkpoint of either package into a
CaptionService (``echr_tpu_torch.serve``) on ``--device`` (default
``cuda``) and captions a directory of C3D feature files (``<vid>.npy``,
[T, video_dim], the reference's on-disk feature format,
dataloader.py:47-53), greedy or beam with ``--beam_size``.  It writes one
JSON of dense captions with timestamps per video, in the eval's
predictions layout, so ``echr_tpu_torch.cli.score`` scores it.

Example:
  python -m echr_tpu_torch.cli.serve --checkpoint save/RUN/model-best.ckpt \\
      --features_dir /data/c3d --output captions.json --beam_size 4

With ``--trace_dir DIR`` the whole corpus runs under torch.profiler
(``utils/profiling.device_trace``), which writes ``DIR/trace.json``: one
Chrome trace with the serving path's spans (``serve.caption``,
``serve.pad``, ``sst.encode``, ``select.*``, ``decode.*``,
``serve.render``, ``gc.gen<N>``) and the card's kernels on one clock.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import logging
import os
import sys
import time

import numpy as np

from echr_tpu_torch.data.dataset import C3D_MEAN, C3D_VAR
from echr_tpu_torch.serve import CaptionRequest, from_checkpoint
from echr_tpu_torch.utils.profiling import TRACE_FILE, device_trace

log = logging.getLogger("echr_tpu_torch.serve_cli")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("echr_tpu_torch.serve")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="path to a model-*.ckpt training checkpoint")
    p.add_argument("--features_dir", type=str, required=True,
                   help="directory of <vid>.npy C3D feature files [T, video_dim]")
    p.add_argument("--output", type=str, required=True, help="output JSON path")
    p.add_argument("--duration_json", type=str, default=None,
                   help="optional {vid: seconds} map; defaults to frames * "
                        "feature_seconds per video")
    p.add_argument("--feature_seconds", type=float, default=2.0,
                   help="seconds of video per feature row (64-frame C3D "
                        "stride at 32 fps ~= 2s)")
    p.add_argument("--batch_videos", type=int, default=32)
    p.add_argument("--topN", type=int, default=100)
    p.add_argument("--nms_threshold", type=float, default=0.0)
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--limit", type=int, default=0, help="cap #videos (0 = all)")
    p.add_argument("--pre_normalized", action="store_true",
                   help="features are already (f - C3D_MEAN)/sqrt(C3D_VAR); by "
                        "default the CLI applies the normalisation the data "
                        "pipeline applies to raw on-disk C3D features "
                        "(reference: dataloader.py:49-51)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="run the corpus under torch.profiler and write one Chrome "
                        "trace of the program's spans and the card's kernels to "
                        f"<trace_dir>/{TRACE_FILE}")
    return p


def main(argv=None) -> dict:
    """Caption the directory; returns the results JSON it wrote."""
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s")
    ns = build_parser().parse_args(argv)
    service = from_checkpoint(ns.checkpoint, device=ns.device, batch_videos=ns.batch_videos,
                              topN=ns.topN, nms_threshold=ns.nms_threshold,
                              beam_size=ns.beam_size)
    durations = {}
    if ns.duration_json:
        with open(ns.duration_json) as f:
            durations = json.load(f)
    files = sorted(glob.glob(os.path.join(ns.features_dir, "*.npy")))
    if ns.limit:
        files = files[:ns.limit]
    if not files:
        raise FileNotFoundError(f"no .npy feature files under {ns.features_dir}")

    # batch_videos files at a time: host memory holds one chunk of
    # features, not the directory
    results = {}
    t0 = time.time()
    with device_trace(ns.trace_dir) if ns.trace_dir else contextlib.nullcontext():
        for i0 in range(0, len(files), ns.batch_videos):
            requests = []
            for path in files[i0:i0 + ns.batch_videos]:
                vid = os.path.splitext(os.path.basename(path))[0]
                feats = np.load(path).astype(np.float32)
                if not ns.pre_normalized:
                    feats = (feats - C3D_MEAN) / np.sqrt(C3D_VAR)
                dur = float(durations.get(vid, feats.shape[0] * ns.feature_seconds))
                requests.append(CaptionRequest(vid=vid, feats=feats, duration=dur))
            results.update(service.caption(requests))
    dt = time.time() - t0
    if ns.trace_dir:
        log.info("wrote %s", os.path.join(ns.trace_dir, TRACE_FILE))
    n_caps = sum(len(v) for v in results.values())
    log.info("captioned %d videos (%d captions) in %.2fs (%.1f captions/s)",
             len(results), n_caps, dt, n_caps / max(dt, 1e-9))
    out = {
        "results": {
            vid: [{"sentence": c.sentence, "timestamp": list(c.timestamp),
                   "proposal_score": c.proposal_score,
                   "sentence_confidence": c.sentence_confidence} for c in caps]
            for vid, caps in results.items()
        },
        "version": "VERSION 1.0",
        "external_data": {"used": True, "details": "C3D features"},
    }
    os.makedirs(os.path.dirname(ns.output) or ".", exist_ok=True)
    with open(ns.output, "w") as f:
        json.dump(out, f)
    log.info("wrote %s", ns.output)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
