"""Standalone evaluation CLI (echr_tpu/cli/eval.py; reference:
eval.py:26-154).

Loads the best or last checkpoint of a run folder (either package's
format v2), overlays the CLI flags onto the checkpoint's config
(reference: eval.py:32-35), rebuilds the loader and runs the batched eval
driver, ``eval_split_batched``, with ``--batch_videos`` videos a group
(default 8), for --flag_eval_what in {tap, cg, tap_cg, cg_extend}, on
``--device`` (default ``cuda``).  ``--sample_max 0`` decodes by
multinomial sampling at ``--temperature`` with ``--sample_seed``.  Not
ported, each raising NotImplementedError: SOTA_TEP and --SOTA_json
(ROADMAP.md A.6), --data_parallel > 1 and a multi-host launch (A.13).
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

from echr_tpu_torch.data.dataset import build_dataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import checkpoint as ckpt
from echr_tpu_torch.engine.evaluate import eval_split_batched

log = logging.getLogger("echr_tpu_torch.eval_cli")

# echr_tpu's cluster launch (echr_tpu/parallel/distributed.py)
_CLUSTER_ENV = ("ECHR_COORDINATOR", "ECHR_DISTRIBUTED")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("echr_tpu_torch.eval")
    p.add_argument("--folder_id", type=str, required=True, help="run id under save/")
    p.add_argument("--checkpoint_path", type=str, default="save")
    p.add_argument("--model_path", type=str, default=None, help="explicit .ckpt path")
    p.add_argument("--which", type=str, default="best", choices=["best", "last"])
    p.add_argument("--flag_eval_what", type=str, default="tap_cg",
                   choices=["tap", "cg", "tap_cg", "cg_extend", "SOTA_TEP"])
    p.add_argument("--SOTA_json", type=str, default=None,
                   help="external proposal JSON override (reference: eval.py:146)")
    p.add_argument("--topN", type=int, default=1000)
    p.add_argument("--val_score_thres", type=float, default=0.0)
    p.add_argument("--nms_threshold", type=float, default=0.0)
    p.add_argument("--reranking", type=int, default=0)
    p.add_argument("--num_vids_eval", type=int, default=0)
    p.add_argument("--no_language_eval", action="store_true")
    p.add_argument("--val_all_metrics", type=int, default=1)
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--sample_max", type=int, default=1,
                   help="1=greedy argmax; 0=multinomial sampling (reference: eval.py:119-122)")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="sampling temperature when sample_max=0 (reference: eval.py:123-125)")
    p.add_argument("--sample_seed", type=int, default=0,
                   help="seed of the multinomial draws (sample_max=0)")
    p.add_argument("--wait_for_checkpoint", type=int, default=0,
                   help="poll until the checkpoint exists (reference: eval.py:53-55)")
    p.add_argument("--batch_videos", type=int, default=8,
                   help="videos a group of the batched eval driver")
    p.add_argument("--data_parallel", type=int, default=0,
                   help=">1 would shard the eval over that many GPUs (not ported)")
    p.add_argument("--eval_inflight", type=int, default=None,
                   help="dispatched-but-uncollected device batches the pipeline keeps in "
                        "flight (default cfg.eval.eval_inflight)")
    p.add_argument("--device_select", type=int, default=None,
                   help="0 forces host-side top-N proposal selection (default "
                        "cfg.eval.device_select=1)")
    p.add_argument("--transfer_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="host->device feature dtype of the decode-only paths (default: the "
                        "checkpoint's runtime.transfer_dtype)")
    p.add_argument("--split", type=str, default="val", choices=["val", "test"])
    p.add_argument("--device", type=str, default="cuda")
    # reference eval.py flag surface, accepted no-ops: --dataset is
    # informational (eval.py:105), --batch_size the loader batch (eval.py:112;
    # the throughput knob is --batch_videos), --debug (eval.py:129) and
    # --old_loader (eval.py:142) are never read downstream
    p.add_argument("--dataset", type=str, default="ActivityNet")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--debug", nargs="?", const="1", default=None)
    p.add_argument("--old_loader", action="store_true")
    return p


def _not_ported(ns) -> None:
    if ns.flag_eval_what == "SOTA_TEP" or ns.SOTA_json:
        raise NotImplementedError(
            "external proposals (SOTA_TEP, --SOTA_json) are not ported: ROADMAP.md A.6")
    if ns.data_parallel > 1:
        raise NotImplementedError("--data_parallel > 1 is not ported: ROADMAP.md A.13")
    if any(os.environ.get(k) for k in _CLUSTER_ENV):
        raise NotImplementedError(
            f"a multi-host eval ({' / '.join(_CLUSTER_ENV)} set) is not ported: ROADMAP.md A.13")
    if ns.batch_videos < 1:
        raise ValueError(f"--batch_videos must be >= 1, got {ns.batch_videos}")


def main(argv=None) -> str:
    """Run the eval; returns the path of the predictions JSON."""
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s")
    ns = build_parser().parse_args(argv)
    _not_ported(ns)
    folder = os.path.join(ns.checkpoint_path, ns.folder_id)
    path = ns.model_path or os.path.join(folder, f"model-{ns.which}.ckpt")
    while not os.path.exists(path):
        if not ns.wait_for_checkpoint:
            raise FileNotFoundError(path)
        log.info("waiting for checkpoint %s ...", path)
        time.sleep(60)

    payload = ckpt.load_checkpoint(path, ns.device)
    cfg = payload["config"].replace_in(
        "eval",
        topN=ns.topN,
        val_score_thres=ns.val_score_thres,
        nms_threshold=ns.nms_threshold,
        reranking=bool(ns.reranking),
        num_vids_eval=ns.num_vids_eval,
        language_eval=not ns.no_language_eval,
        val_all_metrics=bool(ns.val_all_metrics),
        beam_size=ns.beam_size,
        sample_max=ns.sample_max,
        temperature=ns.temperature,
    )
    if ns.transfer_dtype:
        cfg = cfg.replace_in("runtime", transfer_dtype=ns.transfer_dtype)
    # a group drains batch_videos items at once: a prefetch queue of two
    # groups keeps the producer ahead of the consumer
    if cfg.data.prefetch < 2 * ns.batch_videos:
        cfg = cfg.replace_in("data", prefetch=2 * ns.batch_videos)
    dataset = build_dataset(cfg)
    loader = Loader(dataset, cfg, process_index=0, process_count=1, seed=0)
    state = payload["state"]

    stamp = f"{ns.flag_eval_what}_top{ns.topN}_thr{ns.val_score_thres}_nms{ns.nms_threshold}"
    # decode-mode dimensions, so that a beam or sampling run does not
    # overwrite the greedy run's predictions for the same proposal settings
    if ns.beam_size > 1:
        stamp += f"_beam{ns.beam_size}"
    if not ns.sample_max:
        stamp += f"_sampleT{ns.temperature}_s{ns.sample_seed}"
    json_path = os.path.join(folder, f"eval_{stamp}.json")
    tm: dict = {}
    t0 = time.time()
    try:
        preds, scores, _ = eval_split_batched(
            state.tap, state.cg, loader, cfg, json_path,
            eval_kwargs={
                "split": ns.split,
                "topN": ns.topN,
                "num_vids_eval": ns.num_vids_eval,
                "val_all_metrics": bool(ns.val_all_metrics),
                "language_eval": not ns.no_language_eval,
                "nms_threshold": ns.nms_threshold,
                "val_score_thres": ns.val_score_thres,
                "reranking": bool(ns.reranking),
                "beam_size": ns.beam_size,
                "sample_max": ns.sample_max,
                "temperature": ns.temperature,
                "sample_seed": ns.sample_seed,
                # the reference's standalone eval passes crits=None: no val
                # losses (eval.py:87-88), and the decode-only batches
                "get_eval_loss": False,
                "timing_out": tm,
                **({"eval_inflight": ns.eval_inflight}
                   if ns.eval_inflight is not None else {}),
                **({"device_select": bool(ns.device_select)}
                   if ns.device_select is not None else {}),
            },
            flag_eval_what=ns.flag_eval_what, batch_videos=ns.batch_videos, device=ns.device)
    finally:
        loader.load_state(loader.state())  # stops and joins the prefetch threads
    eval_wall = time.time() - t0
    avg = {k: float(np.asarray(v, dtype=float).mean()) for k, v in scores.items()}
    log.info("predictions: %d videos -> %s", len(preds), json_path)
    # the eval's own wall time: no process start, no checkpoint load
    log.info("eval wall %.2fs (%.2f videos/s), grid_fallbacks %d", eval_wall,
             len(preds) / max(eval_wall, 1e-9), tm.get("grid_fallbacks", 0))
    log.info("avg scores: %s", {k: round(v, 4) for k, v in avg.items()})
    return json_path


if __name__ == "__main__":
    main(sys.argv[1:])
