"""Standalone evaluation CLI (echr_tpu/cli/eval.py; reference:
eval.py:26-154).

Loads the best or last checkpoint of a run folder (either package's
format v2), overlays the CLI flags onto the checkpoint's config
(reference: eval.py:32-35), rebuilds the loader and runs the eval, for
--flag_eval_what in {tap, cg, tap_cg, cg_extend, SOTA_TEP}, on
``--device`` (default ``cuda``): without ``--batch_videos`` (or with 1)
the per-video ``eval_split``, as echr_tpu's CLI does, and with
``--batch_videos`` > 1 the batched driver, ``eval_split_batched``, with
that many videos a group.  --SOTA_json overrides the
external-proposal file (reference: eval.py:146).  ``--sample_max 0``
decodes by multinomial sampling at ``--temperature`` with
``--sample_seed``.

Data parallel (echr_tpu's multi-host eval and ``--data_parallel``): under
echr_tpu's cluster variables (``ECHR_COORDINATOR`` / ``ECHR_NUM_PROCESSES``
/ ``ECHR_PROCESS_ID``, or torchrun's with ``ECHR_DISTRIBUTED=1``) the same
command on every rank joins the group after parsing, each rank evaluates
its shard of ``--split`` through the batched driver (``--batch_videos``
default 8) and every rank scores the gathered split; rank 0 writes the
predictions JSON, rank r ``<json>.proc<r>``.  ``--data_parallel N``
outside such a group spawns N ranks on N local devices (gloo ranks with
``--device cpu``) and raises when N exceeds the local devices.
"""
from __future__ import annotations

import argparse
import logging
import os
import socket
import sys
import time

import numpy as np
import torch

from echr_tpu_torch.data.dataset import build_dataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import checkpoint as ckpt
from echr_tpu_torch.engine.evaluate import eval_split, eval_split_batched
from echr_tpu_torch.parallel import distributed as pdist

log = logging.getLogger("echr_tpu_torch.eval_cli")


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
    p.add_argument("--batch_videos", type=int, default=None,
                   help="videos a group: unset or 1 runs the per-video eval_split, > 1 the "
                        "batched eval_split_batched")
    p.add_argument("--data_parallel", type=int, default=0,
                   help=">1 shards the eval over that many local devices, one rank each")
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


def main(argv=None) -> str:
    """Run the eval; returns the path of the predictions JSON (rank 0's)."""
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s")
    ns = build_parser().parse_args(argv)
    if ns.batch_videos is not None and ns.batch_videos < 1:
        raise ValueError(f"--batch_videos must be >= 1, got {ns.batch_videos}")
    # parse before joining: a --help or a typo exits before the rendezvous
    device = pdist.maybe_initialize_from_env(ns.device)
    try:
        if ns.data_parallel > 1 and pdist.world_size() != ns.data_parallel:
            if device is not None:
                raise ValueError(
                    f"--data_parallel {ns.data_parallel} in a group of {pdist.world_size()} "
                    "ranks: one rank drives one device; launch that many ranks or drop "
                    "--data_parallel")
            return _spawn_ranks(list(argv or []), ns)
        return _run(ns, device or ns.device)
    finally:
        if device is not None:
            pdist.destroy()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(argv, ns) -> str:
    """--data_parallel N: N ranks on N local devices (echr_tpu's N local
    chips in one process), spawned here and joined in a group of their own."""
    n = ns.data_parallel
    if torch.device(ns.device).type == "cuda":
        local = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > local:
            raise ValueError(f"--data_parallel {n} exceeds the {local} local devices")
    torch.multiprocessing.spawn(_rank_main, args=(argv, n, _free_port()), nprocs=n, join=True)
    return _json_path(ns, os.path.join(ns.checkpoint_path, ns.folder_id))


def _rank_main(r: int, argv, n: int, port: int) -> None:
    """One spawned rank of --data_parallel: device cuda:r or the CPU."""
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s")
    ns = build_parser().parse_args(argv)
    os.environ["LOCAL_RANK"] = str(r)
    device = pdist.initialize(f"127.0.0.1:{port}", n, r, device=ns.device)
    try:
        _run(ns, device)
    finally:
        pdist.destroy()


def _json_path(ns, folder: str) -> str:
    stamp = f"{ns.flag_eval_what}_top{ns.topN}_thr{ns.val_score_thres}_nms{ns.nms_threshold}"
    # decode-mode dimensions, so that a beam or sampling run does not
    # overwrite the greedy run's predictions for the same proposal settings
    if ns.beam_size > 1:
        stamp += f"_beam{ns.beam_size}"
    if not ns.sample_max:
        stamp += f"_sampleT{ns.temperature}_s{ns.sample_seed}"
    return os.path.join(folder, f"eval_{stamp}.json")


def _run(ns, device) -> str:
    """The eval on ``device``, over the whole split or, in a group of
    several ranks, over this rank's shard with the predictions gathered."""
    multihost = pdist.world_size() > 1
    if multihost:
        if ns.batch_videos is None:
            ns.batch_videos = 8  # the data-parallel sweep is the batched driver's
        elif ns.batch_videos <= 1:
            raise ValueError("a data-parallel eval runs the batched driver only: --batch_videos "
                             "must be > 1 (or omitted for 8)")
    elif ns.batch_videos is None:
        ns.batch_videos = 1  # the per-video eval_split, echr_tpu's default
    folder = os.path.join(ns.checkpoint_path, ns.folder_id)
    path = ns.model_path or os.path.join(folder, f"model-{ns.which}.ckpt")
    while not os.path.exists(path):
        if not ns.wait_for_checkpoint:
            raise FileNotFoundError(path)
        log.info("waiting for checkpoint %s ...", path)
        time.sleep(60)

    payload = ckpt.load_checkpoint(path, device)
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
    if ns.SOTA_json:
        cfg = cfg.replace_in("data", SOTA_json=ns.SOTA_json)
    if ns.transfer_dtype:
        cfg = cfg.replace_in("runtime", transfer_dtype=ns.transfer_dtype)
    # a group drains batch_videos items at once: a prefetch queue of two
    # groups keeps the producer ahead of the consumer
    if ns.batch_videos > 1 and cfg.data.prefetch < 2 * ns.batch_videos:
        cfg = cfg.replace_in("data", prefetch=2 * ns.batch_videos)
    dataset = build_dataset(cfg)
    # each rank of a group its strided shard of the split
    loader = Loader(dataset, cfg, process_index=pdist.rank(), process_count=pdist.world_size(),
                    seed=0, shard_splits=(ns.split,))
    state = payload["state"]
    json_path = _json_path(ns, folder)
    tm: dict = {}
    t0 = time.time()
    batched = ns.batch_videos > 1
    try:
        run = eval_split_batched if batched else eval_split
        preds, scores, _ = run(
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
            flag_eval_what=ns.flag_eval_what, device=device,
            **({"batch_videos": ns.batch_videos, "multihost": multihost} if batched else {}))
    finally:
        loader.load_state(loader.state())  # stops and joins the prefetch threads
    eval_wall = time.time() - t0
    avg = {k: float(np.asarray(v, dtype=float).mean()) for k, v in scores.items()}
    log.info("predictions: %d videos -> %s", len(preds), json_path)
    # the eval's own wall time: no process start, no checkpoint load
    log.info("eval wall %.2fs (%.2f videos/s, %s), grid_fallbacks %d", eval_wall,
             len(preds) / max(eval_wall, 1e-9),
             f"eval_split_batched, {ns.batch_videos} videos a group" if batched else "eval_split",
             tm.get("grid_fallbacks", 0))
    log.info("avg scores: %s", {k: round(v, 4) for k, v in avg.items()})
    return json_path


if __name__ == "__main__":
    main(sys.argv[1:])
