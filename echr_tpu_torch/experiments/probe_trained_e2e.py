"""Probe: the batched eval of a trained checkpoint with the batch-wide early
exit on and off (experiments/probe_trained_e2e.py's counterpart).

At random weights no caption ends early, so the batched decode's early
exit (runtime.decode_early_exit_batched: one host sync a step, the loop
stops once every proposal of every video in the group has ended) runs all
L steps and can only show its cost.  On a trained checkpoint captions end
after a few tokens.  This probe loads a format-v2 checkpoint of either
package (engine.checkpoint.load_checkpoint) and runs the whole
eval_split_batched pipeline (loader, batched encode, device top-N,
batched decode, predictions JSON; no scoring) over a synthetic split with
the exit on and off, in interleaved windows, and prints for each form the
least window's videos/s, the mean emitted caption length of L, the decode
steps run and the timing_out breakdown; the predictions JSON of every
pass must be the same.

    python -m echr_tpu_torch.experiments.probe_trained_e2e [folder_id] [beam] [num_videos] [batch_videos]

reads save/<folder_id>/model-best.ckpt (defaults: R4S_JT, greedy, 384
synthetic videos of which 96 in val, 32 videos a group), on the card.
"""
from __future__ import annotations

import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from echr_tpu_torch.data.dataset import SyntheticDataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import checkpoint as ckpt
from echr_tpu_torch.engine.evaluate import eval_split_batched
from echr_tpu_torch.experiments import device_name, probe_device
from echr_tpu_torch.models.beam import beam_search_batched
from echr_tpu_torch.models.decoder import decoder_sample_batched

FORMS = ("exit", "scan")  # decode_early_exit_batched on, off


def load(path: str, num_videos: int = 384, batch_videos: int = 32, device="cuda"):
    """(tap, cg, loader, cfg) of the checkpoint at ``path`` over a synthetic
    corpus of ``num_videos`` videos (dataset seed 11), with
    experiments/probe_trained_e2e.py's pipeline settings: one 256 bucket, a
    prefetch of three groups, the whole split cached, bf16 feature
    transfer."""
    payload = ckpt.load_checkpoint(path, device)
    cfg = payload["config"].replace_in(
        "data", synthetic=True, synthetic_num_videos=num_videos, shuffle=False,
        time_buckets=(256,), synthetic_cache_videos=num_videos, prefetch=3 * batch_videos)
    cfg = cfg.replace_in("runtime", transfer_dtype="bfloat16")
    ds = SyntheticDataset(cfg, num_videos=num_videos, seed=11)
    state = payload["state"]
    return state.tap, state.cg, Loader(ds, cfg, 0, 1, seed=0), cfg


def compare(tap, cg, loader, cfg, beam: int = 1, batch_videos: int = 32, windows: int = 5,
            topN: int = 128, device="cuda") -> Dict[str, dict]:
    """eval_split_batched (tap_cg, no scoring) with the exit on ("exit") and
    off ("scan"): one warm-up pass each, then ``windows`` rounds of one pass
    of each.  For each form: the least pass's seconds and videos/s and its
    timing_out, the mean emitted caption length and caption count, the
    decode steps and early-exit host syncs a pass, and whether every pass
    wrote the first pass's predictions JSON ("same_json", the same for
    both forms)."""
    dev = probe_device(device)
    fn = decoder_sample_batched if beam == 1 else beam_search_batched
    kw = {"language_eval": False, "get_eval_loss": False, "topN": topN, "beam_size": beam}
    cfgs = {form: cfg.replace_in("runtime", decode_early_exit_batched=(form == "exit"))
            for form in FORMS}
    out = {form: {"s": float("inf")} for form in FORMS}
    n_val = loader.split_size("val")
    first = None
    with tempfile.TemporaryDirectory() as td:
        json_path = f"{td}/pred.json"

        def one_pass(form):
            nonlocal first
            fn.steps = fn.host_syncs = 0
            timing: Dict = {}
            t0 = time.perf_counter()
            preds, _, _ = eval_split_batched(tap, cg, loader, cfgs[form], json_path,
                                             dict(kw, timing_out=timing), flag_eval_what="tap_cg",
                                             batch_videos=batch_videos, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            with open(json_path) as f:
                text = f.read()
            first = text if first is None else first
            rec = out[form]
            rec["same_json"] = rec.get("same_json", True) and text == first
            rec.update(steps=fn.steps, host_syncs=fn.host_syncs)
            if "mean_len" not in rec:
                lengths = [len(p["sentence"].split()) for v in preds.values() for p in v]
                rec.update(mean_len=float(np.mean(lengths)) if lengths else 0.0,
                           captions=len(lengths), videos=len(preds))
            return wall, timing

        for form in FORMS:  # warm-up
            one_pass(form)
        for _ in range(windows):
            for form in FORMS:
                wall, timing = one_pass(form)
                rec = out[form]
                if wall < rec["s"]:
                    rec.update(s=wall, videos_per_s=n_val / wall, timing=timing)
    same = all(out[form]["same_json"] for form in FORMS)
    for form in FORMS:
        out[form]["same_json"] = same
    return out


def main(argv) -> Dict[str, dict]:
    folder = argv[0] if argv else "R4S_JT"
    beam = int(argv[1]) if len(argv) > 1 else 1
    num_videos = int(argv[2]) if len(argv) > 2 else 384
    batch_videos = int(argv[3]) if len(argv) > 3 else 32
    tap, cg, loader, cfg = load(f"save/{folder}/model-best.ckpt", num_videos, batch_videos)
    windows = 5
    try:
        res = compare(tap, cg, loader, cfg, beam, batch_videos, windows)
    finally:
        loader.load_state(loader.state())  # stops and joins the prefetch threads
    n_val = loader.split_size("val")
    L = cfg.decoder.CG_seq_length
    for form, r in res.items():
        print(f"{folder} beam={beam} B={batch_videos} {form}: {n_val} videos in {r['s']:.2f}s -> "
              f"{r['videos_per_s']:6.1f} videos/s (mean caption len {r['mean_len']:.1f} of L={L}, "
              f"{r['captions']} captions, {r['steps']} decode steps, {r['host_syncs']} exit "
              f"syncs) [min of {windows} interleaved windows; {device_name(torch.device('cuda'))}]",
              flush=True)
        brk = {k: round(v, 3) for k, v in r["timing"].items() if isinstance(v, float)}
        print(f"  breakdown: {brk} (groups={r['timing'].get('groups')})", flush=True)
    print(f"predictions JSON the same in every pass: {res['exit']['same_json']}", flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
