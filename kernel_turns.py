#!/usr/bin/env python3
"""Time kernels 1 and 4 of this checkout beside another build of their
sources, in turns on one NVIDIA GPU; and kernel 1 on the decode paths'
masks with the proposals sorted by window start and unsorted.

    python3 kernel_turns.py [--earlier CSRC]

The builds, each a library with the same C entry points: "this", the
package's own (echr_tpu_torch/csrc), and with --earlier "earlier", every
*.cu of CSRC, for example a parent commit's kernel sources unpacked into
a gitignored directory:

    mkdir -p echr_tpu_torch/_build/parent
    git archive HEAD~1 echr_tpu_torch/csrc | tar -x -C echr_tpu_torch/_build/parent
    python3 kernel_turns.py --earlier echr_tpu_torch/_build/parent/echr_tpu_torch/csrc

Kernel 1 runs at chip_smoke.py's four inputs (phase 2's synthetic
windows, one greedy step, the beam step, the beam step with short
windows), kernel 4 at three (a dense cotangent, one zero outside windows,
the cotangents of one training step after two).  Every build is held
against the plain version (kernel 1 within 5e-4 where mask == 1; kernel 4
within phase 8's gates), then all are timed in turns: each build in
order, then in reverse (CUDA events).  Last, kernel 1 of this build on the
greedy and the beam step with runtime.sort_decode_props on (as the decode
paths run) and off, and on the short windows sorted and with the
proposals shuffled (shuffle_proposals), in turns.  The last line is a
JSON record of every time; each time printed stands beside the card's
name and power limit.
"""
import argparse
import json
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


def builds(earlier):
    """{name: library}, in the order they are timed."""
    from echr_tpu_torch.ops import native

    libs = {}
    if earlier:
        cu = sorted(Path(earlier).glob("*.cu"))
        if not cu:
            cs.fail(f"no *.cu in {earlier}")
        libs["earlier"] = native.load(native.build(cu))
    libs["this"] = native.library()
    return libs


def turns_of(card, what, calls):
    """in_turns over ``calls``, printed; {name: [ms, ms]}."""
    turns = cs.in_turns(calls)
    print(f"  {what}: in turns " + ", ".join(f"{k} {a:.4f} / {b:.4f}"
                                             for k, (a, b) in turns.items()) + f" ms [{card}]")
    return turns


@torch.inference_mode()
def kernel1_builds(card, name, args, libs):
    """Every build of kernel 1 on args against the plain version, then
    timed in turns."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked, masked_scores_on

    with force_plain():
        want = attention_scores_masked(*args)
    m = args[4] > 0
    errs = {}
    for b, lib in libs.items():
        errs[b] = float((masked_scores_on(lib, *args) - want).abs()[m].max())
        if not errs[b] <= cs.TOL:
            cs.fail(f"kernel 1 {name}, build {b}: max|d| {errs[b]:.3e} > {cs.TOL}")
    del want
    print(f"[k1] {name}: density {float(m.float().mean()):.3f}; max|d| where mask==1 "
          + ", ".join(f"{b} {e:.3e}" for b, e in errs.items()))
    calls = {b: (lambda lib=lib: masked_scores_on(lib, *args)) for b, lib in libs.items()}
    return {"max_abs_err": errs, "turns_ms": turns_of(card, f"kernel 1, {name}", calls)}


def _bwd_ok(got, want):
    """Phase 8's gates: d_pre and d_q within 2e-4 + 1e-4 |ref|; d_w within
    1e-4 of its largest entry.  Returns the worst d_pre / d_q error, or
    None when a gate fails."""
    (gp, gq, gw), (wp, wq, ww) = got, want
    for a, b in ((gp, wp), (gq, wq)):
        if not bool(((a - b).abs() <= 2e-4 + 1e-4 * b.abs()).all()):
            return None
    if not float((gw - ww).abs().max()) <= 1e-4 * float(ww.abs().max()):
        return None
    return max(float((gp - wp).abs().max()), float((gq - wq).abs().max()))


def kernel4_builds(card, name, raws, libs):
    """Every build of kernel 4 over raws [(pre, q, w, g), ...] against the
    plain version, then timed in turns (ms a call)."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd_plain, scores_bwd_on

    errs = {b: 0.0 for b in libs}
    for raw in raws:
        want = attention_scores_bwd_plain(*raw)
        for b, lib in libs.items():
            err = _bwd_ok(scores_bwd_on(lib, *raw), want)
            if err is None:
                cs.fail(f"kernel 4 {name}, build {b}: outside phase 8's gates")
            errs[b] = max(errs[b], err)
        del want
    nonzero = sum(int(r[3].ne(0).sum()) for r in raws) / sum(r[3].numel() for r in raws)
    print(f"[k4] {name}: {len(raws)} call(s), nonzero g {nonzero:.4f}; max|d| d_pre/d_q "
          + ", ".join(f"{b} {e:.3e}" for b, e in errs.items()))
    calls = {b: (lambda lib=lib: [scores_bwd_on(lib, *raw) for raw in raws])
             for b, lib in libs.items()}
    turns = {b: [t / len(raws) for t in ts]
             for b, ts in turns_of(card, f"kernel 4, {name} (ms for all calls)", calls).items()}
    return {"g_nonzero": nonzero, "calls": len(raws), "max_abs_err": errs, "turns_ms": turns}


@torch.inference_mode()
def sort_turns(card, name, sorted_args, unsorted_args):
    """Kernel 1 (this build) on a step's tensors with the window sort and
    without: both held against the plain version, the same live pairs,
    timed in turns."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked

    live = [int(a[4].ne(0).sum()) for a in (sorted_args, unsorted_args)]
    if live[0] != live[1]:
        cs.fail(f"{name}: the sorted and unsorted masks differ in live pairs {live}")
    errs = [cs.kernel1_check(f"{name}, {k}", a)[0]
            for k, a in (("sorted", sorted_args), ("unsorted", unsorted_args))]
    print(f"[sort] {name}: {live[0]} live pairs either way; max|d| where mask==1 sorted "
          f"{errs[0]:.3e}, unsorted {errs[1]:.3e}")
    turns = turns_of(card, f"kernel 1, {name}", {
        "sorted": lambda: attention_scores_masked(*sorted_args),
        "unsorted": lambda: attention_scores_masked(*unsorted_args)})
    return {"live_pairs": live[0], "turns_ms": turns}


def shuffle_proposals(args, k=cs.BEAM, seed=0):
    """Kernel 1's args (pre, q, w, b, mask) with each video's proposals,
    k adjacent rows each, in a random order: an unsorted version of
    windows that were drawn sorted."""
    pre, q, w, b, mask = args
    B, N = q.shape[:2]
    gen = torch.Generator().manual_seed(seed)
    perm = torch.stack([torch.randperm(N // k, generator=gen) for _ in range(B)])
    rows = (perm[:, :, None] * k + torch.arange(k)).reshape(B, N, 1).to(q.device)

    def take(x):
        return torch.gather(x, 1, rows.expand(-1, -1, x.shape[2])).contiguous()
    return pre, take(q), w, b, take(mask)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", default=None,
                    help="a directory of kernel sources (*.cu) with the same C entry points")
    opts = ap.parse_args()
    card = cs.phase_device()
    libs = builds(opts.earlier)
    print(f"[1] builds, in the order of the turns: {list(libs)}")
    dev = torch.device("cuda")
    rec = {"card": card, "builds": list(libs), "kernel1": {}, "kernel4": {}, "sort": {}}

    k1 = rec["kernel1"]
    k1["phase2_synthetic"] = kernel1_builds(
        card, "phase-2 synthetic windows",
        cs.score_case_inputs(np.random.RandomState(0), "serving", dev), libs)
    greedy_sorted = cs.first_scores_args(cs.caption_service(1), cs.requests(32, seed=2))
    k1["greedy_slice"] = kernel1_builds(card, "one greedy step", greedy_sorted, libs)
    svc = cs.caption_service()
    keys = ("pre", "q", "w", "b", "mask")
    step = cs.beam_step_tensors(svc)
    beam_sorted = tuple(step[k] for k in keys)
    k1["beam_step"] = kernel1_builds(card, "the beam step", beam_sorted, libs)
    sw = cs.short_windows(step)
    short_sorted = tuple(sw[k] for k in keys)
    k1["beam_step_short_windows"] = kernel1_builds(
        card, "the beam step, short windows", short_sorted, libs)
    del sw, step

    rng = np.random.RandomState(5)  # phase 8's draw for its dense case
    B, N, T, H = cs.TRAIN_SHAPES["training"]
    k4 = rec["kernel4"]
    raw = cs._score_inputs(rng, B, N, T, H, dev)[:3] + (cs._rand(rng, (B, N, T), 1.0, dev),)
    k4["dense_g"] = kernel4_builds(card, "dense g", [raw], libs)
    raw = cs._score_inputs(rng, B, N, T, H, dev)[:3]
    g = cs._rand(rng, (B, N, T), 1.0, dev)
    g = g * torch.from_numpy(cs._windows_mask(rng, B, N, T)).to(dev)
    k4["windowed_g"] = kernel4_builds(card, "g zero outside windows", [raw + (g,)], libs)
    from echr_tpu_torch.engine.train import train

    out = train(cs.train_cfg(), max_iterations=2, device="cuda")
    k4["training_g"] = kernel4_builds(card, "one training step's cotangents",
                                      cs.training_cotangents(out), libs)
    del out

    srt = rec["sort"]
    greedy_unsorted = cs.first_scores_args(cs.caption_service(1, sort_decode_props=False),
                                           cs.requests(32, seed=2))
    srt["greedy_step"] = sort_turns(card, "one greedy step", greedy_sorted, greedy_unsorted)
    beam_unsorted = cs.beam_step_tensors(svc, sort=False)
    srt["beam_step"] = sort_turns(card, "the beam step", beam_sorted,
                                  tuple(beam_unsorted[k] for k in keys))
    srt["beam_step_short_windows"] = sort_turns(card, "the beam step, short windows",
                                                short_sorted, shuffle_proposals(short_sorted))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
