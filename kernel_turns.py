#!/usr/bin/env python3
"""Time kernels 1-10 of this checkout beside another build of their
sources, in turns on one NVIDIA GPU; kernels 1 and 3 on the paths' masks
with the proposals sorted by window start and unsorted.

    python3 kernel_turns.py [--earlier CSRC [--earlier CSRC2 ...]]

The builds, each a library with the same C entry points: "this", the
package's own (echr_tpu_torch/csrc), and with --earlier "earlier" (then
"earlier2", ... for more), every *.cu of CSRC, for example the parent
commit's kernel sources unpacked into a gitignored directory:

    mkdir -p echr_tpu_torch/_build/parent
    git archive HEAD~1 echr_tpu_torch/csrc | tar -x -C echr_tpu_torch/_build/parent
    python3 kernel_turns.py --earlier echr_tpu_torch/_build/parent/echr_tpu_torch/csrc

or a copy of the package's sources changed with sed, for example kernel
10 with its product warps inlined into the kernel:

    cp -r echr_tpu_torch/csrc echr_tpu_torch/_build/inlined
    sed -i 's/__noinline__ void product_warps(/__forceinline__ void product_warps(/' \
        echr_tpu_torch/_build/inlined/probe_score_overlap.cu
    python3 kernel_turns.py --earlier echr_tpu_torch/_build/inlined

or kernel 5 with eight warps a block in place of sixteen:

    cp -r echr_tpu_torch/csrc echr_tpu_torch/_build/warps8
    sed -i 's/WARPS = 16;/WARPS = 8;/; s/PAIRS = 1; /PAIRS = 2; /' \
        echr_tpu_torch/_build/warps8/attention_fused.cu

Kernel 1 runs at chip_smoke.py's four inputs (phase 2's synthetic
windows, one greedy step, the beam step, the beam step with short
windows), kernel 4 at three (a dense cotangent, one zero outside windows,
the cotangents of one training step after two), kernel 3 at three
(phase 7's every entry live and windows in random order, and the window
masks of that training step), kernel 2 at the serving shapes in bf16
(R=4096, C=1536, V1=6001; also its host time a call), kernels 7 and 8 at
the head probes' shapes (R=4096, C=1536, V1=6001 padded to the vocab
tile, bf16) at every tiling (kernel 7 is the (64, 512) one; also its host
time a call), kernels 9 and 10 and kernel 10's product warps alone at the
overlap probe's shapes (B=32, N=128, T=256, H=512, KD=2048), kernels 5
and 6 at chip_smoke.py's four inputs of the attention step (the beam
step, the beam step with short windows, the SOTA_TEP eval's first decode
step and a per-video decode step of eval_split, each made as phases 11,
27 and 29 make them; kernel 6 takes each row's window from the mask),
beside the kernel-1 route.  Every build is held against the plain
version (kernels 1 and 3 within 5e-4 where mask == 1; kernel 4 within
phase 8's gates; kernel 2 within phase 3's; kernels 7-8 tokens
bit-equal, max and lse within 5e-4; kernels 9-10 within 5e-4; kernel 5
within 2e-3 and kernel 6 within 5e-4, rows without a live frame exact
zeros: an earlier build of kernel 5 or 6 outside its gate is reported and
timed all the same), then all are timed in turns: each build in order,
then in reverse (CUDA events).  Kernels 5 and 6 of a build from before their
frame split and row groups are called through their earlier entry points
(EARLIER_SIGNATURES).  Last, kernel 1 of this build on
the greedy and the beam step with runtime.sort_decode_props on (as the
decode paths run) and off, and on the short windows sorted and with the
proposals shuffled (shuffle_proposals), and kernel 3 of this build on
the training step's masks as sampled and sorted by window start
(sort_windows; training does not sort), in turns.  The last line is a
JSON record of every time; each time printed stands beside the card's
name and power limit.
"""
import argparse
import ctypes
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernels 5 and 6's entry points before the frame split and the row groups:
# pre, q, w, b, mask, feats, out, B, N, T, H, D, stream and
# pre, feats, q, w, b, soi, out, B, N, T, H, D, stream
EARLIER_SIGNATURES = {"echr_attention_fused": [_P] * 7 + [_I] * 5 + [_P],
                      "echr_windowed_attention": [_P] * 7 + [_I] * 5 + [_P]}


def builds(earlier):
    """{name: library}, in the order they are timed: "earlier",
    "earlier2", ... for the directories of ``earlier``, then "this"."""
    from echr_tpu_torch.ops import native

    libs = {}
    for i, csrc in enumerate(earlier or ()):
        cu = sorted(Path(csrc).glob("*.cu"))
        if not cu:
            cs.fail(f"no *.cu in {csrc}")
        lib = native.load(native.build(cu))
        for name, argtypes in EARLIER_SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs["earlier" + (str(i + 1) if i else "")] = lib
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


def step_calls(lib, t):
    """(kernel 5, kernel 6) of ``lib`` on the attention step's tensors t
    (chip_smoke.step_inputs' keys) as calls without arguments: through
    this form's entry points with the wrappers' plans, or through the
    earlier form's (EARLIER_SIGNATURES)."""
    from echr_tpu_torch.ops.kernel_attention_step import (fused_on, fused_splits, windowed_on,
                                                          windowed_rows)

    pre, q, w, b, mask, feats, soi = (t[k] for k in ("pre", "q", "w", "b", "mask", "feats",
                                                      "soi"))
    B, T, H = pre.shape
    N, D = q.shape[1], feats.shape[2]
    dev = pre.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if hasattr(lib, "echr_attention_fused_splits"):
        splits, rows = fused_splits(B, N, T, D, sms), windowed_rows(B, N, sms)
        return (lambda: fused_on(lib, pre, q, w, b, mask, feats, splits),
                lambda: windowed_on(lib, pre, feats, q, w, b, soi, rows))

    def earlier(fn, *args):
        out = torch.empty(B, N, D, device=dev, dtype=torch.float32)
        rc = fn(*(a.data_ptr() for a in args), out.data_ptr(), B, N, T, H, D,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            cs.fail(f"an earlier build's kernel 5 or 6: cudaError {rc}")
        return out
    return (lambda: earlier(lib.echr_attention_fused, pre, q, w, b, mask, feats),
            lambda: earlier(lib.echr_windowed_attention, pre, feats, q, w, b, soi))


@torch.inference_mode()
def step_builds(card, name, t, libs):
    """Every build of kernels 5 and 6 at one input against the plain
    versions (FUSED_TOL and TOL, rows without a live frame exact zeros),
    then each kernel's builds timed in turns with the kernel-1 route.  An
    earlier build outside its gate is reported (``outside_gate``) and
    timed all the same; this build outside its gate fails the run."""
    from echr_tpu_torch.ops.kernel_attention_step import (attention_fused_plain,
                                                          windowed_attention_plain)

    want = (attention_fused_plain(t["pre"], t["q"], t["w"], t["b"], t["mask"], t["feats"]),
            windowed_attention_plain(t["pre"], t["feats"], t["q"], t["w"], t["b"], t["soi"],
                                     cs.WINDOW))
    lens = (t["soi"][..., 1] - t["soi"][..., 0]).clamp(min=0)
    empty = (~(t["mask"] > 0).any(-1), lens == 0)
    calls = {b: step_calls(lib, t) for b, lib in libs.items()}
    rec = {"density": float((t["mask"] > 0).float().mean()), "kernel5": {}, "kernel6": {}}
    for i, (k, gate) in enumerate(((5, cs.FUSED_TOL), (6, cs.TOL))):
        errs, outside = {}, []
        for b, fns in calls.items():
            got = fns[i]()
            errs[b] = float((got - want[i]).abs().max())
            if not errs[b] <= gate or bool(got[empty[i]].ne(0).any()):
                if b == "this":
                    cs.fail(f"kernel {k} {name}: max|d| {errs[b]:.3e} (gate {gate}), or a row "
                            f"without a live frame is not zero")
                outside.append(b)
        print(f"[k{k}] {name}: density {rec['density']:.3f}; max|d| "
              + ", ".join(f"{b} {e:.3e}" for b, e in errs.items())
              + (f"; OUTSIDE the gate {gate} or not zero on empty rows: {outside}"
                 if outside else ""))
        turns = turns_of(card, f"kernel {k}, {name}",
                         {**{b: fns[i] for b, fns in calls.items()},
                          "route": lambda: cs.kernel1_route(t)})
        rec[f"kernel{k}"] = {"max_abs_err": errs, "outside_gate": outside, "turns_ms": turns}
    return rec


def sota_step():
    """(pre, q, w, b, mask, feats) of the SOTA_TEP eval's first decode step
    as phase 27 keeps them: phase 18's corpus exported to a temporary
    directory, the proposals JSON, one group of 32 val videos decoded
    greedy from disk."""
    from echr_tpu_torch.data.export_disk import export_synthetic_corpus
    from echr_tpu_torch.engine import evaluate

    root = tempfile.mkdtemp(prefix="kernel_turns_sota_")
    kept = []
    try:
        paths = export_synthetic_corpus(cs.eval_cfg(), root, log_every=0)
        sota_path = f"{root}/sota_proposals.json"
        cs.write_sota_json(paths, sota_path)
        cfg, _, loader, tap, cg = cs.sota_loader(root, sota_path)
        kw = {"topN": cs.TOP_N, "num_vids_eval": cs.EVAL_B, "language_eval": False,
              "get_eval_loss": False}
        with cs.kept_attention_calls(kept, lambda a: not kept):
            evaluate.eval_split_batched(tap, cg, loader, cfg, f"{root}/w.json", kw,
                                        flag_eval_what="SOTA_TEP", batch_videos=cs.EVAL_B,
                                        device="cuda")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return kept[0]


def pervideo_step():
    """(pre, q, w, b, mask, feats) of the first per-video decode step of
    eval_split over phase 18's val split and weights (B=1, N=128 rows), as
    phase 29 keeps it."""
    from echr_tpu_torch.engine import evaluate

    cfg, tap, cg, _, loader = cs.eval_setup()
    kept = []
    kw = {"topN": cs.TOP_N, "num_vids_eval": 1, "language_eval": False, "get_eval_loss": False}
    with tempfile.TemporaryDirectory() as tmp, \
            cs.kept_attention_calls(kept, lambda a: not kept and a[1].shape[1] == cs.TOP_N):
        evaluate.eval_split(tap, cg, loader, cfg, f"{tmp}/p.json", kw, device="cuda")
    return kept[0]


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
def kernel3_builds(card, name, raws, libs):
    """Every build of kernel 3 over raws [(pre, q, w, b, mask), ...]
    against the plain version where mask == 1, then timed in turns (ms a
    call)."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_dense_plain, dense_scores_on

    errs = {b: 0.0 for b in libs}
    for raw in raws:
        want = attention_scores_dense_plain(*raw[:4])
        m = raw[4] > 0
        for b, lib in libs.items():
            errs[b] = max(errs[b], float((dense_scores_on(lib, *raw) - want).abs()[m].max()))
            if not errs[b] <= cs.TOL:
                cs.fail(f"kernel 3 {name}, build {b}: max|d| {errs[b]:.3e} > {cs.TOL}")
        del want
    density = sum(int(r[4].ne(0).sum()) for r in raws) / sum(r[4].numel() for r in raws)
    print(f"[k3] {name}: {len(raws)} call(s), density {density:.4f}; max|d| where mask==1 "
          + ", ".join(f"{b} {e:.3e}" for b, e in errs.items()))
    calls = {b: (lambda lib=lib: [dense_scores_on(lib, *raw) for raw in raws])
             for b, lib in libs.items()}
    turns = {b: [t / len(raws) for t in ts]
             for b, ts in turns_of(card, f"kernel 3, {name} (ms for all calls)", calls).items()}
    return {"density": density, "calls": len(raws), "max_abs_err": errs, "turns_ms": turns}


@torch.inference_mode()
def kernel2_builds(card, libs):
    """Every build of kernel 2 at the serving shapes in bf16 against the
    plain version (phase 3's gates), then timed in turns; and each build's
    host time a call."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_head import greedy_head, head_on

    dev = torch.device("cuda")
    out, w, b = cs.head_inputs(np.random.RandomState(1), 4096, 1536, 6001, torch.bfloat16, dev)
    a = out.to(torch.bfloat16)
    with force_plain():
        ptok, pmx, plse = greedy_head(a, w, b)
        top2 = torch.topk(torch.matmul(a.float(), w.float().t()) + b, 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    errs = {}
    for name, lib in libs.items():
        tok, mx, lse = head_on(lib, a, w, b)
        bad = int((tok != ptok)[clear].sum())
        errs[name] = max(float((mx - pmx).abs().max()), float((lse - plse).abs().max()))
        if bad or not errs[name] <= cs.TOL:
            cs.fail(f"kernel 2, build {name}: {bad} token mismatches, max|d| {errs[name]:.3e}")
    print(f"[k2] R=4096 C=1536 V1=6001 bf16: tokens equal on the {int(clear.sum())} rows with "
          f"top-2 gap > 1e-3; max|d| max/lse " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    calls = {k: (lambda lib=lib: head_on(lib, a, w, b)) for k, lib in libs.items()}
    turns = turns_of(card, "kernel 2, R=4096 C=1536 V1=6001 bf16", calls)
    host = {k: cs.host_us(fn) for k, fn in calls.items()}
    print("  kernel 2 host time a call: " + ", ".join(f"{k} {u:.1f} us" for k, u in host.items())
          + f" [{card}]")
    return {"max_abs_err": errs, "turns_ms": turns, "host_us_per_call": host}


@torch.inference_mode()
def stream_builds(card, libs):
    """Every build of kernels 7-8 at every tiling at the head probes'
    shapes against the plain version (tokens bit-equal, max and lse within
    TOL), then timed in turns; and each build's host time a call at kernel
    7's plan."""
    from echr_tpu_torch.experiments import probe_greedy_head as pg
    from echr_tpu_torch.ops.kernel_probe_head import (PLAN, TILINGS, pad_probe_head,
                                                      stream_head_on, stream_head_plain)

    w, b, out0 = pg.probe_inputs(pg.B, pg.N, pg.C, pg.V1, 0, torch.device("cuda"))
    a = out0.to(torch.bfloat16)
    rec = {}
    for tr, tv in TILINGS:
        wp, bp = pad_probe_head(w, b, tv)
        want = stream_head_plain(a, wp, bp)
        errs = {}
        for name, lib in libs.items():
            c = pg.check_head(stream_head_on(lib, a, wp, bp, tr, tv), want)
            errs[name] = max(c["max_abs_err_max"], c["max_abs_err_lse"])
            if c["token_mismatches"] or not errs[name] <= cs.TOL:
                cs.fail(f"kernels 7-8 at {(tr, tv)}, build {name}: {c}")
        del want
        tag = f"{tr}x{tv}"
        print(f"[k8] {tag} R={a.shape[0]} C={pg.C} VP={wp.shape[1]}: tokens bit-equal, max|d| "
              f"max/lse " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
        calls = {k: (lambda lib=lib: stream_head_on(lib, a, wp, bp, tr, tv))
                 for k, lib in libs.items()}
        kernel = 7 if (tr, tv) == PLAN else 8
        rec[tag] = {"max_abs_err": errs, "turns_ms": turns_of(card, f"kernel {kernel}, {tag}",
                                                              calls)}
    wp, bp = pad_probe_head(w, b, PLAN[1])
    host = {k: cs.host_us(lambda lib=lib: stream_head_on(lib, a, wp, bp, *PLAN))
            for k, lib in libs.items()}
    print("  kernel 7 host time a call: " + ", ".join(f"{k} {u:.1f} us" for k, u in host.items())
          + f" [{card}]")
    return {"tilings": rec, "host_us_per_call": host}


@torch.inference_mode()
def scores_builds(card, libs):
    """Every build of kernels 9 and 10, and of kernel 10's product warps
    alone, at the overlap probe's shapes (B=32, N=128, T=256, H=512,
    KD=2048) against the plain versions (within 5e-4), then timed in
    turns."""
    from echr_tpu_torch.experiments import probe_mxu_vpu_overlap as pm
    from echr_tpu_torch.ops.kernel_probe_scores import (probe_dot_plain, probe_scores_on,
                                                        probe_scores_plain)

    dev = torch.device("cuda")
    rng = np.random.RandomState(17)  # chip_smoke phase 17's draw
    pre, q = cs._rand(rng, (pm.B, pm.T, pm.H), 0.5, dev), cs._rand(rng, (pm.B, pm.N, pm.H), 0.5,
                                                                   dev)
    w, wd = cs._rand(rng, (pm.H,), 0.05, dev), cs._rand(rng, (pm.H, pm.KD), 0.05,
                                                        dev).to(torch.bfloat16)
    want_s, want_d = probe_scores_plain(pre, q, w), probe_dot_plain(q, wd, pm.T)
    cases = {"kernel 9": (pre, q, w), "kernel 10": (pre, q, w, wd),
             "kernel 10's product alone": (pre, q, w, wd, False)}
    rec = {}
    for what, args in cases.items():
        errs = {}
        for name, lib in libs.items():
            s, d = probe_scores_on(lib, *args)
            errs[name] = max(0.0 if s is None else float((s - want_s).abs().max()),
                             0.0 if d is None else float((d - want_d).abs().max()))
            if not errs[name] <= cs.TOL:
                cs.fail(f"{what}, build {name}: max|d| {errs[name]:.3e} > {cs.TOL}")
        print(f"[k9-10] {what} B={pm.B} N={pm.N} T={pm.T} H={pm.H} KD={pm.KD}: max|d| "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
        calls = {k: (lambda lib=lib, args=args: probe_scores_on(lib, *args))
                 for k, lib in libs.items()}
        rec[what] = {"max_abs_err": errs, "turns_ms": turns_of(card, what, calls)}
    return rec


@torch.inference_mode()
def sort_turns(card, name, sorted_args, unsorted_args, kernel=1):
    """Kernel 1 or 3 (this build) on a step's tensors, lists of (pre, q,
    w, b, mask), with the proposals sorted by window start and without:
    both held against the plain version, the same live pairs, timed in
    turns (ms a call)."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_dense, attention_scores_masked

    fn, check = {1: (attention_scores_masked, cs.kernel1_check),
                 3: (attention_scores_dense, cs.kernel3_check)}[kernel]
    cases = {"sorted": sorted_args, "unsorted": unsorted_args}
    live = [sum(int(a[4].ne(0).sum()) for a in args) for args in cases.values()]
    if live[0] != live[1]:
        cs.fail(f"{name}: the sorted and unsorted masks differ in live pairs {live}")
    errs = [max(check(f"{name}, {k}", a)[0] for a in args) for k, args in cases.items()]
    print(f"[sort] {name}: {live[0]} live pairs either way; max|d| where mask==1 sorted "
          f"{errs[0]:.3e}, unsorted {errs[1]:.3e}")
    turns = turns_of(card, f"kernel {kernel}, {name} (ms for all calls)",
                     {k: (lambda args=args: [fn(*a) for a in args]) for k, args in cases.items()})
    return {"live_pairs": live[0], "calls": len(sorted_args),
            "turns_ms": {k: [t / len(sorted_args) for t in ts] for k, ts in turns.items()}}


def shuffle_proposals(args, k=cs.BEAM, seed=0):
    """Kernel 1's args (pre, q, w, b, mask) with each video's proposals,
    k adjacent rows each, in a random order: an unsorted version of
    windows that were drawn sorted."""
    B, N = args[1].shape[:2]
    gen = torch.Generator().manual_seed(seed)
    perm = torch.stack([torch.randperm(N // k, generator=gen) for _ in range(B)])
    rows = (perm[:, :, None] * k + torch.arange(k)).reshape(B, N, 1).to(args[1].device)
    return take_rows(args, rows)


def sort_windows(args):
    """Kernel 1 or 3's args (pre, q, w, b, mask) with each video's
    proposals sorted by the first frame of their window (rows with none
    last), as the decode paths sort theirs."""
    live = args[4].ne(0)
    start = torch.where(live.any(2), live.float().argmax(2), live.shape[2])
    return take_rows(args, start.argsort(dim=1, stable=True)[..., None])


def take_rows(args, rows):
    """(pre, q, w, b, mask) with the proposals of q and mask taken in the
    order rows [B, N, 1]."""
    pre, q, w, b, mask = args

    def take(x):
        return torch.gather(x, 1, rows.expand(-1, -1, x.shape[2])).contiguous()
    return pre, take(q), w, b, take(mask)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", action="append",
                    help="a directory of kernel sources (*.cu) with the same C entry points; "
                         "may be given more than once")
    opts = ap.parse_args()
    card = cs.phase_device()
    libs = builds(opts.earlier)
    print(f"[1] builds, in the order of the turns: {list(libs)}")
    dev = torch.device("cuda")
    rec = {"card": card, "builds": list(libs), "kernel1": {}, "kernel4": {}, "kernel3": {},
           "sort": {}}
    rec["kernel2"] = kernel2_builds(card, libs)
    rec["kernel78"] = stream_builds(card, libs)
    rec["kernel9_10"] = scores_builds(card, libs)

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
    rec["kernel5_6"] = {"beam_step": step_builds(card, "the beam step", step, libs),
                        "beam_step_short_windows": step_builds(
                            card, "the beam step, short windows", sw, libs)}
    del sw, step
    for key, name, make in (("sota_eval", "the SOTA_TEP eval's first decode step", sota_step),
                            ("per_video", "a per-video decode step", pervideo_step)):
        rec["kernel5_6"][key] = step_builds(card, name, cs.step_inputs(make()), libs)

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
    fwd, bwd = cs.training_step_inputs(out)
    del out
    k4["training_g"] = kernel4_builds(card, "one training step's cotangents", bwd, libs)
    del bwd
    k3 = rec["kernel3"]
    k3["training_masks"] = kernel3_builds(card, "one training step's window masks", fwd, libs)
    rec["sort"]["training_masks"] = sort_turns(card, "one training step's window masks",
                                               [sort_windows(a) for a in fwd], fwd, kernel=3)
    del fwd
    phase7 = cs.kernel3_inputs(np.random.RandomState(4), dev)
    k3["all_live"] = kernel3_builds(card, "training shapes, every entry live",
                                    [phase7["all_live"]], libs)
    k3["windows"] = kernel3_builds(card, "training shapes, windows of 4-47 frames in random "
                                   "order", [phase7["windows"]], libs)
    del phase7

    srt = rec["sort"]
    greedy_unsorted = cs.first_scores_args(cs.caption_service(1, sort_decode_props=False),
                                           cs.requests(32, seed=2))
    srt["greedy_step"] = sort_turns(card, "one greedy step", [greedy_sorted], [greedy_unsorted])
    beam_unsorted = cs.beam_step_tensors(svc, sort=False)
    srt["beam_step"] = sort_turns(card, "the beam step", [beam_sorted],
                                  [tuple(beam_unsorted[k] for k in keys)])
    srt["beam_step_short_windows"] = sort_turns(card, "the beam step, short windows",
                                                [short_sorted], [shuffle_proposals(short_sorted)])
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
