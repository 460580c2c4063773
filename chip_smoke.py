#!/usr/bin/env python3
"""Drive echr_tpu_torch's batched greedy and beam serving paths, its XE
training path, its three probes and its batched eval loop once on one
NVIDIA GPU, and hold every kernel against its plain PyTorch version.

    python3 chip_smoke.py

kernel_turns.py times kernels 1-4 and 7-10 beside another build of their
sources (a parent commit's) in turns; this script times this checkout's
kernels alone.

Phases, in order; any failure raises and the script exits non-zero:

  1. device: require CUDA, print the card's name and power limit, build
     the CUDA kernels from echr_tpu_torch/csrc into echr_tpu_torch/_build;
  2. kernel 1 (masked attention scores) against its plain PyTorch version
     at the serving shapes, ragged shapes, all-masked, all-unmasked, an
     unsorted mask and a mask with holes inside windows (masked entries
     must be 0), and at the serving shape with every entry live, whose
     time gives the rate of kernel 1's tanh; then its tanh itself
     (csrc/tanh.cuh): kernel 1 at H=1 (w=1, q=0, b=0) returns it exactly,
     swept over [-10, 10] and small |x| against float64 (max abs error at
     most 2.4e-7, 2 ulp of 1.0);
  3. kernel 2 (streaming greedy head) against its plain version at the
     serving shapes in bf16 and f32, ragged shapes (a width that is not a
     multiple of 8 included: w padded once, out per call), and exact ties
     within a tile, across tiles of one vocab split and across splits;
  4. the greedy slice: CaptionService at the flagship width (vocab 6000,
     30 steps) from the port's seeded init captions 64 requests of 256 x
     500 C3D features (two chunks of 32 videos, top-128 proposals: 4096
     decode rows); both kernels' launch counts must equal the decode steps;
  5. greedy parity: at f32 with TF32 off and sharpened logit weights, the
     slice with the kernels and under force_plain() gives the same tokens
     and logps within 5e-4;
  6. times: kernel against plain version (CUDA events after warm-up) and
     the slice's captions/s, each beside the card's name and power limit;
     kernel 2 in turns with the bare bf16 torch.matmul over the same out
     and w, unpadded and with the vocab padded to a multiple of 8 (a
     yardstick, not the head's function), and its host time a call;
     kernel 1 at four inputs, phase 2's synthetic windows, one greedy
     step's tensors of phase 4 and (after phase 10) the beam path's step
     tensors with their own and with short windows, each held against
     its plain version and timed with its live-work bound, the tanh the
     design evaluates there over the tanh the mask needs (modelled from
     the mask), and at the end the tanh-rate floor (live tanh over the
     all-live rate of phase 2);
  7. kernel 3 (differentiable scores, forward, window-masked) against its
     plain version wherever mask == 1, masked entries exactly 0: at the
     training shapes with every entry live and with phase 2-style windows
     of 4-47 frames in random order, and at a ragged shape; its time at
     the first two beside its live-work bound;
  8. kernel 4 (their backward) against the autograd of the plain forward at
     the same shapes with a dense cotangent and with one that is zero
     outside sorted windows (N=64), and two calls bit-identical; its time
     with both;
  9. the training slice: engine.train.train at the flagship width as
     bench.py's e2e_train_cfg builds it (B=32 videos of T=256, cotrain /
     tap_cg, vocab 6000, bf16, dropout on, seeded): 1 warm-up and 5 timed
     steps; finite losses, moved parameters, and kernel 3 and 4 launches
     equal to the teacher-forced steps run; time/step, videos/s and peak
     memory; then one more step with wrappers that keep kernels 3 and 4's
     inputs: the density of the step's 29 window masks and the share of
     nonzero cotangent entries, each kernel held against its plain version
     and timed on the step's own inputs;
  10. training parity: at f32 with TF32 off and dropout off, one step's
     loss and gradients with the kernels and under force_plain() agree;
  11. kernel 5 (the fused attention step) through
     additive_attention_step(fused=True) on the beam path's step tensors
     (32 requests, window-sorted, k=4: N*k=512 rows, T=256, Hatt=512,
     D=500, bf16), against its plain version within 2e-3, a ragged shape
     and a fully-masked row; its time beside the kernel-1 route's (kernel 1
     + masked_softmax + the bf16 AV product), in turns;
  12. kernel 6 (windowed attention) on the same tensors with the sorted
     windows and W=64, against its plain version within 5e-4, with
     zero-length windows, windows that end at T and a ragged shape; its
     time beside the kernel-1 route's;
  13. the beam slice: CaptionService(beam_size=4) at the flagship width on
     64 requests (two chunks of 32 videos, top-128 proposals: 16384 beam
     rows a chunk) after a warm-up chunk; kernel 1's launches must equal
     the beam steps run; captions/s, ms per chunk, early-exit syncs, peak
     memory, and one chunk's decode under torch.profiler, with kernel 1's
     device ms over the chunk;
  14. beam parity: at f32 with TF32 off and phase 5's weights, beam 4 with
     the kernels and under force_plain() gives identical tokens for every
     beam and best logprobs within 5e-4; with the weights sharpened 16x
     more, beam 1 gives the greedy tokens;
  15. kernel 7 (the head probes' streaming head at its plan, TR=64, TV=512)
     against its plain version at the probe's shapes (R=4096, C=1536,
     V1=6001 padded to 6144, bf16; tokens bit-equal, max and lse within
     5e-4), a ragged R and exact ties within and across vocab tiles; its
     time and the bytes its plan reads through L2 (modelled); then
     probe_greedy_head: X0, XM (and both over the padded vocab), K1
     (kernel 7) and K2 (kernel 2) ms a step;
  16. kernel 8, every instantiated tiling, against its plain version at a
     ragged R, then probe_streaming_head2: each tiling checked at the
     probe's shapes, then X0, XM, X0p, XMp and every tiling in interleaved
     windows; exact ties at every tiling; each tiling's time a call and
     the bytes its plan reads through L2 (modelled);
  17. kernels 9 and 10, and kernel 10's product warps alone, against their
     plain versions at B=32, N=128, T=256, H=512, KD=2048, a ragged shape
     and a shape with N and T both off the kernels' 64 x 128 block at the
     narrowest product (KD=128), and kernel 10 at the probe's KD=8192; their
     times (kernel 10 also at KD=8192) beside the bound, the SFU floor
     (two SFU ops a tanh at the data sheet's 16 a clock an SM, at
     clocks.max.sm: modelled, printed and kept out of the record) and, at
     the end, the tanh-rate floor (phase 2's rate); then probe_mxu_vpu_overlap: S0, S1,
     SD and S2 at KD=2048 and 8192.  In 15-17 each kernel's launches over
     the probe's run must equal the calls the probe made;
  18. the eval slice: engine.evaluate.eval_split_batched over the 64-video
     val split of train_cfg()'s 256 synthetic videos (the flagship width,
     random weights from a seed), tap_cg, top-128, 32 videos a group,
     every metric: greedy with val losses, then beam 4 decode-only.  Every
     usable val video has predictions (at most 128, well-formed timestamps,
     sentences in the vocab, re_score = 10 x proposal_score +
     sentence_confidence), the val losses are finite, the scores hold every
     metric at the four tIoUs; kernel 1's launches equal the decode steps
     plus the val losses' teacher-forced steps (29 a group), kernel 2's the
     greedy decode steps; TF32 is still off after each pass (the prep
     thread's bf16 products and the caller's overlap).  For each pass,
     after a warm-up group: eval videos/s and captions/s without scoring,
     the timing_out breakdown, the seconds in eval_score and its stemmer,
     peak device memory;
  19. eval parity: at f32 with TF32 off and phase 5's sharpened logit
     weights, the greedy eval with the kernels and under force_plain()
     gives the same sentences, timestamps and proposal scores for every
     video, sentence confidences within 5e-4 a token and val losses within
     1e-5 relative.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import contextlib
import functools
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = 5e-4
FUSED_TOL = 2e-3  # kernel 5: bf16 weights from the running max (echr_tpu's gate)
T_BUCKET, VIDEO_DIM, VOCAB, SEQ_LEN, TOP_N = 256, 500, 6000, 30, 128
TRAIN_B, TRAIN_N, TRAIN_STEPS = 32, 64, 6  # videos, sampled proposals, steps (1 warm-up)
EVAL_B = 32  # videos a group of the batched eval
BEAM, WINDOW = 4, 64  # beam width; kernel 6's W
# published H100 SXM peaks (NVIDIA's data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}
# special-function unit: 16 results a clock an SM (CUDA C++ Programming Guide,
# arithmetic instructions, compute capability 9.0); echr_tanh takes two
SFU_OPS_PER_CLOCK_SM, SFU_OPS_PER_TANH = 16, 2


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, **ops):
    """The least time the card could take: the larger of the bytes over the
    memory rate (each input read once, each output written once) and the
    operations over the peak rate of their type, summed over the types
    (``ops`` by type: f32=..., bf16=...).  No single PyTorch call
    computes any of the port's kernels' functions (additive scores are not
    scaled_dot_product_attention's form; the greedy head is a product with
    an argmax, max and logsumexp), so library_ms is null for each."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
            "bytes": n_bytes, "ops": sum(ops.values())}


def in_turns(calls):
    """Each of ``calls`` (name -> fn) timed in order and then in reverse
    order (a, b, b, a): two CUDA-event means a name, in one call."""
    times = {name: [] for name in calls}
    for name in [*calls, *reversed(calls)]:
        times[name].append(cuda_ms(calls[name]))
    return times


@contextlib.contextmanager
def wrapped(module, name, hook):
    """Within the block, module.name(*args) first calls hook(*args)."""
    fn = getattr(module, name)

    @functools.wraps(fn)  # with its attributes: fn counts its launches on its global name
    def wrapper(*args):
        hook(*args)
        return fn(*args)
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over ``iters`` launches, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    """Require CUDA, print the card, build the kernels; returns the card's
    name and power limit as nvidia-smi prints them."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from echr_tpu_torch.ops import native

    t0 = time.time()
    native.library()
    print(f"[1] kernels built in {time.time() - t0:.1f} s into {native.BUILD_DIR}")
    for line in native.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    ptxas:", line.strip())
    return card


def _windows_mask(rng, B, N, T, shuffle=False):
    """Sorted proposal windows drawn as bench.py draws them -> [B, N, T];
    with ``shuffle`` each video's windows in random order."""
    masks = np.zeros((B, N, T), np.float32)
    for b in range(B):
        starts = np.sort(rng.randint(0, T - 8, size=N))
        if shuffle:
            starts = rng.permutation(starts)
        lens = rng.randint(4, 48, size=N)
        ends = np.minimum(starts + lens, T)
        t = np.arange(T)[None, :]
        masks[b] = (t >= starts[:, None]) & (t < ends[:, None])
    return masks


def _mask_of_windows(B, N, T, soi):
    """[B, N, T] f32 mask of the windows soi [B, N, 2] (any order)."""
    t = np.arange(T)[None, None, :]
    return ((t >= soi[..., :1]) & (t < soi[..., 1:])).astype(np.float32)


# kernel 1's exactness cases: (B, N, T, H, mask kind)
SCORE_CASES = {
    "serving": (32, 128, 256, 512, "windows"),
    "ragged": (3, 120, 200, 500, "windows"),
    "all_masked": (2, 40, 96, 64, "none"),
    "all_unmasked": (2, 40, 96, 64, "all"),
    "unsorted": (4, 130, 256, 512, "unsorted"),
    "holes": (3, 77, 250, 300, "holes"),
}


def _case_mask(rng, kind, B, N, T):
    """windows: sorted, 4-47 frames (_windows_mask); unsorted: windows of
    1-120 frames in random order; holes: those with 30% of their frames
    masked out; none / all: every entry 0 / 1."""
    if kind == "windows":
        return _windows_mask(rng, B, N, T)
    if kind in ("none", "all"):
        return np.full((B, N, T), float(kind == "all"), np.float32)
    m = _mask_of_windows(B, N, T, _random_windows(rng, B, N, T, 120))
    return m * (rng.rand(B, N, T) > 0.3) if kind == "holes" else m


def score_case_inputs(rng, name, dev):
    """(pre, q, w, b, mask) of kernel 1's exactness case ``name``
    (SCORE_CASES), drawn from ``rng``: the mask first, then pre, q, w."""
    B, N, T, H, kind = SCORE_CASES[name]
    mask = torch.from_numpy(_case_mask(rng, kind, B, N, T)).to(dev)
    pre = _rand(rng, (B, T, H), 0.5, dev)
    q = _rand(rng, (B, N, H), 0.5, dev)
    return pre, q, _rand(rng, (H,), 0.05, dev), torch.tensor([0.25], device=dev), mask


def kernel1_check(name, args, want=None):
    """Kernel 1 on args (pre, q, w, b, mask) against its plain version
    (or ``want``): within TOL wherever mask == 1, masked entries 0.
    Returns (max |d| where mask == 1, the kernel's output)."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked

    return masked_check(1, attention_scores_masked, name, args, want)


def kernel3_check(name, args):
    """Kernel 3 on args (pre, q, w, b, mask), as kernel1_check: its plain
    version computes the scores everywhere, the kernel only at mask == 1."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_dense

    return masked_check(3, attention_scores_dense, name, args)


def masked_check(k, fn, name, args, want=None):
    from echr_tpu_torch.ops import force_plain

    got = fn(*args)
    torch.cuda.synchronize()
    if want is None:
        with force_plain():
            want = fn(*args)
    m = args[4] > 0
    err = float((got - want).abs()[m].max()) if bool(m.any()) else 0.0
    if bool(got[~m].ne(0).any()):
        fail(f"kernel {k} {name}: a masked entry is not 0")
    if not err <= TOL:
        fail(f"kernel {k} {name}: max|d| {err:.3e} > {TOL}")
    return err, got


def phase_scores(card):
    """Kernel 1 at every SCORE_CASES mask; at the serving shape also with
    every entry live, whose time gives the rate of its tanh (the floor of
    kernels 1, 3 and 4); then the tanh sweep."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked

    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    worst = 0.0
    for name, (B, N, T, H, kind) in SCORE_CASES.items():
        args = score_case_inputs(rng, name, dev)
        err, _ = kernel1_check(name, args)
        worst = max(worst, err)
        print(f"[2] scores {name} B={B} N={N} T={T} H={H} (mask density "
              f"{float(args[4].mean()):.3f}): max|d| where mask==1 {err:.3e}, masked entries 0")
        if name != "serving":
            continue
        record = kernel1_timing(card, "phase-2 synthetic windows", args)
        with force_plain():
            want = attention_scores_masked(*args)
            record["plain_ms"] = cuda_ms(lambda: attention_scores_masked(*args), iters=5)
        print(f"[6] scores plain version {record['plain_ms']:.4f} ms [{card}]")
        live = args[:4] + (torch.ones_like(args[4]),)
        err, _ = kernel1_check("serving, all live", live, want)
        worst = max(worst, err)
        all_live_ms = cuda_ms(lambda: attention_scores_masked(*live))
        record.update(all_live_ms=all_live_ms, tanh_per_ms=B * N * T * H / all_live_ms)
        print(f"[2] scores serving, every entry live: max|d| {err:.3e}; {all_live_ms:.4f} ms, "
              f"{record['tanh_per_ms'] / 1e6:.1f} M tanh a ms: the rate of the tanh-rate floors "
              f"of kernels 1, 3 and 4 [{card}]")
    record["max_abs_err"] = worst
    record["tanh_max_abs_err"] = tanh_sweep()
    return record


def tanh_sweep():
    """Kernel 1 at H=1 with w=1, q=0 and b=0 returns its tanh of pre
    exactly (its other lanes add 0): the device tanh in use, held to
    float64 over a dense sweep of [-10, 10] and of |x| from 1e-38 to 1,
    both signs (experiments/probe_tanh.sweep_error)."""
    from echr_tpu_torch.experiments.probe_tanh import TANH_TOL, sweep_error

    err, at, n = sweep_error(torch.device("cuda"))
    print(f"[2] tanh sweep, {n} points of [-10, 10] and +-[1e-38, 1]: max|tanh - tanh "
          f"(float64)| {err:.3e} at x = {at:.9g} (gate {TANH_TOL})")
    if not err <= TANH_TOL:
        fail(f"the device tanh is off by {err:.3e} > {TANH_TOL}")
    return err


def kernel1_tanh(mask, H):
    """Tanh per call of kernel 1 on ``mask`` [B, N, T] at width H, counted
    from the mask, not on the card: what the mask needs (live pairs x H);
    what this design evaluates by its rule (live pairs x H padded to its
    chunk of hidden units: 128, 256 or multiples of 512); what the earlier
    tiled design (kernel 1 before its lanes ran over hidden units)
    evaluated by its rule (16 rows x 32 frames x H for every 16 x 32 tile
    with a 1)."""
    live = mask.ne(0)
    B, N, T = live.shape
    pairs = int(live.sum())
    chunk = 128 if H <= 128 else 256 if H <= 256 else 512
    tiles = torch.nn.functional.pad(live.float(), (0, -T % 32, 0, -N % 16))
    tiles = tiles.reshape(B, -(-N // 16), 16, -(-T // 32), 32)
    return {"tanh_needed": pairs * H, "tanh_modelled": pairs * -(-H // chunk) * chunk,
            "tanh_modelled_tiled": int(tiles.amax(dim=(2, 4)).sum()) * 16 * 32 * H}


def kernel1_timing(card, name, args):
    """Kernel 1 at one input (pre, q, w, b, mask): held against its plain
    version (kernel1_check), its time, its live-work bound and its tanh."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked

    pre, q, mask = args[0], args[1], args[4]
    B, T, H = pre.shape
    N = q.shape[1]
    err, out = kernel1_check(name, args)
    work = kernel1_tanh(mask, H)
    # per live (n, t, h): add, tanh, multiply, add
    rec = {"B": B, "N": N, "T": T, "H": H, "density": work["tanh_needed"] / (mask.numel() * H),
           "max_abs_err": err, **work,
           **bound(nbytes(*args, out), f32=4.0 * work["tanh_needed"])}
    rec["ms"] = cuda_ms(lambda: attention_scores_masked(*args))
    need = max(work["tanh_needed"], 1)
    print(f"[6] kernel 1, {name} B={B} N={N} T={T} H={H} (density {rec['density']:.3f}): "
          f"max|d| where mask==1 {err:.3e}; {rec['ms']:.4f} ms, live-work bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); tanh by the design's rule / needed "
          f"{work['tanh_modelled'] / need:.3f} (the earlier tiled design "
          f"{work['tanh_modelled_tiled'] / need:.3f}) [{card}]")
    return rec


def host_us(fn, calls=50):
    """Host time a call of fn() (the enqueue, without a synchronise), in
    microseconds, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def head_inputs(rng, R, C, V1, dtype, dev):
    """(out f32 [R, C], w [V1, C] in ``dtype``, b f32 [V1]); bf16 w padded
    to a multiple of 8 columns as prepare_head pads it."""
    from echr_tpu_torch.ops.kernel_head import pad_head_width

    out = torch.from_numpy(np.tanh(rng.randn(R, C)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(-0.1, 0.1, (V1, C)).astype(np.float32))
    b = torch.from_numpy((rng.randn(V1) * 0.1).astype(np.float32)).to(dev)
    w = w.to(dev).to(dtype)
    if dtype == torch.bfloat16:
        w = pad_head_width(w)
    return out, w.contiguous(), b


def phase_head(card):
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_head import greedy_head, split_plan

    rng = np.random.RandomState(1)
    dev = torch.device("cuda")

    def compare(name, args):
        tok, mx, lse = outs = greedy_head(*args)
        torch.cuda.synchronize()
        with force_plain():
            ptok, pmx, plse = greedy_head(*args)
            C = args[0].shape[1]
            logits = torch.matmul(args[0].to(args[1].dtype).float(),
                                  args[1][:, :C].float().t()) + args[2]
        top2 = torch.topk(logits, 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3
        bad = int((tok != ptok)[clear].sum())
        err = max(float((mx - pmx).abs().max()), float((lse - plse).abs().max()))
        print(f"[3] head {name}: {bad} token mismatches on {int(clear.sum())}/{len(clear)} "
              f"rows with top-2 gap > 1e-3; max|d| max/lse {err:.3e}")
        if bad or not err <= TOL:
            fail(f"kernel 2 {name} disagrees with its plain version")
        return err, outs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for name, (R, C, V1, dtype) in {
        "serving_bf16": (4096, 1536, 6001, torch.bfloat16),
        "serving_f32": (4096, 1536, 6001, torch.float32),
        "ragged_bf16": (1000, 200, 777, torch.bfloat16),
        "ragged_unaligned_bf16": (77, 36, 130, torch.bfloat16),
        "ragged_f32": (77, 36, 130, torch.float32),
        "ragged_unaligned_f32": (33, 30, 70, torch.float32),
    }.items():
        args = head_inputs(rng, R, C, V1, dtype, dev)
        err, outs = compare(name, args)
        worst = max(worst, err)
        if name == "serving_bf16":
            record = head_timing(card, args, outs, split_plan(R, V1, sms, dtype))

    # exact ties from integer-valued sums: columns 3 and 11 in one thread's
    # columns of the first tile, 5 in another thread's, 300 in the second
    # tile, 1031 and 2000 in later ones.  At 64 rows every tile is a vocab
    # split of its own; at 4096 rows (4 splits in bf16, 8 in f32) 300 shares
    # a split with the first tile in bf16.  The first index wins.
    C, V1 = 16, 2048
    w = torch.zeros(V1, C)
    for col in (3, 5, 11, 300, 1031, 2000):
        w[col] = 1.0
    for R in (64, 4096):
        for dtype in (torch.bfloat16, torch.float32):
            tok, mx, _ = greedy_head(torch.ones(R, C, device=dev),
                                     w.to(dev).to(dtype).contiguous(),
                                     torch.zeros(V1, device=dev))
            if not (bool((tok == 3).all()) and bool((mx == C).all())):
                fail(f"kernel 2 tie (R={R}, {dtype}): tokens {tok.unique().tolist()}")
    print("[3] head ties: the first index wins (bf16, f32; within a tile, across tiles and "
          "across splits)")
    record["max_abs_err"] = worst
    return record


def head_timing(card, args, outs, plan):
    """Kernel 2 on bf16 core outputs (the cast is not timed) in turns with
    the bare bf16 product over the same out and w, unpadded and with the
    vocab padded to a multiple of 8; its plain version; its host time a
    call (the tensor maps are encoded per call)."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_head import greedy_head

    out, w, b = args
    R, C = out.shape
    V1 = w.shape[0]
    a = out.to(torch.bfloat16)
    w8 = torch.nn.functional.pad(w, (0, 0, 0, -V1 % 8))
    turns = in_turns({"kernel": lambda: greedy_head(a, w, b),
                      "matmul": lambda: torch.matmul(a, w.t()),
                      "matmul_vocab_pad8": lambda: torch.matmul(a, w8.t())})
    mean = {k: sum(v) / 2 for k, v in turns.items()}
    with force_plain():
        plain_ms = cuda_ms(lambda: greedy_head(a, w, b), iters=10)
    record = {"ms": mean["kernel"], "plain_ms": plain_ms, "turns_ms": turns,
              "matmul_ms": mean["matmul"], "matmul_vocab_pad8_ms": mean["matmul_vocab_pad8"],
              "host_us_per_call": host_us(lambda: greedy_head(a, w, b)),
              "tiles_per_split": plan[0], "splits": plan[1],
              **bound(nbytes(a, w, b, *outs), bf16=2.0 * R * C * V1)}
    print(f"[6] head kernel " + ", ".join(f"{k} {x:.4f} / {y:.4f}" for k, (x, y) in turns.items())
          + f" ms in turns (R={R} C={C} V1={V1} bf16, {plan[1]} splits of {plan[0]} tiles; "
          f"kernel {2 * R * C * V1 / record['ms'] / 1e9:.1f} TFLOP/s); plain {plain_ms:.4f} ms; "
          f"bound {record['bound_ms']:.4f} ms ({record['bound_by']}); host "
          f"{record['host_us_per_call']:.1f} us a call [{card}]")
    return record


def flagship_cfg(**runtime):
    from echr_tpu_torch.config import flagship_config

    cfg = flagship_config()
    cfg = cfg.replace_in("data", lda_dim=100, time_buckets=(T_BUCKET,))
    cfg = cfg.replace_in("decoder", CG_vocab_size=VOCAB, CG_seq_length=SEQ_LEN)
    if runtime:
        cfg = cfg.replace_in("runtime", **runtime)
    return cfg.validate()


def requests(n, seed):
    from echr_tpu_torch.serve import CaptionRequest

    rng = np.random.RandomState(seed)
    base = rng.randn(T_BUCKET, VIDEO_DIM).astype(np.float32) * 0.5
    return [CaptionRequest(vid=f"v{i}", duration=120.0 + i,
                           feats=base + 0.3 * rng.randn(T_BUCKET, VIDEO_DIM).astype(np.float32),
                           lda=rng.randn(100).astype(np.float32))
            for i in range(n)]


def check_captions(res, reqs):
    """Every request captioned, TOP_N captions each, well-formed timestamps,
    scores and sentences."""
    if sorted(res) != sorted(r.vid for r in reqs):
        fail("not every request was captioned")
    for r in reqs:
        caps = res[r.vid]
        if len(caps) != TOP_N:
            fail(f"{r.vid}: {len(caps)} captions, expected {TOP_N}")
        for c in caps:
            s, e = c.timestamp
            if not (0.0 <= s < e <= r.duration + 1e-6 and 0.0 <= c.proposal_score <= 1.0
                    and np.isfinite(c.sentence_confidence) and c.sentence_confidence <= 0.0):
                fail(f"{r.vid}: malformed caption {c}")
            if any(not w.startswith("w") for w in c.sentence.split()):
                fail(f"{r.vid}: sentence outside the vocab: {c.sentence!r}")


def phase_slice(card):
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.serve import CaptionService

    cfg = flagship_cfg()
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=32, topN=TOP_N)
    reqs = requests(64, seed=2)
    # warm-up (cuBLAS handles, allocator), keeping kernel 1's inputs of one step
    step_args = first_scores_args(svc, reqs[:32])

    attention_scores_masked.launches = 0
    greedy_head.launches = 0
    decoder_sample_batched.steps = 0
    decoder_sample_batched.host_syncs = 0
    t0 = time.time()
    res = svc.caption(reqs)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {"attention_scores_masked": attention_scores_masked.launches,
                "greedy_head": greedy_head.launches}
    steps = decoder_sample_batched.steps

    n_caps = sum(len(c) for c in res.values())
    check_captions(res, reqs)
    if not (steps > 0 and launches["attention_scores_masked"] == steps
            and launches["greedy_head"] == steps):
        fail(f"kernel launches {launches} do not match the {steps} decode steps run")
    print(f"[4] slice: {len(res)} videos, {n_caps} captions, {steps} decode steps, "
          f"{decoder_sample_batched.host_syncs} early-exit syncs, launches {launches}; "
          f"e.g. {res['v0'][0]}")
    print(f"[6] slice {n_caps / dt:.1f} captions/s ({len(reqs)} videos x {TOP_N} proposals "
          f"in {dt:.3f} s, bf16 compute, batch 32) [{card}]")
    return launches, tap, cg, vocab, step_args


def first_scores_args(svc, reqs):
    """svc.caption(reqs) with a wrapper on kernel 1 that keeps the inputs
    of its first call, the first decode step's: (pre, q, w, b, mask)."""
    from echr_tpu_torch.ops import attention as attention_ops

    kept = []

    def keep_first(*args):
        if not kept:
            kept.append(tuple(a.detach().clone() for a in args))
    with wrapped(attention_ops, "attention_scores_masked", keep_first):
        svc.caption(reqs)
    torch.cuda.synchronize()
    return kept[0]


def phase_parity(tap, cg, vocab):
    from echr_tpu_torch.engine.steps import decode_step_batched
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.serve import CaptionService

    cfg = flagship_cfg(compute_dtype="float32")
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(8.0)  # sharpen: argmax margins >> f32 noise
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=8, topN=TOP_N)
    _, _, args = svc.prepare_chunk(requests(8, seed=3), T_BUCKET)
    seq_k, lp_k, _ = decode_step_batched(*args)
    with force_plain():
        seq_p, lp_p, _ = decode_step_batched(*args)
    bad = int((seq_k != seq_p).sum())
    err = float((lp_k - lp_p).abs().max())
    print(f"[5] f32 slice, kernels vs plain: {bad} token mismatches of {seq_k.numel()}, "
          f"max|d| logps {err:.3e}, {int((seq_k > 0).sum())} non-EOS tokens")
    if bad or not err <= TOL:
        fail("the slice with the kernels disagrees with its plain version")


def caption_service(beam_size=BEAM, **runtime):
    """The serving slice at the flagship width, bf16, from the port's
    seeded init: CaptionService(beam_size), 32 videos a chunk (greedy at
    beam_size 1); ``runtime`` overrides cfg.runtime fields."""
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.serve import CaptionService

    cfg = flagship_cfg(**runtime)
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    return CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=32, topN=TOP_N,
                          beam_size=beam_size)


@torch.inference_mode()
def beam_step_tensors(svc, sort=True):
    """The beam path's decode-step tensors for 32 requests: make_contexts,
    the window sort (unless ``sort`` is false), _expand_ctxs(k=4),
    precompute_attention and init_state, then the <bos> step, whose hidden
    state is step 1's query.  B=32, N*k=512 rows, T=256, Hatt=512, D=500,
    bf16 compute."""
    from echr_tpu_torch.models.beam import _expand_ctxs
    from echr_tpu_torch.models.captioner import make_contexts
    from echr_tpu_torch.models.decoder import (ctxs_soi, init_state, precompute_attention,
                                               sort_ctxs_by_window, step_core_out)
    from echr_tpu_torch.ops.core import dense

    bf16 = torch.bfloat16
    _, nb, (cg, cfg, tap_feats, feats, lda, fm, props) = svc.prepare_chunk(
        requests(32, seed=5), T_BUCKET)
    ctxs = make_contexts(cg, cfg, tap_feats, feats, lda, props, frame_mask=fm)
    if sort:
        ctxs, _ = sort_ctxs_by_window(ctxs)
    bctx = _expand_ctxs(ctxs, BEAM)
    dec = cg.decoder
    pre = precompute_attention(dec, cfg, bctx, bf16)
    state = init_state(dec, cfg, bctx, nb * BEAM, bf16)
    bos = torch.zeros(feats.shape[0], nb * BEAM, dtype=torch.int32, device=feats.device)
    _, state = step_core_out(dec, cfg, bos, bctx, pre, state, bf16)
    att = dec.core.attention
    h = state.h[1]
    return {"att": att, "h": h, "pre": pre.att.contiguous(),
            "q": dense(att.h2att, h, bf16).contiguous(),
            "w": att.alpha_net.weight.reshape(-1).contiguous(), "b": att.alpha_net.bias,
            "mask": bctx.clip_mask.contiguous(), "feats": bctx.clip_feats.contiguous(),
            "soi": ctxs_soi(bctx).to(torch.int32).contiguous()}


def kernel1_route(t):
    """The route the decode path takes now: kernel 1, masked_softmax and the
    bf16 AV product."""
    from echr_tpu_torch.ops.core import matmul, round_to
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.masked import masked_softmax

    bf16 = torch.bfloat16
    s = attention_scores_masked(t["pre"], t["q"], t["w"], t["b"], t["mask"])
    return matmul(round_to(masked_softmax(s, t["mask"]), bf16), round_to(t["feats"], bf16), bf16)


def short_windows(t):
    """t with short windows in place of the random-init SST's long ones:
    sorted starts and 4-47 frames as bench.py draws them (phase 2's mask
    density, ~0.1), each proposal's window repeated for its k beams."""
    from echr_tpu_torch.ops.masked import segment_window_mask

    rng = np.random.RandomState(10)
    B, N = t["soi"].shape[:2]
    T = t["pre"].shape[1]
    s = np.sort(rng.randint(0, T - 8, size=(B, N // BEAM)), axis=1)
    e = np.minimum(s + rng.randint(4, 48, size=s.shape), T)
    soi = torch.from_numpy(np.stack([s, e], -1).astype(np.int32)).to(t["pre"].device)
    soi = soi.repeat_interleave(BEAM, dim=1).contiguous()
    return {**t, "soi": soi, "mask": segment_window_mask(soi, T).contiguous()}


def _random_windows(rng, B, N, T, max_len):
    s = rng.randint(0, T - 1, size=(B, N))
    e = np.minimum(s + rng.randint(1, max_len + 1, size=(B, N)), T)
    return np.stack([s, e], -1).astype(np.int32)


@torch.inference_mode()
def phase_fused(card, t):
    """Kernel 5 on the beam path's step tensors against its plain version
    (atol 2e-3), a ragged shape with D > 512 and a fully-masked row, and
    its time beside the kernel-1 route's."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.attention import additive_attention_step
    from echr_tpu_torch.ops.kernel_attention_step import attention_fused
    from echr_tpu_torch.ops.masked import segment_window_mask

    attention_fused.launches = 0
    res, weights = additive_attention_step(t["att"], t["h"], t["feats"], t["pre"], t["mask"],
                                           torch.bfloat16, use_kernel=True, fused=True)
    torch.cuda.synchronize()
    launches = attention_fused.launches
    if launches != 1 or weights is not None:
        fail(f"additive_attention_step(fused=True) launched kernel 5 {launches} times")
    args = (t["pre"], t["q"], t["w"], t["b"], t["mask"], t["feats"])
    got = attention_fused(*args)
    with force_plain():
        want = attention_fused(*args)
    err = float((got - want).abs().max())
    route_err = float((got - kernel1_route(t)).abs().max())
    B, T, H = t["pre"].shape
    N, D = t["q"].shape[1], t["feats"].shape[2]
    live = float(t["mask"].sum())
    print(f"[11] fused step, beam path B={B} N*k={N} T={T} H={H} D={D} (mask density "
          f"{live / t['mask'].numel():.3f}): max|d| vs plain {err:.3e} (vs the kernel-1 route, "
          f"which rounds the normalised weights instead, {route_err:.3e}); entry point "
          f"launches {launches}")
    if not err <= FUSED_TOL:
        fail(f"kernel 5: max|d| {err:.3e} > {FUSED_TOL}")
    worst = err

    rng = np.random.RandomState(8)
    dev = t["pre"].device
    Br, Nr, Tr, Hr, Dr = 3, 77, 200, 500, 700
    soi = torch.from_numpy(_random_windows(rng, Br, Nr, Tr, 60)).to(dev)
    mask = segment_window_mask(soi, Tr).contiguous()
    mask[1, 5] = 0.0  # a fully-masked row
    rargs = (_rand(rng, (Br, Tr, Hr), 0.5, dev), _rand(rng, (Br, Nr, Hr), 0.5, dev),
             _rand(rng, (Hr,), 0.05, dev), torch.tensor([0.25], device=dev), mask,
             _rand(rng, (Br, Tr, Dr), 1.0, dev))
    rgot = attention_fused(*rargs)
    with force_plain():
        rwant = attention_fused(*rargs)
    rerr = float((rgot - rwant).abs().max())
    print(f"[11] fused step ragged B={Br} N={Nr} T={Tr} H={Hr} D={Dr}: max|d| {rerr:.3e}; "
          f"fully-masked row max|out| {float(rgot[1, 5].abs().max()):.1e}")
    if not rerr <= FUSED_TOL or bool(rgot[1, 5].ne(0).any()):
        fail(f"kernel 5 ragged: max|d| {rerr:.3e}, or a fully-masked row is not zero")
    worst = max(worst, rerr)

    turns = in_turns({"kernel": lambda: attention_fused(*args), "route": lambda: kernel1_route(t)})
    (k1, k2), (r1, r2) = turns["kernel"], turns["route"]
    with force_plain():
        plain_ms = cuda_ms(lambda: attention_fused(*args), iters=3, warmup=1)
    # per live (n, t, h): add, tanh, multiply, add in f32; per live (n, t, d): a
    # multiply-add of bf16 operands, which tensor cores take at the bf16 rate
    record = {"launches": launches, "max_abs_err": worst, "ms": (k1 + k2) / 2,
              "plain_ms": plain_ms, "kernel1_route_ms": (r1 + r2) / 2,
              **bound(nbytes(*args, got), f32=live * 4.0 * H, bf16=live * 2.0 * D)}
    print(f"[11] fused step kernel {k1:.4f}, {k2:.4f} ms vs the kernel-1 route {r1:.4f}, "
          f"{r2:.4f} ms (in turns) vs plain {plain_ms:.4f} ms; bound {record['bound_ms']:.4f} ms "
          f"({record['bound_by']}) [{card}]")
    sw = short_windows(t)
    sargs = args[:4] + (sw["mask"], t["feats"])
    with force_plain():
        swant = attention_fused(*sargs)
    serr = float((attention_fused(*sargs) - swant).abs().max())
    if not serr <= FUSED_TOL:
        fail(f"kernel 5, short windows: max|d| {serr:.3e} > {FUSED_TOL}")
    record["max_abs_err"] = max(worst, serr)
    turns = in_turns({"kernel": lambda: attention_fused(*sargs),
                      "route": lambda: kernel1_route(sw)})
    (k1, k2), (r1, r2) = turns["kernel"], turns["route"]
    record.update(short_windows_ms=(k1 + k2) / 2, short_windows_route_ms=(r1 + r2) / 2)
    print(f"[11] fused step, short windows (mask density {float(sw['mask'].mean()):.3f}): "
          f"max|d| {serr:.3e}; kernel {k1:.4f}, {k2:.4f} ms vs the kernel-1 route {r1:.4f}, "
          f"{r2:.4f} ms (in turns) [{card}]")
    return record


@torch.inference_mode()
def phase_windowed(card, t):
    """Kernel 6 on the beam path's step tensors with the sorted windows and
    W=64, against its plain version (atol 5e-4); zero-length windows,
    windows that end at T and a ragged shape; its time beside the kernel-1
    route's."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention_step import windowed_attention

    def check(name, args, zero_rows=None):
        got = windowed_attention(*args, W=WINDOW)
        with force_plain():
            want = windowed_attention(*args, W=WINDOW)
        err = float((got - want).abs().max())
        lens = (args[5][..., 1].clamp(max=args[0].shape[1]) - args[5][..., 0]).clamp(min=0)
        print(f"[12] windowed {name} B={args[0].shape[0]} N={args[2].shape[1]} "
              f"T={args[0].shape[1]} H={args[0].shape[2]} D={args[1].shape[2]}: max|d| "
              f"{err:.3e}; window lengths mean {float(lens.float().mean()):.1f}, max "
              f"{int(lens.max())}, {float((lens > WINDOW).float().mean()):.3f} longer than W")
        if not err <= TOL:
            fail(f"kernel 6 {name}: max|d| {err:.3e} > {TOL}")
        if zero_rows is not None and bool(got[zero_rows].ne(0).any()):
            fail(f"kernel 6 {name}: a zero-length window is not zero")
        return err, got

    args = (t["pre"], t["feats"], t["q"], t["w"], t["b"], t["soi"])
    windowed_attention.launches = 0
    windowed_attention(*args, W=WINDOW)
    torch.cuda.synchronize()
    launches = windowed_attention.launches
    if launches != 1:
        fail(f"windowed_attention launched kernel 6 {launches} times")
    worst, got = check("beam path", args)

    soi = t["soi"].clone()
    T = t["pre"].shape[1]
    zero = torch.zeros_like(soi[..., 0], dtype=torch.bool)
    zero[:, ::7] = True
    soi[:, ::7, 1] = soi[:, ::7, 0]  # zero-length windows
    soi[:, 3::7, 1] = T  # windows that end at T
    worst = max(worst, check("edges", args[:5] + (soi.contiguous(),), zero)[0])

    rng = np.random.RandomState(9)
    dev = t["pre"].device
    Br, Nr, Tr, Hr, Dr = 3, 50, 200, 500, 300
    rsoi = torch.from_numpy(_random_windows(rng, Br, Nr, Tr, 120)).to(dev)
    rargs = (_rand(rng, (Br, Tr, Hr), 0.5, dev), _rand(rng, (Br, Tr, Dr), 1.0, dev),
             _rand(rng, (Br, Nr, Hr), 0.5, dev), _rand(rng, (Hr,), 0.05, dev),
             torch.tensor([0.25], device=dev), rsoi)
    worst = max(worst, check("ragged", rargs)[0])

    turns = in_turns({"kernel": lambda: windowed_attention(*args, W=WINDOW),
                      "route": lambda: kernel1_route(t)})
    (k1, k2), (r1, r2) = turns["kernel"], turns["route"]
    with force_plain():
        plain_ms = cuda_ms(lambda: windowed_attention(*args, W=WINDOW), iters=3, warmup=1)
    B, _, H = t["pre"].shape
    D = t["feats"].shape[2]
    frames = float((t["soi"][..., 1] - t["soi"][..., 0]).clamp(min=0).sum())
    record = {"launches": launches, "max_abs_err": worst, "ms": (k1 + k2) / 2,
              "plain_ms": plain_ms, "kernel1_route_ms": (r1 + r2) / 2,
              **bound(nbytes(*args, got), f32=frames * (4.0 * H + 2.0 * D))}
    print(f"[12] windowed kernel {k1:.4f}, {k2:.4f} ms vs the kernel-1 route {r1:.4f}, "
          f"{r2:.4f} ms (in turns) vs plain {plain_ms:.4f} ms; bound {record['bound_ms']:.4f} ms "
          f"({record['bound_by']}) [{card}]")
    sw = short_windows(t)
    sargs = args[:5] + (sw["soi"],)
    worst = max(worst, check("short windows", sargs)[0])
    record["max_abs_err"] = worst
    turns = in_turns({"kernel": lambda: windowed_attention(*sargs, W=WINDOW),
                      "route": lambda: kernel1_route(sw)})
    (k1, k2), (r1, r2) = turns["kernel"], turns["route"]
    record.update(short_windows_ms=(k1 + k2) / 2, short_windows_route_ms=(r1 + r2) / 2)
    print(f"[12] windowed, short windows: kernel {k1:.4f}, {k2:.4f} ms vs the kernel-1 route "
          f"{r1:.4f}, {r2:.4f} ms (in turns) [{card}]")
    return record


def phase_beam(card, svc):
    """The beam slice: CaptionService(beam_size=4) captions 64 requests
    (two chunks of 32 videos, top-128 proposals: 16384 beam rows a chunk)
    after one warm-up chunk.  Kernel 1's launches must equal the beam steps
    run, the <bos> steps included."""
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked

    reqs = requests(64, seed=6)
    svc.caption(reqs[:32])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention_scores_masked.launches = 0
    beam_search_batched.steps = 0
    beam_search_batched.host_syncs = 0
    t0 = time.time()
    res = svc.caption(reqs)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = attention_scores_masked.launches
    steps, syncs = beam_search_batched.steps, beam_search_batched.host_syncs
    peak = torch.cuda.max_memory_allocated()
    check_captions(res, reqs)
    if not (steps > 0 and launches == steps):
        fail(f"kernel 1 launched {launches} times in {steps} beam steps")
    n_caps = sum(len(c) for c in res.values())
    print(f"[13] beam slice: {len(res)} videos, {n_caps} captions, beam {BEAM}, {steps} beam "
          f"steps (the <bos> steps included), {syncs} early-exit syncs, kernel 1 launches "
          f"{launches}; e.g. {res['v0'][0]}")
    print(f"[13] beam {n_caps / dt:.1f} captions/s, {1000 * dt / 2:.1f} ms per chunk of 32 "
          f"videos x {TOP_N} proposals x {BEAM} beams, peak device memory {peak / 2**30:.2f} GiB, "
          f"bf16 compute [{card}]")
    profile = beam_profile(card, svc, reqs[:32])
    return {"attention_scores_masked": launches, "kernel1_profile": profile}


def beam_profile(card, svc, chunk):
    """Device kernel time of one chunk's beam decode under torch.profiler,
    beside its host-clock time; returns kernel 1's device ms over the chunk
    and its launches there (None when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    from echr_tpu_torch.engine.steps import beam_decode_step_batched
    from echr_tpu_torch.models.beam import beam_search_batched

    _, _, args = svc.prepare_chunk(chunk, T_BUCKET)
    torch.cuda.synchronize()
    steps0 = beam_search_batched.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        beam_decode_step_batched(*args, BEAM, length_alpha=svc.cfg.eval.beam_length_alpha)
        torch.cuda.synchronize()
        wall = time.time() - t0
    steps = beam_search_batched.steps - steps0
    def dev_time(e):  # the name before torch 2.4: self_cuda_time_total
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(dev_time(e) for e in events)
    if not dev_us:
        print(f"[13] beam decode profile: device time not measured (no CUDA events) [{card}]")
        return None
    top = sorted(events, key=lambda e: -dev_time(e))[:10]
    print(f"[13] beam decode of one chunk under the profiler: wall {1000 * wall:.1f} ms, "
          f"device kernel time {dev_us / 1000:.1f} ms over {steps} steps "
          f"({dev_us / 1000 / steps:.3f} ms a step, busy {dev_us / 1e6 / wall:.3f}) [{card}]")
    for e in top:
        print(f"     {dev_time(e) / 1000:9.2f} ms {e.count:6d}x {e.key[:90]}")
    k1 = [e for e in events if "masked_scores_kernel" in e.key]
    k1_ms = sum(dev_time(e) for e in k1) / 1000
    k1_n = sum(e.count for e in k1)
    print(f"[13] kernel 1 under the profiler: {k1_ms:.2f} ms of device time over the chunk, "
          f"{k1_n} launches, {k1_ms / max(k1_n, 1):.4f} ms each [{card}]")
    return {"device_ms_per_chunk": k1_ms, "launches": k1_n}


@torch.inference_mode()
def phase_beam_parity(tap, cg, vocab):
    """f32, TF32 off, phase 5's 8 requests and sharpened weights: beam 4
    with the kernels and under force_plain() gives identical tokens for
    every beam and best logprobs within 5e-4.  Then beam 1 against greedy
    decode, with the logit weights sharpened 16x more: beam 1 ranks
    score + logprob, and at phase 5's weights a summed score near -240 has
    a ulp of 1.5e-5, so candidates closer than that tie and the lower index
    wins where greedy takes the larger (echr_tpu's beam does the same).
    Peaked weights keep the scores near 0."""
    from echr_tpu_torch.engine.steps import beam_decode_step_batched, decode_step_batched
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.models.captioner import make_contexts
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.serve import CaptionService

    cfg = flagship_cfg(compute_dtype="float32")
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=8, topN=TOP_N,
                         beam_size=BEAM)
    _, _, args = svc.prepare_chunk(requests(8, seed=3), T_BUCKET)
    cgm, cfg, tap_feats, feats, lda, fm, props = args
    ctxs = make_contexts(cgm, cfg, tap_feats, feats, lda, props, frame_mask=fm)
    alpha = cfg.eval.beam_length_alpha
    got = beam_search_batched(cgm.decoder, cfg, ctxs, BEAM, alpha)
    with force_plain():
        want = beam_search_batched(cgm.decoder, cfg, ctxs, BEAM, alpha)
    bad = int((got.all_seqs != want.all_seqs).sum())
    err = float((got.all_logprobs - want.all_logprobs).abs().max())
    print(f"[14] f32 beam {BEAM}, kernels vs plain: {bad} token mismatches of "
          f"{got.all_seqs.numel()} (every beam), max|d| beam logprobs {err:.3e}, "
          f"{int((got.seq > 0).sum())} non-EOS tokens")
    if bad or not err <= TOL:
        fail("f32 beam search with the kernels disagrees with its plain version")
    cgm.decoder.logit.weight.mul_(16.0)
    seq1, lp1 = beam_decode_step_batched(*args, 1)
    seqg, _, _ = decode_step_batched(*args)
    real = props.prop_mask > 0
    bad1 = int((seq1 != seqg)[real].sum())
    print(f"[14] beam 1 vs greedy, weights sharpened 16x more: {bad1} token mismatches on "
          f"{int(real.sum())} real proposals, {int((seqg > 0)[real].sum())} non-EOS greedy "
          f"tokens, best-beam logprobs down to {float(lp1[real].min()):.3e}")
    if bad1:
        fail("beam 1 does not give the greedy tokens")

def _rand(rng, shape, scale, dev):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def _score_inputs(rng, B, N, T, H, dev):
    return (_rand(rng, (B, T, H), 0.5, dev), _rand(rng, (B, N, H), 0.5, dev),
            _rand(rng, (H,), 0.05, dev), torch.tensor([0.25], device=dev))


TRAIN_SHAPES = {"training": (TRAIN_B, TRAIN_N, T_BUCKET, 512), "ragged": (3, 60, 200, 500)}


def kernel3_timing(card, name, raws, tag="7"):
    """Kernel 3 over a list of inputs (pre, q, w, b, mask), each held
    against its plain version where mask == 1 (kernel3_check): ms a call
    (the mean over the list), its bound over the live (n, t) and the tanh
    they need."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_dense

    pre, q = raws[0][0], raws[0][1]
    B, T, H = pre.shape
    N = q.shape[1]
    outs, err = [], 0.0
    for raw in raws:
        e, out = kernel3_check(name, raw)
        err = max(err, e)
        outs.append(out)
    live = sum(int(raw[4].ne(0).sum()) for raw in raws) / len(raws)
    n_bytes = sum(nbytes(*raw, out) for raw, out in zip(raws, outs)) / len(raws)
    del outs
    # per live (n, t, h): add, tanh, multiply, add
    rec = {"B": B, "N": N, "T": T, "H": H, "calls": len(raws), "density": live / (B * N * T),
           "max_abs_err": err, "tanh_needed": live * H, **bound(n_bytes, f32=4.0 * live * H)}
    rec["ms"] = cuda_ms(lambda: [attention_scores_dense(*raw) for raw in raws]) / len(raws)
    print(f"[{tag}] kernel 3, {name} B={B} N={N} T={T} H={H} (density {rec['density']:.4f}"
          f"{f', mean of {len(raws)} calls' if len(raws) > 1 else ''}): max|d| where mask==1 "
          f"{err:.3e}, masked entries 0; {rec['ms']:.4f} ms a call, live-work bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) [{card}]")
    return rec


def kernel3_inputs(rng, dev):
    """Phase 7's inputs (pre, q, w, b, mask): the training shapes with every
    entry live and with windows of 4-47 frames in random order (one draw
    of pre, q, w), and a ragged shape with unsorted windows of 1-120."""
    B, N, T, H = TRAIN_SHAPES["training"]
    args = _score_inputs(rng, B, N, T, H, dev)
    windows = torch.from_numpy(_windows_mask(rng, B, N, T, shuffle=True)).to(dev)
    Br, Nr, Tr, Hr = TRAIN_SHAPES["ragged"]
    ragged = _score_inputs(rng, Br, Nr, Tr, Hr, dev)
    rmask = torch.from_numpy(_case_mask(rng, "unsorted", Br, Nr, Tr)).to(dev)
    return {"all_live": args + (torch.ones(B, N, T, device=dev),),
            "windows": args + (windows,), "ragged": ragged + (rmask,)}


def phase_scores_dense(card):
    """Kernel 3 against its plain version where mask == 1, masked entries
    exactly 0 (kernel3_inputs); its time with every entry live (the
    no-regression case) and at the windows."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_dense

    inputs = kernel3_inputs(np.random.RandomState(4), torch.device("cuda"))
    err, _ = kernel3_check("ragged", inputs["ragged"])
    (B, T, H), N = inputs["ragged"][0].shape, inputs["ragged"][1].shape[1]
    print(f"[7] kernel 3, ragged B={B} N={N} T={T} H={H}, unsorted windows (density "
          f"{float(inputs['ragged'][4].mean()):.3f}): max|d| where mask==1 {err:.3e}, masked "
          f"entries 0")
    record = kernel3_timing(card, "training shapes, every entry live", [inputs["all_live"]])
    with force_plain():
        record["plain_ms"] = cuda_ms(lambda: attention_scores_dense(*inputs["all_live"]),
                                     iters=5)
    print(f"[7] kernel 3 plain version {record['plain_ms']:.4f} ms per teacher-forced step "
          f"[{card}]")
    record["windows"] = kernel3_timing(card, "training shapes, windows of 4-47 frames in "
                                       "random order", [inputs["windows"]])
    record["max_abs_err"] = max(err, record["max_abs_err"], record["windows"]["max_abs_err"])
    return record


def _bwd_check(name, args, g):
    """Kernel 4 through attention_scores_diff against the autograd of the
    plain forward: d_pre and d_q at atol 2e-4, rtol 1e-4 (the JAX
    package's gate for its backward kernel); d_w and d_b are each a sum of
    B*N*T = 524k terms at the training shapes, so they are held to 1e-4 of
    their largest entry.  Returns the worst d_pre / d_q error."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_dense_plain, attention_scores_diff

    leaves = [a.clone().requires_grad_() for a in args]
    # every entry live: the forward's masked entries are not under test here
    attention_scores_diff(*leaves, torch.ones_like(g)).backward(g)
    got = [x.grad for x in leaves]
    torch.cuda.synchronize()
    ref = [a.clone().requires_grad_() for a in args]
    attention_scores_dense_plain(*ref).backward(g)
    want = [x.grad for x in ref]
    worst = 0.0
    for key, a, b in zip(("d_pre", "d_q", "d_w", "d_b"), got, want):
        err = float((a - b).abs().max())
        if key in ("d_pre", "d_q"):
            ok = bool(((a - b).abs() <= 2e-4 + 1e-4 * b.abs()).all())
            worst = max(worst, err)
        else:
            ok = err <= 1e-4 * float(b.abs().max())
        print(f"[8] scores backward {name} {key}: max|d| {err:.3e} "
              f"(max|ref| {float(b.abs().max()):.3e})")
        if not ok:
            fail(f"kernel 4 {name} {key} disagrees with the plain autograd")
    return worst


def kernel4_timing(card, name, raws, tag="8"):
    """Kernel 4 over a list of inputs (pre, q, w, g): two calls
    bit-identical; ms a call (the mean over the list), and the bound over
    the nonzero cotangents."""
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd

    pre, q = raws[0][0], raws[0][1]
    B, T, H = pre.shape
    N = q.shape[1]
    call = lambda: [attention_scores_bwd(*raw) for raw in raws]  # noqa: E731
    first = call()
    if not all(torch.equal(u, v) for a, b in zip(first, call()) for u, v in zip(a, b)):
        fail(f"kernel 4 {name}: two calls differ")
    live = sum(int(raw[3].ne(0).sum()) for raw in raws) / len(raws)
    n_bytes = sum(nbytes(*raw, *out) for raw, out in zip(raws, first)) / len(raws)
    # per live (n, t, h): tanh(pre + q) 2, dz = g * w * (1 - y^2) 4, the d_pre,
    # d_q and d_w sums 4
    rec = {"B": B, "N": N, "T": T, "H": H, "calls": len(raws), "g_nonzero": live / (B * N * T),
           "tanh_needed": live * H, **bound(n_bytes, f32=10.0 * live * H)}
    rec["ms"] = cuda_ms(call) / len(raws)
    print(f"[{tag}] kernel 4, {name} B={B} N={N} T={T} H={H} (nonzero g {rec['g_nonzero']:.3f}"
          f"{f', mean of {len(raws)} calls' if len(raws) > 1 else ''}): two calls bit-identical; "
          f"{rec['ms']:.4f} ms a call, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}) "
          f"[{card}]")
    return rec


def phase_scores_bwd(card):
    """Kernel 4 against the autograd of the plain forward (_bwd_check) at
    the training and ragged shapes with a dense cotangent, and at the
    training shapes with one that is zero outside sorted windows drawn by
    _windows_mask (the masked softmax gives exactly that); its time with
    both."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd

    rng = np.random.RandomState(5)
    dev = torch.device("cuda")
    worst, record = 0.0, None
    cases = {name: (shape, False) for name, shape in TRAIN_SHAPES.items()}
    cases["training, g zero outside windows"] = (TRAIN_SHAPES["training"], True)
    for name, ((B, N, T, H), windowed) in cases.items():
        args = _score_inputs(rng, B, N, T, H, dev)
        g = _rand(rng, (B, N, T), 1.0, dev)
        if windowed:
            g = g * torch.from_numpy(_windows_mask(rng, B, N, T)).to(dev)
        worst = max(worst, _bwd_check(name, args, g))
        raw = args[:3] + (g,)
        rec = kernel4_timing(card, name, [raw])
        if name == "ragged":
            continue
        if record is None:
            with force_plain():
                rec["plain_ms"] = cuda_ms(lambda: attention_scores_bwd(*raw), iters=5)
            print(f"[8] scores backward plain version {rec['plain_ms']:.4f} ms per "
                  f"teacher-forced step [{card}]")
            record = rec
        else:
            record["windowed_g"] = rec
    record["max_abs_err"] = worst
    return record


def train_cfg(**runtime):
    """bench.py's e2e_train_cfg (bench.py:290-319): the flagship width on
    synthetic data, cotrain, batch 32, no eval or checkpoints.  Its 256
    synthetic videos (192 train) already cover 6 steps of 32: nothing is
    cut."""
    from echr_tpu_torch.config import flagship_config

    cfg = flagship_config()
    cfg = cfg.replace_in("data", synthetic=True, lda_dim=100, time_buckets=(T_BUCKET,),
                         synthetic_vocab_size=VOCAB, synthetic_seq_length=SEQ_LEN,
                         synthetic_num_videos=256, synthetic_cache_videos=256,
                         synthetic_learnable=True)
    cfg = cfg.replace_in("train", training_mode="cotrain", tap_epochs=0, cg_epochs=0,
                         tapcg_epochs=10**6, batch_size=TRAIN_B, self_critical_after=-1,
                         m_batch=1)
    cfg = cfg.replace_in("save", losses_log_every=10**9, save_checkpoint_every=10**9,
                         min_epoch_when_save=10**9)
    if runtime:
        cfg = cfg.replace_in("runtime", **runtime)
    return cfg.validate()


def phase_train(card):
    from echr_tpu_torch.engine.train import train
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd, attention_scores_dense

    cfg = train_cfg()
    torch.cuda.reset_peak_memory_stats()
    attention_scores_dense.launches = 0
    attention_scores_bwd.launches = 0
    timing = {}
    out = train(cfg, max_iterations=TRAIN_STEPS, device="cuda", timing_out=timing)
    torch.cuda.synchronize()
    launches = {"attention_scores_dense": attention_scores_dense.launches,
                "attention_scores_bwd": attention_scores_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    tf_steps = SEQ_LEN - 1  # caption columns minus the BOS input
    expect = tf_steps * out["iteration"]
    if out["iteration"] != TRAIN_STEPS:
        fail(f"train stopped at iteration {out['iteration']}")
    if not all(np.isfinite(v) for v in out["losses"].values()):
        fail(f"non-finite losses {out['losses']}")
    gen = torch.Generator().manual_seed(cfg.train.seed)  # train()'s init, again
    tap0, cg0 = init_tap(gen, out["config"]), init_captioner(gen, out["config"])
    state = out["state"]
    for name, m0, m in (("tap", tap0, state.tap), ("cg", cg0, state.cg)):
        for (pn, p0), p in zip(m0.named_parameters(), m.parameters()):
            if torch.equal(p0, p.detach().cpu()):
                fail(f"{name}.{pn} did not move in {out['iteration']} steps")
    if any(n != expect for n in launches.values()):
        fail(f"kernel launches {launches} do not match {tf_steps} teacher-forced steps x "
             f"{out['iteration']} train steps = {expect}")
    t = dict(timing["iters"])
    dt = (t[TRAIN_STEPS] - t[1]) / (TRAIN_STEPS - 1)
    print(f"[9] training slice: {out['iteration']} steps of {TRAIN_B} videos (cotrain/tap_cg, "
          f"vocab {VOCAB}, {tf_steps} teacher-forced steps, T={T_BUCKET}, "
          f"N={cfg.tap.prop_sample_num}, bf16, "
          f"dropout on, seed {cfg.train.seed}; synthetic_num_videos 256 as e2e_train_cfg, "
          f"nothing cut); launches {launches}; last losses "
          f"{ {k: round(v, 4) for k, v in out['losses'].items()} }")
    print(f"[9] training {1000 * dt:.1f} ms/step, {TRAIN_B / dt:.2f} videos/s over steps 2-"
          f"{TRAIN_STEPS}, peak device memory {peak / 2**30:.2f} GiB [{card}]")
    fwd, raws = training_step_inputs(out)
    density = sum(int(r[4].ne(0).sum()) for r in fwd) / sum(r[4].numel() for r in fwd)
    share = sum(int(r[3].ne(0).sum()) for r in raws) / sum(r[3].numel() for r in raws)
    print(f"[9] one more step of {TRAIN_B} videos: kernel 3 saw {len(fwd)} window masks, "
          f"{density:.4f} of their entries live; kernel 4 saw {len(raws)} cotangents, "
          f"{share:.4f} of their entries nonzero")
    return (launches, kernel3_timing(card, "the training step's own masks", fwd, tag="9"),
            kernel4_timing(card, "the training step's own cotangents", raws, tag="9"))


def training_step_inputs(out):
    """One more gradient step of train()'s state ``out`` on a batch of the
    training data, with wrappers on kernels 3 and 4 that keep the inputs
    of each of their calls: ([(pre, q, w, b, mask), ...],
    [(pre, q, w, g), ...])."""
    from echr_tpu_torch.data.batcher import make_batch
    from echr_tpu_torch.data.dataset import build_dataset
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine.train import _collate
    from echr_tpu_torch.ops import kernel_attention

    cfg = out["config"]
    ds = build_dataset(cfg)
    ix = ds.split_ix["train"][:TRAIN_B]
    batch = steps.batch_to_device(_collate([
        make_batch(ds.get_example(i), cfg, np.random.RandomState(i), w1=ds.w1)[0] for i in ix]),
        "cuda")
    fwd, bwd = [], []

    def keeper(kept):
        def keep(*args):
            kept.append(tuple(x.detach().clone() for x in args))
        return keep
    gen = torch.Generator(device="cuda").manual_seed(cfg.train.seed + 2)
    with wrapped(kernel_attention, "attention_scores_dense", keeper(fwd)), \
            wrapped(kernel_attention, "attention_scores_bwd", keeper(bwd)):
        steps.grad_step(out["state"], batch, gen, cfg, "tap_cg")
    return fwd, bwd


def phase_train_parity():
    """f32, TF32 off, dropout off, B=4: one step's loss and gradients with
    the kernels and under force_plain().  Gates: loss within 1e-5 relative,
    every gradient leaf within atol 2e-4, rtol 1e-3."""
    from echr_tpu_torch.data.batcher import make_batch
    from echr_tpu_torch.data.dataset import SyntheticDataset
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine.train import _collate
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops import force_plain

    cfg = train_cfg(compute_dtype="float32").replace_in("decoder", CG_vocab_size=VOCAB,
                                                          CG_seq_length=SEQ_LEN)
    ds = SyntheticDataset(cfg, num_videos=8, seed=11)
    batch = steps.batch_to_device(_collate([
        make_batch(ds.get_example(i), cfg, np.random.RandomState(i), w1=ds.w1)[0]
        for i in range(4)]), "cuda")
    gen = torch.Generator().manual_seed(0)
    state = steps.init_train_state(cfg, init_tap(gen, cfg, "cuda"),
                                   init_captioner(gen, cfg, "cuda"))
    (tk, ck), mk = steps.grad_step(state, batch, None, cfg, "tap_cg")
    with force_plain():
        (tp, cp), mp = steps.grad_step(state, batch, None, cfg, "tap_cg")
    rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    names = ([f"tap.{n}" for n, _ in state.tap.named_parameters()]
             + [f"cg.{n}" for n, _ in state.cg.named_parameters()])
    worst, bad = 0.0, []
    for name, a, b in zip(names, tk + ck, tp + cp):
        worst = max(worst, float((a - b).abs().max()))
        if not bool(((a - b).abs() <= 2e-4 + 1e-3 * b.abs()).all()):
            bad.append(name)
    print(f"[10] f32 training step, kernels vs plain: loss {mk['loss']:.6f} vs "
          f"{mp['loss']:.6f} (rel {rel:.2e}), {len(names)} gradient leaves, max|d| "
          f"{worst:.3e}")
    if not rel <= 1e-5 or bad:
        fail(f"training step with the kernels disagrees with its plain version: rel {rel:.2e}, "
             f"leaves {bad[:5]}")


def _reset_probe_counts():
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.ops.kernel_probe_head import stream_head
    from echr_tpu_torch.ops.kernel_probe_scores import probe_scores, probe_scores_plus_dot

    for fn in (greedy_head, stream_head, probe_scores, probe_scores_plus_dot):
        fn.launches = 0


def _check_calls(phase, record, counts):
    """Each kernel's launch count over a probe's run equals the calls the
    run made to its wrapper."""
    for name, calls in record["kernel_calls"].items():
        if counts[name] != calls:
            fail(f"phase {phase}: {name} launched {counts[name]} times, the probe made {calls} "
                 f"calls")


def _head_check(name, args, tr, tv):
    """stream_head against its plain version: tokens bit-equal, max and lse
    within TOL."""
    from echr_tpu_torch.experiments.probe_greedy_head import check_head
    from echr_tpu_torch.ops.kernel_probe_head import stream_head, stream_head_plain

    got = stream_head(*args, tr, tv)
    torch.cuda.synchronize()
    c = check_head(got, stream_head_plain(*args))
    err = max(c["max_abs_err_max"], c["max_abs_err_lse"])
    if c["token_mismatches"] or not err <= TOL:
        fail(f"stream_head {name} at {(tr, tv)}: {c}")
    return err, got


def _tie_check(tr, tv, dev):
    """Exact ties from integer-valued sums, the first index winning: columns
    3 and 5 in the first vocab tile, 1031 and 2000 in later ones; and tv - 1
    (the first tile's upper column half, which TR <= 64 folds in the second
    consumer) against tv + 1 and 2000 (lower halves of later tiles)."""
    from echr_tpu_torch.ops.kernel_probe_head import pad_probe_head, stream_head

    C, V1 = 16, 2048
    for cols in ([3, 5, 1031, 2000], [tv - 1, tv + 1, 2000]):
        wt = torch.zeros(C, V1, device=dev)
        wt[:, cols] = 1.0
        tok, mx, _ = stream_head(torch.ones(64, C, device=dev), *pad_probe_head(
            wt, torch.zeros(V1, device=dev), tv), tr, tv)
        if not (bool((tok == cols[0]).all()) and bool((mx == C).all())):
            fail(f"stream_head tie at {(tr, tv)}, columns {cols}: tokens "
                 f"{tok.unique().tolist()}")


@torch.inference_mode()
def phase_probe_head(card):
    """Kernel 7 (stream_head at its plan) against its plain version at the
    probe's shapes (R=4096, C=1536, V1=6001 padded to 6144, bf16), a ragged
    R and exact ties within and across vocab tiles; its time; then the
    probe: X0, XM, X0p, XMp, K1 (kernel 7) and K2 (kernel 2) ms per step."""
    from echr_tpu_torch.experiments import probe_greedy_head as probe
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.ops.kernel_probe_head import PLAN, l2_bytes, pad_probe_head, stream_head

    dev = torch.device("cuda")
    tr, tv = PLAN
    w, b, out0 = probe.probe_inputs(probe.B, probe.N, probe.C, probe.V1, 0, dev)
    wp, bp = pad_probe_head(w, b, tv)
    args = (out0, wp, bp)
    worst, got = _head_check("probe", args, tr, tv)
    rng = np.random.RandomState(15)
    Rr, Cr, Vr = 1000, 200, 777  # ragged rows; C a multiple of 8, as the kernel needs
    rargs = (_rand(rng, (Rr, Cr), 1.0, dev),) + pad_probe_head(_rand(rng, (Cr, Vr), 0.1, dev),
                                                               _rand(rng, (Vr,), 0.1, dev), tv)
    worst = max(worst, _head_check("ragged", rargs, tr, tv)[0])
    _tie_check(tr, tv, dev)
    print(f"[15] kernel 7 {PLAN} R={out0.shape[0]} C={probe.C} V1={probe.V1} VP={wp.shape[1]} "
          f"bf16: tokens bit-equal, max|d| max/lse {worst:.3e}; ragged R={Rr} C={Cr} V1={Vr} "
          f"equal; ties: the first index wins")
    ms = cuda_ms(lambda: stream_head(*args, tr, tv))
    with force_plain():
        plain_ms = cuda_ms(lambda: stream_head(*args, tr, tv), iters=10)
    R, V1 = out0.shape[0], probe.V1
    l2 = l2_bytes(R, probe.C, wp.shape[1], tr, tv)["total"]  # modelled, not measured
    record = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
              **bound(nbytes(out0.to(torch.bfloat16), wp, bp, *got),
                      bf16=2.0 * R * probe.C * V1)}
    _reset_probe_counts()
    run = probe.run()
    torch.cuda.synchronize()
    counts = {"stream_head": stream_head.launches, "greedy_head": greedy_head.launches}
    _check_calls(15, run, counts)
    if run["check"]["token_mismatches"]:
        fail(f"probe_greedy_head: {run['check']}")
    record.update(launches=counts["stream_head"], probe_ms_per_step=run["ms_per_step"])
    p = run["ms_per_step"]
    print(f"[15] kernel 7 {ms:.4f} ms vs plain {plain_ms:.4f} ms a call, bound "
          f"{record['bound_ms']:.4f} ms ({record['bound_by']}), {l2 / 1e9:.3f} GB through L2 by "
          f"the plan (modelled); probe ms/step "
          f"{ {k: round(v, 4) for k, v in p.items()} }; launches {counts} [{card}]")
    return record


@torch.inference_mode()
def phase_probe_sweep(card):
    """Kernel 8, every instantiated tiling: a ragged R against the plain
    version, then the probe (each tiling checked at the probe's shapes,
    argmax bit-equal, then X0, XM, X0p, XMp and each tiling in interleaved
    windows); each tiling's time a call."""
    from echr_tpu_torch.experiments import probe_greedy_head, probe_streaming_head2 as probe
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_probe_head import TILINGS, l2_bytes, pad_probe_head, stream_head

    dev = torch.device("cuda")
    rng = np.random.RandomState(16)
    Rr, Cr, Vr = 1000, 200, 777
    a, w, b = _rand(rng, (Rr, Cr), 1.0, dev), _rand(rng, (Cr, Vr), 0.1, dev), _rand(rng, (Vr,),
                                                                                     0.1, dev)
    worst = max(_head_check("ragged", (a,) + pad_probe_head(w, b, tv), tr, tv)[0]
                for tr, tv in TILINGS)
    for tr, tv in TILINGS:
        _tie_check(tr, tv, dev)
    _reset_probe_counts()
    run = probe.run()
    torch.cuda.synchronize()
    counts = {"stream_head": stream_head.launches}
    _check_calls(16, run, counts)
    for c in run["checks"].values():
        worst = max(worst, c["max_abs_err_max"], c["max_abs_err_lse"])
    if not worst <= TOL:
        fail(f"kernel 8: max|d| max/lse {worst:.3e} > {TOL}")
    w, b, out0 = probe_greedy_head.probe_inputs(probe.B, probe.N, probe.C, probe.V1, 0, dev)
    tilings_ms, tilings_l2 = {}, {}
    for tr, tv in TILINGS:
        wp, bp = pad_probe_head(w, b, tv)
        tilings_ms[f"{tr}x{tv}"] = cuda_ms(lambda: stream_head(out0, wp, bp, tr, tv))
        tilings_l2[f"{tr}x{tv}"] = l2_bytes(out0.shape[0], probe.C, wp.shape[1], tr, tv)["total"]
    best = min(tilings_ms, key=tilings_ms.get)
    tr, tv = map(int, best.split("x"))
    wp, bp = pad_probe_head(w, b, tv)
    with force_plain():
        plain_ms = cuda_ms(lambda: stream_head(out0, wp, bp, tr, tv), iters=10)
    got = stream_head(out0, wp, bp, tr, tv)
    R = out0.shape[0]
    record = {"launches": counts["stream_head"], "max_abs_err": worst, "ms": tilings_ms[best],
              "best_tiling": best, "tilings_ms": tilings_ms, "plain_ms": plain_ms,
              **bound(nbytes(out0.to(torch.bfloat16), wp, bp, *got),
                      bf16=2.0 * R * probe.C * probe.V1),
              "probe_ms_per_step": run["ms_per_step"]}
    print(f"[16] kernel 8, {len(TILINGS)} tilings: tokens bit-equal at the probe's shapes and "
          f"ragged R={Rr}, first-index ties, max|d| max/lse {worst:.3e}; ms a call "
          f"{ {k: round(v, 4) for k, v in tilings_ms.items()} }, best {best}; GB through L2 "
          f"by the plan (modelled) { {k: round(v / 1e9, 3) for k, v in tilings_l2.items()} }; "
          f"plain "
          f"{plain_ms:.4f} ms; bound {record['bound_ms']:.4f} ms ({record['bound_by']}); "
          f"launches {counts['stream_head']} [{card}]")
    return record


def sfu_floor(tanh_needed, grid_blocks=None, tanh_per_block=None):
    """The SFU floor of echr_tanh work: two SFU ops a tanh (ex2, rcp) at the
    data sheet's 16 a clock an SM, at the card's clocks.max.sm.  Over every
    SM (``sfu_floor_ms``), and, given a grid, over its waves of blocks of
    ``tanh_per_block`` each, one block an SM (``sfu_floor_grid_ms``)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_ms = SFU_OPS_PER_CLOCK_SM * mhz * 1e3 / SFU_OPS_PER_TANH  # tanh a ms on one SM
    rec = {"sfu_floor_ms": tanh_needed / (per_ms * sms), "sfu_clock_mhz": mhz, "sms": sms}
    if grid_blocks is not None:
        rec["sfu_floor_grid_ms"] = -(-grid_blocks // sms) * tanh_per_block / per_ms
    return rec


@torch.inference_mode()
def phase_probe_overlap(card):
    """Kernels 9 and 10, and kernel 10's product warps alone, against their
    plain versions at the probe's shapes (B=32, N=128, T=256, H=512,
    KD=2048), a ragged shape and one with N and T both off the 64 x 128
    block and the narrowest product (KD=128), and kernel 10 at KD=8192;
    their times and SFU floors (printed only: modelled from the data
    sheet); then the probe: S0, S1, SD and S2 at KD=2048 and 8192."""
    from echr_tpu_torch.experiments import probe_mxu_vpu_overlap as probe
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_probe_scores import (KD_TILE, TILE_N, TILE_T, grid,
                                                        probe_dot_plain, probe_scores,
                                                        probe_scores_plus_dot)

    dev = torch.device("cuda")
    rng = np.random.RandomState(17)
    bf16 = torch.bfloat16
    records, worst = {}, {"probe_scores": 0.0, "probe_scores_plus_dot": 0.0}
    for name, (B, N, T, H, KD) in {"probe": (probe.B, probe.N, probe.T, probe.H, probe.KD),
                                   "ragged": (3, 77, 200, 496, 256),
                                   "off the block": (2, 50, 130, 100, KD_TILE)}.items():
        pre, q = _rand(rng, (B, T, H), 0.5, dev), _rand(rng, (B, N, H), 0.5, dev)
        w, wd = _rand(rng, (H,), 0.05, dev), _rand(rng, (H, KD), 0.05, dev).to(bf16)
        s9 = probe_scores(pre, q, w)
        s10, d10 = probe_scores_plus_dot(pre, q, w, wd)
        _, d_only = probe_scores_plus_dot(pre, q, w, wd, scores=False)
        torch.cuda.synchronize()
        with force_plain():
            ps, pd = probe_scores_plus_dot(pre, q, w, wd)
        e9 = float((s9 - ps).abs().max())
        e10 = max(float((s10 - ps).abs().max()), float((d10 - pd).abs().max()),
                  float((d_only - pd).abs().max()))
        print(f"[17] {name} B={B} N={N} T={T} H={H} KD={KD}: kernel 9 max|d| {e9:.3e}; kernel 10 "
              f"scores and product (and the product alone) max|d| {e10:.3e}")
        if not (e9 <= TOL and e10 <= TOL):
            fail(f"kernels 9/10 {name}: max|d| {e9:.3e}, {e10:.3e} > {TOL}")
        worst["probe_scores"] = max(worst["probe_scores"], e9)
        worst["probe_scores_plus_dot"] = max(worst["probe_scores_plus_dot"], e10)
        if name != "probe":
            continue
        tanh_ops = 4.0 * B * N * T * H  # per (n, t, h): add, tanh, multiply, add
        blocks = int(np.prod(grid(B, N, T)))
        floors = sfu_floor(B * N * T * H, blocks, TILE_N * TILE_T * H)
        for fn, call, outs, extra in (
                (probe_scores, lambda: probe_scores(pre, q, w), (s9,), {}),
                (probe_scores_plus_dot, lambda: probe_scores_plus_dot(pre, q, w, wd),
                 (s10, d10, wd), {"bf16": 2.0 * d10.numel() * H})):
            ms = cuda_ms(call)
            with force_plain():
                plain_ms = cuda_ms(call, iters=3, warmup=1)
            records[fn.__name__] = {"ms": ms, "plain_ms": plain_ms,
                                    **bound(nbytes(pre, q, w, *outs), f32=tanh_ops, **extra)}
        records["probe_scores_plus_dot"]["product_only_ms"] = cuda_ms(
            lambda: probe_scores_plus_dot(pre, q, w, wd, scores=False))
        del wd, s9, s10, d10, d_only, pd
        wide = _rand(rng, (H, probe.KDS[-1]), 0.05, dev).to(bf16)  # the probe's wider product
        s_w, d_w = probe_scores_plus_dot(pre, q, w, wide)
        _, d_w_only = probe_scores_plus_dot(pre, q, w, wide, scores=False)
        pd_w = probe_dot_plain(q, wide, T)
        e_w = max(float((s_w - ps).abs().max()), float((d_w - pd_w).abs().max()),
                  float((d_w_only - pd_w).abs().max()))
        print(f"[17] {name} at KD={wide.shape[1]}: kernel 10 scores and product (and the "
              f"product alone) max|d| {e_w:.3e}")
        if not e_w <= TOL:
            fail(f"kernel 10 {name} at KD={wide.shape[1]}: max|d| {e_w:.3e} > {TOL}")
        worst["probe_scores_plus_dot"] = max(worst["probe_scores_plus_dot"], e_w)
        del s_w, d_w, d_w_only, pd_w, ps
        records["probe_scores_plus_dot"]["at_kd"] = {str(probe.KDS[-1]): {
            "ms": cuda_ms(lambda: probe_scores_plus_dot(pre, q, w, wide)),
            "product_only_ms": cuda_ms(lambda: probe_scores_plus_dot(pre, q, w, wide,
                                                                     scores=False))}}
        del pre, q, wide
    _reset_probe_counts()
    run = probe.run()
    torch.cuda.synchronize()
    counts = {"probe_scores": probe_scores.launches,
              "probe_scores_plus_dot": probe_scores_plus_dot.launches}
    _check_calls(17, run, counts)
    n_tanh = run["B"] * run["N"] * run["T"] * run["H"]
    for name, rec in records.items():
        rec.update(launches=counts[name], max_abs_err=worst[name], tanh_needed=n_tanh,
                   probe_ms_per_step={str(kd): row for kd, row in run["ms_per_step"].items()})
        print(f"[17] {name} {rec['ms']:.4f} ms vs plain {rec['plain_ms']:.4f} ms a call, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), SFU floor worked from the data "
              f"sheet (modelled) {floors['sfu_floor_ms']:.4f} ms on {floors['sms']} SMs, "
              f"{floors['sfu_floor_grid_ms']:.4f} ms for its grid's {blocks} blocks (at "
              f"{floors['sfu_clock_mhz']:.0f} MHz); launches {counts[name]} [{card}]")
    kd = min(run["ms_per_step"])
    rows = {kd: {k: round(v, 4) for k, v in row.items()} for kd, row in run["ms_per_step"].items()}
    print(f"[17] S0 (kernel 9, echr_tanh) evaluates "
          f"{n_tanh / run['ms_per_step'][kd]['S0'] / 1e6:.1f} M tanh a ms (KD={kd}) [{card}]")
    k10 = records["probe_scores_plus_dot"]
    at_kd = {kd: f"{r['ms']:.4f} ms, the product alone {r['product_only_ms']:.4f} ms"
             for kd, r in k10["at_kd"].items()}
    print(f"[17] kernel 10's product warps alone {k10['product_only_ms']:.4f} ms a call; "
          f"kernel 10 at KD={at_kd}; probe ms/step {rows} [{card}]")
    return records


def eval_setup(**runtime):
    """train_cfg()'s data (256 synthetic videos at the flagship width, the
    64-video val split) for the batched eval: the seeded random init, the
    dataset and a Loader whose prefetch covers two groups of 32."""
    from echr_tpu_torch.data.dataset import build_dataset
    from echr_tpu_torch.data.loader import Loader
    from echr_tpu_torch.models.registry import init_captioner, init_tap

    cfg = train_cfg(**runtime).replace_in("decoder", CG_vocab_size=VOCAB, CG_seq_length=SEQ_LEN)
    cfg = cfg.replace_in("data", prefetch=2 * EVAL_B, nthreads=4)
    ds = build_dataset(cfg)
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    return cfg, tap, cg, ds, Loader(ds, cfg, process_index=0, process_count=1, seed=0)


def usable_val_videos(cfg, ds):
    """The val videos eval counts (proposal_num > 0, n_frames > 1), from the
    labels-off batch."""
    from echr_tpu_torch.data.batcher import make_batch

    out = []
    for ix in ds.split_ix["val"]:
        _, m = make_batch(ds.get_example(ix), cfg, np.random.RandomState(0), labels=False)
        if m.proposal_num > 0 and m.n_frames > 1:
            out.append(m.vid)
    return out


def check_predictions(preds, usable, vocab, durations):
    """Every usable val video has predictions, at most TOP_N each, with
    well-formed timestamps, sentences in the vocab and re_score = 10 x
    proposal_score + sentence_confidence."""
    if sorted(preds) != sorted(usable):
        fail(f"predictions for {len(preds)} videos, {len(usable)} usable val videos")
    words = set(vocab.values())
    for vid, caps in preds.items():
        if not 0 < len(caps) <= TOP_N:
            fail(f"{vid}: {len(caps)} predictions")
        for c in caps:
            s, e = c["timestamp"]
            if not (0.0 <= s < e <= durations[vid] + 1e-6 and 0.0 <= c["proposal_score"] <= 1.0
                    and np.isfinite(c["sentence_confidence"])
                    and abs(c["re_score"] - 10 * c["proposal_score"]
                            - c["sentence_confidence"]) <= 1e-9):
                fail(f"{vid}: malformed prediction {c}")
            if not set(c["sentence"].split()) <= words:
                fail(f"{vid}: sentence outside the vocab: {c['sentence']!r}")


@contextlib.contextmanager
def timed_scoring(seconds):
    """Within the block, the batched eval's eval_score calls add their wall
    time to ``seconds``."""
    from echr_tpu_torch.engine import evaluate

    fn = evaluate.eval_score

    def timed(*args, **kw):
        t0 = time.time()
        try:
            return fn(*args, **kw)
        finally:
            seconds.append(time.time() - t0)
    evaluate.eval_score = timed
    try:
        yield
    finally:
        evaluate.eval_score = fn


def phase_eval(card):
    """The eval slice: eval_split_batched over the 64-video val split,
    tap_cg, top-128, batch 32, every metric: greedy with val losses, then
    beam 4 decode-only (no val losses)."""
    cfg, tap, cg, ds, loader = eval_setup()
    usable = usable_val_videos(cfg, ds)
    durations = {ds.get_example(ix).vid: ds.get_example(ix).duration for ix in ds.split_ix["val"]}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            return {name: eval_pass(card, name, beam, (tap, cg, loader, cfg), usable, durations,
                                    f"{tmp}/{name}.json")
                    for name, beam in (("eval_greedy", 1), ("eval_beam", BEAM))}
    finally:
        loader.load_state(loader.state())  # stops and joins the prefetch threads


def eval_pass(card, name, beam, args, usable, durations, json_path):
    """One pass of phase 18.  Kernel 1's launches must equal the decode steps
    plus the val losses' teacher-forced steps (29 a group), kernel 2's the
    greedy decode steps."""
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.metrics import scorers
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head

    tap, cg, loader, cfg = args
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": True, "val_all_metrics": True,
          "get_eval_loss": beam == 1, "beam_size": beam}
    # warm-up: one group, unscored (a first val-loss call takes seconds)
    eval_split_batched(tap, cg, loader, cfg, json_path,
                       dict(kw, num_vids_eval=EVAL_B, language_eval=False),
                       flag_eval_what="tap_cg", batch_videos=EVAL_B, device="cuda")
    torch.cuda.synchronize()
    timing, score_s = {}, []
    for fn in (attention_scores_masked, greedy_head):
        fn.launches = 0
    for fn in (decoder_sample_batched, beam_search_batched):
        fn.steps = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with timed_scoring(score_s):
        preds, score, losses = eval_split_batched(
            tap, cg, loader, cfg, json_path, dict(kw, timing_out=timing),
            flag_eval_what="tap_cg", batch_videos=EVAL_B, device="cuda")
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    if torch.backends.cuda.matmul.allow_tf32:  # phase 1 turned it off
        fail(f"{name}: the eval's two threads left TF32 on")
    k1, k2 = attention_scores_masked.launches, greedy_head.launches
    steps = decoder_sample_batched.steps if beam == 1 else beam_search_batched.steps
    check_predictions(preds, usable, loader.dataset.ix_to_word, durations)
    want_k1 = steps + ((SEQ_LEN - 1) * timing["groups"] if beam == 1 else 0)
    want_k2 = steps if beam == 1 else 0
    if not (steps > 0 and k1 == want_k1 and k2 == want_k2):
        fail(f"{name}: kernel 1 launched {k1} times (want {want_k1}), kernel 2 {k2} "
             f"(want {want_k2}) in {steps} decode steps")
    if beam == 1 and not (np.isfinite(losses).all() and (losses[:3] > 0).all()):
        fail(f"{name}: val losses {losses}")
    metrics = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr",
               "Recall", "Precision")
    if not all(np.shape(score.get(m)) == (4,) and np.isfinite(score[m]).all() for m in metrics):
        fail(f"{name}: scores {score}")
    stemmer = ("nltk PorterStemmer" if getattr(scorers._STEM, "__self__", None) is not None
               else "identity (nltk absent)")
    n_caps = sum(len(c) for c in preds.values())
    run = wall - sum(score_s)
    print(f"[18] {name}: {len(preds)} videos (of {len(usable)} usable), {n_caps} captions, "
          f"{timing['groups']} groups of {EVAL_B}, {steps} decode steps, kernel 1 launches "
          f"{k1}, kernel 2 {k2}; val losses {np.round(losses[:3], 4).tolist()}; all scored")
    print(f"[18] {name}: {len(preds) / run:.2f} eval videos/s, {n_caps / run:.1f} captions/s "
          f"over {run:.3f} s without scoring; eval_score {sum(score_s):.3f} s (stemmer: "
          f"{stemmer}); peak device memory {peak / 2**30:.2f} GiB, bf16 compute [{card}]")
    print(f"[18] {name} timing_out: "
          f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in timing.items()} }")
    print(f"[18] {name} scores: { {m: np.round(score[m], 4).tolist() for m in metrics} }")
    return {"attention_scores_masked": k1, "greedy_head": k2}


def phase_eval_parity():
    """f32, TF32 off, phase 5's sharpened logit weights: the greedy eval with
    the kernels and under force_plain() gives the same videos, sentences,
    timestamps and proposal scores, sentence confidences within 5e-4 a
    token (the caption's words and its end token) and val losses within
    1e-5 relative."""
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.ops import force_plain

    cfg, tap, cg, ds, loader = eval_setup(compute_dtype="float32")
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": False, "get_eval_loss": True}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            got, _, got_loss = eval_split_batched(tap, cg, loader, cfg, f"{tmp}/k.json", dict(kw),
                                                  batch_videos=EVAL_B, device="cuda")
            with force_plain():
                want, _, want_loss = eval_split_batched(tap, cg, loader, cfg,
                                                        f"{tmp}/p.json", dict(kw),
                                                        batch_videos=EVAL_B, device="cuda")
    finally:
        loader.load_state(loader.state())
    if sorted(got) != sorted(want) or not want:
        fail("eval parity: the kernels and the plain versions predicted for other videos")
    bad, worst, n = 0, 0.0, 0
    for vid, preds in want.items():
        if len(got[vid]) != len(preds):
            fail(f"eval parity: {vid} has {len(got[vid])} predictions against {len(preds)}")
        for g, w in zip(got[vid], preds):
            n += 1
            bad += (g["sentence"], g["timestamp"], g["proposal_score"]) != \
                (w["sentence"], w["timestamp"], w["proposal_score"])
            err = abs(g["sentence_confidence"] - w["sentence_confidence"])
            worst = max(worst, err / (len(w["sentence"].split()) + 1))
    rel = np.abs(got_loss[:3] - want_loss[:3]) / np.abs(want_loss[:3])
    print(f"[19] f32 eval, kernels vs plain: {len(want)} videos, {n} captions, {bad} differ in "
          f"sentence, timestamp or proposal score; max|d| confidence {worst:.3e} a token; val "
          f"losses {np.round(want_loss[:3], 6).tolist()} (rel {float(rel.max()):.2e})")
    if bad or not worst <= TOL or not float(rel.max()) <= 1e-5:
        fail("the eval pass with the kernels disagrees with its plain version")


def add_tanh_floor(rec, tanh_per_ms, rate_of):
    """tanh_floor_ms = tanh_needed over ``tanh_per_ms``, the measured rate
    of the kernel's own tanh (``rate_of`` names where it was measured), in
    rec and every record nested in it."""
    if "tanh_needed" in rec:
        rec.update(tanh_floor_ms=rec["tanh_needed"] / tanh_per_ms, tanh_floor_rate_of=rate_of)
    for v in rec.values():
        if isinstance(v, dict):
            add_tanh_floor(v, tanh_per_ms, rate_of)


def main():
    card = phase_device()
    scores = phase_scores(card)
    head = phase_head(card)
    launches, tap, cg, vocab, greedy_args = phase_slice(card)
    k1_inputs = {"phase2_synthetic": {k: v for k, v in scores.items()
                                      if k not in ("max_abs_err", "tanh_max_abs_err", "plain_ms",
                                                   "all_live_ms", "tanh_per_ms")}}
    k1_inputs["greedy_slice"] = kernel1_timing(card, "one greedy step of phase 4", greedy_args)
    del greedy_args
    phase_parity(tap, cg, vocab)
    dense = phase_scores_dense(card)
    bwd = phase_scores_bwd(card)
    train_launches, dense["training_masks"], bwd["training_g"] = phase_train(card)
    launches.update(train_launches)
    phase_train_parity()
    svc = caption_service()
    step = beam_step_tensors(svc)
    keys = ("pre", "q", "w", "b", "mask")
    k1_inputs["beam_step"] = kernel1_timing(card, "the beam path's step tensors",
                                            tuple(step[k] for k in keys))
    sw = short_windows(step)
    k1_inputs["beam_step_short_windows"] = kernel1_timing(
        card, "the beam path's step tensors, short windows", tuple(sw[k] for k in keys))
    del sw
    fused = phase_fused(card, step)
    windowed = phase_windowed(card, step)
    del step
    beam_launches = phase_beam(card, svc)
    del svc
    phase_beam_parity(tap, cg, vocab)
    probe_head = phase_probe_head(card)
    probe_sweep = phase_probe_sweep(card)
    overlap = phase_probe_overlap(card)
    evals = phase_eval(card)
    phase_eval_parity()
    scores.update(by_input=k1_inputs, beam_chunk_profile=beam_launches["kernel1_profile"])
    for rec in (scores, dense, bwd, *overlap.values()):
        add_tanh_floor(rec, scores["tanh_per_ms"], "kernel 1 with every entry live (phase 2)")
    for name, rec in k1_inputs.items():
        print(f"[6] kernel 1, {name}: {rec['ms']:.4f} ms, tanh-rate floor "
              f"{rec['tanh_floor_ms']:.4f} ms, live-work bound {rec['bound_ms']:.4f} ms [{card}]")
    for name, rec in (("every entry live", dense), ("windows in random order",
                                                    dense["windows"]),
                      ("the training step's masks", dense["training_masks"])):
        print(f"[7] kernel 3, {name}: {rec['ms']:.4f} ms, tanh-rate floor "
              f"{rec['tanh_floor_ms']:.4f} ms, live-work bound {rec['bound_ms']:.4f} ms [{card}]")
    for name, rec in (("dense g", bwd), ("windowed g", bwd["windowed_g"]),
                      ("the training step's g", bwd["training_g"])):
        print(f"[8] kernel 4, {name}: {rec['ms']:.4f} ms, tanh-rate floor "
              f"{rec['tanh_floor_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms [{card}]")
    k1_paths = {"greedy": launches["attention_scores_masked"],
                "beam": beam_launches["attention_scores_masked"],
                **{name: n["attention_scores_masked"] for name, n in evals.items()}}
    k2_paths = {"greedy": launches["greedy_head"], "eval_greedy": evals["eval_greedy"]["greedy_head"]}
    kernels = [
        {"name": "attention_scores_masked", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_scores.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:119",
         "launches": sum(k1_paths.values()), "launches_by_path": k1_paths, **scores},
        {"name": "greedy_head", "route": "cuda",
         "source": "echr_tpu_torch/csrc/greedy_head.cu",
         "replaces": "echr_tpu/ops/pallas_head.py:92",
         "launches": sum(k2_paths.values()), "launches_by_path": k2_paths, **head},
        {"name": "attention_scores_dense", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_scores.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:31",
         "launches": launches["attention_scores_dense"], **dense},
        {"name": "attention_scores_bwd", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_scores_bwd.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:310",
         "launches": launches["attention_scores_bwd"], **bwd},
        {"name": "attention_fused", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_fused.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:205", **fused},
        {"name": "windowed_attention", "route": "cuda",
         "source": "echr_tpu_torch/csrc/windowed_attention.cu",
         "replaces": "echr_tpu/ops/pallas_windowed_attention.py:37", **windowed},
        {"name": "probe_greedy_head", "route": "cuda",
         "source": "echr_tpu_torch/csrc/probe_stream_head.cu",
         "replaces": "experiments/probe_greedy_head.py:36", **probe_head},
        {"name": "probe_stream_head", "route": "cuda",
         "source": "echr_tpu_torch/csrc/probe_stream_head.cu",
         "replaces": "experiments/probe_streaming_head2.py:38", **probe_sweep},
        {"name": "probe_scores", "route": "cuda",
         "source": "echr_tpu_torch/csrc/probe_score_overlap.cu",
         "replaces": "experiments/probe_mxu_vpu_overlap.py:55", **overlap["probe_scores"]},
        {"name": "probe_scores_plus_dot", "route": "cuda",
         "source": "echr_tpu_torch/csrc/probe_score_overlap.cu",
         "replaces": "experiments/probe_mxu_vpu_overlap.py:62",
         **overlap["probe_scores_plus_dot"]},
    ]
    foreign = sorted(m for m in sys.modules
                     if m in ("jax", "echr_tpu", "experiments")
                     or m.startswith(("jax.", "echr_tpu.", "experiments.")))
    if foreign:
        fail(f"imported {foreign[:5]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
