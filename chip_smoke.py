#!/usr/bin/env python3
"""Drive echr_tpu_torch's batched greedy and beam serving paths, its XE
training path, its three probes, its batched eval loop, its checkpointed
training, its self-critical (SCST) training, its multinomial eval and the
decoder family's other cores once on one NVIDIA GPU, and hold every
kernel against its plain PyTorch version.

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
     greedy decode steps; TF32 is still off after each pass (every bf16
     product turns it on for its own duration).  For each pass,
     after a warm-up group: eval videos/s and captions/s without scoring,
     the timing_out breakdown, the seconds in eval_score and its stemmer,
     peak device memory;
  19. eval parity: at f32 with TF32 off and phase 5's sharpened logit
     weights, the greedy eval with the kernels and under force_plain()
     gives the same sentences, timestamps and proposal scores for every
     video, sentence confidences within 5e-4 a token and val losses within
     1e-5 relative;
  20. checkpointed training: engine.train.train on train_cfg() (nothing
     cut) for 8 steps with save_checkpoint_every 4 from epoch 0, so the
     gate runs at 4 and 8, each over one group of 32 val videos, the cg
     pass and then the tap_cg pass, every metric scored.  Kernels 3 and
     4 launch 29 times a step and a histogram step, kernel 1 once a gate
     decode step and 29 times a val-loss group, kernel 2 once a decode
     step; the best score is the gates' highest, model-best.ckpt holds it;
     TF32 is off after the gates; model-last.ckpt read back onto the card
     equals the run's state, parameters and Adam state; serve's
     from_checkpoint on model-best.ckpt captions phase 6's requests.
     ms/step outside the gate, each gate's seconds by pass and in
     eval_score, the checkpoints' bytes and seconds to write and to read,
     peak device memory with the gate inside the run;
  21. preemption: a hook on train_step sends the process SIGTERM before
     step 3; train() returns at step 3 with a readable model-last.ckpt
     and its handler restored, and start_from runs on to step 5;
  22. resume parity: at f32 with TF32 off, dropout and scheduled sampling
     off (steps without a generator), 3 steps then a resume to 6 against 6
     straight: the losses of steps 4-6 within 1e-5 relative, the
     parameters within atol 1e-5;
  23. SCST training: engine.train.train on train_cfg() with
     self_critical_after 0 (B=32 videos of T=256, N=64 sampled
     proposals, vocab 6000, L=30, tap_cg, bf16 with f32 masters, dropout
     on; nothing cut): 1 warm-up and 4 timed steps.  Finite losses,
     avg_reward logged, moved parameters; kernel 1 launches once a greedy
     baseline decode step, kernel 2 too (R = B*N = 2048), kernel 3 once a
     sampled decode step and 30 times a replay, kernel 4 30 times a step.
     ms/step split into the rollouts (sampled + greedy baseline), the host
     METEOR reward (pool size, stemmer) and the update; the steps each
     rollout's early exit ran; peak device memory.  The reward pool's
     workers are joined at the end;
  24. SCST fidelity: f32, TF32 off, phase 5's sharpened weights, dropout
     on, B=4: the replay's logps of the rollout's tokens equal the
     rollout's within 1e-5; the greedy baseline's tokens equal with the
     kernels and under force_plain(); one update's loss within 1e-5
     relative and its gradient leaves within atol 2e-4, rtol 1e-3 with the
     kernels and under force_plain(); kernels 1 and 2 on copies of the
     baseline's first call, kernels 3 and 4 on copies of each of the
     replay's calls, against their plain versions within 5e-4 (kernel 4's
     d_w within 1e-4 of its largest entry);
  25. multinomial eval: eval_split_batched with sample_max 0, temperature
     1, sample_seed 7 over phase 18's val split (tap_cg, top-128, batch 32,
     decode-only, every metric) after a warm-up group: well-formed
     predictions, kernel 1's launches equal the decode steps and kernel 2
     none, eval videos/s and captions/s without eval_score (printed
     beside), and a second pass with the seed gives the same predictions
     JSON.  Then at f32 on phase 5's weights, the greedy pass against
     sampling at T=1e-3: every draw whose top two logits lie >= 20 T apart
     takes the argmax, the draws that leave it number what the tempered
     softmax expects (within 5 standard deviations), and no more
     sentences differ than draws that left the argmax or met a top-2 gap
     below 1e-4;
  26. the decoder family: kernel 2 at the family's logit widths (R=4096,
     C=512 and C=1024, V1=6001, bf16) against its plain version and timed
     beside its bound and the bare bf16 product in turns, as phase 6; then
     each core of CORE_REGISTRY but three_stream at the flagship width
     (show_attend_tell and all_img with CG_num_layers 3, "V+E+C" inputs and
     a "V+E" init state): CaptionService greedy over a timed 32-video chunk
     after a warm-up chunk (kernel 2 once a decode step, kernel 1 too where
     the attention is live and never where it is not; captions/s), the f32
     decode of 4 videos with the kernels and under force_plain() (phase 5's
     gates), and 1 warm-up and 2 timed XE steps of engine.train.train at
     B=8 (finite losses, moved parameters, kernels 3 and 4 once a
     teacher-forced step, none for all_img; ms/step); for show_attend_tell
     also beam 4 over a timed chunk (kernel 1 once a beam step) and one
     timed SCST step at B=8 after a warm-up step (phase 23's launch
     counts).  The phase's wall seconds.

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
    """Within the block, module.name(*args, **kw) first calls hook(*args)."""
    fn = getattr(module, name)

    @functools.wraps(fn)  # with its attributes: fn counts its launches on its global name
    def wrapper(*args, **kw):
        hook(*args)
        return fn(*args, **kw)
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def patched(module, name, fn):
    """Within the block, module.name is fn."""
    before = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, before)


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
    version (kernel1_check), its time and its plain version's, its
    live-work bound and its tanh."""
    from echr_tpu_torch.ops import force_plain
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
    with force_plain():
        rec["plain_ms"] = cuda_ms(lambda: attention_scores_masked(*args), iters=5)
    need = max(work["tanh_needed"], 1)
    print(f"[6] kernel 1, {name} B={B} N={N} T={T} H={H} (density {rec['density']:.3f}): "
          f"max|d| where mask==1 {err:.3e}; {rec['ms']:.4f} ms, plain version "
          f"{rec['plain_ms']:.4f} ms, live-work bound "
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


def head_check(tag, name, args):
    """Kernel 2 on args (out, w, b) against its plain version: the same
    token on every row whose top two logits are more than 1e-3 apart, max
    and logsumexp within TOL.  Returns (max |d|, the kernel's outputs)."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_head import greedy_head

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
    print(f"[{tag}] head {name}: {bad} token mismatches on {int(clear.sum())}/{len(clear)} "
          f"rows with top-2 gap > 1e-3; max|d| max/lse {err:.3e}")
    if bad or not err <= TOL:
        fail(f"kernel 2 {name} disagrees with its plain version")
    return err, outs


def phase_head(card):
    from echr_tpu_torch.ops.kernel_head import greedy_head, split_plan

    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for name, (R, C, V1, dtype) in {
        "serving_bf16": (4096, 1536, 6001, torch.bfloat16),
        # the gate's cg pass: 32 videos x bucket 64 (another vocab split)
        "gate_cg_bf16": (2048, 1536, 6001, torch.bfloat16),
        "serving_f32": (4096, 1536, 6001, torch.float32),
        "ragged_bf16": (1000, 200, 777, torch.bfloat16),
        "ragged_unaligned_bf16": (77, 36, 130, torch.bfloat16),
        "ragged_f32": (77, 36, 130, torch.float32),
        "ragged_unaligned_f32": (33, 30, 70, torch.float32),
    }.items():
        args = head_inputs(rng, R, C, V1, dtype, dev)
        err, outs = head_check("3", f"{name} ({split_plan(R, V1, sms, dtype)[1]} splits)",
                               args)
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


def head_timing(card, args, outs, plan, tag="6"):
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
    print(f"[{tag}] head kernel " + ", ".join(f"{k} {x:.4f} / {y:.4f}" for k, (x, y) in turns.items())
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


def check_captions(res, reqs, ties=False):
    """Every request captioned, TOP_N captions each (with ``ties``, also
    more: proposals tied at the top-N threshold are all kept, as in
    echr_tpu, so every caption past the TOP_N-th scores exactly the TOP_N-th
    largest proposal score), well-formed timestamps, scores and
    sentences."""
    if sorted(res) != sorted(r.vid for r in reqs):
        fail("not every request was captioned")
    for r in reqs:
        caps = res[r.vid]
        scores = sorted((c.proposal_score for c in caps), reverse=True)
        tied = len(caps) > TOP_N and all(x == scores[TOP_N - 1] for x in scores[TOP_N:])
        if not (len(caps) == TOP_N or ties and tied):
            fail(f"{r.vid}: {len(caps)} captions, expected {TOP_N}"
                 + (" and threshold ties past it" if ties else "")
                 + f"; scores from the {TOP_N}-th on {scores[TOP_N - 1:TOP_N + 3]}")
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
    and the plain version's (the means over the list), its bound over the
    live (n, t) and the tanh they need."""
    from echr_tpu_torch.ops import force_plain
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
    with force_plain():
        rec["plain_ms"] = cuda_ms(lambda: [attention_scores_dense(*raw) for raw in raws],
                                  iters=3, warmup=1) / len(raws)
    print(f"[{tag}] kernel 3, {name} B={B} N={N} T={T} H={H} (density {rec['density']:.4f}"
          f"{f', mean of {len(raws)} calls' if len(raws) > 1 else ''}): max|d| where mask==1 "
          f"{err:.3e}, masked entries 0; {rec['ms']:.4f} ms a call, plain version "
          f"{rec['plain_ms']:.4f} ms, live-work bound "
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
    inputs = kernel3_inputs(np.random.RandomState(4), torch.device("cuda"))
    err, _ = kernel3_check("ragged", inputs["ragged"])
    (B, T, H), N = inputs["ragged"][0].shape, inputs["ragged"][1].shape[1]
    print(f"[7] kernel 3, ragged B={B} N={N} T={T} H={H}, unsorted windows (density "
          f"{float(inputs['ragged'][4].mean()):.3f}): max|d| where mask==1 {err:.3e}, masked "
          f"entries 0")
    record = kernel3_timing(card, "training shapes, every entry live", [inputs["all_live"]])
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
    bit-identical; ms a call and the plain version's (the means over the
    list), and the bound over the nonzero cotangents."""
    from echr_tpu_torch.ops import force_plain
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
    with force_plain():
        rec["plain_ms"] = cuda_ms(call, iters=3, warmup=1) / len(raws)
    print(f"[{tag}] kernel 4, {name} B={B} N={N} T={T} H={H} (nonzero g {rec['g_nonzero']:.3f}"
          f"{f', mean of {len(raws)} calls' if len(raws) > 1 else ''}): two calls bit-identical; "
          f"{rec['ms']:.4f} ms a call, plain version {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) [{card}]")
    return rec


def phase_scores_bwd(card):
    """Kernel 4 against the autograd of the plain forward (_bwd_check) at
    the training and ragged shapes with a dense cotangent, and at the
    training shapes with one that is zero outside sorted windows drawn by
    _windows_mask (the masked softmax gives exactly that); its time with
    both."""
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
    with patched(evaluate, "eval_score", timed):
        yield


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
        fail(f"{name}: the eval left TF32 on")
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
    the kernels and under force_plain(), in the tap_cg mode and in the cg
    mode that phase 20's gate runs first (GT proposals, bucket 64), gives
    the same videos, sentences, timestamps and proposal scores, sentence
    confidences within 5e-4 a token (the caption's words and its end
    token) and val losses within 1e-5 relative."""
    cfg, tap, cg, ds, loader = eval_setup(compute_dtype="float32")
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
    try:
        for mode in ("tap_cg", "cg"):
            eval_parity(tap, cg, loader, cfg, mode)
    finally:
        loader.load_state(loader.state())


def eval_parity(tap, cg, loader, cfg, mode):
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.ops import force_plain

    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": False, "get_eval_loss": True}
    with tempfile.TemporaryDirectory() as tmp:
        got, _, got_loss = eval_split_batched(tap, cg, loader, cfg, f"{tmp}/k.json", dict(kw),
                                              flag_eval_what=mode, batch_videos=EVAL_B,
                                              device="cuda")
        with force_plain():
            want, _, want_loss = eval_split_batched(tap, cg, loader, cfg, f"{tmp}/p.json",
                                                    dict(kw), flag_eval_what=mode,
                                                    batch_videos=EVAL_B, device="cuda")
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
    print(f"[19] f32 {mode} eval, kernels vs plain: {len(want)} videos, {n} captions, {bad} "
          f"differ in sentence, timestamp or proposal score; max|d| confidence {worst:.3e} a "
          f"token; val losses {np.round(want_loss[:3], 6).tolist()} (rel {float(rel.max()):.2e})")
    if bad or not worst <= TOL or not float(rel.max()) <= 1e-5:
        fail(f"the {mode} eval pass with the kernels disagrees with its plain version")


CKPT_STEPS, CKPT_EVERY = 8, 4  # phase 20: steps, save_checkpoint_every (two gates)
RESUME_K = 3  # phases 21-22: the step a run is stopped at


def ckpt_train_cfg(folder, **runtime):
    """train_cfg() (bench.py's e2e_train_cfg, nothing cut) with checkpoints
    into ``folder``: save_checkpoint_every 4 from epoch 0, each gate over
    one group of EVAL_B val videos, the cg pass and then the tap_cg pass
    (fast_eval_cg off)."""
    cfg = train_cfg(**runtime).replace(run_id="ckpt")
    cfg = cfg.replace_in("save", checkpoint_path=folder, save_checkpoint_every=CKPT_EVERY,
                         min_epoch_when_save=0)
    return cfg.replace_in("eval", num_vids_eval=EVAL_B, batch_videos=EVAL_B, fast_eval_cg=False)


def first_of_each_shape(kept):
    """A hook that keeps a copy of the arguments of the first call of each
    shape and dtype signature in ``kept``."""
    def keep(*args):
        key = tuple((tuple(x.shape), x.dtype) for x in args)
        if key not in kept:
            kept[key] = tuple(x.detach().clone() for x in args)
    return keep


def phase_ckpt_train(card):
    """Phase 20: checkpointed training through engine.train.train: 8 steps,
    gates at 4 and 8, model-last / model-best, then the checkpoint read
    back and served.  Kernels 1 and 2 are held against their plain versions
    on a copy of the arguments of their first call at each shape the run
    gave them (the gate's cg and tap_cg decodes and val losses); the
    training steps give kernels 3 and 4 phase 9's shapes, held there on
    the step's own inputs.  Returns kernels 1-4's launches in the run."""
    import os

    from echr_tpu_torch.engine import checkpoint
    from echr_tpu_torch.engine import train as train_mod
    from echr_tpu_torch.models import decoder
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops import attention
    from echr_tpu_torch.ops.kernel_attention import (attention_scores_bwd,
                                                     attention_scores_dense,
                                                     attention_scores_masked)
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.serve import from_checkpoint

    kernels = (attention_scores_masked, greedy_head, attention_scores_dense,
               attention_scores_bwd)
    passes, score_s, saves = [], [], []
    eval_fn, save_fn = train_mod.eval_split_batched, checkpoint.save_checkpoint

    def timed_eval(tap, cg, loader, cfg, json_path, kw, **k):
        kw = dict(kw, timing_out={})
        t0 = time.time()
        res = eval_fn(tap, cg, loader, cfg, json_path, kw, **k)
        torch.cuda.synchronize()
        passes.append((k["flag_eval_what"], time.time() - t0, kw["timing_out"]["groups"]))
        return res

    def timed_save(path, *a, **k):
        t0 = time.time()
        save_fn(path, *a, **k)
        saves.append((os.path.basename(path), time.time() - t0, os.path.getsize(path)))

    with tempfile.TemporaryDirectory() as tmp:
        cfg = ckpt_train_cfg(tmp)
        timing = {}
        for fn in kernels:
            fn.launches = 0
        decoder_sample_batched.steps = 0
        torch.cuda.reset_peak_memory_stats()
        seen1, seen2 = {}, {}
        with patched(train_mod, "eval_split_batched", timed_eval), \
                patched(checkpoint, "save_checkpoint", timed_save), timed_scoring(score_s), \
                wrapped(attention, "attention_scores_masked", first_of_each_shape(seen1)), \
                wrapped(decoder, "greedy_head", first_of_each_shape(seen2)):
            out = train_mod.train(cfg, max_iterations=CKPT_STEPS, device="cuda",
                                  timing_out=timing)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in kernels}
        steps = decoder_sample_batched.steps
        peak = torch.cuda.max_memory_allocated()

        tf_steps = SEQ_LEN - 1
        gates = [it for it, _ in timing["ckpt"]]
        groups = sum(g for _, _, g in passes)
        folder = out["save_folder"]
        last, best = (os.path.join(folder, f"model-{w}.ckpt") for w in ("last", "best"))
        raw = checkpoint.load_checkpoint(last, rebuild_state=False)
        val = raw["histories"]["val"]
        gate_scores = {it: float(np.mean(val[it]["METEOR"])) * 100 for it in gates}
        want = {"attention_scores_dense": tf_steps * (CKPT_STEPS + len(gates)),
                "attention_scores_bwd": tf_steps * (CKPT_STEPS + len(gates)),
                "attention_scores_masked": steps + tf_steps * groups, "greedy_head": steps}
        if out["iteration"] != CKPT_STEPS or gates != [CKPT_EVERY, 2 * CKPT_EVERY]:
            fail(f"checkpointed training: iteration {out['iteration']}, gates at {gates}")
        if [m for m, _, _ in passes] != ["cg", "tap_cg"] * 2 or groups != 4:
            fail(f"checkpointed training: gate passes {passes}")
        if not (steps > 0 and launches == want):
            fail(f"checkpointed training: launches {launches}, want {want} ({steps} decode "
                 f"steps, {groups} val-loss groups)")
        if not (seen1 and seen2):
            fail("checkpointed training: no call of kernel 1 or 2 was seen")
        worst1 = max(kernel1_check(f"gate {key}", args)[0] for key, args in seen1.items())
        worst2 = max(head_check("20", f"gate R={args[0].shape[0]} {args[1].dtype}", args)[0]
                     for args in seen2.values())
        print(f"[20] kernel 1 at the run's {len(seen1)} shapes "
              f"{[tuple(k[0][0]) + (k[1][0][1],) for k in seen1]} (pre [B, T, H], N): max|d| "
              f"where mask==1 {worst1:.3e}, masked entries 0; kernel 2 at its "
              f"{len(seen2)} shapes (R, C) {[k[0][0] for k in seen2]}: max|d| max/lse "
              f"{worst2:.3e}; against their plain versions")
        del seen1, seen2
        if sorted(val) != gates or out["best_val_score"] != max(gate_scores.values()):
            fail(f"checkpointed training: best {out['best_val_score']}, gates {gate_scores}")
        best_raw = checkpoint.load_checkpoint(best, rebuild_state=False)
        if gate_scores[best_raw["iteration"]] != best_raw["best_val_score"]:
            fail(f"model-best.ckpt at iteration {best_raw['iteration']} holds score "
                 f"{best_raw['best_val_score']}, the gate gave {gate_scores}")
        if torch.backends.cuda.matmul.allow_tf32:
            fail("checkpointed training: the gate left TF32 on")
        torch.cuda.synchronize()
        t0 = time.time()
        loaded = checkpoint.load_checkpoint(last, "cuda")
        torch.cuda.synchronize()
        read_s = time.time() - t0
        st, ld = out["state"], loaded["state"]
        for name in ("tap", "cg"):
            for (pn, a), b in zip(getattr(st, name).named_parameters(),
                                  getattr(ld, name).parameters()):
                sa, sb = getattr(st, name + "_opt").state[a], getattr(ld, name + "_opt").state[b]
                if not (torch.equal(a, b) and all(torch.equal(sa[k].cpu(), sb[k].cpu())
                                                  for k in sa)):
                    fail(f"model-last.ckpt read back: {name}.{pn} or its Adam state differs")
        reqs = requests(64, seed=2)
        svc = from_checkpoint(best, device="cuda", batch_videos=32, topN=TOP_N)
        t0 = time.time()
        res = svc.caption(reqs)
        torch.cuda.synchronize()
        serve_s = time.time() - t0
        check_captions(res, reqs, ties=True)

    t = dict(timing["iters"])
    ck = dict(timing["ckpt"])
    dt = (t[CKPT_STEPS] - t[1] - ck[CKPT_EVERY]) / (CKPT_STEPS - 1)
    print(f"[20] checkpointed training: {out['iteration']} steps of {TRAIN_B} videos "
          f"(cotrain/tap_cg, bf16, dropout on), gates at {gates} over {EVAL_B} val videos "
          f"(cg, then tap_cg), scores {gate_scores}, best {out['best_val_score']:.4f} at "
          f"iteration {best_raw['iteration']}; launches {launches} ({steps} decode steps)")
    print(f"[20] {1000 * dt:.1f} ms/step outside the gate (steps 2-{CKPT_STEPS} less the "
          f"boundary at {CKPT_EVERY}); peak device memory {peak / 2**30:.2f} GiB with the "
          f"gate inside the run [{card}]")
    for i, it in enumerate(gates):
        (m1, s1, _), (m2, s2, _) = passes[2 * i:2 * i + 2]
        print(f"[20] boundary at {it}: {ck[it]:.3f} s; gate {s1 + s2:.3f} s = {m1} pass "
              f"{s1:.3f} s (eval_score {score_s[2 * i]:.3f} s) + {m2} pass {s2:.3f} s "
              f"(eval_score {score_s[2 * i + 1]:.3f} s); histograms and saves "
              f"{ck[it] - s1 - s2:.3f} s [{card}]")
    for name, sec, size in saves:
        print(f"[20] wrote {name}: {size} bytes ({size / 2**20:.1f} MiB) in {sec:.3f} s")
    print(f"[20] read model-last.ckpt onto the card: {read_s:.3f} s; the state read back "
          f"equals the run's, parameters and Adam state [{card}]")
    n_caps = sum(len(c) for c in res.values())
    print(f"[20] serve.from_checkpoint(model-best.ckpt): {len(res)} requests, {n_caps} "
          f"captions (top-{TOP_N} with threshold ties) in {serve_s:.3f} s, e.g. {res['v0'][0]}")
    return launches


def phase_preempt():
    """Phase 21: SIGTERM, sent from a hook on train_step before step 3, stops
    train() at step 3 with a readable model-last.ckpt and the handler
    restored; start_from then runs to step 5."""
    import os
    import signal

    from echr_tpu_torch.engine import checkpoint
    from echr_tpu_torch.engine import train as train_mod

    calls = []

    def sigterm_at_k(*args):
        calls.append(1)
        if len(calls) == RESUME_K:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ckpt_train_cfg(tmp).replace_in("save", save_checkpoint_every=10**9)
        with wrapped(train_mod, "train_step", sigterm_at_k):
            out = train_mod.train(cfg, max_iterations=RESUME_K + 5, device="cuda")
        last = checkpoint.load_checkpoint(os.path.join(out["save_folder"], "model-last.ckpt"),
                                          "cuda")
        if signal.getsignal(signal.SIGTERM) is not before:
            fail("train() left its SIGTERM handler installed")
        if not (out["iteration"] == last["iteration"] == last["state"].step == RESUME_K):
            fail(f"SIGTERM before step {RESUME_K}: train() returned at {out['iteration']}, "
                 f"model-last.ckpt at {last['iteration']}")
        res = train_mod.train(cfg.replace_in("save", start_from=cfg.run_id),
                              max_iterations=RESUME_K + 2, device="cuda")
    if not (res["iteration"] == res["state"].step == RESUME_K + 2
            and all(np.isfinite(v) for v in res["losses"].values())):
        fail(f"resume after SIGTERM: iteration {res['iteration']}, losses {res['losses']}")
    print(f"[21] SIGTERM before step {RESUME_K}: train() returned at iteration "
          f"{out['iteration']} with a readable model-last.ckpt, handler restored; start_from "
          f"ran to {res['iteration']}, losses {res['losses']['loss']:.4f}")


def phase_resume_parity():
    """Phase 22: f32, TF32 off, dropout and scheduled sampling off (steps
    without a generator: the three_stream core's dropout has no setting):
    3 steps, then a resume to 6, against 6 steps straight.  Gates: the
    losses of steps 4-6 within 1e-5 relative, the parameters within atol
    1e-5."""
    from echr_tpu_torch.engine import steps as steps_mod
    from echr_tpu_torch.engine import train as train_mod

    losses = []

    def no_dropout(state, batch, gen, *a, **k):
        state, m = steps_mod.train_step(state, batch, None, *a, **k)
        losses.append(m["loss"])
        return state, m

    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 22 needs TF32 off")
    with tempfile.TemporaryDirectory() as tmp, patched(train_mod, "train_step", no_dropout):
        cfg = ckpt_train_cfg(tmp, compute_dtype="float32").replace_in(
            "save", save_checkpoint_every=10**9)
        cfg = cfg.replace_in("tap", rnn_dropout=0.0).replace_in("decoder", CG_drop_prob=0.0)
        straight = train_mod.train(cfg.replace(run_id="S"), max_iterations=2 * RESUME_K,
                                   device="cuda")
        want = losses[RESUME_K:]
        del losses[:]
        train_mod.train(cfg.replace(run_id="K"), max_iterations=RESUME_K, device="cuda")
        resumed = train_mod.train(cfg.replace(run_id="K").replace_in("save", start_from="K"),
                                  max_iterations=2 * RESUME_K, device="cuda")
        got = losses[RESUME_K:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    err = max(float((a - b).detach().abs().max()) for name in ("tap", "cg")
              for a, b in zip(getattr(straight["state"], name).parameters(),
                              getattr(resumed["state"], name).parameters()))
    print(f"[22] f32 resume at step {RESUME_K} of {2 * RESUME_K}: losses of steps "
          f"{RESUME_K + 1}-{2 * RESUME_K} {[round(x, 6) for x in got]} against "
          f"{[round(x, 6) for x in want]} (max rel {rel:.2e}); parameters max|d| {err:.3e}")
    if len(got) != RESUME_K or not rel <= 1e-5 or not err <= 1e-5:
        fail("the resumed run disagrees with the uninterrupted one")


SCST_STEPS = 5  # phase 23: SCST steps (1 warm-up)
SAMPLE_SEED, COLD_T = 7, 1e-3  # phase 25: the draws' seed; the near-greedy temperature


def scst_cfg(**runtime):
    """train_cfg() (bench.py's e2e_train_cfg, nothing cut) with SCST from
    epoch 0."""
    return train_cfg(**runtime).replace_in("train", self_critical_after=0)


def stemmer_name():
    from echr_tpu_torch.metrics import scorers

    return ("nltk PorterStemmer" if getattr(scorers._STEM, "__self__", None) is not None
            else "identity (nltk absent)")


def phase_scst_train(card):
    """Phase 23: SCST through engine.train.train at the flagship width: 1
    warm-up and 4 timed steps of 32 videos.  Kernel 1 launches once a
    greedy-baseline decode step, kernel 2 too (R = B*N = 2048), kernel 3
    once a sampled decode step and L times a replay, kernel 4 L times an
    update.  Returns kernels 1-4's launches in the run."""
    from echr_tpu_torch.engine import rl
    from echr_tpu_torch.engine.train import train
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops.kernel_attention import (attention_scores_bwd,
                                                     attention_scores_dense,
                                                     attention_scores_masked)
    from echr_tpu_torch.ops.kernel_head import greedy_head

    kernels = (attention_scores_masked, greedy_head, attention_scores_dense,
               attention_scores_bwd)
    cfg = scst_cfg()
    timing = {}
    for fn in kernels:
        fn.launches = 0
    decoder_sample_batched.steps = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        out = train(cfg, max_iterations=SCST_STEPS, device="cuda", timing_out=timing)
        torch.cuda.synchronize()
    finally:
        rl.close_default_reward_pool()  # joins the reward workers
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()
    sc = timing["scst"]
    if out["iteration"] != SCST_STEPS or len(sc) != SCST_STEPS:
        fail(f"SCST: train stopped at iteration {out['iteration']} with {len(sc)} SCST steps")
    if not all(np.isfinite(v) for v in out["losses"].values()) or "avg_reward" not in out[
            "losses"]:
        fail(f"SCST: losses {out['losses']}")
    sampled = sum(s["sample_steps"] for s in sc)
    greedy = sum(s["greedy_steps"] for s in sc)
    want = {"attention_scores_masked": greedy, "greedy_head": greedy,
            "attention_scores_dense": sampled + SEQ_LEN * SCST_STEPS,
            "attention_scores_bwd": SEQ_LEN * SCST_STEPS}
    decoded = sampled + greedy + SEQ_LEN * SCST_STEPS  # the replays run all L steps
    if launches != want or decoder_sample_batched.steps != decoded:
        fail(f"SCST: launches {launches}, want {want} ({sampled} sampled and {greedy} greedy "
             f"decode steps; the decoder counted {decoder_sample_batched.steps})")
    t = dict(timing["iters"])
    dt = (t[SCST_STEPS] - t[1]) / (SCST_STEPS - 1)
    part = {k: 1000 * np.mean([s[k] for s in sc[1:]]) for k in ("rollout", "reward", "update")}
    print(f"[23] SCST: {out['iteration']} steps of {TRAIN_B} videos (cotrain/tap_cg, vocab "
          f"{VOCAB}, L={SEQ_LEN}, T={T_BUCKET}, N={cfg.tap.prop_sample_num}, bf16, dropout on, "
          f"self_critical_after 0; nothing cut); launches {launches}; sampled decode steps "
          f"{[s['sample_steps'] for s in sc]}, greedy baseline steps "
          f"{[s['greedy_steps'] for s in sc]}; avg_reward a step "
          f"{[round(s['avg_reward'], 5) for s in sc]}; last losses "
          f"{ {k: round(v, 5) for k, v in out['losses'].items()} }")
    print(f"[23] SCST {1000 * dt:.1f} ms/step over steps 2-{SCST_STEPS}: rollouts (sampled + "
          f"greedy baseline) {part['rollout']:.1f} ms, host reward {part['reward']:.1f} ms "
          f"({sc[-1]['reward_rows']} proposal rows, 2 captions each, pool of "
          f"{sc[-1]['pool_workers']} workers, stemmer: {stemmer_name()}), update "
          f"{part['update']:.1f} ms; the warm-up step {1000 * sum(sc[0][k] for k in part):.1f} "
          f"ms; peak device memory {peak / 2**30:.2f} GiB [{card}]")
    gen = torch.Generator().manual_seed(cfg.train.seed)  # train()'s init, again
    tap0, cg0 = init_tap(gen, out["config"]), init_captioner(gen, out["config"])
    for name, m0, m in (("tap", tap0, out["state"].tap), ("cg", cg0, out["state"].cg)):
        for (pn, p0), p in zip(m0.named_parameters(), m.parameters()):
            # the score bias shifts every score of a masked softmax: its
            # gradient is 0 up to rounding, and Adam's step on that rounds away
            if pn != "decoder.core.attention.alpha_net.bias" and torch.equal(
                    p0, p.detach().cpu()):
                fail(f"SCST: {name}.{pn} did not move in {out['iteration']} steps")
    return launches


def kernel4_check(name, args):
    """Kernel 4 on args (pre, q, w, g) against its plain version: d_pre and
    d_q within TOL, d_w (a sum of B*N*T terms) within 1e-4 of its largest
    entry.  Returns the worst d_pre / d_q error."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd

    got = attention_scores_bwd(*args)
    torch.cuda.synchronize()
    with force_plain():
        want = attention_scores_bwd(*args)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    if not (max(errs[:2]) <= TOL and errs[2] <= 1e-4 * float(want[2].abs().max())):
        fail(f"kernel 4 {name}: max|d| d_pre, d_q, d_w {errs}")
    return max(errs[:2])


def scst_parity_setup():
    """Phase 24's f32 state (phase 5's sharpened logit weights) and a batch
    of 4 videos of train_cfg()'s widths."""
    from echr_tpu_torch.data.batcher import make_batch
    from echr_tpu_torch.data.dataset import SyntheticDataset
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine.train import _collate
    from echr_tpu_torch.models.registry import init_captioner, init_tap

    cfg = scst_cfg(compute_dtype="float32").replace_in("decoder", CG_vocab_size=VOCAB,
                                                         CG_seq_length=SEQ_LEN)
    ds = SyntheticDataset(cfg, num_videos=8, seed=11)
    batch = steps.batch_to_device(_collate([
        make_batch(ds.get_example(i), cfg, np.random.RandomState(i), w1=ds.w1)[0]
        for i in range(4)]), "cuda")
    gen = torch.Generator().manual_seed(0)
    state = steps.init_train_state(cfg, init_tap(gen, cfg, "cuda"),
                                   init_captioner(gen, cfg, "cuda"))
    with torch.no_grad():
        state.cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
    return cfg, batch, state


def reward_mask(seq):
    """reward_loss's token mask: every emitted token and the end token."""
    m = (seq > 0).float()
    return torch.cat([torch.ones_like(m[..., :1]), m[..., :-1]], dim=-1)


def phase_scst_parity():
    """Phase 24: f32, TF32 off, phase 5's sharpened weights, dropout on, from
    the same generator states: the replay's logps of the rollout's tokens
    equal the rollout's within 1e-5; the greedy baseline's tokens are equal
    with the kernels and under force_plain(); one update's loss within 1e-5
    relative and its gradient leaves within atol 2e-4, rtol 1e-3 with the
    kernels and under force_plain(); kernels 1-4 on copies of the step's
    own arguments agree with their plain versions within 5e-4."""
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.models import decoder
    from echr_tpu_torch.ops import attention, force_plain, kernel_attention

    if torch.backends.cuda.matmul.allow_tf32:
        fail("phase 24 needs TF32 off")
    cfg, batch, state = scst_parity_setup()
    phase = "tap_cg"

    def gens(seed):
        return (torch.Generator(device="cuda").manual_seed(seed),
                torch.Generator(device="cuda").manual_seed(seed + 1))

    # the rollout and its replay, dropout on, kernels on
    gen, sample_gen = gens(21)
    before = gen.get_state()
    with torch.no_grad():
        _, seq, logps = steps._rl_forward(state.tap, state.cg, cfg, batch, phase, gen,
                                          sample_gen)
    gen.set_state(before)
    _, seq2, logps2 = steps._rl_forward(state.tap, state.cg, cfg, batch, phase, gen,
                                        forced=seq)
    m = reward_mask(seq)
    err_replay = float(((logps2.detach() - logps) * m).abs().max())
    del logps2
    if not (torch.equal(seq2, seq) and err_replay <= 1e-5):
        fail(f"SCST replay: logps max|d| {err_replay:.3e} against the rollout's")

    # the rollouts with the kernels and under force_plain(); kernels 1 and 2
    # kept on their first call
    seen1, seen2 = {}, {}
    with wrapped(attention, "attention_scores_masked", first_of_each_shape(seen1)), \
            wrapped(decoder, "greedy_head", first_of_each_shape(seen2)):
        _, gen_k, greedy_k = steps.rl_rollout_step_batched(state, batch, cfg, phase, *gens(31))
    gaps, invs = [], []

    def keep_gap(out, w, b):
        logits = torch.matmul(out.to(w.dtype).float(), w[:, :out.shape[1]].float().t()) + b
        top2 = torch.topk(logits, 2, dim=1).values
        gaps.append(top2[:, 0] - top2[:, 1])

    def keep_inv(ctxs, sort=decoder.sort_ctxs_by_window):
        ctxs, inv = sort(ctxs)
        invs.append(inv)
        return ctxs, inv
    with force_plain(), wrapped(decoder, "greedy_head", keep_gap), \
            patched(decoder, "sort_ctxs_by_window", keep_inv):
        _, gen_p, greedy_p = steps.rl_rollout_step_batched(state, batch, cfg, phase, *gens(31))
    B, N, L = gen_k.shape
    # a row is clear when every step's top two logits lie more than 1e-3 apart
    # (head_check's margin): kernel 2's f32 argmax and the plain one agree there
    gap = torch.stack(gaps, dim=-1).reshape(B, N, -1).amin(dim=-1)
    clear = torch.gather(gap, 1, invs[0]) > 1e-3 if invs else gap > 1e-3
    differ = (greedy_k != greedy_p).any(dim=-1)
    if bool((differ & clear).any()):
        fail(f"SCST greedy baseline: {int((differ & clear).sum())} rows with top-2 gaps above "
             f"1e-3 differ between the kernels and plain")
    worst1 = max(kernel1_check(f"baseline {k}", a)[0] for k, a in seen1.items())
    worst2 = max(head_check("24", f"baseline R={a[0].shape[0]}", a)[0] for a in seen2.values())

    # one update with the kernels and under force_plain(), the same gen_seq,
    # reward and dropout generator; kernels 3 and 4 kept on every call
    reward = torch.from_numpy(np.broadcast_to(np.random.RandomState(3).randn(B, N, 1),
                                              (B, N, L)).astype(np.float32)).to("cuda")
    fwd, bwd = [], []

    def keep(kept):
        return lambda *a: kept.append(tuple(x.detach().clone() for x in a))
    with wrapped(kernel_attention, "attention_scores_dense", keep(fwd)), \
            wrapped(kernel_attention, "attention_scores_bwd", keep(bwd)):
        (tk, ck), mk = steps._phase_grads(state, cfg, phase, steps._rl_losses, batch, phase,
                                          gens(41)[0], gen_k, reward)
    with force_plain():
        (tp, cp), mp = steps._phase_grads(state, cfg, phase, steps._rl_losses, batch, phase,
                                          gens(41)[0], gen_k, reward)
    rel = abs(mk["loss"] - mp["loss"]) / abs(mp["loss"])
    names = ([f"tap.{n}" for n, _ in state.tap.named_parameters()]
             + [f"cg.{n}" for n, _ in state.cg.named_parameters()])
    worst, leaves = 0.0, []
    for name, a, b in zip(names, tk + ck, tp + cp):
        worst = max(worst, float((a - b).abs().max()))
        if not bool(((a - b).abs() <= 2e-4 + 1e-3 * b.abs()).all()):
            leaves.append(name)
    if not rel <= 1e-5 or leaves:
        fail(f"SCST update with the kernels disagrees with plain: rel {rel:.2e}, leaves "
             f"{leaves[:5]}")
    if len(fwd) != L or len(bwd) != L:
        fail(f"SCST update: kernel 3 ran {len(fwd)} times, kernel 4 {len(bwd)}, want {L}")
    worst3 = max(kernel3_check(f"replay step {i}", a)[0] for i, a in enumerate(fwd))
    worst4 = max(kernel4_check(f"replay step {i}", a) for i, a in enumerate(bwd))
    density = sum(int(a[4].ne(0).sum()) for a in fwd) / sum(a[4].numel() for a in fwd)
    del fwd, bwd
    print(f"[24] f32 SCST, dropout on, B={B}, N={N}: replay logps against the rollout's "
          f"max|d| {err_replay:.3e} over {int(m.sum())} reward tokens; greedy baseline with the "
          f"kernels and plain: {int(differ.sum())} of {B * N} rows differ, none of the "
          f"{int(clear.sum())} rows whose top-2 gaps stay above 1e-3 ({int((gen_k != gen_p).sum())} "
          f"sampled tokens differ: draws at near-equal cumulative probabilities); update loss "
          f"{mk['loss']:.6f} vs {mp['loss']:.6f} (rel {rel:.2e}), {len(names)} gradient leaves "
          f"max|d| {worst:.3e}")
    print(f"[24] on the step's own arguments against the plain versions: kernel 1 (baseline, "
          f"{len(seen1)} shape) {worst1:.3e}, kernel 2 (R={B * N}) {worst2:.3e}, kernel 3 "
          f"({L} replay calls, mask density {density:.4f}) {worst3:.3e}, kernel 4 ({L} calls) "
          f"{worst4:.3e}")


def phase_sample_eval(card):
    """Phase 25: eval_split_batched with sample_max=0, temperature 1 and
    sample_seed 7 over phase 18's 64-video val split (tap_cg, top-128,
    batch 32, decode-only, every metric), after a warm-up group; a second
    pass with the seed gives the same predictions.  Then at f32 on phase
    5's sharpened weights, the greedy pass against sampling at T=1e-3.
    Kernel 1 launches once a decode step, kernel 2 never (the sampled head
    is the logits path).  Returns kernel 1's launches in the timed pass."""
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.models.decoder import decoder_sample_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head

    cfg, tap, cg, ds, loader = eval_setup()
    usable = usable_val_videos(cfg, ds)
    durations = {ds.get_example(ix).vid: ds.get_example(ix).duration for ix in ds.split_ix["val"]}
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": True, "val_all_metrics": True,
          "get_eval_loss": False, "sample_max": 0, "temperature": 1.0, "sample_seed": SAMPLE_SEED}
    run = functools.partial(eval_split_batched, flag_eval_what="tap_cg", batch_videos=EVAL_B,
                            device="cuda")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run(tap, cg, loader, cfg, f"{tmp}/w.json",
                dict(kw, num_vids_eval=EVAL_B, language_eval=False))  # warm-up
            torch.cuda.synchronize()
            timing, score_s = {}, []
            for fn in (attention_scores_masked, greedy_head):
                fn.launches = 0
            decoder_sample_batched.steps = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            with timed_scoring(score_s):
                preds, score, _ = run(tap, cg, loader, cfg, f"{tmp}/a.json",
                                      dict(kw, timing_out=timing))
            wall = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
            k1, k2, steps = (attention_scores_masked.launches, greedy_head.launches,
                             decoder_sample_batched.steps)
            again, _, _ = run(tap, cg, loader, cfg, f"{tmp}/b.json", dict(kw, language_eval=False))
            with open(f"{tmp}/a.json") as fa, open(f"{tmp}/b.json") as fb:
                same_json = json.load(fa) == json.load(fb)
    finally:
        loader.load_state(loader.state())
    check_predictions(preds, usable, loader.dataset.ix_to_word, durations)
    if not (steps > 0 and k1 == steps and k2 == 0):
        fail(f"sampled eval: kernel 1 launched {k1} times, kernel 2 {k2}, in {steps} decode "
             f"steps (want {steps} and 0)")
    if not same_json:
        fail(f"sampled eval: two passes with sample_seed {SAMPLE_SEED} differ")
    metrics = ("Bleu_1", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "Recall", "Precision")
    if not all(np.shape(score.get(m)) == (4,) and np.isfinite(score[m]).all() for m in metrics):
        fail(f"sampled eval: scores {score}")
    n_caps = sum(len(c) for c in preds.values())
    run_s = wall - sum(score_s)
    print(f"[25] sampled eval (sample_max 0, T=1, sample_seed {SAMPLE_SEED}): {len(preds)} "
          f"videos, {n_caps} captions, {timing['groups']} groups of {EVAL_B}, {steps} decode "
          f"steps, kernel 1 launches {k1}, kernel 2 {k2}; a second pass with the seed gives "
          f"the same predictions JSON; e.g. {preds[sorted(preds)[0]][0]['sentence'][:60]!r}")
    print(f"[25] sampled eval: {len(preds) / run_s:.2f} eval videos/s, {n_caps / run_s:.1f} "
          f"captions/s over {run_s:.3f} s without scoring; eval_score {sum(score_s):.3f} s "
          f"(stemmer: {stemmer_name()}); peak device memory {peak / 2**30:.2f} GiB, bf16 "
          f"compute [{card}]")
    print(f"[25] sampled eval timing_out: "
          f"{ {k: round(v, 4) if isinstance(v, float) else v for k, v in timing.items()} }")
    cold_sampling()
    return k1


def cold_sampling():
    """f32, phase 5's sharpened weights: the greedy eval pass against
    sampling at T=1e-3.  Every draw whose top two logits lie at least 20 T
    apart (a non-argmax draw there has probability below e^-20) must take
    the argmax, the draws that leave it number the tempered softmax's
    expectation within 5 standard deviations (Poisson), and the sentences
    may differ from the greedy pass's only as often as draws left the
    argmax or met a top-2 gap below 1e-4 (where kernel 2's f32 argmax and
    the plain logits' may differ)."""
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    from echr_tpu_torch.models import decoder

    cfg, tap, cg, ds, loader = eval_setup(compute_dtype="float32")
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(8.0)  # phase 5's weights
    kw = {"topN": TOP_N, "num_vids_eval": 0, "language_eval": False, "get_eval_loss": False}
    stats = []
    draw = decoder._categorical

    def watched(logits, temperature, gen):
        tok = draw(logits, temperature, gen)
        top2, arg = torch.topk(logits, 2, dim=-1)
        gap = top2[:, 0] - top2[:, 1]
        off = tok != arg[:, 0]
        p_off = 1.0 - torch.softmax(logits.float() / temperature, dim=-1).max(dim=-1).values
        stats.append(torch.stack([off.sum(), (off & (gap >= 20 * temperature)).sum(),
                                  (gap < 1e-4).sum(), torch.tensor(gap.numel(), device=gap.device)]
                                 ).double().cpu().tolist() + [float(p_off.double().sum())])
        return tok
    try:
        with tempfile.TemporaryDirectory() as tmp:
            greedy, _, _ = eval_split_batched(tap, cg, loader, cfg, f"{tmp}/g.json", kw,
                                              flag_eval_what="tap_cg", batch_videos=EVAL_B,
                                              device="cuda")
            with patched(decoder, "_categorical", watched):
                cold, _, _ = eval_split_batched(
                    tap, cg, loader, cfg, f"{tmp}/c.json",
                    dict(kw, sample_max=0, temperature=COLD_T, sample_seed=SAMPLE_SEED),
                    flag_eval_what="tap_cg", batch_videos=EVAL_B, device="cuda")
    finally:
        loader.load_state(loader.state())
    off, off_clear, near_tie, draws, expected = np.sum(stats, axis=0)
    if sorted(cold) != sorted(greedy) or any(len(cold[v]) != len(greedy[v]) for v in greedy):
        fail("T=1e-3 sampling captioned other videos or proposals than the greedy pass")
    differ = sum(c["sentence"] != g["sentence"] for v in greedy
                 for c, g in zip(cold[v], greedy[v]))
    n = sum(len(v) for v in greedy.values())
    print(f"[25] f32, phase 5's weights, T={COLD_T}: {differ} of {n} sentences differ from the "
          f"greedy pass; {int(off)} of {int(draws)} draws left the argmax ({expected:.1f} "
          f"expected from the tempered softmax), {int(off_clear)} of them with a top-2 gap >= "
          f"{20 * COLD_T:g}; {int(near_tie)} draws had a gap below 1e-4")
    if off_clear or differ > off + near_tie or abs(off - expected) > 5 * expected ** 0.5 + 5:
        fail("T=1e-3 sampling strays from the greedy pass beyond its near-ties, or leaves "
             "the argmax at another rate than the tempered softmax gives")


FAMILY_B, FAMILY_XE_STEPS, FAMILY_SCST_STEPS = 8, 3, 2  # phase 26: videos a step; steps (1 warm-up)
FAMILY_SHARPEN = 8.0  # phase 5's logit weight scale


def family_cfg(model, base):
    """``base`` with the decoder core swapped.  show_attend_tell as
    experiments/train_SST.sh builds it (CG_num_layers 3), with "V+E+C"
    inputs and a "V+E" init state so that its attention and init_linear
    are live (tests/test_parity_sat.py's feature types), all_img the same;
    the other cores at their own layer counts."""
    from echr_tpu_torch.models.decoder import core_num_layers

    cfg = base.replace_in("decoder", caption_model=model, CG_num_layers=3)
    if model in ("show_attend_tell", "all_img"):
        cfg = cfg.replace_in("context", CG_input_feats_type="V+E+C", CG_init_feats_type="V+E")
    else:
        cfg = cfg.replace_in("decoder", CG_num_layers=core_num_layers(cfg))
    return cfg.validate()


def _zero(fns):
    for fn in fns:
        fn.launches = 0


def family_greedy(card, model):
    """CaptionService greedy at the flagship width: one warm-up chunk of 32
    videos, then one timed chunk (4096 decode rows).  Kernel 2 launches
    once a decode step, kernel 1 too where the core's attention is live
    and never where it is not.  Returns (launches, tap, cg, vocab)."""
    from echr_tpu_torch.models.decoder import attention_live, decoder_sample_batched
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.ops.kernel_head import greedy_head
    from echr_tpu_torch.serve import CaptionService

    cfg = family_cfg(model, flagship_cfg())
    gen = torch.Generator().manual_seed(0)
    tap, cg = init_tap(gen, cfg), init_captioner(gen, cfg)
    vocab = {str(i): f"w{i}" for i in range(1, VOCAB + 1)}
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=32, topN=TOP_N)
    reqs = requests(64, seed=26)
    svc.caption(reqs[:32])  # warm-up
    torch.cuda.synchronize()
    _zero((attention_scores_masked, greedy_head))
    decoder_sample_batched.steps = 0
    t0 = time.time()
    res = svc.caption(reqs[32:])
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {"attention_scores_masked": attention_scores_masked.launches,
                "greedy_head": greedy_head.launches}
    steps = decoder_sample_batched.steps
    check_captions(res, reqs[32:], ties=True)
    live = attention_live(cfg)
    want = {"attention_scores_masked": steps if live else 0, "greedy_head": steps}
    if steps <= 0 or launches != want:
        fail(f"{model}: greedy launches {launches}, want {want} ({steps} decode steps, "
             f"attention {'live' if live else 'unused'})")
    n_caps = sum(len(c) for c in res.values())
    print(f"[26] {model}: greedy {n_caps / dt:.1f} captions/s (32 videos x {TOP_N} proposals in "
          f"{dt:.3f} s, logit width {cg.decoder.logit.weight.shape[1]}, {steps} decode steps, "
          f"launches {launches}) [{card}]")
    return launches, tap, cg, vocab


def family_beam(card, model, tap, cg, vocab):
    """CaptionService(beam_size=4), one warm-up chunk of 32 videos, then one
    timed chunk (16384 beam rows); kernel 1 launches once a beam step.
    Returns kernel 1's launches."""
    from echr_tpu_torch.models.beam import beam_search_batched
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked
    from echr_tpu_torch.serve import CaptionService

    cfg = family_cfg(model, flagship_cfg())
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=32, topN=TOP_N,
                         beam_size=BEAM)
    reqs = requests(64, seed=27)
    svc.caption(reqs[:32])  # warm-up
    torch.cuda.synchronize()
    _zero((attention_scores_masked,))
    beam_search_batched.steps = 0
    t0 = time.time()
    res = svc.caption(reqs[32:])
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches, steps = attention_scores_masked.launches, beam_search_batched.steps
    check_captions(res, reqs[32:], ties=True)
    if not (steps > 0 and launches == steps):
        fail(f"{model}: kernel 1 launched {launches} times in {steps} beam steps")
    n_caps = sum(len(c) for c in res.values())
    print(f"[26] {model}: beam {BEAM} {n_caps / dt:.1f} captions/s, {1000 * dt:.1f} ms for one "
          f"chunk of 32 videos x {TOP_N} proposals x {BEAM} beams ({steps} beam steps, kernel 1 "
          f"launches {launches}) [{card}]")
    return launches


TIE_GAP = 1e-4  # a top-2 logit gap within f32 reassociation noise (phase 25's near-tie)


def family_parity(model, tap, cg, vocab):
    """Phase 5 for the core: f32, TF32 off, phase 5's sharpened logit
    weights, 4 videos with the kernels and under force_plain().  Tokens
    equal on every proposal, except one whose first differing token is a
    near-tie of the plain decode (top-2 logit gap below TIE_GAP, where f32
    sums in another order may pick either); logps within TOL on the
    proposals whose tokens are equal.  The window sort is off, so that the
    head's rows are the proposals in their own order."""
    from echr_tpu_torch.engine.steps import decode_step_batched
    from echr_tpu_torch.models import decoder
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.serve import CaptionService

    cfg = family_cfg(model, flagship_cfg(compute_dtype="float32", sort_decode_props=False))
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(FAMILY_SHARPEN)
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=4, topN=TOP_N)
    _, _, args = svc.prepare_chunk(requests(4, seed=3), T_BUCKET)
    seq_k, lp_k, _ = decode_step_batched(*args)
    gaps = []

    def gap(out, w, b):
        top2 = torch.topk(out @ w[:, :out.shape[1]].t() + b, 2, dim=1).values
        gaps.append(top2[:, 0] - top2[:, 1])
    with force_plain(), wrapped(decoder, "greedy_head", gap):
        seq_p, lp_p, _ = decode_step_batched(*args)
    B, N, _ = seq_k.shape
    gaps = torch.stack(gaps, dim=1).reshape(B, N, -1)
    diff = seq_k != seq_p
    off = diff.any(dim=-1)
    first = diff.int().argmax(dim=-1).clamp(max=gaps.shape[-1] - 1)
    first_gap = torch.gather(gaps, 2, first[..., None])[..., 0]
    clear = off & (first_gap >= TIE_GAP)
    err = float((lp_k - lp_p).abs()[~off].max())
    print(f"[26] {model}: f32 greedy, kernels vs plain: {int(diff.sum())} token mismatches of "
          f"{seq_k.numel()} on {int(off.sum())} of {B * N} proposals (top-2 gaps at their first "
          f"difference {[round(float(g), 7) for g in first_gap[off]]}), max|d| logps {err:.3e} "
          f"on the rest; {int((seq_k > 0).sum())} non-EOS tokens")
    if bool(clear.any()) or not err <= TOL:
        fail(f"{model}: the f32 decode with the kernels disagrees with its plain version")


# cores whose steps read no event context: the TSRM's gradient is zero
NO_EVENT = ("three_stream_2stream_LDA", "three_stream_2stream_CC")


def _moved(model, out, what):
    """Every parameter of train()'s state differs from train()'s seeded
    init, the score bias aside (phase 23), and the TSRM for NO_EVENT."""
    from echr_tpu_torch.models.registry import init_captioner, init_tap

    gen = torch.Generator().manual_seed(out["config"].train.seed)  # train()'s init, again
    tap0, cg0 = init_tap(gen, out["config"]), init_captioner(gen, out["config"])
    for name, m0, m in (("tap", tap0, out["state"].tap), ("cg", cg0, out["state"].cg)):
        for (pn, p0), p in zip(m0.named_parameters(), m.parameters()):
            unused = model in NO_EVENT and pn.startswith("fusion.")
            if (pn != "decoder.core.attention.alpha_net.bias" and not unused
                    and torch.equal(p0, p.detach().cpu())):
                fail(f"{model} {what}: {name}.{pn} did not move in {out['iteration']} steps")


def family_train(card, model, folder):
    """engine.train.train, XE: 1 warm-up and 2 timed steps of 8 videos
    (train_cfg(): cotrain / tap_cg, bf16, dropout on).  Kernels 3 and 4
    launch once a teacher-forced step where the attention is live, never
    for all_img."""
    from echr_tpu_torch.engine.train import train
    from echr_tpu_torch.models.decoder import attention_live
    from echr_tpu_torch.ops.kernel_attention import attention_scores_bwd, attention_scores_dense

    cfg = family_cfg(model, train_cfg()).replace_in(
        "train", batch_size=FAMILY_B).replace_in("save", checkpoint_path=folder).replace(
        run_id=model)
    timing = {}
    _zero((attention_scores_dense, attention_scores_bwd))
    out = train(cfg, max_iterations=FAMILY_XE_STEPS, device="cuda", timing_out=timing)
    torch.cuda.synchronize()
    launches = {"attention_scores_dense": attention_scores_dense.launches,
                "attention_scores_bwd": attention_scores_bwd.launches}
    if out["iteration"] != FAMILY_XE_STEPS:
        fail(f"{model}: train stopped at iteration {out['iteration']}")
    if not all(np.isfinite(v) for v in out["losses"].values()):
        fail(f"{model}: non-finite losses {out['losses']}")
    n = (SEQ_LEN - 1) * FAMILY_XE_STEPS if attention_live(cfg) else 0
    if launches != {"attention_scores_dense": n, "attention_scores_bwd": n}:
        fail(f"{model}: XE launches {launches}, want {n} each")
    _moved(model, out, "XE")
    t = dict(timing["iters"])
    ms = 1000 * (t[FAMILY_XE_STEPS] - t[1]) / (FAMILY_XE_STEPS - 1)
    print(f"[26] {model}: XE {ms:.1f} ms/step over steps 2-{FAMILY_XE_STEPS} of {FAMILY_B} videos "
          f"(tap_cg, bf16, dropout on), launches {launches}, last loss "
          f"{out['losses']['loss']:.4f} [{card}]")
    return launches


def family_scst(card, model, folder):
    """engine.train.train with self_critical_after 0: 1 warm-up and 1 timed
    SCST step of 8 videos; launches as phase 23 counts them."""
    from echr_tpu_torch.engine import rl
    from echr_tpu_torch.engine.train import train
    from echr_tpu_torch.ops.kernel_attention import (attention_scores_bwd,
                                                     attention_scores_dense,
                                                     attention_scores_masked)
    from echr_tpu_torch.ops.kernel_head import greedy_head

    kernels = (attention_scores_masked, greedy_head, attention_scores_dense,
               attention_scores_bwd)
    cfg = family_cfg(model, scst_cfg()).replace_in(
        "train", batch_size=FAMILY_B).replace_in("save", checkpoint_path=folder).replace(
        run_id=model + "_scst")
    timing = {}
    _zero(kernels)
    try:
        out = train(cfg, max_iterations=FAMILY_SCST_STEPS, device="cuda", timing_out=timing)
        torch.cuda.synchronize()
    finally:
        rl.close_default_reward_pool()  # joins the reward workers
    launches = {fn.__name__: fn.launches for fn in kernels}
    sc = timing["scst"]
    if out["iteration"] != FAMILY_SCST_STEPS or len(sc) != FAMILY_SCST_STEPS:
        fail(f"{model}: SCST stopped at iteration {out['iteration']} with {len(sc)} SCST steps")
    if not all(np.isfinite(v) for v in out["losses"].values()) or "avg_reward" not in out[
            "losses"]:
        fail(f"{model}: SCST losses {out['losses']}")
    sampled = sum(s["sample_steps"] for s in sc)
    greedy = sum(s["greedy_steps"] for s in sc)
    want = {"attention_scores_masked": greedy, "greedy_head": greedy,
            "attention_scores_dense": sampled + SEQ_LEN * FAMILY_SCST_STEPS,
            "attention_scores_bwd": SEQ_LEN * FAMILY_SCST_STEPS}
    if launches != want:
        fail(f"{model}: SCST launches {launches}, want {want}")
    _moved(model, out, "SCST")
    t = dict(timing["iters"])
    ms = 1000 * (t[FAMILY_SCST_STEPS] - t[1]) / (FAMILY_SCST_STEPS - 1)
    part = {k: 1000 * sc[-1][k] for k in ("rollout", "reward", "update")}
    print(f"[26] {model}: SCST {ms:.1f} ms for step {FAMILY_SCST_STEPS} of {FAMILY_B} videos "
          f"(rollouts {part['rollout']:.1f}, reward {part['reward']:.1f}, update "
          f"{part['update']:.1f} ms), launches {launches}, avg_reward "
          f"{out['losses']['avg_reward']:.5f} [{card}]")
    return launches


def phase_family(card):
    """Phase 26: every other core of the decoder family through serving,
    XE training and (show_attend_tell) beam and SCST; kernel 2 at the
    family's logit widths.  Returns (kernels 1-4's launches on the
    family's main paths, kernel 2's records by width)."""
    import shutil

    from echr_tpu_torch.models.decoder import CORE_REGISTRY
    from echr_tpu_torch.ops.kernel_head import split_plan

    t_phase = time.time()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.RandomState(26)
    widths = {}
    for C in (512, 1024):  # show_attend_tell, all_img, h3, h3_dense_add; the two-stream cores
        args = head_inputs(rng, 4096, C, VOCAB + 1, torch.bfloat16, dev)
        plan = split_plan(4096, VOCAB + 1, sms, torch.bfloat16)
        err, outs = head_check("26", f"C={C} ({plan[1]} splits)", args)
        widths[f"C{C}"] = {**head_timing(card, args, outs, plan, tag="26"), "max_abs_err": err}
        del args, outs
    launches = {"attention_scores_masked": 0, "greedy_head": 0, "attention_scores_dense": 0,
                "attention_scores_bwd": 0}
    cores = 0
    folder = tempfile.mkdtemp(prefix="chip_smoke_family_")
    try:
        for model in sorted(set(CORE_REGISTRY) - {"three_stream"}):
            served, tap, cg, vocab = family_greedy(card, model)
            if model == "show_attend_tell":
                served["attention_scores_masked"] += family_beam(card, model, tap, cg, vocab)
            family_parity(model, tap, cg, vocab)
            del tap, cg
            counts = [served, family_train(card, model, folder)]
            if model == "show_attend_tell":
                counts.append(family_scst(card, model, folder))
            for c in counts:
                for k, v in c.items():
                    launches[k] += v
            cores += 1
            shutil.rmtree(folder, ignore_errors=True)  # the run folders' checkpoints
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"[26] decoder family: {cores} cores, launches on their main paths {launches}; "
          f"phase wall {time.time() - t_phase:.1f} s [{card}]")
    return launches, widths


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
    ckpt_launches = phase_ckpt_train(card)
    phase_preempt()
    phase_resume_parity()
    scst_launches = phase_scst_train(card)
    phase_scst_parity()
    sample_k1 = phase_sample_eval(card)
    family, head["by_width"] = phase_family(card)
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
                **{name: n["attention_scores_masked"] for name, n in evals.items()},
                "checkpointed_train": ckpt_launches["attention_scores_masked"],
                "scst_train": scst_launches["attention_scores_masked"],
                "eval_sampled": sample_k1,
                "decoder_family": family["attention_scores_masked"]}
    k2_paths = {"greedy": launches["greedy_head"], "eval_greedy": evals["eval_greedy"]["greedy_head"],
                "checkpointed_train": ckpt_launches["greedy_head"],
                "scst_train": scst_launches["greedy_head"],
                "decoder_family": family["greedy_head"]}
    k3_paths, k4_paths = ({"train": launches[k], "checkpointed_train": ckpt_launches[k],
                           "scst_train": scst_launches[k], "decoder_family": family[k]}
                          for k in ("attention_scores_dense", "attention_scores_bwd"))
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
         "launches": sum(k3_paths.values()), "launches_by_path": k3_paths, **dense},
        {"name": "attention_scores_bwd", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_scores_bwd.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:310",
         "launches": sum(k4_paths.values()), "launches_by_path": k4_paths, **bwd},
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
