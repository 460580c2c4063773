#!/usr/bin/env python3
"""Drive echr_tpu_torch's batched greedy serving path and its XE training
path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: require CUDA, print the card's name and power limit, build
     the CUDA kernels from echr_tpu_torch/csrc into echr_tpu_torch/_build;
  2. kernel 1 (masked attention scores) against its plain PyTorch version
     at the serving shapes, ragged shapes, all-masked and all-unmasked;
  3. kernel 2 (streaming greedy head) against its plain version at the
     serving shapes in bf16 and f32, ragged shapes, and exact ties;
  4. the slice: CaptionService at the flagship width (vocab 6000, 30
     steps) from the port's seeded init captions 64 requests of 256 x 500
     C3D features (two chunks of 32 videos, top-128 proposals: 4096 decode
     rows); both kernels' launch counts must equal the decode steps run;
  5. slice parity: at f32 with TF32 off and sharpened logit weights, the
     slice with the kernels and under force_plain() gives the same tokens
     and logps within 5e-4;
  6. times: kernel against plain version (CUDA events after warm-up) and
     the slice's captions/s, each beside the card's name and power limit;
  7. kernel 3 (differentiable scores, forward) against its plain version
     at the training shapes and ragged shapes;
  8. kernel 4 (their backward) against the autograd of the plain forward at
     the same shapes, and two calls bit-identical;
  9. the training slice: engine.train.train at the flagship width as
     bench.py's e2e_train_cfg builds it (B=32 videos of T=256, cotrain /
     tap_cg, vocab 6000, bf16, dropout on, seeded): 1 warm-up and 5 timed
     steps; finite losses, moved parameters, and kernel 3 and 4 launches
     equal to the teacher-forced steps run; time/step, videos/s and peak
     memory;
  10. training parity: at f32 with TF32 off and dropout off, one step's
     loss and gradients with the kernels and under force_plain() agree.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 5e-4
T_BUCKET, VIDEO_DIM, VOCAB, SEQ_LEN, TOP_N = 256, 500, 6000, 30, 128
TRAIN_B, TRAIN_N, TRAIN_STEPS = 32, 64, 6  # videos, sampled proposals, steps (1 warm-up)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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


def _windows_mask(rng, B, N, T):
    """Sorted proposal windows drawn as bench.py draws them -> [B, N, T]."""
    masks = np.zeros((B, N, T), np.float32)
    for b in range(B):
        starts = np.sort(rng.randint(0, T - 8, size=N))
        lens = rng.randint(4, 48, size=N)
        ends = np.minimum(starts + lens, T)
        t = np.arange(T)[None, :]
        masks[b] = (t >= starts[:, None]) & (t < ends[:, None])
    return masks


def phase_scores(card):
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_masked

    rng = np.random.RandomState(0)
    dev = torch.device("cuda")

    def inputs(B, N, T, H, mask):
        pre = torch.from_numpy((rng.randn(B, T, H) * 0.5).astype(np.float32)).to(dev)
        q = torch.from_numpy((rng.randn(B, N, H) * 0.5).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.randn(H) * 0.05).astype(np.float32)).to(dev)
        b = torch.tensor([0.25], device=dev)
        return pre, q, w, b, torch.from_numpy(mask).to(dev)

    cases = {
        "serving": (32, 128, 256, 512, None),
        "ragged": (3, 120, 200, 500, None),
        "all_masked": (2, 40, 96, 64, 0.0),
        "all_unmasked": (2, 40, 96, 64, 1.0),
    }
    worst = 0.0
    for name, (B, N, T, H, fill) in cases.items():
        mask = _windows_mask(rng, B, N, T) if fill is None else np.full((B, N, T), fill,
                                                                         np.float32)
        args = inputs(B, N, T, H, mask)
        got = attention_scores_masked(*args)
        torch.cuda.synchronize()
        with force_plain():
            want = attention_scores_masked(*args)
        m = args[4] > 0
        err = float((got - want).abs()[m].max()) if bool(m.any()) else 0.0
        if fill == 0.0 and bool(got.ne(0).any()):
            fail("kernel 1 computed a fully-masked tile")
        if not err <= TOL:
            fail(f"kernel 1 {name}: max|d| {err:.3e} > {TOL}")
        worst = max(worst, err)
        print(f"[2] scores {name} B={B} N={N} T={T} H={H}: max|d| where mask==1 {err:.3e}")
        if name == "serving":
            ms = cuda_ms(lambda: attention_scores_masked(*args))
            with force_plain():
                plain_ms = cuda_ms(lambda: attention_scores_masked(*args), iters=5)
            live = float(m.float().mean())
            print(f"[6] scores kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms per decode step "
                  f"(mask density {live:.3f}) [{card}]")
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    record["max_abs_err"] = worst
    return record


def phase_head(card):
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_head import greedy_head

    rng = np.random.RandomState(1)
    dev = torch.device("cuda")

    def inputs(R, C, V1, dtype):
        out = torch.from_numpy(np.tanh(rng.randn(R, C)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.uniform(-0.1, 0.1, (V1, C)).astype(np.float32))
        b = torch.from_numpy((rng.randn(V1) * 0.1).astype(np.float32)).to(dev)
        return out, w.to(dev).to(dtype).contiguous(), b

    def compare(name, args):
        tok, mx, lse = greedy_head(*args)
        torch.cuda.synchronize()
        with force_plain():
            ptok, pmx, plse = greedy_head(*args)
            logits = torch.matmul(args[0].to(args[1].dtype).float(), args[1].float().t()) + args[2]
        top2 = torch.topk(logits, 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3
        bad = int((tok != ptok)[clear].sum())
        err = max(float((mx - pmx).abs().max()), float((lse - plse).abs().max()))
        print(f"[3] head {name}: {bad} token mismatches on {int(clear.sum())}/{len(clear)} "
              f"rows with top-2 gap > 1e-3; max|d| max/lse {err:.3e}")
        if bad or not err <= TOL:
            fail(f"kernel 2 {name} disagrees with its plain version")
        return err

    worst = 0.0
    for name, (R, C, V1, dtype) in {
        "serving_bf16": (4096, 1536, 6001, torch.bfloat16),
        "serving_f32": (4096, 1536, 6001, torch.float32),
        "ragged_bf16": (1000, 200, 777, torch.bfloat16),
        "ragged_unaligned_bf16": (77, 36, 130, torch.bfloat16),
        "ragged_f32": (77, 36, 130, torch.float32),
        "ragged_unaligned_f32": (33, 30, 70, torch.float32),
    }.items():
        args = inputs(R, C, V1, dtype)
        err = compare(name, args)
        worst = max(worst, err)
        if name == "serving_bf16":
            ms = cuda_ms(lambda: greedy_head(*args))
            with force_plain():
                plain_ms = cuda_ms(lambda: greedy_head(*args), iters=10)
            print(f"[6] head kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms per decode step "
                  f"(R={R} C={C} V1={V1} bf16, {2 * R * C * V1 / ms / 1e9:.1f} TFLOP/s) [{card}]")
            record = {"ms": ms, "plain_ms": plain_ms}

    # exact ties from integer-valued sums: within a tile, across tiles and
    # across vocab splits the first index wins
    C, V1 = 16, 2048
    w = torch.zeros(V1, C)
    for col in (3, 5, 1031, 2000):
        w[col] = 1.0
    out = torch.ones(64, C, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        tok, mx, _ = greedy_head(out, w.to(dev).to(dtype).contiguous(),
                                 torch.zeros(V1, device=dev))
        if not (bool((tok == 3).all()) and bool((mx == C).all())):
            fail(f"kernel 2 tie ({dtype}): tokens {tok.unique().tolist()}")
    print("[3] head ties: the first index wins (bf16, f32)")
    record["max_abs_err"] = worst
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
    svc.caption(reqs[:32])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

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
    if not (steps > 0 and launches["attention_scores_masked"] == steps
            and launches["greedy_head"] == steps):
        fail(f"kernel launches {launches} do not match the {steps} decode steps run")
    print(f"[4] slice: {len(res)} videos, {n_caps} captions, {steps} decode steps, "
          f"{decoder_sample_batched.host_syncs} early-exit syncs, launches {launches}; "
          f"e.g. {res['v0'][0]}")
    print(f"[6] slice {n_caps / dt:.1f} captions/s ({len(reqs)} videos x {TOP_N} proposals "
          f"in {dt:.3f} s, bf16 compute, batch 32) [{card}]")
    return launches, tap, cg, vocab


def phase_parity(tap, cg, vocab):
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.serve import CaptionService

    cfg = flagship_cfg(compute_dtype="float32")
    with torch.no_grad():
        cg.decoder.logit.weight.mul_(8.0)  # sharpen: argmax margins >> f32 noise
    svc = CaptionService(cfg, tap, cg, vocab, device="cuda", batch_videos=8, topN=TOP_N)
    chunk = requests(8, seed=3)
    _, _, seq_k, lp_k = svc.decode_chunk(chunk, T_BUCKET)
    with force_plain():
        _, _, seq_p, lp_p = svc.decode_chunk(chunk, T_BUCKET)
    bad = int((seq_k != seq_p).sum())
    err = float((lp_k - lp_p).abs().max())
    print(f"[5] f32 slice, kernels vs plain: {bad} token mismatches of {seq_k.numel()}, "
          f"max|d| logps {err:.3e}, {int((seq_k > 0).sum())} non-EOS tokens")
    if bad or not err <= TOL:
        fail("the slice with the kernels disagrees with its plain version")


def _rand(rng, shape, scale, dev):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)


def _score_inputs(rng, B, N, T, H, dev):
    return (_rand(rng, (B, T, H), 0.5, dev), _rand(rng, (B, N, H), 0.5, dev),
            _rand(rng, (H,), 0.05, dev), torch.tensor([0.25], device=dev))


TRAIN_SHAPES = {"training": (TRAIN_B, TRAIN_N, T_BUCKET, 512), "ragged": (3, 60, 200, 500)}


def phase_scores_dense(card):
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import attention_scores_dense

    rng = np.random.RandomState(4)
    dev = torch.device("cuda")
    worst = 0.0
    for name, (B, N, T, H) in TRAIN_SHAPES.items():
        args = _score_inputs(rng, B, N, T, H, dev)
        got = attention_scores_dense(*args)
        torch.cuda.synchronize()
        with force_plain():
            want = attention_scores_dense(*args)
        err = float((got - want).abs().max())
        print(f"[7] dense scores {name} B={B} N={N} T={T} H={H}: max|d| {err:.3e}")
        if not err <= TOL:
            fail(f"kernel 3 {name}: max|d| {err:.3e} > {TOL}")
        worst = max(worst, err)
        if name == "training":
            ms = cuda_ms(lambda: attention_scores_dense(*args))
            with force_plain():
                plain_ms = cuda_ms(lambda: attention_scores_dense(*args), iters=5)
            print(f"[7] dense scores kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms per "
                  f"teacher-forced step [{card}]")
            record = {"ms": ms, "plain_ms": plain_ms}
    record["max_abs_err"] = worst
    return record


def phase_scores_bwd(card):
    """Kernel 4 against the autograd of the plain forward.  d_pre and d_q at
    atol 2e-4, rtol 1e-4 (the JAX package's gate for its backward kernel);
    d_w and d_b are each a sum of B*N*T = 524k terms at the training shapes,
    so they are held to 1e-4 of their largest entry."""
    from echr_tpu_torch.ops import force_plain
    from echr_tpu_torch.ops.kernel_attention import (attention_scores_bwd,
                                                     attention_scores_dense_plain,
                                                     attention_scores_diff)

    rng = np.random.RandomState(5)
    dev = torch.device("cuda")
    worst = 0.0
    for name, (B, N, T, H) in TRAIN_SHAPES.items():
        args = _score_inputs(rng, B, N, T, H, dev)
        g = _rand(rng, (B, N, T), 1.0, dev)
        leaves = [a.clone().requires_grad_() for a in args]
        attention_scores_diff(*leaves).backward(g)
        got = [x.grad for x in leaves]
        torch.cuda.synchronize()
        ref = [a.clone().requires_grad_() for a in args]
        attention_scores_dense_plain(*ref).backward(g)
        want = [x.grad for x in ref]
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
        raw = args[:3] + (g,)
        first = attention_scores_bwd(*raw)
        second = attention_scores_bwd(*raw)
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            fail(f"kernel 4 {name}: two calls differ")
        print(f"[8] scores backward {name}: two calls bit-identical")
        if name == "training":
            ms = cuda_ms(lambda: attention_scores_bwd(*raw))
            with force_plain():
                plain_ms = cuda_ms(lambda: attention_scores_bwd(*raw), iters=5)
            print(f"[8] scores backward kernel {ms:.4f} ms vs plain {plain_ms:.4f} ms per "
                  f"teacher-forced step [{card}]")
            record = {"ms": ms, "plain_ms": plain_ms}
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
    return launches


def phase_train_parity():
    """f32, TF32 off, dropout off, B=4: one step's loss and gradients with
    the kernels and under force_plain().  Gates: loss within 1e-5 relative,
    every gradient leaf within atol 2e-4, rtol 1e-3."""
    from echr_tpu.data.batcher import make_batch
    from echr_tpu.data.dataset import SyntheticDataset
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


def main():
    card = phase_device()
    scores = phase_scores(card)
    head = phase_head(card)
    launches, tap, cg, vocab = phase_slice(card)
    phase_parity(tap, cg, vocab)
    del tap, cg
    dense = phase_scores_dense(card)
    bwd = phase_scores_bwd(card)
    launches.update(phase_train(card))
    phase_train_parity()
    kernels = [
        {"name": "attention_scores_masked", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_scores.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:119",
         "launches": launches["attention_scores_masked"], **scores},
        {"name": "greedy_head", "route": "cuda",
         "source": "echr_tpu_torch/csrc/greedy_head.cu",
         "replaces": "echr_tpu/ops/pallas_head.py:92",
         "launches": launches["greedy_head"], **head},
        {"name": "attention_scores_dense", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_scores.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:31",
         "launches": launches["attention_scores_dense"], **dense},
        {"name": "attention_scores_bwd", "route": "cuda",
         "source": "echr_tpu_torch/csrc/attention_scores_bwd.cu",
         "replaces": "echr_tpu/ops/pallas_attention.py:310",
         "launches": launches["attention_scores_bwd"], **bwd},
    ]
    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
