"""Probe: where does SCST's replay leave its rollout's numbers at bf16?
(ROADMAP.md C.2; no JAX original.)

``steps.rl_update_step_batched`` replays the rollout's tokens under
autograd with the dropout generator restored, so its logps should be the
rollout's.  At bf16 on the card they were up to 5.27e-04 off (chip_smoke
phase 29).  This probe runs the rollout (no grad) and its replay
(autograd), records every ``torch.matmul`` call of each (its inputs, its
output, whether its right operand requires grad, both operands' strides)
and reports:

  * the logps' max |d| up to each row's end token;
  * the first call whose inputs are equal in the two passes and whose
    output is not (the product itself sums in another order), and the
    first call whose inputs differ (from there on the sampled rollout
    feeds its draws after a row's end token, the replay the end token);

once with ``ops.core.matmul`` as it is (a [..., K] left operand folded
into one 2-D product) and once with ``torch_dispatch=True``, the earlier
form: ``torch.matmul`` on the operands as given, which folds only where b
requires grad or a's leading dimensions are contiguous, and otherwise runs
a batched product.  ``run`` takes one batch through ``steps._rl_forward``;
``train_pass`` the first SCST step of ``engine.train.train``.

Usage: python -m echr_tpu_torch.experiments.probe_scst_replay
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
from torch import nn

from echr_tpu_torch.experiments import device_name, probe_device


@contextlib.contextmanager
def recording(calls: List):
    """Within the block, every torch.matmul call appends (a, b, out, how)
    to ``calls``: detached copies, and how the call was made (whether b
    requires grad, both operands' strides)."""
    fn = torch.matmul

    def rec(a, b, *args, **kw):
        out = fn(a, b, *args, **kw)
        calls.append((a.detach().clone(), b.detach().clone(), out.detach().clone(),
                      {"b_requires_grad": b.requires_grad, "a_strides": a.stride(),
                       "b_strides": b.stride()}))
        return out
    torch.matmul = rec
    try:
        yield
    finally:
        torch.matmul = fn


@contextlib.contextmanager
def torch_dispatch(on: bool = True):
    """Within the block (when ``on``), ops.core.matmul is its earlier form:
    torch.matmul on the operands as given, under the TF32 block for bf16
    on CUDA."""
    from echr_tpu_torch.models import decoder
    from echr_tpu_torch.ops import attention, core, masked, recurrent

    fn = core.matmul

    def plain(a, b, dtype):
        if dtype != torch.bfloat16 or not a.is_cuda:
            return torch.matmul(a, b)
        with core._TF32_BLOCKS.on():
            return torch.matmul(a, b)
    mods = (core, decoder, attention, masked, recurrent)
    for m in mods:
        m.matmul = plain if on else fn
    try:
        yield
    finally:
        for m in mods:
            m.matmul = fn


def compare(roll: List, rep: List) -> Dict:
    """The first call with equal inputs and another output, and the first
    call with other inputs, over the calls the two passes share."""
    out: Dict = {"calls": (len(roll), len(rep)), "first_product": None, "first_input": None}
    for i, (r, p) in enumerate(zip(roll, rep)):
        if r[0].shape != p[0].shape or r[1].shape != p[1].shape:
            out["first_input"] = out["first_input"] or (i, "shapes", tuple(r[0].shape),
                                                        tuple(p[0].shape))
            break
        same_in = torch.equal(r[0], p[0]) and torch.equal(r[1], p[1])
        if not same_in and out["first_input"] is None:
            out["first_input"] = (i, tuple(r[0].shape), tuple(r[1].shape))
        if same_in and not torch.equal(r[2], p[2]) and out["first_product"] is None:
            out["first_product"] = {
                "call": i, "a": tuple(r[0].shape), "b": tuple(r[1].shape),
                "max_abs_d": float((r[2] - p[2]).abs().max()), "rollout": r[3], "replay": p[3]}
        if out["first_product"] is not None and out["first_input"] is not None:
            break
    return out


def one_pass(state, cfg, batch, phase: str, earlier: bool, seed: int = 4) -> Dict:
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.ops.core import call_in_compute_dtype, compute_dtype

    models = nn.ModuleDict({"tap": state.tap, "cg": state.cg})
    dt = compute_dtype(cfg.runtime.compute_dtype)
    gen = torch.Generator(device=batch.feats.device).manual_seed(seed)
    before = gen.get_state()
    sample_gen = torch.Generator(device=batch.feats.device).manual_seed(seed + 1)
    roll, rep = [], []

    def rollout(mods, cfg_):
        return steps._rl_forward(mods["tap"], mods["cg"], cfg_, batch, phase, gen, sample_gen)

    with torch_dispatch(earlier):
        with torch.no_grad(), recording(roll):
            _, seq, lp = call_in_compute_dtype(models, dt, rollout, cfg)
        gen.set_state(before)

        def replay(mods, cfg_):
            return steps._rl_forward(mods["tap"], mods["cg"], cfg_, batch, phase, gen,
                                     forced=seq)
        with recording(rep):
            _, seq2, lp2 = call_in_compute_dtype(models, dt, replay, cfg)
    ended = torch.cat([torch.ones_like(seq[..., :1]), seq[..., :-1]], -1) > 0
    return {"tokens_equal": bool(torch.equal(seq, seq2)),
            "logps_max_abs_d": float(((lp2.detach() - lp).abs() * ended).max()),
            **compare(roll, rep)}


def flagship_train_cfg(dtype: str):
    """chip_smoke.py's train_cfg() (bench.py's e2e_train_cfg): the flagship
    width on synthetic data, tap_cg, at ``dtype``."""
    from echr_tpu_torch.config import flagship_config

    cfg = flagship_config()
    cfg = cfg.replace_in("data", synthetic=True, lda_dim=100, time_buckets=(256,),
                         synthetic_vocab_size=6000, synthetic_seq_length=30,
                         synthetic_num_videos=8)
    cfg = cfg.replace_in("train", training_mode="cotrain", tap_epochs=0, cg_epochs=0,
                         tapcg_epochs=1, self_critical_after=0)
    return cfg.replace_in("runtime", compute_dtype=dtype).validate()


def run(device="cuda", cfg=None, videos: int = 4, phase: str = "tap_cg") -> Dict:
    """The probe at ``cfg``'s widths (default: the flagship training width
    at bf16) on ``videos`` synthetic videos, dropout on, with
    ops.core.matmul's earlier form and as it is; returns and prints the
    record."""
    from echr_tpu_torch.data.batcher import make_batch
    from echr_tpu_torch.data.dataset import SyntheticDataset
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine.train import _collate
    from echr_tpu_torch.models.registry import init_captioner, init_tap

    dev = probe_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or flagship_train_cfg("bfloat16")
    ds = SyntheticDataset(cfg, num_videos=max(videos, 2), seed=11)
    cfg = cfg.replace_in("decoder", CG_vocab_size=ds.vocab_size, CG_seq_length=ds.seq_length)
    batch = steps.batch_to_device(_collate([
        make_batch(ds.get_example(i), cfg, np.random.RandomState(i), w1=ds.w1)[0]
        for i in range(videos)]), dev)
    gen = torch.Generator().manual_seed(0)
    state = steps.init_train_state(cfg, init_tap(gen, cfg, dev), init_captioner(gen, cfg, dev))
    rec = {"device": device_name(dev), "compute_dtype": cfg.runtime.compute_dtype}
    for earlier in (True, False):
        r = one_pass(state, cfg, batch, phase, earlier)
        rec["torch_dispatch" if earlier else "folded"] = r
        print(f"probe_scst_replay ({rec['device']}, {rec['compute_dtype']}, "
              f"{'torch.matmul dispatch' if earlier else 'folded'}): "
              f"tokens equal {r['tokens_equal']}, logps max|d| {r['logps_max_abs_d']:.3e}; "
              f"calls {r['calls']}; first product that differs on equal inputs "
              f"{r['first_product']}; first call with other inputs {r['first_input']}")
    return rec


def train_pass(device="cuda", cfg=None, batch_size: int = 1, earlier: bool = False) -> Dict:
    """The same comparison inside engine.train.train's first SCST step at
    ``batch_size`` (1: the per-video step, chip_smoke phase 29's): the
    sampled rollout's logps against the update's replay, and the matmul
    calls of rl_rollout_step_batched against rl_update_step_batched's
    forward; ``earlier``: with ops.core.matmul's earlier form."""
    import tempfile

    from echr_tpu_torch.engine import rl, steps
    from echr_tpu_torch.engine import train as T

    dev = probe_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = (cfg or flagship_train_cfg("bfloat16")).replace_in("train", batch_size=batch_size)
    roll_calls, rep_calls, sampled, replays = [], [], [], []
    dec_fn, roll_fn, upd_fn = (steps.decoder_sample_batched, T.rl_rollout_step_batched,
                               T.rl_update_step_batched)

    def keep(dec, cfg_, ctxs, dtype=torch.float32, greedy=True, temperature=1.0,
             sample_gen=None, train=False, gen=None, forced=None):
        out = dec_fn(dec, cfg_, ctxs, dtype, greedy, temperature, sample_gen, train, gen, forced)
        if forced is not None:
            replays.append(tuple(x.detach() for x in out))
        elif not greedy:
            sampled.append(out)
        return out

    def roll(*a, **k):
        with recording(roll_calls):
            return roll_fn(*a, **k)

    def upd(*a, **k):
        with recording(rep_calls):
            return upd_fn(*a, **k)
    steps.decoder_sample_batched, T.rl_rollout_step_batched, T.rl_update_step_batched = (
        keep, roll, upd)
    try:
        with tempfile.TemporaryDirectory() as tmp, torch_dispatch(earlier):
            T.train(cfg.replace_in("save", checkpoint_path=tmp), max_iterations=1, device=dev)
    finally:
        steps.decoder_sample_batched, T.rl_rollout_step_batched, T.rl_update_step_batched = (
            dec_fn, roll_fn, upd_fn)
        rl.close_default_reward_pool()
    (seq, lp, _), (seq2, lp2, _) = sampled[0], replays[0]
    ended = torch.cat([torch.ones_like(seq[..., :1]), seq[..., :-1]], -1) > 0
    r = {"batch_size": batch_size, "earlier": earlier, "tokens_equal": bool(torch.equal(seq, seq2)),
         "logps_max_abs_d": float(((lp2 - lp).abs() * ended).max()),
         **compare(roll_calls, rep_calls)}
    print(f"probe_scst_replay train() ({device_name(dev)}, {cfg.runtime.compute_dtype}, "
          f"batch_size {batch_size}, "
          f"{'torch.matmul dispatch' if earlier else 'folded'}): tokens equal "
          f"{r['tokens_equal']}, logps max|d| "
          f"{r['logps_max_abs_d']:.3e}; calls {r['calls']}; first product that differs on "
          f"equal inputs {r['first_product']}; first call with other inputs {r['first_input']}")
    return r


if __name__ == "__main__":
    run()
    for b in (1, 4):
        for earlier in (True, False):
            train_pass(batch_size=b, earlier=earlier)
