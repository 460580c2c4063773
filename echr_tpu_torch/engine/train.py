"""The XE training loop (echr_tpu/engine/train.py), synchronous, one GPU.

The reference's loop in reduced form: the curriculum phase per epoch, the
epoch step-decay learning rate and scheduled-sampling ramp, bad-video
skipping, same-bucket collation of ``batch_size`` videos, ``m_batch``
gradient accumulation, and the ``losses_log_every`` log line with
time/batch.  It writes no files.  Not ported yet (ROADMAP.md A.8), each
absent or raising: checkpoint writing and resume, the eval-gated best
checkpoint, the preemption handler and the watchdog, the pipelined
producer (the loop is the reference's synchronous one, which gives the
same trajectory), TensorBoard, SCST, meshes and transfer compression.

``get_training_list``, ``current_lr``, ``current_ss_prob``, ``_collate``
and ``_BucketCollator`` are host-only copies: echr_tpu/engine/train.py
imports jax at the top.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from echr_tpu_torch.config import Config
from echr_tpu_torch.data.batcher import VideoBatch
from echr_tpu_torch.data.dataset import build_dataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine.steps import (
    apply_grads,
    batch_to_device,
    grad_step,
    init_train_state,
    set_lr,
    train_step,
)
from echr_tpu_torch.models.registry import init_captioner, init_tap

log = logging.getLogger("echr_tpu_torch.train")


def get_training_list(cfg: Config) -> List[str]:
    """Curriculum tags per epoch (reference: get_training_list, train.py:26-66)."""
    t = cfg.train
    mode = t.training_mode
    if mode == "pre_tap+cotrain":
        return ["tap"] * t.tap_epochs + ["cg"] * t.cg_epochs + ["tap_cg"] * t.tapcg_epochs
    if mode == "cotrain":
        assert t.tap_epochs == 0 and t.cg_epochs == 0
        return ["tap_cg"] * t.tapcg_epochs
    if mode == "pre_cg":
        assert t.tap_epochs == 0
        return ["cg"] * t.cg_epochs
    if mode == "pre_LP_cg":
        assert t.tap_epochs == 0
        return ["LP_cg"] * t.cg_epochs
    if mode == "gt_tap_cg":
        assert t.tap_epochs == 0
        return ["gt_tap_cg"] * t.cg_epochs
    if mode == "pre_tap":
        assert t.cg_epochs == 0
        return ["tap"] * t.tap_epochs
    if mode == "alter":
        assert t.cg_epochs == 0 and t.tap_epochs == 0
        return ["gt_tap_cg", "tap_cg"] * t.tapcg_epochs
    if mode == "alter2":
        # phase indexed by ITERATION, not epoch (reference: train.py:53-55,249-250)
        assert t.cg_epochs == 0 and t.tap_epochs == 0
        return (["gt_tap_cg"] * 500 + ["tap_cg"] * 500) * t.tapcg_epochs * 10
    if mode == "alter3":
        assert t.cg_epochs == 0 and t.tap_epochs == 0
        return (["gt_tap_cg"] * 5 * 10009
                + (["gt_tap_cg"] * 500 + ["tap_cg"] * 500) * t.tapcg_epochs)
    raise ValueError(f"training_mode {mode!r} is incorrect")


def current_lr(cfg: Config, epoch: int) -> float:
    """Epoch step decay (reference: train.py:232-240)."""
    t = cfg.train
    if epoch > t.learning_rate_decay_start >= 0:
        frac = (epoch - t.learning_rate_decay_start) // t.learning_rate_decay_every
        return t.lr * (t.learning_rate_decay_rate ** int(frac))
    return t.lr


def current_ss_prob(cfg: Config, epoch: int) -> float:
    """Scheduled-sampling ramp (opts.py:218-228)."""
    t = cfg.train
    if t.scheduled_sampling_start < 0 or epoch < t.scheduled_sampling_start:
        return 0.0
    frac = (epoch - t.scheduled_sampling_start) // t.scheduled_sampling_increase_every
    return min(t.scheduled_sampling_increase_prob * (frac + 1), t.scheduled_sampling_max_prob)


def _stack_batch(batch: VideoBatch) -> VideoBatch:
    return VideoBatch(*(np.asarray(x)[None] for x in batch))


def _collate(batches: List[VideoBatch]) -> VideoBatch:
    """Stack same-bucket videos into a [B, ...] batch."""
    return VideoBatch(*(np.stack([np.asarray(x) for x in xs]) for xs in zip(*batches)))


class _BucketCollator:
    """Groups same-time-bucket videos until ``batch_size`` are available.
    Returns (stacked_batch, metas)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.groups: Dict[int, List] = {}

    def add(self, batch: VideoBatch, meta):
        g = self.groups.setdefault(meta.t_bucket, [])
        g.append((batch, meta))
        if len(g) >= self.batch_size:
            out = _collate([b for b, _ in g])
            metas = [m for _, m in g]
            self.groups[meta.t_bucket] = []
            return out, metas
        return None


def _not_ported(cfg: Config) -> None:
    """Raise for the options whose code is not ported yet."""
    why = []
    if cfg.save.start_from:
        why.append("resume (save.start_from)")
    if cfg.save.pretrain and cfg.save.pretrain_path:
        why.append("warm start (save.pretrain)")
    if cfg.train.self_critical_after != -1:
        why.append("SCST (train.self_critical_after)")
    if cfg.runtime.transfer_dtype != "float32":
        why.append("transfer compression (runtime.transfer_dtype)")
    if why:
        raise NotImplementedError(
            "not ported to echr_tpu_torch yet (ROADMAP.md A.8): " + ", ".join(why))


def train(cfg: Config, max_iterations: Optional[int] = None, device="cuda",
          timing_out: Optional[Dict] = None) -> Dict:
    """Run the curriculum on ``device`` from the seeded init; returns a
    summary: iteration, epoch, the last step's losses, the state and the
    config.  ``timing_out`` (optional) receives "iters", a list of
    (iteration, perf_counter) pairs taken after each step's metrics reached
    the host, which waits for the device."""
    _not_ported(cfg)
    device = torch.device(device)
    dataset = build_dataset(cfg)
    loader = Loader(dataset, cfg, seed=cfg.train.seed, process_index=0, process_count=1)
    cfg = cfg.replace_in(
        "decoder", CG_vocab_size=dataset.vocab_size, CG_seq_length=dataset.seq_length)

    init_gen = torch.Generator().manual_seed(cfg.train.seed)
    state = init_train_state(cfg, init_tap(init_gen, cfg, device),
                             init_captioner(init_gen, cfg, device))
    # dropout masks and scheduled-sampling draws, on the device
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 1)

    curriculum = get_training_list(cfg)
    log.info("curriculum: %s (%d epochs)", cfg.train.training_mode, len(curriculum))
    iter_indexed = cfg.train.training_mode == "alter2"
    collator = _BucketCollator(cfg.train.batch_size) if cfg.train.batch_size > 1 else None
    epoch, iteration, lr = 0, 0, None
    loss_sum: Dict[str, float] = {}
    loss_count, bad_video_num = 0, 0
    metrics: Dict[str, float] = {}
    acc_grads = None
    iters: List = []
    t_start = time.time()
    try:
        while epoch < len(curriculum):
            phase = (curriculum[min(iteration, len(curriculum) - 1)] if iter_indexed
                     else curriculum[epoch])
            new_lr = current_lr(cfg, epoch)
            if new_lr != lr:
                lr = new_lr
                set_lr(state, lr)
            ss_prob = current_ss_prob(cfg, epoch)

            batch, meta = loader.get_batch("train")
            if meta.proposal_num <= 0 or meta.n_frames <= 1:
                bad_video_num += 1
                if meta.wrapped:
                    epoch += 1
                continue
            if cfg.train.m_batch > 1:
                # summed gradients over m_batch videos, one update
                # (reference: train.py:281-283,294,316-329)
                grads, metrics = grad_step(state, batch_to_device(_stack_batch(batch), device),
                                           gen, cfg, phase, ss_prob)
                acc_grads = grads if acc_grads is None else tuple(
                    [a + g for a, g in zip(acc, new)] for acc, new in zip(acc_grads, grads))
                if (iteration + 1) % cfg.train.m_batch == 0:
                    apply_grads(state, acc_grads[0], acc_grads[1], cfg, phase)
                    acc_grads = None
            else:
                if collator is not None:
                    res = collator.add(batch, meta)
                    if res is None:
                        if meta.wrapped:
                            epoch += 1
                        continue
                    stacked, _ = res
                else:
                    stacked = _stack_batch(batch)
                state, metrics = train_step(state, batch_to_device(stacked, device), gen, cfg,
                                            phase, ss_prob=ss_prob)
            iteration += 1
            if not np.isfinite(metrics["loss"]):
                log.warning("non-finite loss %s at iter %d (vid %s, phase %s)",
                            metrics["loss"], iteration, meta.vid, phase)
            for k, v in metrics.items():
                loss_sum[k] = loss_sum.get(k, 0.0) + v
            loss_count += 1
            iters.append((iteration, time.perf_counter()))
            if meta.wrapped:
                epoch += 1
            if iteration % cfg.save.losses_log_every == 0:
                avg = {k: round(v / loss_count, 4) for k, v in loss_sum.items()}
                log.info("iter %d (epoch %d, lr %.2e, phase %s) losses=%s time/batch=%.3fs "
                         "bad_vid=%d", iteration, epoch, lr, phase, avg,
                         (time.time() - t_start) / loss_count, bad_video_num)
                loss_sum, loss_count, bad_video_num = {}, 0, 0
                t_start = time.time()
            if max_iterations and iteration >= max_iterations:
                break
    finally:
        loader.load_state(loader.state())  # stops and joins the prefetch threads
    if timing_out is not None:
        timing_out["iters"] = iters
    return {"iteration": iteration, "epoch": epoch, "losses": metrics, "state": state,
            "config": cfg}
