"""The XE and self-critical training loop (echr_tpu/engine/train.py),
synchronous, one GPU, with checkpoints.

The reference's single-host synchronous loop: the run folder (its
config.json, pred_sent/ and a snapshot of echr_tpu_torch/), resume from
``model-{start_from_mode}.ckpt`` (the checkpoint's config overlaid by
``overlay_resumed_config``, the loader state and histories restored) or a
warm start (``save.pretrain``), the curriculum phase per epoch, the epoch
step-decay learning rate and scheduled-sampling ramp, bad-video skipping,
same-bucket collation of ``batch_size`` videos, ``m_batch`` gradient
accumulation, the ``losses_log_every`` log line, and at each
``save_checkpoint_every`` boundary the gating eval, the parameter and
gradient histograms, ``model-last.ckpt`` and, when the score rises,
``model-best.ckpt`` (format v2, ``engine.checkpoint``: either package reads
them).  SIGTERM stops the loop at the next iteration boundary, and the
loop's exit writes ``model-last.ckpt``; a hang watchdog runs around the
loop.

From epoch ``train.self_critical_after`` on (when it is not -1), every
phase but 'tap' takes self-critical steps (``_self_critical_step_batched``):
the sampled and greedy rollouts of a batch, its METEOR rewards on the host
(engine/rl.py's process pool), and the policy-gradient update.

Dropout and scheduled sampling draw from a generator seeded with
``train.seed + 1``, and SCST's token draws from one seeded with
``train.seed + 2``, also on a resumed run: echr_tpu does not save its PRNG
either (it splits its rng anew from the seed), so a resumed run is exact
only with dropout and scheduled sampling off (the cores' fixed dropout of
0.5 on their streams has no setting: only steps without a generator are
free of it).

Not ported, raising NotImplementedError: transfer compression (ROADMAP.md
A.8).  The pipelined producer is not ported either; this loop is the
reference's synchronous one, which gives the same trajectory.

``get_training_list``, ``current_lr``, ``current_ss_prob``, ``_collate``,
``_BucketCollator``, ``overlay_resumed_config`` and the preemption handler
are host-only copies: echr_tpu/engine/train.py imports jax at the top.
"""
from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from echr_tpu_torch.bridge import captioner_from_jax, tap_from_jax
from echr_tpu_torch.config import Config
from echr_tpu_torch.data.batcher import VideoBatch
from echr_tpu_torch.data.dataset import build_dataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import checkpoint as ckpt
from echr_tpu_torch.engine.evaluate import eval_split_batched
from echr_tpu_torch.engine.rl import default_reward_pool, self_critical_reward_batched
from echr_tpu_torch.engine.steps import (
    TrainState,
    apply_grads,
    batch_to_device,
    grad_step,
    init_train_state,
    rl_rollout_step_batched,
    rl_update_step_batched,
    set_lr,
    train_step,
)
from echr_tpu_torch.models.registry import init_captioner, init_tap
from echr_tpu_torch.utils.tb import TBWriter
from echr_tpu_torch.utils.watchdog import HangWatchdog

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
    if cfg.runtime.transfer_dtype != "float32":
        raise NotImplementedError("not ported to echr_tpu_torch yet: transfer compression "
                                  "(runtime.transfer_dtype, ROADMAP.md A.8)")


def train(cfg: Config, max_iterations: Optional[int] = None, device="cuda",
          timing_out: Optional[Dict] = None) -> Dict:
    """Run the curriculum on ``device``.  Returns a summary: iteration,
    epoch, best_val_score, save_folder, the last step's losses, the state,
    the config and the loader (stopped).

    ``timing_out`` (optional) receives cumulative seconds per loop section,
    "loader" (get_batch), "collate", "step" (the step up to its metrics on
    the host, which waits for the device) and "boundary" (log, eval and
    checkpoint work); "iters", (iteration, perf_counter) after each step;
    "ckpt", (iteration, seconds) of each checkpoint boundary; and for
    each SCST step "scst", a dict of the rollouts', the host reward's and
    the update's seconds, the sampled and the greedy decode's steps, the
    reward rows, the pool's workers and the step's avg_reward."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"train(device={str(device)!r}): CUDA is not available")
    _not_ported(cfg)
    save_folder = os.path.join(cfg.save.checkpoint_path, cfg.run_id)
    os.makedirs(os.path.join(save_folder, "pred_sent"), exist_ok=True)
    handler = _setup_logger(save_folder)
    try:
        with open(os.path.join(save_folder, "config.json"), "w") as f:
            f.write(cfg.to_json())
        _snapshot_source(save_folder)
        dataset = build_dataset(cfg)
        # the gating eval shares this loader, as echr_tpu's single-host loop does
        loader = Loader(dataset, cfg, seed=cfg.train.seed, process_index=0, process_count=1)
        try:
            out = _train(cfg, dataset, loader, save_folder, max_iterations, device, timing_out)
        finally:
            loader.load_state(loader.state())  # stops and joins the prefetch threads
    finally:
        logging.getLogger("echr_tpu_torch").removeHandler(handler)
        handler.close()
    return out


def _train(cfg: Config, dataset, loader: Loader, save_folder: str,
           max_iterations: Optional[int], device: torch.device,
           timing_out: Optional[Dict]) -> Dict:
    cfg = cfg.replace_in(
        "decoder", CG_vocab_size=dataset.vocab_size, CG_seq_length=dataset.seq_length)
    init_gen = torch.Generator().manual_seed(cfg.train.seed)
    tap, cg = init_tap(init_gen, cfg, device), init_captioner(init_gen, cfg, device)

    epoch, iteration, best_val_score = 0, 0, -1.0
    histories: Dict[str, Dict] = {"loss": {}, "lr": {}, "val": {}}
    resume_path = os.path.join(save_folder, f"model-{cfg.save.start_from_mode}.ckpt")
    if cfg.save.start_from and os.path.exists(resume_path):
        payload = ckpt.load_checkpoint(resume_path, device)
        cfg = overlay_resumed_config(cfg, payload["config"])
        state = payload["state"]
        iteration, epoch = payload["iteration"], payload["epoch"]
        best_val_score = payload["best_val_score"]
        histories = payload.get("histories") or histories
        if payload.get("loader_state"):
            loader.load_state(payload["loader_state"])
        log.info("resumed from %s at iter %d epoch %d", resume_path, iteration, epoch)
    else:
        if cfg.save.pretrain and cfg.save.pretrain_path:
            warm = ckpt.load_params_only(cfg.save.pretrain_path, cfg.save.pretrain)
            if "tap_params" in warm:
                tap = tap_from_jax(warm["tap_params"], cfg, device)
            if "cg_params" in warm:
                cg = captioner_from_jax(warm["cg_params"], cfg, device)
            log.info("warm-started %s from %s", cfg.save.pretrain, cfg.save.pretrain_path)
        state = init_train_state(cfg, tap, cg)
    # dropout masks and scheduled-sampling draws, and SCST's token draws,
    # on the device
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 1)
    sample_gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 2)

    curriculum = get_training_list(cfg)
    log.info("curriculum: %s (%d epochs)", cfg.train.training_mode, len(curriculum))
    tb = TBWriter(os.path.join(save_folder, "tf_summary_train"))
    iter_indexed = cfg.train.training_mode == "alter2"  # reference: train.py:249-250
    collator = _BucketCollator(cfg.train.batch_size) if cfg.train.batch_size > 1 else None
    lr = None
    loss_sum: Dict[str, float] = {}
    loss_count, bad_video_num = 0, 0
    metrics: Dict[str, float] = {}
    acc_grads = None  # m_batch gradient accumulation
    t_start = time.time()
    tm: Dict = {"loader": 0.0, "collate": 0.0, "step": 0.0, "boundary": 0.0, "iters": [],
                "ckpt": [], "scst": []}
    tic = time.perf_counter

    def _log_boundary(phase: str) -> None:
        """losses_log_every boundary: the averaged-loss log line and TB
        scalars (reference: train.py:343-357)."""
        nonlocal loss_sum, loss_count, bad_video_num, t_start
        avg = {k: round(v / max(loss_count, 1), 4) for k, v in loss_sum.items()}
        log.info("iter %d (epoch %d, lr %.2e, phase %s) losses=%s time/batch=%.3fs bad_vid=%d",
                 iteration, epoch, lr, phase, avg,
                 (time.time() - t_start) / max(loss_count, 1), bad_video_num)
        histories["loss"][iteration] = avg
        histories["lr"][iteration] = lr
        tb.scalar("lr", lr, iteration)
        for k, v in avg.items():
            tb.scalar(f"train_{k}", v, iteration)
        loss_sum, loss_count, bad_video_num = {}, 0, 0
        t_start = time.time()

    def _ckpt_boundary(phase: str, ss_prob: float, hist_batch_raw: VideoBatch) -> None:
        """save_checkpoint_every boundary: the gating eval, parameter and
        gradient histograms, last / best checkpoints (reference:
        train.py:360-466).  hist_batch_raw is the last single-video batch
        pulled; its gradients are a fresh grad_step, as the reference logs
        the latest step's .grad."""
        nonlocal best_val_score
        # the gate runs minutes on a full split and has its own watchdog
        wd.suspend()
        try:
            current_score, eval_scores = _run_eval(state, loader, cfg, save_folder, iteration,
                                                   phase, device)
            tb.scalar("val_score", current_score, iteration)
            for k, v in eval_scores.items():
                tb.scalar(f"val_{k}", float(np.asarray(v, dtype=float).mean()), iteration)
            # dropout from a copy of the training generator, which stays as it was
            hist_gen = torch.Generator(device=device)
            hist_gen.set_state(gen.get_state())
            (tap_g, cg_g), _ = grad_step(
                state, batch_to_device(_stack_batch(hist_batch_raw), device), hist_gen, cfg,
                phase, ss_prob)
            for prefix, module, grads in (("tap", state.tap, tap_g), ("cg", state.cg, cg_g)):
                for (name, p), g in zip(module.named_parameters(), grads):
                    tb.histogram(f"{prefix}/{name}", p, iteration)
                    tb.histogram(f"{prefix}_grad/{name}", g, iteration)
            histories["val"][iteration] = {
                k: (np.asarray(v).tolist() if hasattr(v, "tolist") else v)
                for k, v in eval_scores.items()}
            _save(state, cfg, save_folder, iteration, epoch, best_val_score, loader, histories,
                  dataset)
            if current_score > best_val_score:
                best_val_score = current_score
                _save(state, cfg, save_folder, iteration, epoch, best_val_score, loader,
                      histories, dataset, best=True)
                log.info("new best %.4f at iter %d", best_val_score, iteration)
        finally:
            wd.resume()

    # preemption (echr_tpu's, which the reference lacks): SIGTERM sets a
    # flag, the loop stops at the next iteration boundary, and the exit
    # path below writes a resumable model-last.ckpt
    preempt = _install_preemption_handler()
    wd = HangWatchdog("train", cfg.runtime.hang_warn_s).start()
    try:
        while epoch < len(curriculum):
            wd.beat()
            if preempt["hit"]:
                log.warning("preemption: stopping before iter %d; resume with --start_from",
                            iteration + 1)
                break
            phase = (curriculum[min(iteration, len(curriculum) - 1)] if iter_indexed
                     else curriculum[epoch])
            new_lr = current_lr(cfg, epoch)
            if new_lr != lr:
                lr = new_lr
                set_lr(state, lr)
            ss_prob = current_ss_prob(cfg, epoch)

            t0 = tic()
            batch, meta = loader.get_batch("train")
            tm["loader"] += tic() - t0
            if meta.proposal_num <= 0 or meta.n_frames <= 1:
                bad_video_num += 1
                if meta.wrapped:
                    epoch += 1
                continue
            sc_flag = (cfg.train.self_critical_after != -1
                       and epoch >= cfg.train.self_critical_after and phase != "tap")
            if cfg.train.m_batch > 1 and not sc_flag:
                # summed gradients over m_batch videos, one update
                # (reference: train.py:281-283,294,316-329)
                t0 = tic()
                grads, metrics = grad_step(state, batch_to_device(_stack_batch(batch), device),
                                           gen, cfg, phase, ss_prob)
                acc_grads = grads if acc_grads is None else tuple(
                    [a + g for a, g in zip(acc, new)] for acc, new in zip(acc_grads, grads))
                if (iteration + 1) % cfg.train.m_batch == 0:
                    apply_grads(state, acc_grads[0], acc_grads[1], cfg, phase)
                    acc_grads = None
                tm["step"] += tic() - t0
            else:
                t0 = tic()
                if collator is not None:
                    res = collator.add(batch, meta)
                    if res is None:
                        tm["collate"] += tic() - t0
                        if meta.wrapped:
                            epoch += 1
                        continue
                    stacked, metas = res
                else:
                    stacked, metas = _stack_batch(batch), [meta]
                tm["collate"] += tic() - t0
                t0 = tic()
                if sc_flag:
                    # batch_size <= 1 takes the batched step on one video
                    state, metrics, sc_tm = _self_critical_step_batched(
                        state, batch_to_device(stacked, device), metas, cfg, phase, gen,
                        sample_gen, dataset)
                    tm["scst"].append(sc_tm)
                else:
                    state, metrics = train_step(state, batch_to_device(stacked, device), gen,
                                                cfg, phase, ss_prob=ss_prob)
                tm["step"] += tic() - t0
            iteration += 1
            if not np.isfinite(metrics["loss"]):
                log.warning("non-finite loss %s at iter %d (vid %s, phase %s)",
                            metrics["loss"], iteration, meta.vid, phase)
            for k, v in metrics.items():
                loss_sum[k] = loss_sum.get(k, 0.0) + v
            loss_count += 1
            tm["iters"].append((iteration, tic()))
            if meta.wrapped:
                epoch += 1

            t_boundary = tic()
            if iteration % cfg.save.losses_log_every == 0:
                _log_boundary(phase)
            if (iteration % cfg.save.save_checkpoint_every == 0
                    and epoch >= cfg.save.min_epoch_when_save):
                t0 = tic()
                _ckpt_boundary(phase, ss_prob, batch)
                tm["ckpt"].append((iteration, tic() - t0))
            tm["boundary"] += tic() - t_boundary
            if max_iterations and iteration >= max_iterations:
                break
            if preempt["hit"]:
                log.warning("preemption: checkpointing at iter %d and exiting; resume with "
                            "--start_from", iteration)
                break
    finally:
        wd.stop()
        _restore_preemption_handler(preempt)
    _save(state, cfg, save_folder, iteration, epoch, best_val_score, loader, histories, dataset)
    tb.close()
    if timing_out is not None:
        timing_out.update(tm)
    return {"iteration": iteration, "epoch": epoch, "best_val_score": best_val_score,
            "save_folder": save_folder, "losses": metrics, "state": state, "config": cfg,
            "loader": loader}


def _executed_steps(seq: np.ndarray) -> int:
    """The token steps a batch-wide early-exit decode ran, from its seq
    [B, N, L]: every column up to the last one with an emitted token, and
    the step after it (whose tokens all ended the captions), at most L."""
    cols = np.flatnonzero((seq != 0).any(axis=(0, 1)))
    last = int(cols[-1]) if cols.size else -1
    return min(last + 2, seq.shape[-1])


def _self_critical_step_batched(state: TrainState, batch: VideoBatch, metas, cfg: Config,
                                phase: str, gen: Optional[torch.Generator],
                                sample_gen: torch.Generator, dataset):
    """One SCST step on a [B]-video batch on the device: the rollouts, the
    METEOR rewards of all B*N proposal rows over the reward pool, and the
    update, which replays the rollout with ``gen`` restored to its state
    before the rollout.  Each proposal's GT sentence: 'cg' / 'gt_tap_cg'
    take every GT sentence under gts_mask, the other phases the sentence
    each sampled proposal was matched to (cg_select) under prop_mask.
    Returns (state, metrics, timing)."""
    tic = time.perf_counter
    t0 = tic()
    drop_state = gen.get_state() if gen is not None else None
    _, gen_seq, greedy_seq = rl_rollout_step_batched(state, batch, cfg, phase, gen, sample_gen)
    gen_np, greedy_np = gen_seq.cpu().numpy(), greedy_seq.cpu().numpy()
    t1 = tic()
    if phase in ("cg", "gt_tap_cg"):
        gts = {i: list(m.sentences) for i, m in enumerate(metas)}
        masks = batch.gts_mask.cpu().numpy()
    else:
        gts = {i: [m.sentences[int(j)] for j in m.cg_select] for i, m in enumerate(metas)}
        masks = batch.prop_mask.cpu().numpy()
    pool = default_reward_pool()
    rewards = self_critical_reward_batched(
        {i: gen_np[i] for i in range(len(metas))}, {i: greedy_np[i] for i in range(len(metas))},
        gts, dataset.ix_to_word, {i: masks[i] for i in range(len(metas))}, len(metas),
        meteor_weight=cfg.train.meteor_reward_weight, pool=pool)
    t2 = tic()
    if gen is not None:
        gen.set_state(drop_state)
    state, metrics = rl_update_step_batched(state, batch, cfg, phase, gen, gen_seq,
                                            torch.from_numpy(rewards).to(gen_seq.device))
    t3 = tic()
    timing = {"rollout": t1 - t0, "reward": t2 - t1, "update": t3 - t2,
              "sample_steps": _executed_steps(gen_np), "greedy_steps": _executed_steps(greedy_np),
              "reward_rows": int((masks > 0).sum()), "pool_workers": pool.workers,
              "avg_reward": metrics["avg_reward"]}
    return state, metrics, timing


def _run_eval(state: TrainState, loader: Loader, cfg: Config, save_folder: str,
              iteration: int, phase: str, device="cuda"):
    """The checkpoint-gating eval (reference: train.py:366-415): TAP phases
    score proposals only (F1, topN 1000); CG phases run the GT-proposal
    eval with every metric (topN 100) and, unless eval.fast_eval_cg, the
    model-proposal (tap_cg) eval, whose METEOR x 100 is the score.
    ``num_vids_eval`` caps each pass.  Returns (score, the gating pass's
    score dict).

    Every pass runs eval_split_batched with max(eval.batch_videos, 1)
    videos a group: echr_tpu takes its per-video eval_split at
    batch_videos <= 1, which the port does not have (ROADMAP.md A.9-A.10),
    and tests/test_train_gate_batched.py holds the two equal in echr_tpu."""
    def run(json_path, kw, mode):
        return eval_split_batched(state.tap, state.cg, loader, cfg, json_path, kw,
                                  flag_eval_what=mode, batch_videos=max(cfg.eval.batch_videos, 1),
                                  device=device)

    json_path = os.path.join(save_folder, "pred_sent", f"pred_iter{iteration}.json")
    n_eval = cfg.eval.num_vids_eval or loader.split_size("val")
    if phase == "tap":
        preds, scores, val_loss = run(
            json_path, {"num_vids_eval": n_eval, "topN": 1000, "val_all_metrics": False}, "tap")
        scores2 = scores
    else:
        preds2, scores2, val_loss2 = run(
            json_path.replace(".json", "_gt.json"),
            {"num_vids_eval": n_eval, "topN": 100, "val_all_metrics": True}, "cg")
        if cfg.eval.fast_eval_cg:
            preds, scores, val_loss = preds2, scores2, val_loss2
        else:
            preds, scores, val_loss = run(
                json_path, {"num_vids_eval": n_eval, "topN": 100, "val_all_metrics": False},
                "tap_cg")
    recall = np.asarray(scores.get("Recall", [0.0]))
    precision = np.asarray(scores.get("Precision", [0.0]))
    f1 = float((2 * recall * precision / np.maximum(recall + precision, 1e-8)).mean())
    if phase != "tap":
        current = float(np.asarray(scores.get("METEOR", [0.0])).mean() * 100)
    else:
        current = f1
    mean_scores = {k: float(np.asarray(v).mean()) for k, v in scores.items()}
    gt_means = {k: float(np.asarray(v).mean()) for k, v in scores2.items()}
    log.info("eval iter %d: score=%.4f f1=%.4f all=%s gt=%s val_loss=%s", iteration, current,
             f1, mean_scores, gt_means, np.round(val_loss, 4).tolist())
    return current, scores


def _install_preemption_handler() -> Dict:
    """Route SIGTERM to a flag the loop polls at iteration boundaries.
    Returns {"hit", "prev", "installed"}; off the main thread no handler
    can be installed, and the flag never fires."""
    import signal

    box: Dict = {"hit": False, "prev": None}

    def handler(signum, frame):
        box["hit"] = True
        log.warning("SIGTERM received: will checkpoint at the next iteration boundary and "
                    "exit cleanly")

    try:
        box["prev"] = signal.signal(signal.SIGTERM, handler)
        box["installed"] = True
    except ValueError:  # not the main thread
        box["installed"] = False
    return box


def _restore_preemption_handler(box: Dict) -> None:
    if box.get("installed"):
        import signal

        signal.signal(signal.SIGTERM, box["prev"] or signal.SIG_DFL)


def _save(state: TrainState, cfg: Config, save_folder: str, iteration: int, epoch: int,
          best_val_score: float, loader: Loader, histories: Dict, dataset,
          best: bool = False) -> None:
    name = "model-best.ckpt" if best else "model-last.ckpt"
    path = os.path.join(save_folder, name)
    ckpt.save_checkpoint(path, state, cfg, iteration=iteration, epoch=epoch,
                         best_val_score=best_val_score, loader_state=loader.state(),
                         histories=histories, vocab=dataset.ix_to_word)
    if not best and cfg.save.save_all_checkpoint:
        # per-iteration files (reference: --save_all_checkpoint, train.py:463-466)
        dst = os.path.join(save_folder, f"model_iter_{iteration}.ckpt")
        shutil.copyfile(path, dst)
        shutil.copyfile(path + ".config.json", dst + ".config.json")


# fields the CLI keeps control of across a resume
# (reference: exclude_opt, train.py:126-129)
_RESUME_EXCLUDE = {
    "train": ("training_mode", "tap_epochs", "cg_epochs", "tapcg_epochs", "lr",
              "learning_rate_decay_start", "learning_rate_decay_every",
              "learning_rate_decay_rate", "self_critical_after"),
    "save": ("save_checkpoint_every", "pretrain", "pretrain_path",
             "save_all_checkpoint", "min_epoch_when_save", "start_from",
             "start_from_mode", "no_exclude_opt"),
}


def overlay_resumed_config(cli_cfg: Config, saved_cfg: Config) -> Config:
    """Resume config overlay: the checkpoint's config wins except the
    schedule / id flags the CLI keeps (reference: train.py:126-148;
    --no_exclude_opt makes the saved config win everywhere)."""
    if cli_cfg.save.no_exclude_opt:
        return saved_cfg
    cfg = saved_cfg.replace(run_id=cli_cfg.run_id, debug=cli_cfg.debug)
    for section, names in _RESUME_EXCLUDE.items():
        cfg = cfg.replace_in(
            section, **{n: getattr(getattr(cli_cfg, section), n) for n in names})
    return cfg


def _snapshot_source(save_folder: str) -> None:
    """Copy echr_tpu_torch/ into the run folder, so that results trace to
    exact code (reference: train.py:99-106); the kernels' build is left
    out."""
    dst = os.path.join(save_folder, "src_snapshot")
    if os.path.exists(dst):
        return
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        shutil.copytree(src, os.path.join(dst, "echr_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.pyc", "_build"))
    except OSError as e:  # snapshotting must never break training
        log.warning("source snapshot failed: %s", e)


def _setup_logger(save_folder: str) -> logging.Handler:
    """The run's train.log: a handler on the package's logger, which
    train() removes when it returns."""
    fmt = "[%(asctime)s] %(message)s"
    logging.basicConfig(format=fmt, datefmt="%d %H:%M", level=logging.INFO)
    root = logging.getLogger("echr_tpu_torch")
    root.setLevel(logging.INFO)
    fh = logging.FileHandler(os.path.join(save_folder, "train.log"))
    fh.setFormatter(logging.Formatter(fmt))
    root.addHandler(fh)
    return fh
