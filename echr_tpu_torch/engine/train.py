"""The XE and self-critical training loop (echr_tpu/engine/train.py) on
one GPU, or data parallel with one rank a GPU, with checkpoints.

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

With ``train_pipeline`` (batch_size > 1, m_batch 1, no SCST) the loop is
echr_tpu's pipelined one (``_loop_pipelined``): a host thread pulls,
skips bad videos, compresses and collates, a second thread uploads each
group on its own CUDA stream, and the steps' metrics are fetched in
deferred batches; the trajectory is the synchronous loop's, bit for bit.
Otherwise the synchronous loop fetches each step's metrics with one
synchronisation.  ``transfer_dtype="bfloat16"`` sends the features as bf16
and the {0,1} grids as uint8 (``_compress_batch``); the step lifts them to
f32 on the device.  At batch_size 1 SCST takes the per-video step
(``_self_critical_step``), and at eval.batch_videos <= 1 the gate runs the
per-video ``eval_split``.

Data parallel (echr_tpu's multi-host train(), on torch.distributed: one
rank a device, the group joined before the call, ``parallel.distributed``).
Every rank walks the whole train split in the same order from the same
seed and collates the same global groups; each takes its rows of a group
(``parallel.mesh.shard_rows``), and ``steps._phase_grads`` averages the
gradients and metrics over the ranks, so the update is that of the mean
over the global group.  Time buckets, bad-video skips and the loader state
agree on every rank by construction.  Rank 0 alone writes config.json, the
source snapshot, train.log, TensorBoard events and checkpoints.  The gating
eval shards the val split over the ranks and gathers the predictions and
losses (``eval_split_batched(multihost=True)``), so every rank makes the
same best-checkpoint decision.  SCST rolls out and scores each rank's own
rows.  The pipelined loop runs only in one process; under several ranks
a SIGTERM stops the loop when the ranks agree on it, every
``runtime.preempt_check_every`` iterations (an all-reduce MAX of the
flag).  Rank r's dropout generator is seeded with ``train.seed + 1 + 2r``
and its token-draw generator with ``train.seed + 2 + 2r``: rank 0's are a
single process's, and no two ranks or kinds share a seed.  The parameters
and optimizer state are rank 0's on every rank after the init or resume
(``parallel.mesh.broadcast_state``); a checkpoint resumes under any number
of ranks.

Tensor parallel (``runtime.mesh_shape`` (dp, tp) with tp > 1, echr_tpu's
train() on a (data, model) mesh): rank r is (d = r // tp, m = r % tp).
The rows of a group are sharded by d, so the tp ranks of a row see the
same videos, draw from the generators of d (seeds ``train.seed + 1 + 2d``
and ``+ 2 + 2d``) and run the same replicated computation; the
captioner's vocab and TSRM-head leaves and their Adam moments are cut to
each rank's block after the broadcast (``parallel.mesh.shard_modules``),
and the gradients are averaged over the dp column.  The checkpoint, the
histograms (of gathered gradients), the gating eval and the final state
take the whole model from ``parallel.mesh.gather_modules``, a collective
of every rank, so a checkpoint is a one-process checkpoint, byte for
byte in layout, and resumes under any layout.  SCST takes the two-program
steps, and each row's rewards are its m = 0 rank's.

With ``runtime.scst_resident_vjp`` in one process an SCST step keeps the
sampled rollout's graph across the host reward and the update
backpropagates through it (``steps.rl_graph_update_step_batched``); under
a group the flag falls back to the two-program steps, as echr_tpu's
train() does under a mesh.

``get_training_list``, ``current_lr``, ``current_ss_prob``, ``_collate``,
``_BucketCollator``, ``overlay_resumed_config`` and the preemption handler
are host-only copies: echr_tpu/engine/train.py imports jax at the top.
"""
from __future__ import annotations

import logging
import os
import queue
import shutil
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from echr_tpu_torch.bridge import captioner_from_jax, tap_from_jax
from echr_tpu_torch.config import Config
from echr_tpu_torch.data.batcher import VideoBatch
from echr_tpu_torch.data.dataset import build_dataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import checkpoint as ckpt
from echr_tpu_torch.engine.evaluate import eval_split, eval_split_batched
from echr_tpu_torch.engine.rl import (
    default_reward_pool,
    self_critical_reward_batched,
)
from echr_tpu_torch.engine.steps import (
    TrainState,
    apply_grads,
    batch_to_device,
    fetch_host,
    fetch_metrics,
    grad_step,
    host_tensor,
    init_train_state,
    lift_batch,
    rl_graph_update_step_batched,
    rl_rollout_graph_step_batched,
    rl_rollout_step_batched,
    rl_update_step_batched,
    set_lr,
    train_step,
)
from echr_tpu_torch.models.registry import init_captioner, init_tap
from echr_tpu_torch.parallel import distributed as pdist
from echr_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast_state,
    build_mesh,
    check_layout,
    gather_grads,
    gather_modules,
    shard_modules,
    shard_rows,
)
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


def _stack(xs) -> object:
    """Stack arrays, or bf16 CPU tensors (a compressed batch's features:
    numpy has no bf16), over a new leading axis.  The tensors are stacked
    as their 16-bit patterns in numpy, so that no torch op runs on the
    producer's thread."""
    if isinstance(xs[0], torch.Tensor):
        return _bf16_tensor(np.stack([x.view(torch.int16).numpy() for x in xs]))
    return np.stack([np.asarray(x) for x in xs])


def _stack_batch(batch: VideoBatch) -> VideoBatch:
    return VideoBatch(*(_stack([x]) for x in batch))


def _collate(batches: List[VideoBatch]) -> VideoBatch:
    """Stack same-bucket videos into a [B, ...] batch."""
    return VideoBatch(*(_stack(xs) for xs in zip(*batches)))


def _nbytes(batch: VideoBatch) -> int:
    return sum(host_tensor(x).nbytes for x in batch)


# {0,1}-valued grids: exact in uint8 (steps.lift_batch restores f32)
_BINARY_FIELDS = ("tap_labels", "tap_masks", "frame_mask", "prop_mask",
                  "cg_masks", "gts_mask", "gts_cg_masks")


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """A bf16 CPU tensor over an array of bf16 bit patterns (int16)."""
    return torch.from_numpy(bits).view(torch.bfloat16)


def _to_bf16(x) -> torch.Tensor:
    """f32 -> a bf16 CPU tensor, rounded to nearest even by integer ops on
    the f32 bits in numpy: the bits of echr_tpu's ml_dtypes cast (a NaN
    stays a quiet NaN of its sign).  A torch cast here would start
    an intra-op thread team on the producer's thread beside the steps'."""
    f = np.ascontiguousarray(x, np.float32)
    u = f.view(np.uint32)
    bits = ((u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16).astype(np.uint16)
    nan = np.isnan(f)
    bits[nan] = (u[nan] >> 16).astype(np.uint16) & np.uint16(0x8000) | np.uint16(0x7FC0)
    return _bf16_tensor(bits.view(np.int16))


def _compress_batch(batch: VideoBatch, cfg: Config) -> VideoBatch:
    """With runtime.transfer_dtype "bfloat16", the host->device payload of
    one video shrinks: the features travel as bf16 (a CPU tensor, rounded to
    nearest even: the bits of echr_tpu's ml_dtypes cast) and the {0,1}
    grids as uint8 (exact).  steps.lift_batch restores f32 on the device.
    Any other transfer_dtype returns the batch as it is."""
    if cfg.runtime.transfer_dtype != "bfloat16":
        return batch
    reps = {"feats": _to_bf16(batch.feats)}
    for f in _BINARY_FIELDS:
        reps[f] = np.asarray(getattr(batch, f)).astype(np.uint8)
    return batch._replace(**reps)


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


class _PrepItem(NamedTuple):
    stacked: VideoBatch  # the host [B, ...] group; after the put stage, its device copy
    metas: List  # each video's BatchMeta
    last_batch: VideoBatch  # the completing pull's host batch (the checkpoint histograms)
    epoch_at_step: int  # the step's epoch: wraps before the completing pull
    epoch_after: int  # the epoch after the completing pull's wrap
    bad_delta: int  # bad-video skips in this item's span of pulls
    loader_state: Dict  # loader.state() right after the completing pull
    ready: Optional[torch.cuda.Event] = None  # the upload's completion


_PREP_STOP = object()


def _upload(batch: VideoBatch, device: torch.device, stream) -> tuple:
    """The put stage's copy of a host group to ``device``, in its own
    dtypes (compressed bytes cross compressed): on CUDA from pinned memory
    on ``stream``, waited for here, so the pinned sources may go when this
    returns.  Returns (device batch, the copy's event or None)."""
    if stream is None:
        return VideoBatch(*(host_tensor(x).to(device, copy=True) for x in batch)), None
    pinned = [host_tensor(x).pin_memory() for x in batch]
    with torch.cuda.stream(stream):
        raw = [p.to(device, non_blocking=True) for p in pinned]
    ready = torch.cuda.Event()
    ready.record(stream)
    ready.synchronize()
    return VideoBatch(*raw), ready


def _consume(raw: VideoBatch, ready: Optional[torch.cuda.Event], device) -> VideoBatch:
    """A put-stage batch on the caller's stream: the stream waits for the
    upload's event, and each tensor is marked as used there
    (record_stream), so that the caching allocator does not hand its memory
    back to the upload stream while the step still reads it; then
    lift_batch."""
    if ready is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(ready)
        for t in raw:
            t.record_stream(cur)
    return lift_batch(raw)


class _TrainPrep:
    """The pipelined train loop's producer (echr_tpu/engine/train.py
    _TrainPrep): the host stage (thread "train-prep": loader pulls,
    bad-video skips, compression, bucket collation) and the put stage
    (thread "train-put": the host-to-device upload on its own CUDA stream)
    run beside the steps that the main thread queues.  It produces the
    synchronous loop's stream of groups from the one Loader, in its order,
    and each item carries the bookkeeping from which the consumer rebuilds
    the synchronous loop's epochs and its checkpointable loader state.

    Neither stage runs a product: while any thread holds a bf16 block of
    ops.core.matmul, TF32 is on for every thread's f32 products."""

    def __init__(self, loader: Loader, cfg: Config, batch_size: int, epoch0: int,
                 n_epochs: int, device: torch.device, depth: int = 2):
        if device.type == "cuda" and device.index is None:  # the put thread sets it
            device = torch.device("cuda", torch.cuda.current_device())
        self.loader, self.cfg, self.batch_size = loader, cfg, batch_size
        self.epoch0, self.n_epochs, self.device = epoch0, n_epochs, device
        self.q_host: "queue.Queue" = queue.Queue(maxsize=depth)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.abort = threading.Event()
        self.error: Optional[BaseException] = None
        self.progress = 0  # pulls and uploads done: get() beats the watchdog on it
        self.final_epoch = epoch0  # valid once the host stage exits
        self.tm = {"loader": 0.0, "compress": 0.0, "collate": 0.0, "put": 0.0, "put_bytes": 0,
                   "put_groups": 0}
        self.thread = threading.Thread(target=self._run, daemon=True, name="train-prep")
        self.put_thread = threading.Thread(target=self._run_put, daemon=True, name="train-put")
        self.thread.start()
        self.put_thread.start()

    def _run(self) -> None:
        tic = time.perf_counter
        try:
            collator = _BucketCollator(self.batch_size)
            wraps, bad = 0, 0
            while not self.abort.is_set() and self.epoch0 + wraps < self.n_epochs:
                t0 = tic()
                batch, meta = self.loader.get_batch("train")
                self.tm["loader"] += tic() - t0
                self.progress += 1
                if meta.proposal_num <= 0 or meta.n_frames <= 1:
                    bad += 1
                    wraps += int(meta.wrapped)
                    continue
                t0 = tic()
                batch = _compress_batch(batch, self.cfg)
                self.tm["compress"] += tic() - t0
                epoch_at_step = self.epoch0 + wraps
                t0 = tic()
                res = collator.add(batch, meta)
                self.tm["collate"] += tic() - t0
                if res is None:
                    wraps += int(meta.wrapped)
                    continue
                stacked, metas = res
                item = _PrepItem(stacked, metas, batch, epoch_at_step,
                                 epoch_at_step + int(meta.wrapped), bad, self.loader.state())
                bad = 0
                wraps += int(meta.wrapped)
                if not self._enqueue(self.q_host, item):
                    return  # aborted
            self.final_epoch = self.epoch0 + wraps
        except BaseException as e:  # raised by get() on the main thread
            self.error = e
        finally:
            self._enqueue(self.q_host, _PREP_STOP)

    def _run_put(self) -> None:
        """The put stage: uploads the host groups in their order."""
        tic = time.perf_counter
        try:
            stream = None
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                stream = torch.cuda.Stream(self.device)
            while not self.abort.is_set():
                try:
                    item = self.q_host.get(timeout=0.2)
                except queue.Empty:
                    if not self.thread.is_alive() and self.q_host.empty():
                        break
                    continue
                if item is _PREP_STOP:
                    break
                t0 = tic()
                raw, ready = _upload(item.stacked, self.device, stream)
                self.tm["put"] += tic() - t0
                self.tm["put_bytes"] += _nbytes(item.stacked)
                self.tm["put_groups"] += 1
                self.progress += 1
                if not self._enqueue(self.q, item._replace(stacked=raw, ready=ready)):
                    return  # aborted
        except BaseException as e:
            if self.error is None:
                self.error = e
        finally:
            self._enqueue(self.q, _PREP_STOP)

    def _enqueue(self, q: "queue.Queue", item) -> bool:
        while not self.abort.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                pass
        return False

    def get(self, stop_requested, beat=lambda: None):
        """The next group.  Returns _PREP_STOP once the curriculum is done or
        stop_requested() turns true while waiting; raises the producer's
        exception.  While it waits, beat() is called whenever the producer
        has pulled or uploaded since the last look: a wait on a live
        producer is no hang, a stuck one leaves the watchdog to fire."""
        seen = self.progress
        while True:
            try:
                item = self.q.get(timeout=0.2)
            except queue.Empty:
                if self.error is not None:
                    raise self.error
                if self.progress != seen:
                    seen = self.progress
                    beat()
                if stop_requested():
                    return _PREP_STOP
                if not self.put_thread.is_alive() and self.q.empty():
                    if self.error is not None:
                        raise self.error
                    return _PREP_STOP
                continue
            if item is _PREP_STOP and self.error is not None:
                raise self.error
            return item

    def stop(self) -> None:
        """Abort both stages and join them."""
        self.abort.set()
        for q in (self.q, self.q_host):
            try:  # drain, so that a blocked _enqueue wakes and sees the abort
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        self.thread.join(timeout=10.0)
        self.put_thread.join(timeout=10.0)
        if self.thread.is_alive() or self.put_thread.is_alive():
            log.warning("train prep / put thread did not join within 10 s")


def train(cfg: Config, max_iterations: Optional[int] = None, device="cuda",
          timing_out: Optional[Dict] = None) -> Dict:
    """Run the curriculum on ``device``.  Returns a summary: iteration,
    epoch, best_val_score, save_folder, the last step's losses (floats),
    the state, the config and the loader (stopped).

    ``timing_out`` (optional) receives cumulative seconds per loop section,
    "loader" (get_batch), "compress" (the host bf16 / uint8 casts),
    "collate", "put" (the pipelined loop's upload stage), "step" (the step's
    launches, with the synchronous loop's upload), "fetch" (the metrics'
    copies to the host, which wait for the device) and "boundary" (log,
    eval and checkpoint work); "put_bytes" and "put_groups", the bytes the
    groups sent to the device and their count (the pipelined loop's
    producer runs ahead of the steps); "pipelined", whether the pipelined
    loop ran; "iters",
    (iteration, perf_counter) after each step is queued; "ckpt",
    (iteration, seconds) of each checkpoint boundary; and for each SCST step
    "scst", a dict of the rollouts', the host reward's and the update's
    seconds, the sampled and the greedy decode's steps, the reward rows, the
    pool's workers and the step's avg_reward.  The pipelined loop's
    "loader", "compress", "collate" and "put" are its threads' seconds, which
    overlap the steps."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"train(device={str(device)!r}): CUDA is not available")
    rank, world = pdist.rank(), pdist.world_size()
    check_data_parallel(cfg, world)
    save_folder = os.path.join(cfg.save.checkpoint_path, cfg.run_id)
    os.makedirs(os.path.join(save_folder, "pred_sent"), exist_ok=True)
    handler = _setup_logger(save_folder) if rank == 0 else None
    try:
        if rank == 0:
            with open(os.path.join(save_folder, "config.json"), "w") as f:
                f.write(cfg.to_json())
            _snapshot_source(save_folder)
        dataset = build_dataset(cfg)
        # replicated: every rank walks the whole train split in one order
        loader = Loader(dataset, cfg, seed=cfg.train.seed, process_index=0, process_count=1)
        # the gating eval shares this loader in one process, as echr_tpu's
        # single-host loop does; under several ranks each evaluates its val shard
        eval_loader = loader if world == 1 else Loader(
            dataset, cfg, seed=cfg.train.seed, process_index=rank, process_count=world,
            shard_splits=("val",))
        try:
            out = _train(cfg, dataset, loader, eval_loader, save_folder, max_iterations, device,
                         timing_out)
        finally:
            for lo in {id(loader): loader, id(eval_loader): eval_loader}.values():
                lo.load_state(lo.state())  # stops and joins the prefetch threads
    finally:
        if handler is not None:
            logging.getLogger("echr_tpu_torch").removeHandler(handler)
            handler.close()
    return out


def check_data_parallel(cfg: Config, world: int) -> None:
    """The refusals of a run of ``world`` ranks (echr_tpu/engine/train.py
    :388-403): ``runtime.mesh_shape`` against the group
    (``parallel.mesh.check_layout``), and under several ranks a batch_size
    that the dp rows do not divide (SCST at batch_size 1 among them: the
    rows share the batched step's videos) and m_batch accumulation."""
    dp, _ = check_layout(cfg, world)
    if world == 1:
        return
    if cfg.train.batch_size % dp:
        raise ValueError(
            f"data-parallel training splits each group of train.batch_size videos over the "
            f"{dp} data-parallel rows: set batch_size to a multiple of {dp}, got "
            f"{cfg.train.batch_size}")
    if cfg.train.m_batch > 1:
        raise NotImplementedError(
            "m_batch accumulation is a single-process path: under several ranks raise "
            "train.batch_size instead")


def _train(cfg: Config, dataset, loader: Loader, eval_loader: Loader, save_folder: str,
           max_iterations: Optional[int], device: torch.device,
           timing_out: Optional[Dict]) -> Dict:
    rank, world = pdist.rank(), pdist.world_size()
    cfg = cfg.replace_in(
        "decoder", CG_vocab_size=dataset.vocab_size, CG_seq_length=dataset.seq_length)
    init_gen = torch.Generator().manual_seed(cfg.train.seed)
    tap, cg = init_tap(init_gen, cfg, device), init_captioner(init_gen, cfg, device)

    epoch, iteration, best_val_score = 0, 0, -1.0
    histories: Dict[str, Dict] = {"loss": {}, "lr": {}, "val": {}}
    resume_path = os.path.join(save_folder, f"model-{cfg.save.start_from_mode}.ckpt")
    resumed = bool(cfg.save.start_from and os.path.exists(resume_path))
    if resumed:
        payload = ckpt.load_checkpoint(resume_path, device)
        # the layout is the launch's (echr_tpu builds its mesh before the
        # resume), so a checkpoint resumes under any layout
        cfg = overlay_resumed_config(cfg, payload["config"]).replace_in(
            "runtime", mesh_shape=cfg.runtime.mesh_shape)
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
    if world > 1:
        check_data_parallel(cfg, world)  # the checkpoint's batch_size, if resumed
        seen = pdist.allgather_object((resumed, iteration, epoch))
        if len(set(seen)) > 1:
            raise RuntimeError(
                f"the ranks disagree on the resume from {resume_path}: (resumed, iteration, "
                f"epoch) by rank {seen}; the ranks need one shared save.checkpoint_path")
        broadcast_state(state)
        lay = build_mesh(cfg)
        state = shard_modules(state, lay) if lay.tp > 1 else state
        state.mesh = lay
    else:
        lay = Mesh(1, 1, 0)
    if cfg.runtime.scst_resident_vjp and world > 1 and cfg.train.self_critical_after != -1:
        log.info("runtime.scst_resident_vjp is single-process: %d ranks take the "
                 "two-program SCST steps", world)
    # dropout masks and scheduled-sampling draws, and SCST's token draws,
    # on the device; row d's seeds are seed + 1 + 2d and seed + 2 + 2d (d
    # is the rank without tensor parallelism)
    gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 1 + 2 * lay.d)
    sample_gen = torch.Generator(device=device).manual_seed(cfg.train.seed + 2 + 2 * lay.d)

    curriculum = get_training_list(cfg)
    log.info("curriculum: %s (%d epochs)", cfg.train.training_mode, len(curriculum))
    tb = TBWriter(os.path.join(save_folder, "tf_summary_train") if rank == 0 else None)
    iter_indexed = cfg.train.training_mode == "alter2"  # reference: train.py:249-250
    collator = _BucketCollator(cfg.train.batch_size) if cfg.train.batch_size > 1 else None
    lr = None
    loss_sum: Dict[str, float] = {}
    loss_count, bad_video_num = 0, 0
    metrics: Dict[str, float] = {}
    acc_grads = None  # m_batch gradient accumulation
    t_start = time.time()
    tm: Dict = {"loader": 0.0, "compress": 0.0, "collate": 0.0, "put": 0.0, "step": 0.0,
                "fetch": 0.0, "boundary": 0.0, "put_bytes": 0, "put_groups": 0, "iters": [],
                "ckpt": [], "scst": []}
    tic = time.perf_counter

    def _add_metrics(fetched: Dict[str, float], it: int, vid: str, phase: str) -> None:
        nonlocal loss_count
        if not np.isfinite(fetched["loss"]):
            log.warning("non-finite loss %s at iter %d (vid %s, phase %s)", fetched["loss"],
                        it, vid, phase)
        for k, v in fetched.items():
            loss_sum[k] = loss_sum.get(k, 0.0) + v
        loss_count += 1

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

    def _ckpt_boundary(phase: str, ss_prob: float, hist_batch_raw: VideoBatch,
                       loader_state: Optional[Dict] = None) -> None:
        """save_checkpoint_every boundary: the gating eval, parameter and
        gradient histograms, last / best checkpoints (reference:
        train.py:360-466).  hist_batch_raw is the last single-video batch
        consumed; its gradients are a fresh grad_step, as the reference logs
        the latest step's .grad.  loader_state: the consumed snapshot, which
        the pipelined loop passes (its producer runs ahead)."""
        nonlocal best_val_score
        # the gate runs minutes on a full split and has its own watchdog
        wd.suspend()
        try:
            # the whole model (a collective under tp, every rank) for the
            # eval, the histograms and the checkpoints
            whole = gather_modules(state)
            current_score, eval_scores = _run_eval(whole, eval_loader, cfg, save_folder,
                                                   iteration, phase, device, world)
            tb.scalar("val_score", current_score, iteration)
            for k, v in eval_scores.items():
                tb.scalar(f"val_{k}", float(np.asarray(v, dtype=float).mean()), iteration)
            # dropout from a copy of the training generator, which stays as it
            # was; every rank takes this step (its gradients are all-reduced)
            hist_gen = torch.Generator(device=device)
            hist_gen.set_state(gen.get_state())
            (tap_g, cg_g), _ = grad_step(
                state, batch_to_device(_stack_batch(hist_batch_raw), device), hist_gen, cfg,
                phase, ss_prob)
            cg_g = gather_grads(state.cg, cg_g)
            for prefix, module, grads in (("tap", whole.tap, tap_g), ("cg", whole.cg, cg_g)):
                for (name, p), g in zip(module.named_parameters(), grads):
                    tb.histogram(f"{prefix}/{name}", p, iteration)
                    tb.histogram(f"{prefix}_grad/{name}", g, iteration)
            histories["val"][iteration] = {
                k: (np.asarray(v).tolist() if hasattr(v, "tolist") else v)
                for k, v in eval_scores.items()}
            if rank == 0:
                _save(whole, cfg, save_folder, iteration, epoch, best_val_score, loader,
                      histories, dataset, loader_state=loader_state)
            if current_score > best_val_score:
                best_val_score = current_score
                if rank == 0:
                    _save(whole, cfg, save_folder, iteration, epoch, best_val_score, loader,
                          histories, dataset, best=True, loader_state=loader_state)
                log.info("new best %.4f at iter %d", best_val_score, iteration)
            del whole
        finally:
            wd.resume()

    def _loop_pipelined() -> None:
        """echr_tpu's pipelined loop (engine/train.py _loop_pipelined): a
        _TrainPrep producer overlaps the pulls, collation and upload with
        the steps, and the metrics of the steps are fetched in deferred
        batches.  A flush copies the oldest pending steps' metrics with one
        synchronisation, which waits for those steps: it is also the bound
        on the steps in flight (runtime.train_inflight).  The main thread
        runs the steps in order, so dropout and scheduled sampling draw as
        in the synchronous loop; the epoch, learning rate and phase follow
        from each item's epoch_at_step / epoch_after, and checkpoints store
        the consumed loader snapshot (item.loader_state), not the
        producer's cursor."""
        nonlocal state, epoch, iteration, lr, bad_video_num, metrics
        # the snapshot before any item, taken before the producer starts
        # pulling: a preemption before the first item checkpoints it
        last_consumed = loader.state()
        prep = _TrainPrep(loader, cfg, cfg.train.batch_size, epoch, len(curriculum), device)
        pending: List = []  # (iteration, device metrics, vid, phase) awaiting a fetch
        inflight = max(1, int(cfg.runtime.train_inflight))

        def _flush_pending(n: Optional[int] = None) -> None:
            """Fetch the oldest n pending steps' metrics (all at log and
            checkpoint boundaries, which need the exact sums).  Past the
            in-flight bound only the older half: a full flush would drain
            the queue of steps and serialise the host with the device."""
            nonlocal metrics
            drain = pending if n is None else pending[:n]
            if not drain:
                return
            t0 = tic()
            fetched = fetch_metrics(*(p[1] for p in drain))
            tm["fetch"] += tic() - t0
            for (it_i, _, vid_i, phase_i), m in zip(drain, fetched):
                _add_metrics(m, it_i, vid_i, phase_i)
            metrics = fetched[-1]
            del pending[:len(drain)]

        try:
            while True:
                wd.beat()
                item = prep.get(lambda: preempt["hit"], wd.beat)
                if item is _PREP_STOP:
                    if preempt["hit"]:
                        log.warning("preemption: stopping before iter %d; resume with "
                                    "--start_from", iteration + 1)
                    else:
                        # curriculum done: wraps on the dropped partial groups
                        # advance the epoch as in the synchronous loop
                        epoch = max(epoch, prep.final_epoch)
                    break
                bad_video_num += item.bad_delta
                epoch = item.epoch_at_step
                phase = (curriculum[min(iteration, len(curriculum) - 1)] if iter_indexed
                         else curriculum[epoch])
                new_lr = current_lr(cfg, epoch)
                if new_lr != lr:
                    lr = new_lr
                    set_lr(state, lr)
                ss_prob = current_ss_prob(cfg, epoch)
                t0 = tic()
                state, step_metrics = train_step(state, _consume(item.stacked, item.ready, device),
                                                 gen, cfg, phase, ss_prob=ss_prob)
                tm["step"] += tic() - t0
                iteration += 1
                epoch = item.epoch_after
                last_consumed = item.loader_state
                pending.append((iteration, step_metrics, item.metas[-1].vid, phase))
                tm["iters"].append((iteration, tic()))

                t_boundary = tic()
                at_log = iteration % cfg.save.losses_log_every == 0
                at_ckpt = (iteration % cfg.save.save_checkpoint_every == 0
                           and epoch >= cfg.save.min_epoch_when_save)
                if at_log or at_ckpt:
                    _flush_pending()
                elif len(pending) >= inflight:
                    _flush_pending(max(1, len(pending) // 2))
                if at_log:
                    _log_boundary(phase)
                if at_ckpt:
                    t0 = tic()
                    _ckpt_boundary(phase, ss_prob, item.last_batch, item.loader_state)
                    tm["ckpt"].append((iteration, tic() - t0))
                tm["boundary"] += tic() - t_boundary
                if max_iterations and iteration >= max_iterations:
                    break
                if preempt["hit"]:
                    log.warning("preemption: checkpointing at iter %d and exiting; resume "
                                "with --start_from", iteration)
                    break
        finally:
            prep.stop()
            for k, v in prep.tm.items():
                tm[k] += v
        _flush_pending()
        # rewind the loader to the last consumed snapshot: the producer ran
        # ahead, and the exit's _save stores loader.state()
        loader.load_state(last_consumed)

    checked = [-1]  # the iteration of the ranks' last preemption agreement
    every = max(int(cfg.runtime.preempt_check_every), 1)

    def _preempted() -> bool:
        """The stop decision at an iteration boundary: the SIGTERM flag in
        one process.  Under several ranks it is collective (echr_tpu's
        train.py:763-787): an all-reduce MAX of the flag once at each
        iteration that preempt_check_every divides, so every rank stops at
        the same boundary; a flag set in between waits for the next check.
        The ranks run the same iterations, so the schedule is collective."""
        if world == 1:
            return preempt["hit"]
        if iteration % every or checked[0] == iteration:
            return False
        checked[0] = iteration
        return pdist.any_rank(preempt["hit"])

    def _my_rows(stacked: VideoBatch, metas: List) -> tuple:
        """This rank's rows of a collated group, and their metas."""
        if world == 1:
            return stacked, metas
        b = len(metas) // lay.dp
        return shard_rows(stacked, lay.d, lay.dp), metas[lay.d * b:(lay.d + 1) * b]

    def _loop_sync() -> None:
        """The reference's synchronous loop (train.py:252-349, echr_tpu's
        single-host form; under several ranks its multi-host form): one step
        at a time, its metrics fetched with one synchronisation."""
        nonlocal state, epoch, iteration, lr, bad_video_num, metrics, acc_grads
        while epoch < len(curriculum):
            wd.beat()
            if _preempted():
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
            t0 = tic()
            batch = _compress_batch(batch, cfg)
            tm["compress"] += tic() - t0
            sc_flag = (cfg.train.self_critical_after != -1
                       and epoch >= cfg.train.self_critical_after and phase != "tap")
            if sc_flag and collator is None:
                # the per-video SCST step (echr_tpu's _self_critical_step)
                tm["put_bytes"] += _nbytes(batch)
                tm["put_groups"] += 1
                t0 = tic()
                state, step_metrics, sc_tm = _self_critical_step(
                    state, batch, meta, cfg, phase, gen, sample_gen, dataset, device)
                tm["scst"].append(sc_tm)
                tm["step"] += tic() - t0
            elif sc_flag or cfg.train.m_batch <= 1:
                t0 = tic()
                if collator is not None:
                    res = collator.add(batch, meta)
                    if res is None:
                        tm["collate"] += tic() - t0
                        if meta.wrapped:
                            epoch += 1
                        continue
                    stacked, metas = _my_rows(*res)
                else:
                    stacked = _stack_batch(batch)
                tm["collate"] += tic() - t0
                tm["put_bytes"] += _nbytes(stacked)
                tm["put_groups"] += 1
                t0 = tic()
                if sc_flag:
                    state, step_metrics, sc_tm = _self_critical_step_batched(
                        state, batch_to_device(stacked, device), metas, cfg, phase, gen,
                        sample_gen, dataset)
                    tm["scst"].append(sc_tm)
                else:
                    state, step_metrics = train_step(state, batch_to_device(stacked, device),
                                                     gen, cfg, phase, ss_prob=ss_prob)
                tm["step"] += tic() - t0
            else:
                # summed gradients over m_batch videos, one update
                # (reference: train.py:281-283,294,316-329)
                tm["put_bytes"] += _nbytes(batch)
                tm["put_groups"] += 1
                t0 = tic()
                grads, step_metrics = grad_step(
                    state, batch_to_device(_stack_batch(batch), device), gen, cfg, phase,
                    ss_prob, updated_only=True)
                acc_grads = grads if acc_grads is None else tuple(
                    [a + g for a, g in zip(acc, new)] for acc, new in zip(acc_grads, grads))
                if (iteration + 1) % cfg.train.m_batch == 0:
                    apply_grads(state, acc_grads[0], acc_grads[1], cfg, phase)
                    acc_grads = None
                tm["step"] += tic() - t0
            iteration += 1
            t0 = tic()
            (metrics,) = fetch_metrics(step_metrics)
            tm["fetch"] += tic() - t0
            _add_metrics(metrics, iteration, meta.vid, phase)
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
            if _preempted():
                log.warning("preemption: checkpointing at iter %d and exiting; resume with "
                            "--start_from", iteration)
                break

    # the pipelined loop's eligibility (echr_tpu's): batched groups, no
    # m_batch accumulation and no SCST, which interleave host work with
    # several device programs an update, and one process (the ranks'
    # preemption agreement and gating eval are collectives, which a
    # producer running ahead would skew)
    pipelined = bool(cfg.runtime.train_pipeline and collator is not None and world == 1
                     and cfg.train.m_batch == 1 and cfg.train.self_critical_after == -1)
    tm["pipelined"] = pipelined
    # preemption (echr_tpu's, which the reference lacks): SIGTERM sets a
    # flag, the loop stops at the next iteration boundary, and the exit
    # path below writes a resumable model-last.ckpt
    preempt = _install_preemption_handler()
    wd = HangWatchdog("train", cfg.runtime.hang_warn_s).start()
    try:
        if pipelined:
            _loop_pipelined()
        else:
            _loop_sync()
    finally:
        wd.stop()
        _restore_preemption_handler(preempt)
    whole = gather_modules(state)  # a collective under tp
    if rank == 0:
        _save(whole, cfg, save_folder, iteration, epoch, best_val_score, loader, histories,
              dataset)
    del whole
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


def _self_critical_step(state: TrainState, batch: VideoBatch, meta, cfg: Config, phase: str,
                        gen: Optional[torch.Generator], sample_gen: torch.Generator, dataset,
                        device):
    """One SCST step on one video, the host batch ``batch`` (echr_tpu's
    _self_critical_step, batch_size 1): _self_critical_step_batched on a
    batch of one, so the rollouts, the METEOR rewards of the video's
    proposal rows and the replayed update are the batched step's.
    Returns (state, metrics, timing)."""
    return _self_critical_step_batched(state, batch_to_device(_stack_batch(batch), device),
                                       [meta], cfg, phase, gen, sample_gen, dataset)


def _self_critical_step_batched(state: TrainState, batch: VideoBatch, metas, cfg: Config,
                                phase: str, gen: Optional[torch.Generator],
                                sample_gen: torch.Generator, dataset):
    """One SCST step on a [B]-video batch on the device: the rollouts, the
    METEOR rewards of all B*N proposal rows over the reward pool, and the
    update, which replays the rollout with ``gen`` restored to its state
    before the rollout.  Each proposal's GT sentence: 'cg' / 'gt_tap_cg'
    take every GT sentence under gts_mask, the other phases the sentence
    each sampled proposal was matched to (cg_select) under prop_mask.
    Under several ranks ``batch`` and ``metas`` are the rank's rows, and
    the update's gradients are all-reduced (steps._phase_grads); under
    tensor parallelism the ranks of a tp row take the rewards of its m = 0
    rank.  With runtime.scst_resident_vjp in one process the rollout keeps
    its graph and the update backpropagates through it instead of
    replaying it.  Returns (state, metrics, timing)."""
    tic = time.perf_counter
    t0 = tic()
    lay = state.mesh
    resident = bool(cfg.runtime.scst_resident_vjp) and pdist.world_size() == 1
    drop_state = gen.get_state() if gen is not None else None
    if resident:
        kept, gen_seq, greedy_seq = rl_rollout_graph_step_batched(state, batch, cfg, phase, gen,
                                                                  sample_gen)
    else:
        _, gen_seq, greedy_seq = rl_rollout_step_batched(state, batch, cfg, phase, gen,
                                                         sample_gen)
    gen_np, greedy_np = fetch_host(gen_seq, greedy_seq)
    t1 = tic()
    if phase in ("cg", "gt_tap_cg"):
        gts = {i: list(m.sentences) for i, m in enumerate(metas)}
        (masks,) = fetch_host(batch.gts_mask)
    else:
        gts = {i: [m.sentences[int(j)] for j in m.cg_select] for i, m in enumerate(metas)}
        (masks,) = fetch_host(batch.prop_mask)
    pool = default_reward_pool(pdist.local_world_size())
    rewards = self_critical_reward_batched(
        {i: gen_np[i] for i in range(len(metas))}, {i: greedy_np[i] for i in range(len(metas))},
        gts, dataset.ix_to_word, {i: masks[i] for i in range(len(metas))}, len(metas),
        meteor_weight=cfg.train.meteor_reward_weight, pool=pool)
    t2 = tic()
    reward = torch.from_numpy(rewards).to(gen_seq.device)
    if lay is not None and lay.tp > 1:
        torch.distributed.broadcast(reward, src=lay.row_root(), group=lay.tp_group)
    if resident:
        state, metrics = rl_graph_update_step_batched(state, batch, cfg, phase, kept, reward)
        del kept
    else:
        if gen is not None:
            gen.set_state(drop_state)
        state, metrics = rl_update_step_batched(state, batch, cfg, phase, gen, gen_seq, reward)
    (metrics,) = fetch_metrics(metrics)
    t3 = tic()
    timing = {"rollout": t1 - t0, "reward": t2 - t1, "update": t3 - t2,
              "sample_steps": _executed_steps(gen_np), "greedy_steps": _executed_steps(greedy_np),
              "reward_rows": int((masks > 0).sum()), "pool_workers": pool.workers,
              "avg_reward": metrics["avg_reward"]}
    return state, metrics, timing


def _run_eval(state: TrainState, loader: Loader, cfg: Config, save_folder: str,
              iteration: int, phase: str, device="cuda", world: int = 1):
    """The checkpoint-gating eval (reference: train.py:366-415): TAP phases
    score proposals only (F1, topN 1000); CG phases run the GT-proposal
    eval with every metric (topN 100) and, unless eval.fast_eval_cg, the
    model-proposal (tap_cg) eval, whose METEOR x 100 is the score.
    ``num_vids_eval`` caps each pass.  Returns (score, the gating pass's
    score dict).

    eval.batch_videos > 1 runs eval_split_batched with that many videos a
    group, and otherwise the per-video eval_split, as echr_tpu does;
    tests/test_train_gate_batched.py holds the two equal in echr_tpu.

    Under ``world`` > 1 ranks, ``loader`` is the val-sharded eval loader:
    each rank runs eval_split_batched(multihost=True) over its shard, with
    at least 2 videos a group, and the gathered predictions and losses give
    every rank the whole split's score; ``num_vids_eval`` is divided over
    the ranks, rounded up."""
    multi = world > 1

    def run(json_path, kw, mode):
        if multi or cfg.eval.batch_videos > 1:
            return eval_split_batched(state.tap, state.cg, loader, cfg, json_path, kw,
                                      flag_eval_what=mode,
                                      batch_videos=max(cfg.eval.batch_videos, 2 if multi else 1),
                                      device=device, multihost=multi)
        return eval_split(state.tap, state.cg, loader, cfg, json_path, kw, flag_eval_what=mode,
                          device=device)

    json_path = os.path.join(save_folder, "pred_sent", f"pred_iter{iteration}.json")
    n_eval = cfg.eval.num_vids_eval or loader.split_size("val")
    if multi and cfg.eval.num_vids_eval:
        n_eval = -(-cfg.eval.num_vids_eval // world)
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
    if multi:
        # each rank scored the gathered split, in its own process's set
        # order (the scorers' sums differ in the last bits): rank 0's scores
        # make every rank's best-checkpoint decision
        scores, scores2, val_loss = pdist.allgather_object((scores, scores2, val_loss))[0]
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
          best: bool = False, loader_state: Optional[Dict] = None) -> None:
    """model-last.ckpt (or model-best.ckpt).  ``loader_state``: the snapshot
    of the last consumed pull, which the pipelined loop passes because its
    producer's cursor runs ahead; by default loader.state()."""
    name = "model-best.ckpt" if best else "model-last.ckpt"
    path = os.path.join(save_folder, name)
    ckpt.save_checkpoint(path, state, cfg, iteration=iteration, epoch=epoch,
                         best_val_score=best_val_score,
                         loader_state=loader.state() if loader_state is None else loader_state,
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
