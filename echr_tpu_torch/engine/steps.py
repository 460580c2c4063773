"""The batched training and eval / serving steps (echr_tpu/engine/steps.py).

Training: ``train_step`` = ``grad_step`` + ``apply_grads`` over a [B]-video
batch.  The loss casts the matrix weights to the compute dtype inside the
graph (``ops.core.call_in_compute_dtype``), so the gradients reach the f32
masters; each video's losses keep that video's denominators and the step
takes the mean over videos, as the reference's vmapped step does.  The
parameters and the two Adam states are updated in place.

Self-critical training (SCST): ``rl_rollout_step_batched`` samples a
train-mode rollout and decodes an eval-mode greedy baseline under no grad;
the host scores both (engine/rl.py); ``rl_update_step_batched`` replays the
rollout's tokens under autograd with the dropout generator restored to the
state it had before the rollout, and takes one dual-Adam step on the
reward loss.  The token draws come from a second generator, so the replay
sees the rollout's dropout masks.

Eval / serving (greedy or multinomial ``decode_step_batched`` and
``beam_decode_step_batched``): each step takes modules already cast once with
``ops.core.cast_compute_dtype(module, cfg.runtime.compute_dtype)`` (the
reference casts inside every jitted step; here CaptionService and
``engine.evaluate.eval_split_batched`` cast at entry) and runs under
``torch.inference_mode``; ``val_loss_step_batched`` takes them cast too
and runs under ``torch.no_grad``.

The per-video steps (``encode_step``, ``val_loss_step``, ``decode_step``,
``beam_decode_step``, ``rl_rollout_step``, ``rl_update_step``) take one
video's tensors and run the batched step on a batch of one.

Resident-graph SCST (``runtime.scst_resident_vjp``, one process):
``rl_rollout_graph_step_batched`` runs the sampled rollout under autograd
and keeps its graph (the training score kernels 3 and 4 through
attention_scores_diff) across the host reward, and
``rl_graph_update_step_batched`` takes the reward loss of the kept logps
and backpropagates it, skipping the replay, then makes the same dual-Adam
step.  The gradient is the replay's: the sampled tokens are integers, and
the replay recomputes the rollout's logps with its dropout masks.

Under a torch.distributed group every gradient passes ``_phase_grads``,
which averages the gradients and metrics of the ranks of the rank's dp
column (``state.mesh``; every rank without a mesh) in one all-reduce a
dtype (``parallel.mesh.all_reduce_grads``) before ``apply_grads`` clips:
the XE step, the SCST update and the checkpoint's histogram step alike.
Under tensor parallelism (tp > 1) the ranks of a tp row hold the same
gradient of every replicated leaf and each its block of a sharded one
(parallel/tensor.py), so the element-wise clip, the decay and Adam act on
the blocks unchanged.

Every training step returns its metrics as 0-d tensors on the device, so
that no metric makes the host wait; ``fetch_metrics`` copies them to the
host with one synchronisation.  ``batch_to_device`` takes a plain or a
compressed batch (bf16 features, uint8 grids) and lifts it on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from echr_tpu_torch.config import Config
from echr_tpu_torch.data.batcher import VideoBatch
from echr_tpu_torch.data.labels import featstamps_to_times
from echr_tpu_torch import losses
from echr_tpu_torch.models.captioner import (
    Captioner,
    ProposalBatch,
    captioner_sample,
    captioner_sample_one,
    captioner_train_forward,
    captioner_train_loss,
    make_contexts,
)
from echr_tpu_torch.models.beam import beam_search_batched
from echr_tpu_torch.models.decoder import decoder_sample_batched
from echr_tpu_torch.models.sst import SST, sst_forward_batched
from echr_tpu_torch.ops.core import call_in_compute_dtype, compute_dtype
from echr_tpu_torch.parallel import mesh
from echr_tpu_torch.utils.profiling import span

UPDATES_TAP = ("tap", "tap_cg", "gt_tap_cg")
UPDATES_CG = ("cg", "gt_tap_cg", "tap_cg", "LP_cg")


@dataclass
class TrainState:
    """The two models (f32 masters), one Adam each, and the step count."""

    tap: SST
    cg: Captioner
    tap_opt: torch.optim.Adam
    cg_opt: torch.optim.Adam
    step: int = 0
    # the (dp, tp) layout under a group (parallel.mesh.shard_modules)
    mesh: Optional[object] = None


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    """Adam(b1 0.9, b2 0.999, optim_epsilon) with L2 weight decay added to
    the gradient before the moments, and lr applied last: optax's
    add_decayed_weights -> scale_by_adam -> scale(-lr) of the reference.
    torch's Adam has no clip: ``apply_grads`` clamps each gradient element
    to grad_clip before step(), so the order is clip -> decay -> Adam -> -lr.
    """
    t = cfg.train
    return torch.optim.Adam(params, lr=t.lr, betas=(0.9, 0.999), eps=t.optim_epsilon,
                            weight_decay=t.weight_decay)


def init_train_state(cfg: Config, tap: SST, cg: Captioner) -> TrainState:
    return TrainState(tap, cg, make_optimizer(cfg, tap.parameters()),
                      make_optimizer(cfg, cg.parameters()))


def set_lr(state: TrainState, lr: float) -> TrainState:
    """The epoch step-decay learning rate, for both optimizers."""
    for opt in (state.tap_opt, state.cg_opt):
        for group in opt.param_groups:
            group["lr"] = lr
    return state


def upload_batch(batch: VideoBatch, device) -> VideoBatch:
    """Copies on ``device`` of a VideoBatch's fields (numpy arrays or CPU
    tensors) in their own dtypes: what crosses to the device is the host
    bytes, so a compressed batch (engine.train._compress_batch: feats as
    bf16 tensors, the {0,1} grids as uint8) crosses compressed.  The copies
    are queued without a stream sync: each source is pageable, and the copy
    stages it before it returns."""
    return VideoBatch(*(host_tensor(x).to(device, non_blocking=True, copy=True)
                        for x in batch))


def host_tensor(x) -> torch.Tensor:
    """A CPU tensor of ``x`` (a tensor, a numpy array or scalar), sharing
    the array's memory where it is writable."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def lift_batch(batch: VideoBatch) -> VideoBatch:
    """The step's dtypes, on the batch's device: integer fields as int64
    and every other field as f32, so bf16 features and uint8 grids become
    f32 as echr_tpu's decompress_batch makes them (exact for the grids)."""
    def up(t):
        if t.is_floating_point() or t.dtype == torch.uint8:
            return t.float()
        return t.long()

    return VideoBatch(*(up(t) for t in batch))


def batch_to_device(batch: VideoBatch, device) -> VideoBatch:
    """A VideoBatch, compressed or not, as the step's tensors on
    ``device``: upload_batch, then lift_batch there."""
    return lift_batch(upload_batch(batch, device))


def fetch_host(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """Host copies of ``tensors`` with one synchronisation: the copies are
    queued on the current stream, then one event is waited on."""
    if all(t.device.type == "cpu" for t in tensors):
        return tuple(t.numpy() for t in tensors)
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return tuple(h.numpy() for h in host)


def fetch_metrics(*metrics: Dict) -> List[Dict[str, float]]:
    """The steps' metric dicts (0-d tensors, as the steps return them, or
    floats) as dicts of floats: every tensor stacked on its device and
    copied to the host with one synchronisation."""
    keys = [(i, k) for i, m in enumerate(metrics) for k, v in m.items()
            if isinstance(v, torch.Tensor)]
    out = [dict(m) for m in metrics]
    if keys:
        (vals,) = fetch_host(torch.stack([metrics[i][k].float() for i, k in keys]))
        for (i, k), v in zip(keys, vals.tolist()):
            out[i][k] = v
    return [{k: float(v) for k, v in m.items()} for m in out]


def _select_props(batch: VideoBatch, phase: str
                  ) -> Tuple[ProposalBatch, torch.Tensor, torch.Tensor]:
    """GT proposals for 'cg' / 'gt_tap_cg', the sampled ones otherwise."""
    if phase in ("cg", "gt_tap_cg"):
        props = ProposalBatch(batch.gts_ind, batch.gts_soi, batch.gts_mask)
        return props, batch.gts_cg_labels, batch.gts_cg_masks
    props = ProposalBatch(batch.ind_select, batch.soi, batch.prop_mask)
    return props, batch.cg_labels, batch.cg_masks


def _one_video_losses(tap: SST, cg: Captioner, cfg: Config, batch: VideoBatch, phase: str,
                      gen: Optional[torch.Generator], train: bool, ss_prob: float
                      ) -> Dict[str, torch.Tensor]:
    """Each video's losses, [B] each: the reference's _one_video_losses over
    a batch axis.  ``tap`` and ``cg`` hold compute-dtype weights."""
    dt = compute_dtype(cfg.runtime.compute_dtype)
    tap_feats, scores = sst_forward_batched(tap, batch.feats, dt, train, gen,
                                            cfg.tap.rnn_dropout)
    tap_l = losses.tap_loss(scores, batch.tap_masks, batch.tap_labels, batch.w1,
                            batch.n_frames)
    out = {"tap_loss": tap_l}
    if phase != "tap":
        props, labels, masks = _select_props(batch, phase)
        if cfg.runtime.fused_loss_head and ss_prob == 0.0:
            cg_l = captioner_train_loss(cg, cfg, tap_feats, batch.feats, batch.lda, labels,
                                        masks, props, batch.frame_mask, dt, train, gen)
        else:
            logprobs = captioner_train_forward(cg, cfg, tap_feats, batch.feats, batch.lda,
                                               labels, props, batch.frame_mask, dt, train,
                                               gen, ss_prob)
            cg_l = losses.language_model_loss(logprobs, labels[..., 1:], masks[..., 1:])
        out["cg_loss"] = cg_l
        out["total_loss"] = cfg.train.lambda1 * tap_l + cfg.train.lambda2 * cg_l
    return out


def _phase_loss(metrics: Dict[str, torch.Tensor], phase: str) -> torch.Tensor:
    if phase == "tap":
        return metrics["tap_loss"]
    if phase in ("cg", "gt_tap_cg", "LP_cg"):
        return metrics["cg_loss"]
    return metrics["total_loss"]


def _batch_losses(models: nn.ModuleDict, cfg: Config, batch: VideoBatch, phase: str,
                  gen: Optional[torch.Generator], ss_prob: float) -> Dict[str, torch.Tensor]:
    per_video = _one_video_losses(models["tap"], models["cg"], cfg, batch, phase, gen, True,
                                  ss_prob)
    return {k: v.mean() for k, v in per_video.items()}


def grad_step(state: TrainState, batch: VideoBatch, gen: Optional[torch.Generator],
              cfg: Config, phase: str, ss_prob: float = 0.0, updated_only: bool = False
              ) -> Tuple[Tuple[List[torch.Tensor], List[torch.Tensor]], Dict[str, torch.Tensor]]:
    """Gradients of the phase loss (the mean over the batch's videos) for
    every parameter of both models, and the metrics as 0-d tensors on the
    device (``fetch_metrics`` makes them floats).  Dropout and scheduled
    sampling draw from ``gen``; ``gen=None`` turns both off.
    ``updated_only``: gradients only for the models the phase updates,
    zeros for the other, whose forward builds no graph (phase 'cg' runs no
    SST backward), as echr_tpu's jitted train_step, whose compiler drops
    the gradients it never applies."""
    return _phase_grads(state, cfg, phase, _batch_losses, batch, phase, gen, ss_prob,
                        updated_only=updated_only)


def _phase_grads(state: TrainState, cfg: Config, phase: str, losses_fn, *args,
                 updated_only: bool = False
                 ) -> Tuple[Tuple[List[torch.Tensor], List[torch.Tensor]], Dict[str, torch.Tensor]]:
    """Gradients of the phase loss of losses_fn(models, cfg, *args), a dict
    of batch-mean losses computed with the weights in the compute dtype,
    for every parameter of both models; and the metrics as detached 0-d
    tensors on the device, so that no metric makes the host wait.
    ``updated_only``: a model the phase does not update runs its forward
    with its parameters out of the graph, and gets zero gradients."""
    models = nn.ModuleDict({"tap": state.tap, "cg": state.cg})  # one cast for both
    frozen = [m for m, phases in ((state.tap, UPDATES_TAP), (state.cg, UPDATES_CG))
              if updated_only and phase not in phases]
    for m in frozen:
        m.requires_grad_(False)
    try:
        metrics = call_in_compute_dtype(models, compute_dtype(cfg.runtime.compute_dtype),
                                        losses_fn, cfg, *args)
    finally:
        for m in frozen:
            m.requires_grad_(True)
    return _grads_of(state, metrics, phase)


def _grads_of(state: TrainState, metrics: Dict[str, torch.Tensor], phase: str
              ) -> Tuple[Tuple[List[torch.Tensor], List[torch.Tensor]], Dict[str, torch.Tensor]]:
    """The gradients of the phase loss of ``metrics`` (batch-mean losses in
    a graph over the state's parameters) and the detached metrics, both
    averaged over the ranks' dp column under a group."""
    params = [*state.tap.parameters(), *state.cg.parameters()]
    loss = _phase_loss(metrics, phase)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    # an unused parameter has a zero gradient (Adam still steps it, as optax does)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    n_tap = len(list(state.tap.parameters()))
    out = {k: v.detach() for k, v in metrics.items()}
    out["loss"] = loss.detach()
    if dist.is_initialized():
        # data parallel: the mean over the ranks of a dp column of each
        # rank's batch-mean gradients and metrics (echr_tpu's gradient psum
        # over the data axis), before any clip
        names = list(out)
        lay = state.mesh
        kw = {} if lay is None else {"group": lay.dp_group, "size": lay.dp}
        reduced = mesh.all_reduce_grads(grads + [out[k] for k in names], **kw)
        grads, out = reduced[:len(params)], dict(zip(names, reduced[len(params):]))
    return (grads[:n_tap], grads[n_tap:]), out


@torch.no_grad()
def _update(opt: torch.optim.Adam, grads: List[torch.Tensor], clip: float) -> None:
    params = [p for group in opt.param_groups for p in group["params"]]
    for p, g in zip(params, grads):
        p.grad = g.clamp(-clip, clip)
    opt.step()
    for p in params:
        p.grad = None


def apply_grads(state: TrainState, tap_g: List[torch.Tensor], cg_g: List[torch.Tensor],
                cfg: Config, phase: str) -> TrainState:
    """Clip each element, then step the phase's optimizers; the other
    model's parameters and Adam state stay as they are."""
    if phase in UPDATES_CG:
        _update(state.cg_opt, cg_g, cfg.train.grad_clip)
    if phase in UPDATES_TAP:
        _update(state.tap_opt, tap_g, cfg.train.grad_clip)
    state.step += 1
    return state


def train_step(state: TrainState, batch: VideoBatch, gen: Optional[torch.Generator],
               cfg: Config, phase: str, ss_prob: float = 0.0
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One training step over a [B]-video batch of tensors on the models'
    device (``batch_to_device``); the metrics stay on the device."""
    (tap_g, cg_g), metrics = grad_step(state, batch, gen, cfg, phase, ss_prob,
                                       updated_only=True)
    return apply_grads(state, tap_g, cg_g, cfg, phase), metrics


# ---------------------------------------------------------------------------
# self-critical (SCST) steps, batched over videos
# ---------------------------------------------------------------------------


def _rl_prepare(tap: SST, cg: Captioner, cfg: Config, batch: VideoBatch, phase: str,
                gen: Optional[torch.Generator]):
    """The train-mode encode and contexts of the SCST rollout, up to (not
    including) the sampled decode, with dropout from ``gen``: (tap_loss
    [B], contexts).  ``tap`` and ``cg`` hold compute-dtype weights."""
    dt = compute_dtype(cfg.runtime.compute_dtype)
    tap_feats, scores = sst_forward_batched(tap, batch.feats, dt, True, gen,
                                            cfg.tap.rnn_dropout)
    tap_l = losses.tap_loss(scores, batch.tap_masks, batch.tap_labels, batch.w1,
                            batch.n_frames)
    props = _select_props(batch, phase)[0]
    ctxs = make_contexts(cg, cfg, tap_feats, batch.feats, batch.lda, props,
                         frame_mask=batch.frame_mask, train=True, gen=gen)
    return tap_l, ctxs


def _rl_forward(tap: SST, cg: Captioner, cfg: Config, batch: VideoBatch, phase: str,
                gen: Optional[torch.Generator], sample_gen: Optional[torch.Generator] = None,
                forced: Optional[torch.Tensor] = None):
    """The train-mode rollout: (tap_loss [B], seq [B, N, L], logps
    [B, N, L]).  Sampled from ``sample_gen`` when ``forced`` is None (the
    batch-wide early exit), else the replay of ``forced`` over all L steps
    under autograd.  Called twice from the same ``gen`` state, the two
    draw the same dropout masks."""
    tap_l, ctxs = _rl_prepare(tap, cg, cfg, batch, phase, gen)
    dt = compute_dtype(cfg.runtime.compute_dtype)
    seq, logps, _ = decoder_sample_batched(cg.decoder, cfg, ctxs, dt, greedy=False,
                                           sample_gen=sample_gen, train=True, gen=gen,
                                           forced=forced)
    return tap_l, seq, logps


def _rl_rollouts(models: nn.ModuleDict, cfg: Config, batch: VideoBatch, phase: str,
                 gen: Optional[torch.Generator], sample_gen: torch.Generator):
    """The sampled rollout, under autograd where the caller is, and the
    greedy baseline under no grad: (tap_loss [B], gen_seq, logps
    [B, N, L], greedy_seq)."""
    tap, cg = models["tap"], models["cg"]
    tap_l, gen_seq, logps = _rl_forward(tap, cg, cfg, batch, phase, gen, sample_gen)
    # the greedy baseline: eval mode, no dropout, the decode path's
    # kernels and window sort
    with torch.no_grad():
        dt = compute_dtype(cfg.runtime.compute_dtype)
        tap_feats_eval, _ = sst_forward_batched(tap, batch.feats, dt)
        props = _select_props(batch, phase)[0]
        greedy_seq, _, _ = captioner_sample(cg, cfg, tap_feats_eval, batch.feats, batch.lda,
                                            props, batch.frame_mask, dt)
    return tap_l, gen_seq, logps, greedy_seq


@torch.no_grad()
def rl_rollout_step_batched(state: TrainState, batch: VideoBatch, cfg: Config, phase: str,
                            gen: Optional[torch.Generator], sample_gen: torch.Generator
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SCST rollouts of a [B]-video batch (reference: CaptionGenerator mode
    'train_rl', :32-38): a multinomial train-mode rollout, dropout from
    ``gen`` and draws from ``sample_gen``, and an eval-mode greedy baseline,
    both with the batch-wide early exit.  Returns (tap_loss [B], gen_seq
    [B, N, L], greedy_seq [B, N, L]).  Save ``gen``'s state before this
    call and restore it for rl_update_step_batched."""
    models = nn.ModuleDict({"tap": state.tap, "cg": state.cg})
    tap_l, gen_seq, _, greedy_seq = call_in_compute_dtype(
        models, compute_dtype(cfg.runtime.compute_dtype), _rl_rollouts, cfg, batch, phase, gen,
        sample_gen)
    return tap_l, gen_seq, greedy_seq


def _rl_losses(models: nn.ModuleDict, cfg: Config, batch: VideoBatch, phase: str,
               gen: Optional[torch.Generator], gen_seq: torch.Tensor, reward: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    tap_l, _, logps = _rl_forward(models["tap"], models["cg"], cfg, batch, phase, gen,
                                  forced=gen_seq)
    return _rl_metrics(cfg, batch, phase, tap_l, logps, gen_seq, reward)


def _rl_metrics(cfg: Config, batch: VideoBatch, phase: str, tap_l: torch.Tensor,
                logps: torch.Tensor, gen_seq: torch.Tensor, reward: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Each video's reward loss of the rollout's ``logps`` with its own
    denominators, its tap loss and mean reward, and the mean over videos."""
    pm = _select_props(batch, phase)[0].prop_mask
    rl_l = losses.reward_loss(logps, gen_seq, reward, prop_mask=pm)
    n_real = torch.clamp(pm.sum(dim=1), min=1.0)
    per_video = {"tap_loss": tap_l, "cg_loss": rl_l,
                 "total_loss": cfg.train.lambda1 * tap_l + cfg.train.lambda2 * rl_l,
                 # the mean reward over REAL proposals (padded rows carry 0)
                 "avg_reward": (reward[..., 0] * pm).sum(dim=1) / n_real}
    return {k: v.mean() for k, v in per_video.items()}


def rl_update_step_batched(state: TrainState, batch: VideoBatch, cfg: Config, phase: str,
                           gen: Optional[torch.Generator], gen_seq: torch.Tensor,
                           reward: torch.Tensor) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The policy-gradient update of a [B]-video batch: the rollout's tokens
    ``gen_seq`` replayed with ``gen`` in the state the rollout started from,
    each video's reward loss (``reward`` [B, N, L]) with its own
    denominators, the mean over videos, and one dual-Adam step: the TAP
    model only in 'tap_cg' / 'gt_tap_cg', the captioner always.  Metrics
    (0-d tensors on the device): tap_loss, cg_loss (the reward loss),
    total_loss, avg_reward and loss."""
    grads, metrics = _phase_grads(state, cfg, phase, _rl_losses, batch, phase, gen, gen_seq,
                                  reward)
    return apply_grads(state, grads[0], grads[1], cfg, phase), metrics


@dataclass
class RolloutGraph:
    """What rl_rollout_graph_step_batched keeps for the update: the
    rollout's tap loss and logps in their autograd graph, and its tokens."""

    tap_loss: torch.Tensor  # [B]
    logps: torch.Tensor  # [B, N, L]
    gen_seq: torch.Tensor  # [B, N, L]


def rl_rollout_graph_step_batched(state: TrainState, batch: VideoBatch, cfg: Config,
                                  phase: str, gen: Optional[torch.Generator],
                                  sample_gen: torch.Generator
                                  ) -> Tuple[RolloutGraph, torch.Tensor, torch.Tensor]:
    """rl_rollout_step_batched with the sampled rollout under autograd
    (echr_tpu's rl_rollout_vjp_step_batched, runtime.scst_resident_vjp):
    the same tokens from the same generators, and its graph, weights cast to
    the compute dtype inside it, kept for rl_graph_update_step_batched.
    Returns (the kept rollout, gen_seq [B, N, L], greedy_seq [B, N, L])."""
    models = nn.ModuleDict({"tap": state.tap, "cg": state.cg})
    tap_l, gen_seq, logps, greedy_seq = call_in_compute_dtype(
        models, compute_dtype(cfg.runtime.compute_dtype), _rl_rollouts, cfg, batch, phase, gen,
        sample_gen)
    return RolloutGraph(tap_l, logps, gen_seq), gen_seq, greedy_seq


def rl_graph_update_step_batched(state: TrainState, batch: VideoBatch, cfg: Config,
                                 phase: str, kept: RolloutGraph, reward: torch.Tensor
                                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The policy-gradient update from a kept rollout (echr_tpu's
    rl_pullback_update_step_batched): the reward loss of its logps, the
    mean over videos, backpropagated through the rollout's graph, and the
    dual-Adam step of rl_update_step_batched.  The graph is freed.  Metrics
    as rl_update_step_batched's."""
    grads, metrics = _grads_of(state, _rl_metrics(cfg, batch, phase, kept.tap_loss, kept.logps,
                                                  kept.gen_seq, reward), phase)
    return apply_grads(state, grads[0], grads[1], cfg, phase), metrics


@torch.no_grad()
def val_loss_step_batched(tap: SST, cg: Captioner, batch: VideoBatch, cfg: Config,
                          phase: str = "tap_cg") -> Dict[str, torch.Tensor]:
    """Eval-mode losses of a [B]-video batch of tensors on the models'
    device: tap_loss, and cg_loss and total_loss unless phase is 'tap',
    [B] each (echr_tpu's vmapped _one_video_losses; reference:
    eval_utils.py:139-155), without dropout.  ``tap`` and ``cg`` are cast
    to the compute dtype already, as the decode steps take them, so no
    cast is needed inside (call_in_compute_dtype, as grad_step does)."""
    return _one_video_losses(tap, cg, cfg, batch, phase, None, False, 0.0)


@torch.inference_mode()
def encode_step_batched(sst: SST, feats: torch.Tensor, cfg: Config
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode SST over [B, T, D] -> (tap_feats [B, T, H], scores [B, T, K]).
    ``encode_step_batched.host_ns``: the host's time issuing it (the LSTM's
    launches frame by frame); the card runs behind."""
    with span("sst.encode", encode_step_batched):
        return sst_forward_batched(sst, feats, compute_dtype(cfg.runtime.compute_dtype))


encode_step_batched.host_ns = 0


@torch.inference_mode()
def select_topk_batched(pred_props: torch.Tensor, n_frames: torch.Tensor, topN: int,
                        nb: int, val_score_thres: float = 0.0):
    """Device-side top-N anchor selection, selection-identical to
    echr_tpu.engine.proposals.top_proposals: threshold = the topN-th largest
    masked score of the [n_frames, K] grid (at least val_score_thres), then
    every anchor >= threshold with the t >= k guard, in row-major (t, k)
    order, truncated to nb slots.

    pred_props [B, T, K], n_frames [B] -> (flat_idx [B, nb] int32 into the
    [T, K] grid with fill T*K, count [B] int32, confidence [B, nb])."""
    with span("select.topk"):
        B, T, K = pred_props.shape
        dev = pred_props.device
        t = torch.arange(T, device=dev)[:, None]
        k = torch.arange(K, device=dev)[None, :]
        amask = (k < torch.clamp(t, max=K)).to(pred_props.dtype)  # anchor_mask
        valid_t = (torch.arange(T, device=dev)[None, :] < n_frames[:, None])[:, :, None]
        masked = pred_props * amask * valid_t
        flat = masked.reshape(B, T * K)
        # frames past n_frames are zero and scores are >= 0, so the topN-th
        # largest over T*K equals the host's over n_frames*K
        thr = torch.topk(flat, min(topN, T * K), dim=1).values[:, -1]
        thr = torch.clamp(thr, min=val_score_thres)
        sel = (masked >= thr[:, None, None]) & (t >= k) & valid_t
        sel = sel.reshape(B, T * K)
        pos = torch.arange(T * K, device=dev).expand(B, T * K)
        key = torch.where(sel, pos, T * K)
        idx = torch.sort(key, dim=1).values[:, :nb]
        if idx.shape[1] < nb:
            idx = torch.cat([idx, torch.full((B, nb - idx.shape[1]), T * K, device=dev,
                                             dtype=idx.dtype)], dim=1)
        conf = torch.where(idx < T * K, torch.gather(flat, 1, torch.clamp(idx, max=T * K - 1)),
                           torch.zeros((), device=dev, dtype=flat.dtype))
        return idx.to(torch.int32), sel.sum(dim=1).to(torch.int32), conf


def unpack_topk_selection(idx_row, count, nb: int, K: int, n_frames: int,
                          duration: float, conf_row):
    """Host decode of one video's select_topk_batched row into the
    (ind, soi, timestamps, confidence) lists of the serving path."""
    n = int(min(int(count), nb))
    flat = np.asarray(idx_row)[:n].astype(np.int64)
    tt, kk = flat // K, flat % K
    soi = np.stack([tt - kk, tt + 1], axis=1)
    ts = featstamps_to_times(soi, n_frames, duration).tolist()
    tp = np.asarray(conf_row)[:n].astype(float).tolist()
    return tt.tolist(), soi.tolist(), ts, tp


@torch.inference_mode()
def decode_step_batched(cg: Captioner, cfg: Config, tap_feats: torch.Tensor,
                        feats: torch.Tensor, lda: torch.Tensor, frame_mask: torch.Tensor,
                        props: ProposalBatch, greedy: bool = True, temperature: float = 1.0,
                        sample_gen: Optional[torch.Generator] = None):
    """Greedy, or with ``greedy=False`` multinomial at ``temperature`` (draws
    from ``sample_gen``), decode of B videos' proposals with the batch-wide
    early exit.  Returns (seq [B, N, L], logps [B, N, L], active [B, L])."""
    return captioner_sample(cg, cfg, tap_feats, feats, lda, props, frame_mask,
                            compute_dtype(cfg.runtime.compute_dtype), greedy, temperature,
                            sample_gen)


@torch.inference_mode()
def beam_decode_step_batched(cg: Captioner, cfg: Config, tap_feats: torch.Tensor,
                             feats: torch.Tensor, lda: torch.Tensor, frame_mask: torch.Tensor,
                             props: ProposalBatch, beam_size: int, length_alpha: float = 0.0,
                             early_exit: Optional[bool] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode of B videos' proposals: (seq [B, N, L] of the best beam,
    its logprob [B, N]).  ``early_exit`` (default
    runtime.decode_early_exit_batched) selects the batch-wide early exit,
    else the fixed-L loop; both return identical tensors."""
    if early_exit is None:
        early_exit = bool(cfg.runtime.decode_early_exit_batched)
    ctxs = make_contexts(cg, cfg, tap_feats, feats, lda, props, frame_mask=frame_mask)
    res = beam_search_batched(cg.decoder, cfg, ctxs, beam_size, length_alpha,
                              early_exit=early_exit,
                              dtype=compute_dtype(cfg.runtime.compute_dtype))
    return res.seq, res.logprob


# ---------------------------------------------------------------------------
# per-video steps: one video's tensors, no batch axis (echr_tpu's
# encode_step, val_loss_step, decode_step, beam_decode_step, rl_rollout_step
# and rl_update_step), each the batched step on a batch of one
# ---------------------------------------------------------------------------


def one_video(batch: VideoBatch) -> VideoBatch:
    """A one-video VideoBatch as a batch of one."""
    return VideoBatch(*(x[None] for x in batch))


def _one_props(props: ProposalBatch) -> ProposalBatch:
    return ProposalBatch(*(x[None] for x in props))


def encode_step(sst: SST, feats: torch.Tensor, cfg: Config
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode SST over one video's [T, D] -> (tap_feats [T, H], scores
    [T, K])."""
    tap_feats, scores = encode_step_batched(sst, feats[None], cfg)
    return tap_feats[0], scores[0]


def val_loss_step(tap: SST, cg: Captioner, batch: VideoBatch, cfg: Config,
                  phase: str = "tap_cg") -> Dict[str, torch.Tensor]:
    """Eval-mode losses of one video (reference: eval_utils.py:139-155):
    tap_loss, and cg_loss and total_loss unless phase is 'tap', 0-d each.
    ``tap`` and ``cg`` are cast to the compute dtype already."""
    return {k: v[0] for k, v in val_loss_step_batched(tap, cg, one_video(batch), cfg,
                                                      phase).items()}


@torch.inference_mode()
def decode_step(cg: Captioner, cfg: Config, tap_feats: torch.Tensor, feats: torch.Tensor,
                lda: torch.Tensor, frame_mask: torch.Tensor, props: ProposalBatch,
                greedy: bool = True, temperature: float = 1.0,
                sample_gen: Optional[torch.Generator] = None):
    """Greedy, or multinomial at ``temperature``, decode of one video's
    proposals (props of [N] rows, padded to a bucket): (seq [N, L], logps
    [N, L], active [L]).  The early exit is the video's own."""
    return captioner_sample_one(cg, cfg, tap_feats, feats, lda, props, frame_mask,
                                compute_dtype(cfg.runtime.compute_dtype), greedy, temperature,
                                sample_gen)


def beam_decode_step(cg: Captioner, cfg: Config, tap_feats: torch.Tensor,
                     feats: torch.Tensor, lda: torch.Tensor, frame_mask: torch.Tensor,
                     props: ProposalBatch, beam_size: int, length_alpha: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam decode of one video's proposals: (seq [N, L] of the best beam,
    its logprob [N]); bucket-padding rows come back as zeros.  The loop is
    the video's early exit or, with runtime.decode_early_exit False, the
    fixed-L loop."""
    seq, logprob = beam_decode_step_batched(cg, cfg, tap_feats[None], feats[None], lda[None],
                                            frame_mask[None], _one_props(props), beam_size,
                                            length_alpha, bool(cfg.runtime.decode_early_exit))
    return seq[0], logprob[0]


def rl_rollout_step(state: TrainState, batch: VideoBatch, cfg: Config, phase: str,
                    gen: Optional[torch.Generator], sample_gen: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SCST rollouts of one video: (tap_loss, gen_seq [N, L], greedy_seq
    [N, L]), as rl_rollout_step_batched makes them."""
    tap_l, gen_seq, greedy_seq = rl_rollout_step_batched(state, one_video(batch), cfg, phase,
                                                         gen, sample_gen)
    return tap_l[0], gen_seq[0], greedy_seq[0]


def rl_update_step(state: TrainState, batch: VideoBatch, cfg: Config, phase: str,
                   gen: Optional[torch.Generator], gen_seq: torch.Tensor, reward: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """The policy-gradient update of one video's rollout ``gen_seq`` [N, L]
    with ``reward`` [N, L] (``gen`` restored to its state before the
    rollout), as rl_update_step_batched makes it."""
    return rl_update_step_batched(state, one_video(batch), cfg, phase, gen, gen_seq[None],
                                  reward[None])
