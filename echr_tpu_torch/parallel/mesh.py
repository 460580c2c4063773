"""The data axis of echr_tpu's (data, model) mesh (echr_tpu/parallel/mesh.py)
on torch.distributed.

echr_tpu lays one jitted step over a mesh and lets XLA insert the gradient
psum.  Here every rank runs its own program on its rows of the global
batch, and the psum is explicit: ``all_reduce_grads`` sums each dtype's
tensors in one flat buffer and divides by the world size.  Each rank's
loss is the mean over its rows, so with equal rows on every rank the
result is the gradient of the mean over the global batch.  The model
axis (vocab and TSRM-head tensor parallelism, ``mesh.py:99-142``) is not
ported (ROADMAP.md A.13).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from echr_tpu_torch.config import Config
from echr_tpu_torch.data.batcher import VideoBatch
from echr_tpu_torch.parallel.distributed import world_size


def check_layout(cfg: Config, world: int) -> None:
    """``runtime.mesh_shape`` (dp, tp) against a group of ``world`` ranks:
    dp must be 1 (the default: every rank on the data axis) or the world
    size, and tp 1.  Raises where echr_tpu's build_mesh would fall back
    silently to (n, 1)."""
    dp, tp = cfg.runtime.mesh_shape
    if tp != 1:
        raise NotImplementedError(
            f"runtime.mesh_shape {tuple(cfg.runtime.mesh_shape)}: tensor parallelism (tp > 1) is "
            "not ported (ROADMAP.md A.13, vocab and TSRM-head TP); use mesh_shape (dp, 1)")
    if dp not in (1, world):
        raise ValueError(
            f"runtime.mesh_shape {tuple(cfg.runtime.mesh_shape)}: dp {dp} must be 1 or the "
            f"group's {world} ranks (one rank a device); launch {dp} ranks or set dp")


def shard_rows(batch: VideoBatch, rank: int, world: int) -> VideoBatch:
    """Rank ``rank``'s rows [r*B/P, (r+1)*B/P) of a collated [B, ...]
    group (echr_tpu's _shard_batch over the data axis)."""
    B = len(batch.feats)
    if B % world:
        raise ValueError(f"a group of {B} videos does not split over {world} ranks")
    lo, hi = rank * B // world, (rank + 1) * B // world
    return VideoBatch(*(x[lo:hi] for x in batch))


def _flat_by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def all_reduce_grads(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (gradients, and the 0-d
    metrics beside them): one flat buffer and one all_reduce(SUM) a dtype,
    then a division by the world size.  Every rank gets the same bits."""
    world = world_size()
    out: List[torch.Tensor] = list(tensors)
    for idx in _flat_by_dtype(tensors).values():
        parts = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in parts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(world)
        for i, piece in zip(idx, torch.split(flat, [t.numel() for t in parts])):
            out[i] = piece.view_as(tensors[i])
    return out


def _state_tensors(state) -> List[torch.Tensor]:
    """A train state's parameters and the optimizer-state tensors that
    live on their device, in a fixed order."""
    out: List[torch.Tensor] = []
    for module, opt in ((state.tap, state.tap_opt), (state.cg, state.cg_opt)):
        params = list(module.parameters())
        out.extend(p.data for p in params)
        dev = params[0].device if params else None
        for p in params:
            for k in sorted(opt.state.get(p, {})):
                v = opt.state[p][k]
                if isinstance(v, torch.Tensor) and v.device == dev:
                    out.append(v)
    return out


@torch.no_grad()
def broadcast_state(state) -> None:
    """Rank 0's parameters and optimizer state on every rank, in place:
    one broadcast a dtype.  Every rank must hold the same structure (the
    same checkpoint, or a fresh init)."""
    if world_size() == 1:
        return
    tensors = _state_tensors(state)
    for idx in _flat_by_dtype(tensors).values():
        parts = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in parts])
        dist.broadcast(flat, src=0)
        for t, piece in zip(parts, torch.split(flat, [t.numel() for t in parts])):
            t.copy_(piece.view_as(t))

