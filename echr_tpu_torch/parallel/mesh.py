"""echr_tpu's (data, model) mesh (echr_tpu/parallel/mesh.py) on
torch.distributed: one rank a device, ``runtime.mesh_shape`` (dp, tp).

Rank r is (d = r // tp, m = r % tp), the row-major layout of echr_tpu's
``np.asarray(devices).reshape(dp, tp)``: the model axis is the fast axis.
``build_mesh`` makes one process group for each tp row (the ranks of one
d) and one for each dp column (the ranks of one m).

The data axis: echr_tpu lays one jitted step over the mesh and lets XLA
insert the gradient psum.  Here every rank runs its own program on its
row d's share of the global batch, and the psum is explicit:
``all_reduce_grads`` sums each dtype's tensors in one flat buffer over a
dp column and divides by dp.  Each rank's loss is the mean over its rows,
so with equal rows on every rank the result is the gradient of the mean
over the global batch.

The model axis (``param_sharding_rules``, ``shard_params``,
``mesh.py:99-142``): ``param_sharding_rule`` names the captioner leaves cut
over the tp ranks of a row, exactly where echr_tpu's rule does, the
vocab-wide decoder ``embed`` [V+1, E] and ``logit`` over the vocab and the
TSRM output projection over its heads, each only where tp divides the
dimension.  ``shard_modules`` cuts them and their Adam moments to the
rank's block and marks the modules (``parallel.tensor.TPShard``), whose
forward then runs the collectives of parallel/tensor.py; the other leaves
stay replicated.  ``gather_modules`` is the collective inverse (echr_tpu's
``_localize``).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from echr_tpu_torch.config import Config
from echr_tpu_torch.data.batcher import VideoBatch
from echr_tpu_torch.parallel.distributed import rank as group_rank
from echr_tpu_torch.parallel.distributed import world_size
from echr_tpu_torch.parallel.tensor import TPShard, all_gather, shard_of


def check_layout(cfg: Config, world: int) -> Tuple[int, int]:
    """``runtime.mesh_shape`` (dp, tp) against a group of ``world`` ranks:
    returns the layout, (world, 1) for the default (1, 1) (every rank on
    the data axis).  Any other (dp, tp) must have dp x tp equal to the
    world size; otherwise this raises, naming both numbers, where
    echr_tpu's build_mesh falls back silently to (n, 1)."""
    dp, tp = (int(x) for x in cfg.runtime.mesh_shape)
    if (dp, tp) == (1, 1):
        return world, 1
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(
            f"runtime.mesh_shape {(dp, tp)}: dp x tp = {dp * tp} ranks, the group has "
            f"{world} (one rank a device); launch {dp * tp} ranks or set mesh_shape")
    return dp, tp


@dataclass
class Mesh:
    """The rank's place in the (dp, tp) layout and its two groups: the tp
    row of its d and the dp column of its m (None: the default group, or
    no group at all in one process)."""

    dp: int
    tp: int
    rank: int
    tp_group: object = None
    dp_group: object = None

    @property
    def d(self) -> int:
        return self.rank // self.tp

    @property
    def m(self) -> int:
        return self.rank % self.tp

    def row_root(self) -> int:
        """The global rank of m = 0 in this rank's tp row."""
        return self.d * self.tp


def build_mesh(cfg: Config) -> Mesh:
    """The (dp, tp) layout of ``runtime.mesh_shape`` over the current
    group (check_layout), with its row and column groups when tp > 1.
    Every rank of the group calls it, in the same order as the others."""
    world, r = world_size(), group_rank()
    dp, tp = check_layout(cfg, world)
    mesh = Mesh(dp, tp, r)
    if tp > 1:
        # every rank makes every group, in one order
        for d in range(dp):
            g = dist.new_group([d * tp + m for m in range(tp)])
            if d == mesh.d:
                mesh.tp_group = g
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)])
            if m == mesh.m:
                mesh.dp_group = g
    return mesh


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


def all_reduce_grads(tensors: Sequence[torch.Tensor], group=None,
                     size: Optional[int] = None) -> List[torch.Tensor]:
    """The mean over the ranks of ``group`` (the default group: every rank)
    of each tensor (gradients, and the 0-d metrics beside them): one flat
    buffer and one all_reduce(SUM) a dtype, then a division by the group's
    ``size`` (the world size by default).  Every rank gets the same bits."""
    size = world_size() if size is None else size
    out: List[torch.Tensor] = list(tensors)
    for idx in _flat_by_dtype(tensors).values():
        parts = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in parts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat.div_(size)
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



# ---------------------------------------------------------------------------
# the model axis
# ---------------------------------------------------------------------------

_VOCAB_LEAVES = ("decoder.embed", "decoder.logit.weight", "decoder.logit.bias")
_HEAD_LEAF = "fusion.out.weight"


def param_sharding_rule(name: str, tensor: torch.Tensor, tp: int, n_head: int = 1
                        ) -> Optional[int]:
    """The dimension over which the captioner leaf ``name`` (a name of
    Captioner.named_parameters(), "cg." in front or not) is cut into tp
    blocks, or None where it stays replicated: echr_tpu's
    param_sharding_rules keyed by the port's names.  The decoder's embed
    [V+1, E] and logit weight [V+1, C] and bias [V+1] over the vocab where
    tp divides V+1; the TSRM output weight [d_o, d_in] (GroupedProjection,
    the rows of head i contiguous) over its ``n_head`` heads where tp
    divides n_head, so a block is a contiguous run of whole heads."""
    name = name[3:] if name.startswith("cg.") else name
    if tp <= 1:
        return None
    if name in _VOCAB_LEAVES and tensor.shape[0] % tp == 0:
        return 0
    if name == _HEAD_LEAF and n_head % tp == 0:
        return 0
    return None


def sharded_leaves(cg) -> List[Tuple[str, torch.nn.Parameter, TPShard]]:
    """(name, parameter, TPShard) of every leaf of a sharded captioner, from
    its modules' marks."""
    out = []
    for name, p in cg.named_parameters():
        owner = cg.decoder if name in _VOCAB_LEAVES else (
            cg.fusion if name == _HEAD_LEAF else None)
        tp = shard_of(owner) if owner is not None else None
        if tp is not None:
            out.append((name, p, tp))
    return out


@torch.no_grad()
def shard_captioner(cg, m: int, tp: int, group=None, opt: Optional[torch.optim.Adam] = None):
    """Cut ``cg``'s sharded leaves (param_sharding_rule) to block m of tp in
    place, with their Adam state in ``opt`` when given, and mark the
    decoder and the TSRM whose leaves were cut with a TPShard over
    ``group`` (None: the default group).  Returns cg."""
    if tp <= 1:
        return cg
    shard = TPShard(group, m, tp)
    n_head = cg.fusion.out.groups if cg.fusion is not None else 1
    for name, p in cg.named_parameters():
        axis = param_sharding_rule(name, p, tp, n_head)
        if axis is None:
            continue
        full = p.shape
        w = full[axis] // tp
        p.data = p.data.narrow(axis, m * w, w).clone()
        state = opt.state.get(p, {}) if opt is not None else {}
        for k, v in state.items():
            if isinstance(v, torch.Tensor) and v.shape == full:
                state[k] = v.narrow(axis, m * w, w).clone()
        if name in _VOCAB_LEAVES:
            cg.decoder.tp = shard
        else:
            cg.fusion.tp = shard
    return cg


@torch.no_grad()
def gather_captioner(cg, opt: Optional[torch.optim.Adam] = None):
    """A whole copy of a sharded captioner (every leaf gathered over its tp
    group, no marks), and with ``opt`` a new Adam over the copy whose state
    is opt's with the moments gathered: (cg, opt).  A collective: every
    rank of the tp group calls it together.  A whole captioner comes back
    as it is."""
    leaves = sharded_leaves(cg)
    if not leaves:
        return cg, opt
    out = copy.deepcopy(cg)
    for mod in (out.decoder, out.fusion):
        if mod is not None and shard_of(mod) is not None:
            del mod.tp
    by_name = dict(out.named_parameters())
    for name, _, tp in leaves:
        q = by_name[name]
        q.data = all_gather(q.data, tp, 0)
    if opt is None:
        return out, None
    new_opt = type(opt)(out.parameters(), **opt.defaults)
    new_opt.param_groups[0]["lr"] = opt.param_groups[0]["lr"]
    sharded = {id(p): tp for _, p, tp in leaves}
    for p, q in zip(cg.parameters(), out.parameters()):
        state = opt.state.get(p)
        if not state:
            continue
        new_state = {}
        for k, v in state.items():
            if isinstance(v, torch.Tensor) and id(p) in sharded and v.shape == p.shape:
                v = all_gather(v, sharded[id(p)], 0)
            else:
                v = v.clone() if isinstance(v, torch.Tensor) else v
            new_state[k] = v
        new_opt.state[q] = new_state
    return out, new_opt


def gather_grads(cg, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The captioner's gradients (in named_parameters order) with every
    sharded leaf's gathered over its tp group: the whole model's.  A
    collective, as gather_captioner."""
    sharded = {id(p): tp for _, p, tp in sharded_leaves(cg)}
    return [all_gather(g, sharded[id(p)], 0) if id(p) in sharded else g
            for p, g in zip(cg.parameters(), grads)]


def shard_modules(state, mesh: Mesh):
    """The train state cut to the rank's blocks on the model axis (tp > 1):
    the captioner's sharded leaves and their Adam moments (shard_captioner
    over the mesh's tp group); the mesh is kept on the state.  The SST has
    no sharded leaf.  Returns state."""
    state.mesh = mesh
    shard_captioner(state.cg, mesh.m, mesh.tp, mesh.tp_group, state.cg_opt)
    return state


def gather_modules(state):
    """A whole copy of a sharded train state (gather_captioner of the
    captioner and its Adam; the SST and its Adam shared), as one process
    holds it: what the checkpoint, the histograms and the gating eval take.
    A collective over the tp group; a whole state comes back as it is."""
    cg, cg_opt = gather_captioner(state.cg, state.cg_opt)
    if cg is state.cg:
        return state
    return type(state)(state.tap, cg, state.tap_opt, cg_opt, state.step)
