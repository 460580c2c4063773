"""The model axis of echr_tpu's (data, model) mesh: the collectives of the
vocab- and head-parallel modules (echr_tpu/parallel/mesh.py:99-142, where
GSPMD inserts them).

A sharded module carries a ``TPShard`` (its tp group, the rank's block
index m and the group's size tp) as its ``tp`` attribute, set by
``parallel.mesh.shard_modules``; a module without one is whole.  Each rank
of a tp group runs the same replicated computation around the sharded
pieces, so a loss is the same on every rank of the group, and the
collectives are written so that autograd gives each rank the
single-process gradient of every replicated leaf and the block of it of
every sharded leaf:

  * ``copy_to_tp``: the identity forward; the backward sums the ranks'
    gradients, each of which holds only its own block's contribution;
  * ``reduce_from_tp``: the sum forward; the identity backward, since every
    rank's downstream gradient is the same;
  * ``gather_from_tp``: the ranks' blocks concatenated along a dimension;
    the backward keeps the rank's own block.

The vocab-parallel pieces: ``embed_lookup`` (rows outside the block look
up zero, summed over the group), ``vocab_nll`` and ``vocab_logp`` (the max
(all-reduce MAX), the sum of exponentials and the target's logit (both
all-reduce SUM) over the group; the [R, V+1] logits are never gathered),
and ``combine_heads``, the merge of kernel 2's per-block (token, max,
lse).  A sampled decode's draws need whole rows: their logits are
gathered (``gather_from_tp``).  Imports torch only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


class TPShard:
    """A sharded module's place on the model axis: the tp group, the rank's
    block m of the group's tp blocks.  Deep copies share it (a process
    group is not copyable), and a gathered module drops it."""

    def __init__(self, group, m: int, tp: int):
        self.group, self.m, self.tp = group, m, tp

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return f"TPShard(m={self.m}, tp={self.tp})"


def shard_of(module) -> Optional[TPShard]:
    """The module's TPShard, or None for a whole module."""
    return getattr(module, "tp", None)


def all_gather(x: torch.Tensor, tp: TPShard, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(tp.tp)]
    dist.all_gather(parts, x.contiguous(), group=tp.group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x: torch.Tensor, tp: TPShard, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=tp.group)
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.width = tp, dim, x.shape[dim]
        return all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.m * ctx.width, ctx.width).contiguous(), None, None


def copy_to_tp(x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """x as it is; its gradient summed over the tp group."""
    return _CopyToTP.apply(x, tp) if torch.is_grad_enabled() and x.requires_grad else x


def reduce_from_tp(x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """The sum of x over the tp group."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, tp)
    return _all_reduce(x, tp)


def gather_from_tp(x: torch.Tensor, tp: TPShard, dim: int = -1) -> torch.Tensor:
    """The ranks' x concatenated along ``dim``, in the order of m."""
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromTP.apply(x, tp, dim)
    return all_gather(x, tp, dim)


def block(tp: TPShard, width: int) -> Tuple[int, int]:
    """The global [lo, hi) of the rank's block of a sharded dimension whose
    local size is ``width``."""
    return tp.m * width, (tp.m + 1) * width


def embed_lookup(embed: torch.Tensor, it: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """embed[it] of the whole [V+1, E] table, from the rank's rows
    [lo, hi): a token outside them looks up zero, and the rows are summed
    over the group."""
    lo, hi = block(tp, embed.shape[0])
    it = it.long()
    inside = (it >= lo) & (it < hi)
    rows = embed[torch.where(inside, it - lo, torch.zeros_like(it))]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from_tp(rows, tp)


def _max_lse(logits: torch.Tensor, tp: TPShard) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the row max, the row logsumexp) over the group's blocks of [..., V1/tp]
    local logits: the max by all-reduce MAX (a constant to autograd), the
    sum of exponentials by an autograd-aware all-reduce SUM."""
    mx = _all_reduce(logits.detach().amax(dim=-1), tp, dist.ReduceOp.MAX)
    sumexp = reduce_from_tp(torch.exp(logits - mx[..., None]).sum(dim=-1), tp)
    return mx, mx + torch.log(sumexp)


def _target_logit(logits: torch.Tensor, target: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """logits[..., target] of the whole row: the rank that owns the column
    gives it, the others zero, summed over the group."""
    lo, hi = block(tp, logits.shape[-1])
    target = target.long()
    inside = (target >= lo) & (target < hi)
    local = torch.gather(logits, -1, torch.where(inside, target - lo,
                                                 torch.zeros_like(target))[..., None])[..., 0]
    return reduce_from_tp(torch.where(inside, local, torch.zeros_like(local)), tp)


def vocab_logp(logits: torch.Tensor, target: torch.Tensor, tp: TPShard) -> torch.Tensor:
    """log softmax(logits)[target] of the whole row from the rank's block of
    columns [..., V1/tp]: target's logit minus the row's logsumexp."""
    _, lse = _max_lse(logits, tp)
    return _target_logit(logits, target, tp) - lse


def vocab_nll(logits: torch.Tensor, targets: torch.Tensor, m: torch.Tensor,
              tp: TPShard) -> torch.Tensor:
    """The teacher-forced NLL per video [B] (decoder._nll_head's) from the
    rank's block of columns of the [B, N, L, V1/tp] logits."""
    logp = vocab_logp(logits, targets, tp)
    return -(logp * m).sum(dim=(1, 2)) / (m.sum(dim=(1, 2)) + 1e-6)


def combine_heads(tok: torch.Tensor, mx: torch.Tensor, lse: torch.Tensor, tp: TPShard,
                  width: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The greedy head's (token int32, max, lse) of whole rows from each
    rank's kernel-2 result over its block of ``width`` = V1/tp columns,
    whose tokens are block-local: the largest max wins, on a tie the
    lowest global index (the lowest block, as kernel 2 keeps the lowest
    index within a block), and the lse is the logsumexp of the blocks'
    lse.  The same on every rank."""
    toks = all_gather(tok.long()[None] + tp.m * width, tp, 0)  # [tp, R]
    mxs = all_gather(mx[None], tp, 0)
    lses = all_gather(lse[None], tp, 0)
    best = mxs.argmax(dim=0)  # the first (lowest) block on a tie
    pick = best[None]
    return (torch.gather(toks, 0, pick)[0].to(torch.int32), torch.gather(mxs, 0, pick)[0],
            torch.logsumexp(lses, dim=0))
