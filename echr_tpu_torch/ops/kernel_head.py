"""Kernel 2: streaming greedy head (csrc/greedy_head.cu).

For each row r of the decoder's core output, the token, max and
logsumexp of the logits ``out[r] @ w.T + b`` over the V+1 vocab, without
the [R, V+1] logits ever reaching global memory.  It replaces the Pallas
TPU kernel echr_tpu/ops/pallas_head.py::_head_kernel (pallas_call at
:146, via greedy_head :192, head_plan :58 and pad_head_weights :178).

What bounds it on an H100: tensor-core throughput.  At R = B*N = 4096,
C = 3*512 = 1536, V1 = 6001 a step is 75.5 GFLOP, and w in bf16 (18.4 MB)
fits in the 50 MB L2.  The bf16 design: a block owns 128 rows and walks
its share of the 256-wide vocab tiles in order; one producer thread keeps
TMA loads of the operand tiles in flight in a 4-stage shared-memory ring
and two consumer warpgroups compute each logit tile with wgmma (f32
accumulators in registers), then fold it in registers into a running
(max, argmax, sumexp) per row while the next tile's loads land.  Its
128-row tiles give only R/128 blocks (32 at serving dims, against 132
SMs), and a block takes 193 KB of shared memory, one an SM, so the vocab
is split across blocks as well (``split_plan``: 4 splits of 6 tiles at
serving dims, 128 blocks); a second small kernel combines the splits in
vocab order.  The ragged vocab edge is masked in the fold (no -1e30
padding).

TMA reads rows at 16-byte strides, so w's rows are padded with zeros to a
multiple of 8 columns once (``prepare_head`` / ``pad_head_width``) and a
core output of another width is padded per call; at serving C = 1536 no
pad is made.

Ties: the lowest index wins, as in torch.argmax: within a tile the
(value, index) reduction keeps the lower index, a later tile (and a
later split in the combine) takes over only on a strictly greater value.

Dtypes follow the compute dtype: bf16 weights select the wgmma path (the
operands rounded to bf16, as echr_tpu's bf16 decode head); f32 weights,
the f32 parity runs, select an f32 FMA path (128-wide tiles folded in
shared memory) with the same fold.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from echr_tpu_torch.ops import native, use_plain
from echr_tpu_torch.ops.core import Dense

_FN = "greedy_head"
_ROW_TILE = 128  # rows per block, as in csrc/greedy_head.cu
_VOCAB_TILE = {torch.bfloat16: 256, torch.float32: 128}  # columns per tile (BV, FV)
_WIDTH = 8  # w's row length is a multiple of this: 16 bytes of bf16


def pad_head_width(w: torch.Tensor) -> torch.Tensor:
    """w [V1, C] with zero columns appended up to a multiple of 8."""
    return F.pad(w, (0, -w.shape[1] % _WIDTH))


def prepare_head(logit: Dense, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The logit layer as the head takes it, built once per decode:
    w [V1, C padded to a multiple of 8] contiguous in the compute dtype,
    b [V1] f32."""
    w = pad_head_width(logit.weight.to(dtype)).contiguous()
    b = logit.bias.float().contiguous()
    return w, b


def split_plan(R: int, V1: int, sms: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(tiles_per_split, splits): the kernel's vocab tiles cut into runs of
    tiles_per_split, split s taking tiles [s * per, min(n, (s + 1) * per)),
    every split at least one.  bf16 runs one block an SM, so it takes as
    many splits as fill the SMs with whole waves of row tiles; f32 about
    two blocks an SM."""
    n_tiles = -(-V1 // _VOCAB_TILE[dtype])
    row_blocks = -(-R // _ROW_TILE)
    want = sms // row_blocks if dtype == torch.bfloat16 else -(-2 * sms // row_blocks)
    per = -(-n_tiles // max(1, min(want, n_tiles)))
    return per, -(-n_tiles // per)


def greedy_head_plain(out: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The kernel's plain PyTorch version: (token int32, max f32,
    logsumexp f32) of the logits of out [R, C] rounded to w's dtype; w may
    carry zero columns past C (pad_head_width)."""
    C = out.shape[1]
    logits = torch.matmul(out.to(w.dtype).float(), w[:, :C].float().t()) + b
    tok = logits.argmax(dim=1).to(torch.int32)  # first index on a tie
    return tok, logits.amax(dim=1), torch.logsumexp(logits, dim=1)


def greedy_head(out: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """(token [R] int32, max logit [R] f32, logsumexp [R] f32) of
    out [R, C] @ w[V1, C].T + b.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if use_plain(out):
        return greedy_head_plain(out, w, b)
    res = head_on(native.library(), out, w, b)
    greedy_head.launches += 1
    return res


greedy_head.launches = 0


def head_on(lib, out: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Kernel 2 through ``lib`` (native.library(), or another build of its
    C entry point): the arguments are checked, out is cast to w's dtype
    and padded to w's width; the launch is not counted."""
    R, C = out.shape
    V1, Cw = w.shape
    dev = out.device
    if w.dtype not in _VOCAB_TILE:
        raise ValueError(f"{_FN}: w is {w.dtype}, expected bfloat16 or float32")
    if w.dtype == torch.bfloat16 and Cw % _WIDTH:
        raise ValueError(f"{_FN}: w's rows hold {Cw} values; the bf16 kernel takes a multiple "
                         f"of {_WIDTH} (pad_head_width)")
    if C > Cw:
        raise ValueError(f"{_FN}: out has {C} columns, w only {Cw}")
    if R == 0 or V1 == 0:
        raise ValueError(f"{_FN}: empty rows or vocab (R={R}, V1={V1})")
    a = out.to(w.dtype)
    if C < Cw:
        a = F.pad(a, (0, Cw - C))
    a = a.contiguous()
    if a.data_ptr() % 16:
        a = a.clone()
    native.check_arg(_FN, "out", a, (R, Cw), w.dtype, dev)
    native.check_arg(_FN, "w", w, (V1, Cw), w.dtype, dev)
    native.check_arg(_FN, "b", b, (V1,), torch.float32, dev)
    per, splits = split_plan(R, V1, torch.cuda.get_device_properties(dev).multi_processor_count,
                             w.dtype)
    part_m = torch.empty(splits, R, device=dev, dtype=torch.float32)
    part_l = torch.empty(splits, R, device=dev, dtype=torch.float32)
    part_a = torch.empty(splits, R, device=dev, dtype=torch.int32)
    tok = torch.empty(R, device=dev, dtype=torch.int32)
    mx = torch.empty(R, device=dev, dtype=torch.float32)
    lse = torch.empty(R, device=dev, dtype=torch.float32)
    rc = lib.echr_greedy_head(
        a.data_ptr(), w.data_ptr(), b.data_ptr(), int(w.dtype == torch.bfloat16),
        R, Cw, V1, per, splits, part_m.data_ptr(), part_l.data_ptr(), part_a.data_ptr(),
        tok.data_ptr(), mx.data_ptr(), lse.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "echr_greedy_head")
    return tok, mx, lse
