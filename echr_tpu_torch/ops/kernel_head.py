"""Kernel 2: streaming greedy head (csrc/greedy_head.cu).

For each row r of the decoder's core output, the token, max and
logsumexp of the logits ``out[r] @ w.T + b`` over the V+1 vocab, without
the [R, V+1] logits ever reaching global memory.  It replaces the Pallas
TPU kernel echr_tpu/ops/pallas_head.py::_head_kernel (pallas_call at
:146, via greedy_head :192, head_plan :58 and pad_head_weights :178).

What bounds it on an H100: tensor-core throughput.  At R = B*N = 4096,
C = 3*512 = 1536, V1 = 6001 a step is 75.5 GFLOP, and w in bf16 (18.4 MB)
fits in the 50 MB L2.  The design: a block of 8 warps owns 128 rows and
walks its share of the 128-wide vocab tiles in order, computing each
logit tile with nvcuda::wmma bf16 16x16x16 (f32 accumulation) from
64-deep shared-memory stages that cp.async double-buffers, then folding
the tile into a running (max, argmax, sumexp) per row with accurate expf.
128-row tiles give only R/128 blocks (32 at serving dims, against 132
SMs), so the vocab is split across blocks as well, into as many splits as
bring the grid to about two blocks per SM (8 at serving dims: 256
blocks); a second small kernel combines the splits in vocab order.  The
ragged vocab edge is masked in the kernel (no -1e30 lane padding).

Ties: the lowest index wins, as in torch.argmax: within a tile the
(value, index) reduction keeps the lower index, a later tile (and a
later split in the combine) takes over only on a strictly greater value.

Dtypes follow the compute dtype: bf16 weights select the wmma path (the
operands rounded to bf16, as echr_tpu's bf16 decode head); f32 weights,
the f32 parity runs, select an f32 FMA path with the same fold.
"""
from __future__ import annotations

from typing import Tuple

import torch

from echr_tpu_torch.ops import native, use_plain
from echr_tpu_torch.ops.core import Dense

_FN = "greedy_head"
_ROW_TILE = 128  # rows per block, as in csrc/greedy_head.cu
_BLOCKS_PER_SM = 2


def prepare_head(logit: Dense, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The logit layer as the head takes it, built once per decode:
    w [V1, C] contiguous in the compute dtype, b [V1] f32."""
    w = logit.weight.to(dtype).contiguous()
    b = logit.bias.float().contiguous()
    return w, b


def greedy_head_plain(out: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The kernel's plain PyTorch version: (token int32, max f32,
    logsumexp f32) of the logits of out [R, C] rounded to w's dtype."""
    logits = torch.matmul(out.to(w.dtype).float(), w.float().t()) + b
    tok = logits.argmax(dim=1).to(torch.int32)  # first index on a tie
    return tok, logits.amax(dim=1), torch.logsumexp(logits, dim=1)


def greedy_head(out: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """(token [R] int32, max logit [R] f32, logsumexp [R] f32) of
    out [R, C] @ w[V1, C].T + b.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if use_plain(out):
        return greedy_head_plain(out, w, b)
    R, C = out.shape
    V1 = w.shape[0]
    dev = out.device
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{_FN}: w is {w.dtype}, expected bfloat16 or float32")
    a = out.to(w.dtype).contiguous()
    native.check_arg(_FN, "out", a, (R, C), w.dtype, dev)
    native.check_arg(_FN, "w", w, (V1, C), w.dtype, dev)
    native.check_arg(_FN, "b", b, (V1,), torch.float32, dev)
    if R == 0 or V1 == 0:
        raise ValueError(f"{_FN}: empty rows or vocab (R={R}, V1={V1})")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row_blocks = -(-R // _ROW_TILE)
    splits = max(1, -(-_BLOCKS_PER_SM * sms // row_blocks))
    part_m = torch.empty(splits, R, device=dev, dtype=torch.float32)
    part_l = torch.empty(splits, R, device=dev, dtype=torch.float32)
    part_a = torch.empty(splits, R, device=dev, dtype=torch.int32)
    tok = torch.empty(R, device=dev, dtype=torch.int32)
    mx = torch.empty(R, device=dev, dtype=torch.float32)
    lse = torch.empty(R, device=dev, dtype=torch.float32)
    rc = native.library().echr_greedy_head(
        a.data_ptr(), w.data_ptr(), b.data_ptr(), int(w.dtype == torch.bfloat16),
        R, C, V1, splits, part_m.data_ptr(), part_l.data_ptr(), part_a.data_ptr(),
        tok.data_ptr(), mx.data_ptr(), lse.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "echr_greedy_head")
    greedy_head.launches += 1
    return tok, mx, lse


greedy_head.launches = 0
