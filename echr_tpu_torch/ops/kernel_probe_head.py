"""Kernels 7 and 8: the head probes' streaming greedy head
(csrc/probe_stream_head.cu).

For each row r of out [R, C], the token, max and logsumexp of the logits
``out[r] @ wp + bp`` over a vocab padded to a multiple of the vocab tile:
zero weights and a -1e30 bias in the pad lanes, as the probes pad it
(experiments/probe_greedy_head.py:124-126).  Kernel 7 replaces
experiments/probe_greedy_head.py::_greedy_head_kernel (pallas_call at :79),
the fixed plan (TV=512 and the largest TR that fits the card); kernel 8
replaces experiments/probe_streaming_head2.py::_kernel (pallas_call at :78),
the tile sweep.  One block owns TR rows and walks every vocab tile in
order, with no vocab split: the probes' design, where kernel 2
(ops/kernel_head.py) splits the vocab across blocks and masks the edge.

The block is kernel 2's: a producer warp keeps TMA loads of the A row
block and of wp's vocab tiles in flight in a ring of stages, two consumer
warpgroups multiply on wgmma and fold each tile in registers.  How each
tiling maps onto that block, and the checks that it fits, live with the
kernel (Plan in the source); ``l2_bytes`` counts what a call reads from L2
by that plan.
"""
from __future__ import annotations

import torch

from echr_tpu_torch.ops import count_launch, native, use_plain

_FN = "stream_head"
# (TR, TV) pairs instantiated in csrc/probe_stream_head.cu
TILINGS = ((32, 128), (32, 256), (32, 512), (64, 128), (64, 256), (64, 512),
           (128, 128), (128, 256))
PLAN = (64, 512)  # kernel 7: the probe's TV and the largest TR that fits
_PAD_BIAS = -1e30


def l2_bytes(R: int, C: int, VP: int, tr: int, tv: int) -> dict:
    """The bytes a call reads through L2 by the plan, a model and not a
    measurement: A [R, C] bf16 once a vocab tile, wp [C, VP] bf16 and bp
    [VP] f32 once a row block."""
    blocks = -(-R // tr)
    a = R * C * 2 * (VP // tv)
    w = C * VP * 2 * blocks
    bias = VP * 4 * blocks
    return {"a": a, "w": w, "bias": bias, "total": a + w + bias}


def pad_probe_head(w: torch.Tensor, b: torch.Tensor, tv: int):
    """w [C, V1], b [V1] or [1, V1] -> (wp [C, VP] bf16, bp [VP] f32) with
    VP the next multiple of tv: zero weights and a -1e30 bias in the pad
    lanes, so no pad column wins or adds to the sum."""
    C, V1 = w.shape
    vp = -(-V1 // tv) * tv
    wp = torch.zeros(C, vp, dtype=torch.bfloat16, device=w.device)
    wp[:, :V1] = w
    bp = torch.full((vp,), _PAD_BIAS, dtype=torch.float32, device=w.device)
    bp[:V1] = b.reshape(V1)
    return wp, bp


def stream_head_plain(out: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor):
    """The kernels' plain PyTorch version: (token int32, max f32,
    logsumexp f32) of the f32 product of out rounded to bf16 with wp, plus
    bp.  The first index wins a tie (torch.argmax)."""
    logits = torch.matmul(out.to(torch.bfloat16).float(), wp.float()) + bp
    tok = logits.argmax(dim=1).to(torch.int32)
    return tok, logits.amax(dim=1), torch.logsumexp(logits, dim=1)


def stream_head(out: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, tr: int = PLAN[0],
                tv: int = PLAN[1]):
    """(token [R] int32, max [R] f32, logsumexp [R] f32) of
    out [R, C] @ wp [C, VP] + bp [VP] with the (tr, tv) tiling; out is
    rounded to bf16, wp is bf16, VP a multiple of tv, C a multiple of 8.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if use_plain(out):
        return stream_head_plain(out, wp, bp)
    res = stream_head_on(native.library(), out, wp, bp, tr, tv)
    count_launch(stream_head)
    return res


stream_head.launches = 0


def stream_head_on(lib, out: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor, tr: int,
                   tv: int):
    """Kernels 7 and 8 through ``lib`` (native.library(), or another build
    of the C entry point) at the (tr, tv) tiling: the arguments are checked
    and out is rounded to bf16; the launch is not counted."""
    if (tr, tv) not in TILINGS:
        raise ValueError(f"{_FN}: tiling {(tr, tv)} is not one of {TILINGS}")
    R, C = out.shape
    VP = wp.shape[1]
    dev = out.device
    a = out.to(torch.bfloat16).contiguous()
    native.check_arg(_FN, "out", a, (R, C), torch.bfloat16, dev)
    native.check_arg(_FN, "wp", wp, (C, VP), torch.bfloat16, dev)
    native.check_arg(_FN, "bp", bp, (VP,), torch.float32, dev)
    if R == 0 or VP == 0 or VP % tv or C % 8:
        raise ValueError(f"{_FN}: needs R > 0, VP a positive multiple of tv={tv} and C a "
                         f"multiple of 8 (R={R}, VP={VP}, C={C})")
    if a.data_ptr() % 16 or wp.data_ptr() % 16:
        raise ValueError(f"{_FN}: out and wp must start on a 16-byte boundary (TMA)")
    tok = torch.empty(R, device=dev, dtype=torch.int32)
    mx = torch.empty(R, device=dev, dtype=torch.float32)
    lse = torch.empty(R, device=dev, dtype=torch.float32)
    rc = lib.echr_probe_stream_head(
        a.data_ptr(), wp.data_ptr(), bp.data_ptr(), R, C, VP, tr, tv, tok.data_ptr(),
        mx.data_ptr(), lse.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "echr_probe_stream_head")
    return tok, mx, lse
