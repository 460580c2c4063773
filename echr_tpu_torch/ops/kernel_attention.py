"""The additive-attention score kernels and their plain PyTorch versions.

    s[b, n, t] = w . tanh(pre[b, t, :] + q[b, n, :]) + b_alpha

for the proposals n and frames t of each video b where the window mask
is 1, in one launch per decode or teacher-forced step (the plain versions
compute them everywhere).

Kernel 1, ``attention_scores_masked`` (csrc/attention_scores.cu), serves
the no-grad decode.  It replaces the Pallas TPU kernel
echr_tpu/ops/pallas_attention.py::_kernel_skip (pallas_call at :153, via
attention_scores_masked :179 and tile_any_mask :170), which launched per
video under vmap on (8, 128) tiles.

What bounds it on an H100: the throughput of its tanh, not bytes.  At
serving dims (B=32, N=128, T=256, H=512) a step needs B*N*T*H = 537M tanh
before the mask, against ~4 MB of scores out.  The design evaluates the
tanh only at the (n, t) where mask != 0: lanes run over hidden units, so
a (row, frame) pair is uniform across a warp; a warp ballots the mask of
a row pair over 32 frames and walks only the live frames, with both
rows' q in registers and the frames' pre rows in shared memory.  Its work
follows the live pairs whatever the order of the rows.  Its tanh is
csrc/tanh.cuh's, 7 instructions against tanhf's 15, within 2.4e-7 of
float64.  Any N, T and H are taken: the block masks its own ragged edges.

Exactness: equal to the plain version wherever mask == 1 (the sum over H
runs in another order); masked entries are zero, and the caller's masked
softmax never reads them.

Kernels 3 and 4 are the training scores, one ``torch.autograd.Function``
(``attention_scores_diff``).  Kernel 3, ``attention_scores_dense``, is the
forward and replaces echr_tpu/ops/pallas_attention.py::_kernel
(pallas_call at :52), which computes every (n, t).  The training route
reads its scores only through the masked softmax, which ignores them
where the window mask is 0 and passes a zero cotangent there, so kernel
3 takes the mask and runs kernel 1's body under its own C entry point
(csrc/attention_scores.cu): the tanh only at live (n, t), masked entries
0.  Its plain version stays the reference's function, scores everywhere;
the two agree wherever mask == 1.  Kernel 4, ``attention_scores_bwd``
(csrc/attention_scores_bwd.cu), is the backward and replaces
::_bwd_kernel (pallas_call at :344): it recomputes the tanh per tile, so
the [B, N, T, H] intermediate is never stored, and it sums across blocks
in a fixed order, so two runs give identical bits.  It skips every
(n, t) whose cotangent is 0, which on the training path is every (n, t)
outside the window mask; a skipped term is exactly +-0, so the sums are
those of the dense loop up to the sign of zeros.  Both take kernel 1's
tanh (csrc/tanh.cuh).  At training dims (B=32, N=64, T=256, H=512) a
teacher-forced step holds 268M (n, t, h) before the mask.  The route
(kernel or plain) is decided in the forward and kept for the backward,
which autograd may run on another thread.
"""
from __future__ import annotations

import torch

from typing import Tuple

from echr_tpu_torch.ops import count_launch, native, use_plain

_FN = "attention_scores_masked"


def attention_scores_plain(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: scores everywhere, f32.
    pre [B, T, H], q [B, N, H], w [H], b [1], mask [B, N, T] -> [B, N, T]."""
    y = torch.tanh(pre.float()[:, None, :, :] + q.float()[:, :, None, :])
    return torch.matmul(y, w.float()) + b.float()


def attention_scores_masked(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scores [B, N, T]; exact wherever mask == 1.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if use_plain(pre):
        return attention_scores_plain(pre, q, w, b, mask)
    out = masked_scores_on(native.library(), pre, q, w, b, mask)
    if out.numel():
        count_launch(attention_scores_masked)
    return out


attention_scores_masked.launches = 0


def masked_scores_on(lib, pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Kernel 1 through ``lib``: native.library(), or another build of its
    C entry point (experiments/probe_tanh.py, kernel_turns.py).  The
    arguments are checked; the launch is not counted."""
    return _scores_on(lib, _FN, "echr_attention_scores", pre, q, w, b, mask)


def _scores_on(lib, fn: str, entry: str, pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The masked body through ``lib``'s C entry point ``entry`` (kernel
    1's or kernel 3's); ``fn`` names the wrapper in errors.  A missing
    mask raises."""
    if mask is None:
        raise ValueError(f"{fn}: the kernel takes the window mask")
    B, T, H = pre.shape
    N = q.shape[1]
    f32, dev = torch.float32, pre.device
    native.check_arg(fn, "pre", pre, (B, T, H), f32, dev)
    native.check_arg(fn, "q", q, (B, N, H), f32, dev)
    native.check_arg(fn, "w", w, (H,), f32, dev)
    native.check_arg(fn, "b", b, (1,), f32, dev)
    native.check_arg(fn, "mask", mask, (B, N, T), f32, dev)
    out = torch.empty(B, N, T, device=dev, dtype=f32)
    if out.numel() == 0:
        return out
    rc = getattr(lib, entry)(
        pre.data_ptr(), q.data_ptr(), w.data_ptr(), b.data_ptr(), mask.data_ptr(),
        out.data_ptr(), B, N, T, H, torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, entry)
    return out


def attention_scores_dense_plain(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """Kernel 3's plain PyTorch version, the reference's function: scores
    at every (n, t), in the inputs' dtype.  pre [B, T, H], q [B, N, H],
    w [H], b [1] -> [B, N, T]."""
    y = torch.tanh(pre[:, None, :, :] + q[:, :, None, :])
    return torch.matmul(y, w) + b


def attention_scores_dense(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Kernel 3: scores [B, N, T], exact wherever mask == 1.  CPU tensors
    take the plain version (scores everywhere); CUDA tensors launch the
    kernel, which writes 0 where mask == 0."""
    if use_plain(pre):
        return attention_scores_dense_plain(pre, q, w, b)
    out = dense_scores_on(native.library(), pre, q, w, b, mask)
    if out.numel():
        count_launch(attention_scores_dense)
    return out


attention_scores_dense.launches = 0


def dense_scores_on(lib, pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Kernel 3 through ``lib``, as masked_scores_on: checked, not
    counted.  A missing mask raises."""
    return _scores_on(lib, "attention_scores_dense", "echr_attention_scores_dense", pre, q, w,
                      b, mask)


_BWD_TILE_T = 64  # frames per block of kernel 4 (csrc/attention_scores_bwd.cu BT)


def attention_scores_bwd_plain(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                               g: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 4's plain PyTorch version, the same recompute-tanh formulas
    (echr_tpu/ops/pallas_attention.py:310-333): with y = tanh(pre + q) and
    dz = g * w * (1 - y^2), d_pre = sum_n dz, d_q = sum_t dz and
    d_w = sum g * y, in the inputs' dtype.  It holds the [B, N, T, H]
    tensors in memory."""
    y = torch.tanh(pre[:, None, :, :] + q[:, :, None, :])
    g4 = g[..., None]
    dz = g4 * w * (1.0 - y * y)
    return dz.sum(dim=1), dz.sum(dim=2), (g4 * y).sum(dim=(0, 1, 2))


def attention_scores_bwd(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                         g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 4: (d_pre [B, T, H], d_q [B, N, H], d_w [H]) for the cotangent
    g [B, N, T] of kernel 3's scores.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if use_plain(pre):
        return attention_scores_bwd_plain(pre, q, w, g)
    grads = scores_bwd_on(native.library(), pre, q, w, g)
    if min(g.shape) and pre.shape[2]:
        count_launch(attention_scores_bwd)
    return grads


attention_scores_bwd.launches = 0


def scores_bwd_on(lib, pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                  g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 4 through ``lib``, as masked_scores_on: checked, not counted."""
    fn = "attention_scores_bwd"
    B, T, H = pre.shape
    N = q.shape[1]
    f32, dev = torch.float32, pre.device
    native.check_arg(fn, "pre", pre, (B, T, H), f32, dev)
    native.check_arg(fn, "q", q, (B, N, H), f32, dev)
    native.check_arg(fn, "w", w, (H,), f32, dev)
    native.check_arg(fn, "g", g, (B, N, T), f32, dev)
    d_pre = torch.empty(B, T, H, device=dev, dtype=f32)
    d_q = torch.empty(B, N, H, device=dev, dtype=f32)
    d_w = torch.empty(H, device=dev, dtype=f32)
    if min(B, N, T, H) == 0:  # nothing to sum: zero gradients
        return d_pre.zero_(), d_q.zero_(), d_w.zero_()
    tiles = -(-T // _BWD_TILE_T)
    dq_part = torch.empty(B, tiles, N, H, device=dev, dtype=f32)
    dw_part = torch.empty(B * tiles, H, device=dev, dtype=f32)
    rc = lib.echr_attention_scores_bwd(
        pre.data_ptr(), q.data_ptr(), w.data_ptr(), g.data_ptr(), d_pre.data_ptr(),
        d_q.data_ptr(), d_w.data_ptr(), dq_part.data_ptr(), dw_part.data_ptr(),
        B, N, T, H, torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "echr_attention_scores_bwd")
    return d_pre, d_q, d_w


class _ScoresDiff(torch.autograd.Function):
    """Kernel 3 forward, kernel 4 backward; saves pre, q and w, never the
    tanh nor the mask.  ``plain`` is use_plain() as the forward saw it.
    The backward is that of the scores everywhere: exact for a caller
    whose cotangent is 0 where mask == 0, as the masked softmax's is."""

    @staticmethod
    def forward(ctx, pre, q, w, b, mask):
        ctx.plain = use_plain(pre)
        ctx.save_for_backward(pre, q, w)
        if ctx.plain:
            return attention_scores_dense_plain(pre, q, w, b)
        return attention_scores_dense(pre, q, w, b, mask)

    @staticmethod
    def backward(ctx, g):
        pre, q, w = ctx.saved_tensors
        g = g.contiguous()
        if ctx.plain:
            d_pre, d_q, d_w = attention_scores_bwd_plain(pre, q, w, g)
        else:
            d_pre, d_q, d_w = attention_scores_bwd(pre, q, w, g)
        return d_pre, d_q, d_w, g.sum().reshape(1), None


def attention_scores_diff(pre: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Differentiable scores [B, N, T] for training (pre [B, T, H],
    q [B, N, H], w [H], b [1], the window mask [B, N, T]; f32 on the
    kernel route), exact wherever mask == 1: the caller reads them through
    a masked softmax.  Forward kernel 3, backward kernel 4; the gradient
    of b is sum(g), outside the kernel as in the reference."""
    return _ScoresDiff.apply(pre, q, w, b, mask)
