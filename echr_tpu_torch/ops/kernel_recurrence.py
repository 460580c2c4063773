"""Kernel 11: an LSTM layer's recurrence over T in one launch
(csrc/lstm_recurrence.cu).

From the input projection pre_x [T, B, 4H] (x @ W_ih.T plus both biases,
as ``recurrent.lstm_input_proj(..., with_bias=True)`` returns it), the
hidden states hs [T, B, H] and the final (h, c) of

    pre = pre_x[t] + bf16(h) @ W_hh.T;   i, f, g, o = gates(pre)
    c = f * c + i * g;   h = o * tanh(c)

with h and c in f32.  It replaces no Pallas kernel: echr_tpu runs the
loop as a lax.scan, and the port as the Python loop of
``lstm_recurrence_plain``, whose ~11 launches a step left the host issuing
~5,600 launches for the SST of every serving chunk while the card idled.

What bounds it on an H100: the T dependent steps.  The kernel is
persistent: one cooperative launch of H / 4 blocks, each holding its 4
units' 16 gate columns of W_hh in shared memory for all T steps; a step
reads h (bf16) from an exchange buffer in L2, multiplies on the tensor
cores, applies the gates in registers, writes h and meets the other
blocks at a grid barrier.  It takes H a multiple of 32 with its H / 4
blocks on at most one SM each (H <= 528 on an H100), and any T, B >= 1
whose pre_x slice and c fit a block's shared memory (B up to ~1,400 at
H = 512).

The kernel takes bf16 products only, at w_hh already rounded to bf16 (the
serving and eval weights are, by ``cast_compute_dtype``, and training's
no-grad encodes by ``call_in_compute_dtype``): ``recurrent.lstm_layer``
routes to it only for eval-mode layers of CUDA tensors in bf16 with grad
off.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from echr_tpu_torch.ops import count_launch, native, use_plain
from echr_tpu_torch.ops.core import matmul, round_to

_FN = "lstm_recurrence"
_UNITS = 4  # hidden units a block (csrc: U)
_K_BLOCK = 32  # k values a block step of the product covers (csrc: KB)
_WARPS = 8
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90


def lstm_update(pre: torch.Tensor, c: torch.Tensor, H: int):
    """Gates i, f, g, o of pre [..., 4H] -> (h', c'); one sigmoid over all
    four gates (g's is unused) keeps the launches per step few."""
    sig = torch.sigmoid(pre)
    i, f, o = sig[..., :H], sig[..., H:2 * H], sig[..., 3 * H:]
    g = torch.tanh(pre[..., 2 * H:3 * H])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def lstm_recurrence_plain(pre_x: torch.Tensor, w_hh: torch.Tensor,
                          h0: Optional[torch.Tensor] = None, c0: Optional[torch.Tensor] = None,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The recurrence as a loop over T, h rounded to ``dtype`` for the
    product: (hs [T, B, H], (hT, cT)).  The kernel's plain version at bf16,
    and the path of training and the f32 runs."""
    T, B, H4 = pre_x.shape
    H = H4 // 4
    h = torch.zeros(B, H, device=pre_x.device) if h0 is None else h0
    c = torch.zeros(B, H, device=pre_x.device) if c0 is None else c0
    w_hh_t = w_hh.t()
    hs = []
    for t in range(T):
        pre = pre_x[t] + matmul(round_to(h, dtype), w_hh_t, dtype)
        h, c = lstm_update(pre, c, H)
        hs.append(h)
    return torch.stack(hs), (h, c)


def lstm_recurrence(pre_x: torch.Tensor, w_hh: torch.Tensor, h0: Optional[torch.Tensor] = None,
                    c0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(hs [T, B, H] f32, (hT, cT)) of pre_x [T, B, 4H] f32 and w_hh
    [4H, H] (bf16-exact), from h0, c0 [B, H] f32 or zeros, with bf16
    products.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if use_plain(pre_x):
        return lstm_recurrence_plain(pre_x, w_hh, h0, c0, torch.bfloat16)
    res = recurrence_on(native.library(), pre_x, w_hh, h0, c0)
    count_launch(lstm_recurrence)
    return res


lstm_recurrence.launches = 0


def smem_bytes(B: int, H: int) -> int:
    """A block's shared memory (csrc: smem_bytes): its W_hh columns (rows
    padded), pre_x's slice for two steps, c, and the warps' partial sums."""
    stride = (-(-2 * H // 128) * 128 + 64) // 2
    U = _UNITS
    return 4 * U * stride * 2 + 2 * B * 4 * U * 4 + B * U * 4 + _WARPS * 32 * 2 * U * 4


def recurrence_on(lib, pre_x: torch.Tensor, w_hh: torch.Tensor,
                  h0: Optional[torch.Tensor] = None, c0: Optional[torch.Tensor] = None):
    """Kernel 11 through ``lib`` (native.library(), or another build of its
    C entry point): the arguments are checked, w_hh is cast to bf16; the
    launch is not counted."""
    if pre_x.dim() != 3 or pre_x.shape[2] % 4:
        raise ValueError(f"{_FN}: pre_x has shape {tuple(pre_x.shape)}, expected [T, B, 4H]")
    T, B, H4 = pre_x.shape
    H = H4 // 4
    dev = pre_x.device
    if T == 0 or B == 0:
        raise ValueError(f"{_FN}: empty sequence or batch (T={T}, B={B})")
    if H % _K_BLOCK:
        raise ValueError(f"{_FN}: H={H} is not a multiple of {_K_BLOCK}")
    native.check_arg(_FN, "pre_x", pre_x, (T, B, H4), torch.float32, dev)
    if pre_x.data_ptr() % 16:
        raise ValueError(f"{_FN}: pre_x is not 16-byte aligned")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if H // _UNITS > sms:
        raise ValueError(f"{_FN}: H={H} needs {H // _UNITS} blocks, over the card's {sms} SMs")
    if smem_bytes(B, H) > _SMEM_LIMIT:
        raise ValueError(f"{_FN}: B={B}, H={H} need {smem_bytes(B, H)} bytes of shared memory "
                         f"a block, over {_SMEM_LIMIT}")
    w = w_hh.to(torch.bfloat16).contiguous()
    native.check_arg(_FN, "w_hh", w, (H4, H), torch.bfloat16, dev)
    carry = []
    for name, x in (("h0", h0), ("c0", c0)):
        if x is not None:
            x = x.contiguous()
            native.check_arg(_FN, name, x, (B, H), torch.float32, dev)
        carry.append(x)
    hs = torch.empty(T, B, H, device=dev, dtype=torch.float32)
    c_out = torch.empty(B, H, device=dev, dtype=torch.float32)
    xbuf = torch.empty(2, B, H, device=dev, dtype=torch.bfloat16)
    count = torch.empty(1, device=dev, dtype=torch.int32)
    rc = lib.echr_lstm_recurrence(
        pre_x.data_ptr(), w.data_ptr(), *(None if x is None else x.data_ptr() for x in carry),
        hs.data_ptr(), c_out.data_ptr(), xbuf.data_ptr(), count.data_ptr(), T, B, H,
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "echr_lstm_recurrence")
    return hs, (hs[-1], c_out)
