"""Parameter containers, the dense primitive and dropout
(echr_tpu/ops/core.py).

Weights are stored torch-style (a Linear is weight [out, in]) as f32
master tensors.  Serving rounds every matrix-shaped weight to the compute
dtype once (``cast_compute_dtype``); training rounds them inside the step
(``call_in_compute_dtype``), so gradients reach the f32 masters.
``dense`` rounds its activation operand the same way and multiplies in
f32.  That is JAX's ``preferred_element_type=f32``:
a product of two bf16 values is exact in f32, so a bf16 x bf16 -> f32
contraction equals the f32 matmul of the rounded operands up to the order
of the sum.  ``torch.matmul`` on bf16 tensors would round the result to
bf16, which is not the reference's semantics.  Biases stay f32.
"""
from __future__ import annotations

import contextlib
import copy
import math
import threading
from typing import Callable, Optional

import torch
from torch import nn

_DTYPES = {"float32": torch.float32, "fp32": torch.float32, None: torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def compute_dtype(name: Optional[str]) -> torch.dtype:
    """RuntimeConfig.compute_dtype name -> torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return _DTYPES[name]


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` precision, returned as f32."""
    if dtype == torch.float32:
        return x.float()
    return x.to(dtype).float()


class _TF32:
    """TF32 on while any bf16 product runs.  The flag is process-wide, so
    the blocks are counted under a lock: the first one in turns TF32 on,
    the last one out restores the flag as the first one found it.  A
    save-and-restore per block would let blocks that overlap on two
    threads leave TF32 on for good."""

    def __init__(self):
        self._lock = threading.Lock()
        self._users = 0
        self._before = False

    @contextlib.contextmanager
    def on(self):
        flags = torch.backends.cuda.matmul
        with self._lock:
            if self._users == 0:
                self._before = flags.allow_tf32
                flags.allow_tf32 = True
            self._users += 1
        try:
            yield
        finally:
            with self._lock:
                self._users -= 1
                if self._users == 0:
                    flags.allow_tf32 = self._before


_TF32_BLOCKS = _TF32()


def matmul(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ b in f32 for operands already rounded to ``dtype``.

    A bf16 value has 8 significant bits and TF32 keeps 11, so for bf16
    operands on CUDA the TF32 tensor cores multiply exactly and accumulate
    in f32: the numbers of bf16 x bf16 -> f32, at tensor-core speed.  f32
    operands always take full-f32 matmuls, except while another thread
    runs a bf16 product (the flag is process-wide)."""
    if dtype != torch.bfloat16 or not a.is_cuda:
        return torch.matmul(a, b)
    with _TF32_BLOCKS.on():
        return torch.matmul(a, b)


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=gen)


def parameter(*shape) -> nn.Parameter:
    """A zero, trainable parameter (serving runs under inference_mode)."""
    return nn.Parameter(torch.zeros(*shape))


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
            train: bool) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate and scale by
    1 / (1 - rate).  The identity when not training, at rate 0, or with
    ``gen=None`` (as JAX's dropout is with rng=None).  The mask is drawn
    from ``gen`` on x's device."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class Dense(nn.Module):
    """Linear map: weight [out, in], bias [out] (optional)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.weight = parameter(out_dim, in_dim)
        self.bias = parameter(out_dim) if bias else None

    def init_uniform(self, gen: torch.Generator, bound: Optional[float] = None):
        """torch's default Linear init U(-1/sqrt(fan_in), +) (dense_init)."""
        if bound is None:
            bound = 1.0 / math.sqrt(self.weight.shape[1])
        uniform_(self.weight, bound, gen)
        if self.bias is not None:
            uniform_(self.bias, bound, gen)
        return self


def dense(p: Dense, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y = x @ w.T (+ b) with x rounded to ``dtype`` and f32 accumulation.
    The weight is used as stored: cast_compute_dtype (serving) or
    call_in_compute_dtype (training) has rounded it."""
    y = matmul(round_to(x, dtype), p.weight.t(), dtype)
    if p.bias is not None:
        y = y + p.bias
    return y


def call_in_compute_dtype(module: nn.Module, dtype: torch.dtype, fn: Callable, *args, **kw):
    """fn(module, *args, **kw) with ``module``'s matrix-shaped (ndim >= 2)
    parameters rounded to ``dtype`` inside the autograd graph, and 1-D
    leaves exact f32 (echr_tpu/engine/steps.py ``_cast``, which casts inside
    the loss).  The backward of the rounding rounds the gradient to
    ``dtype`` on its way to the f32 master, as the transpose of JAX's
    astype does.  The parameters are swapped only while fn runs: a
    recompute in the backward (torch.utils.checkpoint) must take the
    rounded weights as inputs.  The identity for f32."""
    if dtype == torch.float32:
        return fn(module, *args, **kw)
    wrapper = _Apply(module)
    rounded = {name: round_to(p, dtype) if p.ndim >= 2 else p
               for name, p in wrapper.named_parameters()}
    return torch.func.functional_call(wrapper, rounded, (fn, args, kw))


class _Apply(nn.Module):
    """Holds ``inner`` under the name ``inner``, so that functional_call can
    swap its parameters while a free function of the module runs."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, fn: Callable, args, kw):
        return fn(self.inner, *args, **kw)


def cast_compute_dtype(module: nn.Module, dtype_name: Optional[str]) -> nn.Module:
    """A copy of ``module`` whose matrix-shaped (ndim >= 2) parameters are
    rounded to the compute dtype (kept as f32 storage); 1-D leaves stay
    exact f32.  The identity for f32."""
    dt = compute_dtype(dtype_name)
    if dt == torch.float32:
        return module
    out = copy.deepcopy(module)
    with torch.no_grad():
        for p in out.parameters():
            if p.ndim >= 2:
                p.copy_(round_to(p, dt))
    return out
