"""Operations and bytes of the port's serving kernels, from shapes.

Kernel 1 (masked additive-attention scores, one launch a decode step):
inputs pre [B, T, Hatt] f32, q [B, R, Hatt] f32, w [Hatt], b [1], mask
[B, R, T] f32; output scores [B, R, T] f32; per live (row, frame) pair
Hatt each of add, tanh, multiply, add, so 4 * live * Hatt f32 operations,
counting only the pairs inside the rows' windows.

Kernel 2 (streaming greedy head): a [R, Cw] and w [V1, Cw] in the
compute dtype, b [V1] f32; token, max and logsumexp [R] out; 2 R C V1
operations at the compute dtype's rate."""
from __future__ import annotations

from benchmark.arith.bound import bound

F32 = 4


def k1(B: int, R: int, T: int, Hatt: int, live: int) -> dict:
    n_bytes = F32 * (B * T * Hatt + B * R * Hatt + Hatt + 1 + 2 * B * R * T)
    return bound(n_bytes, f32=4.0 * live * Hatt)


def k2(R: int, C: int, V1: int, dtype_bytes: int = 2) -> dict:
    Cw = -(-C // 8) * 8
    n_bytes = dtype_bytes * (R * Cw + V1 * Cw) + F32 * V1 + 3 * F32 * R
    kind = "bf16" if dtype_bytes == 2 else "f32"
    return bound(n_bytes, **{kind: 2.0 * R * C * V1})
