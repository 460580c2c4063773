"""Kernels 5 and 6's plain versions against the JAX package's Pallas
kernels (interpret mode on the CPU), and the fused route of
additive_attention_step.

Tolerances: kernel 5 at atol 2e-3, the JAX package's own gate for its
fused kernel (bf16 weights taken from the running max against the port's
from the row max); kernel 6 at 5e-4, the port's score gate, everything f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echr_tpu.ops import pallas_attention as PA
from echr_tpu.ops import pallas_windowed_attention as PW

from echr_tpu_torch.ops import attention as A
from echr_tpu_torch.ops.kernel_attention_step import (
    attention_fused,
    attention_fused_plain,
    windowed_attention,
    windowed_attention_plain,
)


def _inputs(B, N, T, H, D, seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, T, H).astype(np.float32), r.randn(B, N, H).astype(np.float32),
            (r.randn(H) * 0.1).astype(np.float32), np.array([0.3], np.float32),
            r.randn(B, T, D).astype(np.float32))


def test_attention_fused_plain_matches_pallas():
    B, N, T, H, D = 2, 16, 256, 128, 96
    pre, q, w, b, feats = _inputs(B, N, T, H, D, seed=0)
    r = np.random.RandomState(1)
    mask = (r.rand(B, N, T) > 0.3).astype(np.float32)
    mask[:, :, 0] = 1.0
    mask[0, 3] = 0.0  # a fully-masked row
    mask[1, :, 128:] = 0.0  # a whole T tile empty for every row
    got = attention_fused(*(torch.from_numpy(x) for x in (pre, q, w, b, mask, feats)))
    assert bool((got[0, 3] == 0).all())
    for v in range(B):
        want = PA.attention_fused(jnp.asarray(pre[v]), jnp.asarray(q[v]),
                                  {"w": jnp.asarray(w[:, None]), "b": jnp.asarray(b)},
                                  jnp.asarray(mask[v]), jnp.asarray(feats[v]))
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want), atol=2e-3, rtol=0)


def test_windowed_attention_plain_matches_pallas():
    """Random windows and end-clamped ones (the TPU kernel's DMA clamp and
    shift): starts T-4, T-16, T-1 touch the last frame."""
    B, N, T, H, D, W = 2, 8, 64, 128, 96, 16
    pre, q, w, b, feats = _inputs(B, N, T, H, D, seed=2)
    r = np.random.RandomState(3)
    starts = np.stack([np.array([T - 4, T - 16, T - 1, 0, 5, 50, 60, 30]),
                       r.randint(0, T - 2, size=N)])
    lens = np.stack([np.array([4, 16, 1, 7, 10, 14, 4, 16]),
                     np.minimum(r.randint(1, W + 1, size=N), T - starts[1])])
    soi = np.stack([starts, starts + lens], -1).astype(np.int32)
    got = windowed_attention(*(torch.from_numpy(x) for x in (pre, feats, q, w, b, soi)), W=W)
    for v in range(B):
        want = PW.windowed_attention(jnp.asarray(pre[v]), jnp.asarray(feats[v]),
                                     jnp.asarray(q[v]),
                                     {"w": jnp.asarray(w[:, None]), "b": jnp.asarray(b)},
                                     jnp.asarray(soi[v]), W=W)
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want), atol=5e-4, rtol=0)


def test_windowed_attention_plain_zero_length_window():
    pre, q, w, b, feats = (torch.from_numpy(x) for x in _inputs(1, 3, 32, 16, 8, seed=4))
    soi = torch.tensor([[[5, 5], [0, 32], [31, 32]]], dtype=torch.int32)
    got = windowed_attention_plain(pre, feats, q, w, b, soi, W=32)
    assert bool((got[0, 0] == 0).all()) and bool((got[0, 1:] != 0).any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_additive_attention_step_fused_route(dtype):
    """On the CPU, fused=True takes kernel 5's plain version in bf16 (no
    weights returned) and the unfused route in f32."""
    B, N, T, Hq, Hatt, D = 2, 6, 40, 12, 16, 10
    gen = torch.Generator().manual_seed(0)
    p = A.AdditiveAttention(D, Hq, Hatt).init_uniform(gen)
    r = np.random.RandomState(5)
    h = torch.from_numpy(r.randn(B, N, Hq).astype(np.float32))
    feats = torch.from_numpy(r.randn(B, T, D).astype(np.float32))
    mask = torch.from_numpy((r.rand(B, N, T) > 0.5).astype(np.float32))
    mask[1, 2] = 0.0
    with torch.no_grad():
        pre = A.additive_attention_precompute(p, feats, dtype)
        got, weights = A.additive_attention_step(p, h, feats, pre, mask, dtype,
                                                 use_kernel=True, fused=True)
        unfused, want_w = A.additive_attention_step(p, h, feats, pre, mask, dtype,
                                                    use_kernel=True)
        if dtype == torch.bfloat16:
            assert weights is None
            att_h = A.dense(p.h2att, h, dtype)
            want = attention_fused_plain(pre, att_h, p.alpha_net.weight.reshape(-1),
                                         p.alpha_net.bias, mask, feats)
            torch.testing.assert_close(got, want, atol=0, rtol=0)
            torch.testing.assert_close(got, unfused, atol=2e-3, rtol=0)
        else:
            torch.testing.assert_close(weights, want_w, atol=0, rtol=0)
            torch.testing.assert_close(got, unfused, atol=0, rtol=0)
        assert bool((got[1, 2] == 0).all())
