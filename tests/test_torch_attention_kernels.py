"""Kernels 5 and 6's plain versions against the JAX package's Pallas
kernels (interpret mode on the CPU), and the fused route of
additive_attention_step.

Tolerances: kernel 5 at atol 2e-3, the JAX package's own gate for its
fused kernel (bf16 weights taken from the running max against the port's
from the row max); kernel 6 at 5e-4, the port's score gate, everything f32.
"""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from echr_tpu.ops import pallas_attention as PA
from echr_tpu.ops import pallas_windowed_attention as PW

from echr_tpu_torch.ops import attention as A
from echr_tpu_torch.ops.kernel_attention_step import (
    attention_fused,
    attention_fused_plain,
    fused_splits,
    windowed_attention,
    windowed_attention_plain,
    windowed_rows,
    windowed_smem_bytes,
)


def _inputs(B, N, T, H, D, seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, T, H).astype(np.float32), r.randn(B, N, H).astype(np.float32),
            (r.randn(H) * 0.1).astype(np.float32), np.array([0.3], np.float32),
            r.randn(B, T, D).astype(np.float32))


def _beam_windows(r, P, k, T, lo, hi):
    """[P * k, 2] windows: P sorted proposals of lo..hi-1 frames, each
    repeated for its k adjacent beam copies (as _expand_ctxs lays them
    out)."""
    s = np.sort(r.randint(0, T - 8, size=P))
    e = np.minimum(s + r.randint(lo, hi, size=P), T)
    return np.repeat(np.stack([s, e], -1), k, axis=0).astype(np.int32)


def _mask_of(soi, T):
    t = np.arange(T)
    return ((t >= soi[..., :1]) & (t < soi[..., 1:])).astype(np.float32)


@pytest.mark.parametrize("case", ["random_mask", "per_video", "ragged_d"])
def test_attention_fused_plain_matches_pallas(case):
    """Kernel 5's plain version against pallas_attention.attention_fused
    (interpret mode): a random mask with a fully-masked row and a T tile
    empty for every row; one video of adjacent row pairs with equal short
    windows (beam copies, the per-video decode's shape) and a row without
    a window; and a D that is not a multiple of 8."""
    r = np.random.RandomState(1)
    if case == "random_mask":
        B, N, T, H, D = 2, 16, 256, 128, 96
        mask = (r.rand(B, N, T) > 0.3).astype(np.float32)
        mask[:, :, 0] = 1.0
        mask[0, 3] = 0.0  # a fully-masked row
        mask[1, :, 128:] = 0.0  # a whole T tile empty for every row
    elif case == "per_video":
        B, N, T, H, D = 1, 16, 256, 128, 100
        mask = _mask_of(_beam_windows(r, N // 2, 2, T, 4, 48), T)[None]
        mask[0, 6:8] = 0.0  # a proposal without a window: both copies
    else:
        B, N, T, H, D = 2, 8, 128, 128, 21
        mask = _mask_of(np.stack([_beam_windows(r, N, 1, T, 4, 100) for _ in range(B)]), T)
    pre, q, w, b, feats = _inputs(B, N, T, H, D, seed=0)
    got = attention_fused(*(torch.from_numpy(x) for x in (pre, q, w, b, mask, feats)))
    empty = ~mask.any(-1)
    assert empty.any() == (case != "ragged_d")
    assert bool((got[torch.from_numpy(empty)] == 0).all())
    for v in range(B):
        want = PA.attention_fused(jnp.asarray(pre[v]), jnp.asarray(q[v]),
                                  {"w": jnp.asarray(w[:, None]), "b": jnp.asarray(b)},
                                  jnp.asarray(mask[v]), jnp.asarray(feats[v]))
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want), atol=2e-3, rtol=0)


@pytest.mark.parametrize("case", ["random_windows", "per_video", "ragged_d"])
def test_windowed_attention_plain_matches_pallas(case):
    """Kernel 6's plain version against pallas_windowed_attention (interpret
    mode), every window within its W (echr_tpu's e - s <= W contract):
    random windows and end-clamped ones (the TPU kernel's DMA clamp and
    shift: starts T-4, T-16, T-1 touch the last frame); one video of
    adjacent row pairs with equal windows (beam copies); a D that is not a
    multiple of 8."""
    r = np.random.RandomState(3)
    if case == "random_windows":
        B, N, T, H, D, W = 2, 8, 64, 128, 96, 16
        starts = np.stack([np.array([T - 4, T - 16, T - 1, 0, 5, 50, 60, 30]),
                           r.randint(0, T - 2, size=N)])
        lens = np.stack([np.array([4, 16, 1, 7, 10, 14, 4, 16]),
                         np.minimum(r.randint(1, W + 1, size=N), T - starts[1])])
        soi = np.stack([starts, starts + lens], -1).astype(np.int32)
    elif case == "per_video":
        B, N, T, H, D, W = 1, 16, 128, 128, 100, 48
        soi = _beam_windows(r, N // 2, 2, T, 4, W + 1)[None]
    else:
        B, N, T, H, D, W = 2, 8, 64, 128, 21, 24
        soi = np.stack([_beam_windows(r, N, 1, T, 1, W + 1) for _ in range(B)])
    assert ((soi[..., 1] - soi[..., 0]) <= W).all()
    pre, q, w, b, feats = _inputs(B, N, T, H, D, seed=2)
    got = windowed_attention(*(torch.from_numpy(x) for x in (pre, feats, q, w, b, soi)), W=W)
    for v in range(B):
        want = PW.windowed_attention(jnp.asarray(pre[v]), jnp.asarray(feats[v]),
                                     jnp.asarray(q[v]),
                                     {"w": jnp.asarray(w[:, None]), "b": jnp.asarray(b)},
                                     jnp.asarray(soi[v]), W=W)
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want), atol=5e-4, rtol=0)


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_fused_splits_rule(sms):
    """fused_splits against a brute force over shapes: the most splits S
    (at most 8, a portable cluster, and at most the 32-frame tiles) whose
    grid of B * ceil(N / 32) * ceil(D / 512) * S blocks fits one a
    multiprocessor, 1 when even the unsplit grid does not; then at least
    the splits that keep every block's share of the tiles, and so of the
    scores it keeps, at 16 tiles or fewer.  The beam step takes none, a
    per-video decode step 8, T=4096 8."""
    for B, N, T, D in itertools.product((1, 2, 4, 32), (1, 32, 100, 128, 512),
                                        (1, 64, 200, 256, 1024, 1056, 2049, 4096), (21, 500, 700)):
        blocks = B * math.ceil(N / 32) * math.ceil(D / 512)
        tiles = math.ceil(T / 32)
        fits = [s for s in range(1, 9) if s <= tiles and blocks * s <= sms]
        need = min(s for s in range(1, 9) if math.ceil(tiles / s) <= 16)
        got = fused_splits(B, N, T, D, sms)
        assert got == max(max(fits, default=1), need), (B, N, T, D)
        assert 1 <= got <= 8 and math.ceil(tiles / got) <= 16
    assert fused_splits(32, 512, 256, 500, 132) == 1
    assert fused_splits(1, 128, 256, 500, 132) == 8
    assert fused_splits(32, 512, 4096, 500, 132) == 8
    assert fused_splits(32, 512, 1024, 500, 132) == 2


@pytest.mark.parametrize("sms", [132, 16])
def test_windowed_rows_rule(sms):
    """windowed_rows against a brute force: the most rows a block of 4, 2
    and 1 whose grid of B * ceil(N / rows) blocks gives two a
    multiprocessor, else 1; with 4, the k = 4 beam copies of a proposal
    (adjacent rows) share one block."""
    for B, N in itertools.product((1, 2, 8, 32), (1, 3, 64, 128, 512)):
        enough = [g for g in (1, 2, 4) if B * math.ceil(N / g) >= 2 * sms]
        assert windowed_rows(B, N, sms) == max(enough, default=1), (B, N)
    assert windowed_rows(32, 512, 132) == 4  # the beam step
    assert windowed_rows(1, 128, 132) == 1  # a per-video decode step
    rows = windowed_rows(32, 512, 132)
    block_of_row = np.arange(512) // rows
    assert (block_of_row.reshape(128, 4) == block_of_row[::4, None]).all()


def test_windowed_smem_bytes():
    """Kernel 6's shared memory a block, brute-forced from its layout: q of
    the block's rows and w (H padded to 128), two 8-frame chunks of pre
    and of feats (D's block columns: 256 a thread-column step, 1, 2, 4 or
    8 a thread, at most 2048); three blocks share an SM at the flagship
    width."""
    for H, D, g in itertools.product((1, 100, 128, 500, 512, 1000), (1, 256, 300, 500, 513,
                                                                    1024, 2048, 5000), (1, 2, 4)):
        hp = math.ceil(H / 128) * 128
        per_thread = next(c for c in (1, 2, 4, 8) if 256 * c >= min(D, 2048))
        floats = g * hp + hp + 2 * 8 * hp + 2 * 8 * 256 * per_thread
        assert windowed_smem_bytes(H, D, g) == 4 * floats, (H, D, g)
    assert 3 * (windowed_smem_bytes(512, 500, 4) + 1024) <= 228 * 1024


def test_step_inputs_windows_of_mask():
    """chip_smoke.step_inputs takes each row's window from its mask as
    decoder.ctxs_soi does: [first live frame, last + 1), and [T, 0) for a
    row without one, which kernel 6 and its plain version take as a
    zero-length window."""
    import chip_smoke
    from echr_tpu_torch.models.contexts import Contexts
    from echr_tpu_torch.models.decoder import ctxs_soi

    r = np.random.RandomState(6)
    B, N, T = 2, 10, 40
    soi = np.stack([_beam_windows(r, N // 2, 2, T, 1, 20) for _ in range(B)])
    mask = _mask_of(soi, T)
    mask[1, 4:6] = 0.0
    t = chip_smoke.step_inputs(tuple(torch.from_numpy(x) for x in (
        np.zeros((B, T, 4), np.float32), np.zeros((B, N, 4), np.float32),
        np.zeros(4, np.float32), np.zeros(1, np.float32), mask, np.zeros((B, T, 3), np.float32))))
    want = soi.copy()
    want[1, 4:6] = (T, 0)
    assert t["soi"].dtype == torch.int32 and t["soi"].is_contiguous()
    np.testing.assert_array_equal(t["soi"].numpy(), want)
    ctxs = Contexts(*([None] * len(Contexts._fields)))._replace(clip_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ctxs_soi(ctxs).numpy(), want)
    got = windowed_attention_plain(torch.randn(B, T, 4), torch.randn(B, T, 3), torch.randn(B, N, 4),
                                   torch.randn(4), torch.zeros(1), t["soi"], W=T)
    assert bool((got[1, 4:6] == 0).all()) and bool((got[0] != 0).any())


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
