"""The two CUDA kernels' plain PyTorch versions against the Pallas kernels
they replace, run on the CPU as the JAX package's own tests run them
(interpret mode), plus the wrappers' CPU contract.

The CUDA kernels themselves run only on the card: chip_smoke.py holds each
against its plain version there.  Tolerances: scores and head max /
logsumexp within 5e-4 (f32 sums in another order); greedy tokens exact,
with the first index winning a tie.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echr_tpu.ops import pallas_attention, pallas_head

from echr_tpu_torch.ops import force_plain, use_plain
from echr_tpu_torch.ops.core import Dense
from echr_tpu_torch.ops.kernel_attention import attention_scores_masked, attention_scores_plain
from echr_tpu_torch.ops.kernel_head import greedy_head, greedy_head_plain, prepare_head

TOL = 5e-4


@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values; the port's parameters are
    trainable, so run without recording gradients."""
    with torch.no_grad():
        yield


def _sorted_windows(r, N, T, lo=4, hi=48):
    starts = np.sort(r.randint(0, T - 8, size=N))
    lens = r.randint(lo, hi, size=N)
    soi = np.stack([starts, np.minimum(starts + lens, T)], 1)
    t = np.arange(T)[None, :]
    return ((t >= soi[:, :1]) & (t < soi[:, 1:])).astype(np.float32)


@pytest.mark.parametrize("N,T,H,k", [
    pytest.param(16, 128, 128, 1, id="16-128-128"),
    pytest.param(24, 256, 128, 1, id="24-256-128"),
    # beam-shaped: 8 proposals' long windows, each repeated for its k = 4 beams
    pytest.param(32, 256, 128, 4, id="32-256-128-beam4"),
])
def test_scores_plain_matches_pallas_masked(N, T, H, k):
    """The plain version equals pallas_attention.attention_scores_masked (the
    tile-skipping Pallas kernel, interpret mode) wherever mask == 1."""
    r = np.random.RandomState(N + T)
    B = 2
    pre = (r.randn(B, T, H) * 0.5).astype(np.float32)
    q = (r.randn(B, N, H) * 0.5).astype(np.float32)
    w = (r.randn(H) * 0.1).astype(np.float32)
    b = np.array([0.3], np.float32)
    if k == 1:
        mask = np.stack([_sorted_windows(r, N, T) for _ in range(B)])
    else:
        mask = np.stack([np.repeat(_sorted_windows(r, N // k, T, 40, 200), k, axis=0)
                         for _ in range(B)])
        assert 0.2 < mask.mean() < 0.8 and np.array_equal(mask[:, ::k], mask[:, k - 1::k])
    assert pallas_attention.supported(jnp.asarray(pre[0]), jnp.asarray(q[0]))
    got = attention_scores_masked(*(torch.from_numpy(x) for x in (pre, q, w, b, mask)))
    for i in range(B):
        want = pallas_attention.attention_scores_masked(
            jnp.asarray(pre[i]), jnp.asarray(q[i]),
            {"w": jnp.asarray(w[:, None]), "b": jnp.asarray(b)}, jnp.asarray(mask[i]))
        m = mask[i] > 0
        np.testing.assert_allclose(got[i].numpy()[m], np.asarray(want)[m], atol=TOL, rtol=0)


def test_kernel1_tanh_counts():
    """chip_smoke's count of kernel 1's tanh, modelled from the mask, equals
    a count made pair by pair and tile by tile: live pairs x H needed; live
    pairs x H padded to the kernel's chunk by this design's rule; every
    live 16 x 32 tile x H by the earlier tiled design."""
    import chip_smoke

    r = np.random.RandomState(7)
    B, N, T = 2, 37, 70
    mask = np.stack([_sorted_windows(r, N, T, 2, 30) for _ in range(B)])
    mask[1, 5, 40:44] = 0.0  # a hole
    blocks = [(b, n0, t0) for b in range(B) for n0 in range(0, N, 16) for t0 in range(0, T, 32)]
    tiles = sum(bool(mask[b, n0:n0 + 16, t0:t0 + 32].any()) for b, n0, t0 in blocks)
    live = int((mask != 0).sum())
    for H, chunk in ((100, 128), (200, 256), (500, 512), (700, 1024)):
        got = chip_smoke.kernel1_tanh(torch.from_numpy(mask), H)
        assert got == {"tanh_needed": live * H, "tanh_modelled": live * chunk,
                       "tanh_modelled_tiled": tiles * 16 * 32 * H}


@pytest.mark.parametrize("kernel", ["masked_scores_on", "scores_bwd_on"])
def test_launch_through_a_library_raises_on_cpu(kernel):
    """The launch helpers behind kernels 1 and 4 (the wrappers call them
    with native.library(); comparisons with another build) take CUDA
    tensors only: on the CPU they raise before reaching the library, and
    the wrappers' launch counts do not move."""
    from echr_tpu_torch.ops import kernel_attention as ka

    r = np.random.RandomState(3)
    B, N, T, H = 2, 5, 9, 16
    pre, q = torch.randn(B, T, H), torch.randn(B, N, H)
    w, b = torch.randn(H), torch.zeros(1)
    mask = torch.from_numpy((r.rand(B, N, T) > 0.5).astype(np.float32))
    args = (pre, q, w, b, mask) if kernel == "masked_scores_on" else (pre, q, w, mask)
    before = (ka.attention_scores_masked.launches, ka.attention_scores_bwd.launches)
    with pytest.raises(ValueError, match="is on cpu"):
        getattr(ka, kernel)(None, *args)
    assert (ka.attention_scores_masked.launches, ka.attention_scores_bwd.launches) == before


def test_shuffle_proposals_keeps_beams_together():
    """kernel_turns.shuffle_proposals permutes each video's proposals as
    blocks of k rows: q and mask rows move together, every row appears
    once, and the mask's live pairs stay the same."""
    import kernel_turns

    r = np.random.RandomState(11)
    B, P, k, T, H = 3, 6, 4, 20, 8
    q = torch.from_numpy(r.randn(B, P * k, H).astype(np.float32))
    mask = torch.from_numpy(np.repeat(_sorted_windows(r, P, T, 2, 9)[None], B, 0)
                            .repeat(k, axis=1))
    pre, w, b = torch.zeros(B, T, H), torch.zeros(H), torch.zeros(1)
    out = kernel_turns.shuffle_proposals((pre, q, w, b, mask), k=k, seed=1)
    assert out[0] is pre and out[2] is w and out[3] is b
    q2, m2 = out[1], out[4]
    assert int(m2.sum()) == int(mask.sum())
    for i in range(B):
        rows = [int(np.where((q[i] == q2[i, j]).all(1).numpy())[0][0]) for j in range(P * k)]
        assert sorted(rows) == list(range(P * k))
        blocks = np.array(rows).reshape(P, k)
        assert (blocks == blocks[:, :1] + np.arange(k)).all() and (blocks[:, 0] % k == 0).all()
        assert torch.equal(m2[i], mask[i, rows])
    assert not torch.equal(q2, q)


def _head_weights(r, C, V1, dtype):
    d = Dense(C, V1)
    w = (r.randn(C, V1) * 0.05).astype(np.float32)
    b = (r.randn(V1) * 0.1).astype(np.float32)
    with torch.no_grad():
        d.weight.copy_(torch.from_numpy(w.T.copy()))
        d.bias.copy_(torch.from_numpy(b))
    return w, b, prepare_head(d, dtype)


@pytest.mark.parametrize("out_dtype", [np.float32, "bf16-valued"])
@pytest.mark.parametrize("R,C,V1", [(128, 96, 301), (120, 64, 1201)])
def test_head_plain_matches_pallas(R, C, V1, out_dtype):
    """bf16 head: the plain version equals pallas_head.greedy_head (interpret
    mode), which rounds both operands to bf16, for f32 core outputs and for
    outputs that already hold bf16 values."""
    r = np.random.RandomState(R + V1)
    w, b, (wk, bk) = _head_weights(r, C, V1, torch.bfloat16)
    out = (r.randn(R, C) * 0.3).astype(np.float32)
    if out_dtype != np.float32:
        out = np.array(jnp.asarray(out).astype(jnp.bfloat16).astype(jnp.float32))
    tr, tv, _, _ = pallas_head.head_plan(R, C, V1)
    wp, bp = pallas_head.pad_head_weights(jnp.asarray(w), jnp.asarray(b), tv)
    jt, jm, jl = pallas_head.greedy_head(jnp.asarray(out), wp, bp, tr, tv)
    tok, mx, lse = greedy_head(torch.from_numpy(out), wk, bk)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jt))
    np.testing.assert_allclose(mx.numpy(), np.asarray(jm), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), atol=TOL, rtol=0)


def test_head_plain_f32_matches_jnp():
    """f32 head (the parity runs' compute dtype): the jnp head the JAX
    decoder uses at f32 -- argmax, max and logsumexp of dense(logit, out)."""
    import jax

    r = np.random.RandomState(7)
    R, C, V1 = 64, 48, 257
    w, b, (wk, bk) = _head_weights(r, C, V1, torch.float32)
    assert wk.dtype == torch.float32
    out = (r.randn(R, C) * 0.3).astype(np.float32)
    logits = jnp.dot(jnp.asarray(out), jnp.asarray(w)) + jnp.asarray(b)
    tok, mx, lse = greedy_head(torch.from_numpy(out), wk, bk)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jnp.argmax(logits, axis=1)))
    np.testing.assert_allclose(mx.numpy(), np.asarray(jnp.max(logits, axis=1)), atol=TOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jax.scipy.special.logsumexp(logits, axis=1)), atol=TOL)


def test_head_cross_tile_tie_keeps_first_index():
    """An exact tie across Pallas vocab tiles, built from integer-valued
    sums: both heads return the first index."""
    C, V1 = 8, 2048
    tr, tv, _, _ = pallas_head.head_plan(8, C, V1)
    assert V1 // tv >= 2
    w = np.zeros((C, V1), np.float32)
    w[:, 3] = 1.0
    w[:, tv + 7] = 1.0
    b = np.zeros((V1,), np.float32)
    d = Dense(C, V1)
    with torch.no_grad():
        d.weight.copy_(torch.from_numpy(w.T.copy()))
        d.bias.zero_()
    out = np.ones((8, C), np.float32)
    wp, bp = pallas_head.pad_head_weights(jnp.asarray(w), jnp.asarray(b), tv)
    jt, _, _ = pallas_head.greedy_head(jnp.asarray(out), wp, bp, tr, tv)
    for dtype in (torch.bfloat16, torch.float32):
        tok, mx, _ = greedy_head(torch.from_numpy(out), *prepare_head(d, dtype))
        assert np.all(tok.numpy() == 3) and np.all(np.asarray(jt) == 3)
        assert np.all(mx.numpy() == C)


def test_wrappers_take_plain_on_cpu_without_counting():
    r = np.random.RandomState(9)
    pre, q = torch.randn(1, 8, 4), torch.randn(1, 3, 4)
    w, b, mask = torch.randn(4), torch.zeros(1), torch.ones(1, 3, 8)
    n0 = attention_scores_masked.launches
    assert torch.equal(attention_scores_masked(pre, q, w, b, mask),
                       attention_scores_plain(pre, q, w, b, mask))
    assert attention_scores_masked.launches == n0
    _, _, (wk, bk) = _head_weights(r, 4, 9, torch.bfloat16)
    out = torch.randn(5, 4)
    h0 = greedy_head.launches
    for got, want in zip(greedy_head(out, wk, bk), greedy_head_plain(out, wk, bk)):
        assert torch.equal(got, want)
    assert greedy_head.launches == h0


def test_use_plain_only_for_cpu_or_forced():
    cpu = torch.zeros(1)
    meta = torch.zeros(1, device="meta")
    assert use_plain(cpu)
    with pytest.raises(ValueError, match="no kernel"):
        use_plain(meta)
    with force_plain():
        assert use_plain(meta)
    with pytest.raises(ValueError):
        use_plain(meta)
