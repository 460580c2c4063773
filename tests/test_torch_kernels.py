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


@pytest.mark.parametrize("kernel", ["masked_scores_on", "scores_bwd_on", "dense_scores_on",
                                    "head_on", "stream_head_on"])
def test_launch_through_a_library_raises_on_cpu(kernel):
    """The launch helpers behind kernels 1-4 and 7-8 (the wrappers call them with
    native.library(); comparisons with another build) take CUDA tensors
    only: on the CPU they raise before reaching the library, and the
    wrappers' launch counts do not move."""
    from echr_tpu_torch.ops import kernel_attention as ka
    from echr_tpu_torch.ops import kernel_head as kh
    from echr_tpu_torch.ops import kernel_probe_head as kp

    r = np.random.RandomState(3)
    B, N, T, H = 2, 5, 9, 16
    pre, q = torch.randn(B, T, H), torch.randn(B, N, H)
    w, b = torch.randn(H), torch.zeros(1)
    mask = torch.from_numpy((r.rand(B, N, T) > 0.5).astype(np.float32))
    args = {"masked_scores_on": (pre, q, w, b, mask), "dense_scores_on": (pre, q, w, b, mask),
            "scores_bwd_on": (pre, q, w, mask),
            "head_on": (torch.randn(7, H), torch.randn(11, H).bfloat16(), torch.zeros(11)),
            "stream_head_on": (torch.randn(7, H),) + kp.pad_probe_head(torch.randn(H, 11),
                                                                       torch.zeros(11), 128)
            + kp.PLAN}
    counts = (ka.attention_scores_masked, ka.attention_scores_dense, ka.attention_scores_bwd,
              kh.greedy_head, kp.stream_head)
    module = {"head_on": kh, "stream_head_on": kp}.get(kernel, ka)
    before = [fn.launches for fn in counts]
    with pytest.raises(ValueError, match="is on cpu"):
        getattr(module, kernel)(None, *args[kernel])
    assert [fn.launches for fn in counts] == before


def test_kernel3_launch_without_mask_raises():
    """Kernel 3 takes the window mask: its launch helper refuses None
    before it looks at the tensors."""
    from echr_tpu_torch.ops.kernel_attention import dense_scores_on

    pre, q, w, b = torch.randn(1, 4, 8), torch.randn(1, 3, 8), torch.randn(8), torch.zeros(1)
    with pytest.raises(ValueError, match="takes the window mask"):
        dense_scores_on(None, pre, q, w, b, None)


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


@pytest.mark.parametrize("C", [36, 61])
def test_head_padded_width_matches_unpadded_and_pallas(C):
    """A width that is not a multiple of 8: prepare_head pads w's rows with
    zeros (the kernel's TMA reads 16-byte strides) and the plain version,
    given the unpadded core output, equals the one over the unpadded w
    bit for bit, and pallas_head.greedy_head (interpret mode)."""
    from echr_tpu_torch.ops.kernel_head import pad_head_width

    r = np.random.RandomState(C)
    R, V1 = 40, 517
    w, b, (wk, bk) = _head_weights(r, C, V1, torch.bfloat16)
    assert wk.shape == (V1, C + (-C % 8)) and not wk[:, C:].any()
    assert torch.equal(pad_head_width(wk), wk)
    out = (r.randn(R, C) * 0.3).astype(np.float32)
    got = greedy_head(torch.from_numpy(out), wk, bk)
    want = greedy_head_plain(torch.from_numpy(out), wk[:, :C].contiguous(), bk)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    tr, tv, _, _ = pallas_head.head_plan(R, C, V1)
    wp, bp = pallas_head.pad_head_weights(jnp.asarray(w), jnp.asarray(b), tv)
    jt, jm, jl = pallas_head.greedy_head(jnp.asarray(out), wp, bp, tr, tv)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jt))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jm), atol=TOL, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jl), atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_split_plan_covers_every_tile_once(dtype):
    """split_plan's vocab splits, as the kernel walks them (split s: tiles
    [s * per, min(n, (s + 1) * per))), cover every vocab tile exactly once
    and each holds at least one; at the serving shapes on 132 SMs the bf16
    grid is 32 row tiles x 4 splits of 6 tiles."""
    from echr_tpu_torch.ops.kernel_head import _VOCAB_TILE, split_plan

    for R in (1, 77, 128, 1000, 4096, 16384):
        for V1 in (1, 70, 130, 777, 2048, 6001):
            for sms in (1, 16, 132):
                per, splits = split_plan(R, V1, sms, dtype)
                n = -(-V1 // _VOCAB_TILE[dtype])
                tiles = [t for s in range(splits) for t in range(s * per, min(n, (s + 1) * per))]
                assert sorted(tiles) == list(range(n)) and len(tiles) == n
                assert all(s * per < n for s in range(splits))
    if dtype == torch.bfloat16:
        assert split_plan(4096, 6001, 132, dtype) == (6, 4)


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
