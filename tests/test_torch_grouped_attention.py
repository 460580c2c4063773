"""The port's grouped windowed attention (ops/attention.py:
grouped_tg_required, grouped_attention_precompute, grouped_attention_step
and additive_attention_step(grouping=...)) against echr_tpu's, on the CPU.

The same numpy-seeded weights and windows (tests/test_grouped_attention.py's
setup, as two videos of the port's batched layout) go through both; each
video is held against echr_tpu's unbatched functions.  Tolerances: the
grouping metadata exact, att_res within atol 1e-5 (test_grouped_attention's
gate), and the grouped step within the same of the port's full-T masked
step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_ops import T

from echr_tpu.ops import attention as jatt

from echr_tpu_torch.ops import attention as att

TD, H, D, N, NG, B = 96, 64, 48, 32, 8, 2
ATOL = 1e-5


def _windows(r):
    starts = r.randint(0, TD - 20, size=N)
    ends = np.minimum(starts + r.randint(2, 16, size=N), TD)
    mask = np.zeros((N, TD), np.float32)
    for n in range(N):
        mask[n, starts[n]:ends[n]] = 1.0
    return mask, np.stack([starts, ends], 1)


@pytest.fixture(scope="module")
def setup():
    r = np.random.RandomState(0)
    p = jatt.additive_attention_init(jax.random.PRNGKey(0), D, H, H)
    p = jax.tree.map(np.array, p)
    mod = att.AdditiveAttention(D, H, H)
    with torch.no_grad():
        for name in ("ctx2att", "h2att", "alpha_net"):
            getattr(mod, name).weight.copy_(T(p[name]["w"].T))
            getattr(mod, name).bias.copy_(T(p[name]["b"]))
    feats = (r.randn(B, TD, D) * 0.5).astype(np.float32)
    h = (r.randn(B, N, H) * 0.5).astype(np.float32)
    masks, sois = zip(*(_windows(r) for _ in range(B)))
    return p, mod, feats, h, np.stack(masks), np.stack(sois)


def test_tg_required_matches_jax(setup):
    """The slice length for each video and for the batch, and the refusal
    of a group count that does not divide N, as echr_tpu's."""
    *_, soi = setup
    for g in (2, 4, NG):
        assert att.grouped_tg_required(soi, g) == jatt.grouped_tg_required(soi, g)
        for s in soi:
            assert att.grouped_tg_required(s, g) == jatt.grouped_tg_required(s, g)
    one = np.array([[[0, 10], [5, 20], [40, 60], [50, 90]]])
    assert att.grouped_tg_required(one, 2) == jatt.grouped_tg_required(one, 2) == 50
    ragged = np.array([[0, 10], [5, 20], [40, 60]])
    for fn in (att.grouped_tg_required, jatt.grouped_tg_required):
        with pytest.raises(ValueError, match="must divide"):
            fn(ragged, 2)


def test_precompute_matches_jax(setup):
    """order, inv_order, slice_start and rel of each video equal echr_tpu's."""
    *_, mask, soi = setup
    tg = min(TD, -(-att.grouped_tg_required(soi, NG) // 8) * 8)
    got = att.grouped_attention_precompute(T(mask), tg, NG)
    precompute = jax.jit(jatt.grouped_attention_precompute, static_argnums=(1, 2))
    for b in range(B):
        want = precompute(jnp.asarray(mask[b]), tg, NG)
        for k in ("order", "inv_order", "slice_start", "rel"):
            np.testing.assert_array_equal(got[k][b].numpy(), np.asarray(want[k]), err_msg=k)


def test_grouped_step_matches_jax_and_the_dense_step(setup):
    """grouped_attention_step against echr_tpu's per video and against the
    port's full-T masked step, within atol 1e-5; the grouping= route of
    additive_attention_step is the grouped step itself, and returns no
    weights."""
    p, mod, feats, h, mask, soi = setup
    tg = min(TD, -(-att.grouped_tg_required(soi, NG) // 8) * 8)
    pre = att.additive_attention_precompute(mod, T(feats))
    grp = att.grouped_attention_precompute(T(mask), tg, NG)
    with torch.no_grad():
        got = att.grouped_attention_step(mod, T(h), T(feats), pre, grp)
        dense, _ = att.additive_attention_step(mod, T(h), T(feats), pre, T(mask))
        routed, w = att.additive_attention_step(mod, T(h), T(feats), pre, T(mask),
                                                grouping=grp)
    assert w is None and torch.equal(routed, got)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=ATOL, rtol=0)
    @jax.jit  # one program for every video: op by op each call compiles anew
    def jax_step(hb, fb, mb):
        jpre = jatt.additive_attention_precompute(p, fb)
        jgrp = jatt.grouped_attention_precompute(mb, tg, NG)
        return jatt.grouped_attention_step(p, hb, fb, jpre, jgrp, jnp.float32)

    for b in range(B):
        want = jax_step(jnp.asarray(h[b]), jnp.asarray(feats[b]), jnp.asarray(mask[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), atol=ATOL, rtol=0)
