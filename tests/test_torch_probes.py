"""Kernels 7-10's plain versions against the JAX probes' own Pallas kernel
bodies, run in interpret mode on the CPU, and the port's probe entry
points at small dims.

The probes' wrappers are jitted over module-level full-size constants, so
each test builds its own pl.pallas_call around the probe's kernel body with
the probe's BlockSpecs.  Importing experiments.probe_streaming_head2 points
jax's persistent compile cache at ./.jax_cache, the directory conftest.py
already uses.

Tolerances: tokens exact; max, logsumexp, scores and products within 5e-4
(f32 sums in another order; the bf16 operands are rounded the same way on
both sides).
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from experiments import probe_greedy_head as PG  # noqa: E402
from experiments import probe_mxu_vpu_overlap as PM  # noqa: E402
from experiments import probe_streaming_head2 as PS  # noqa: E402

from echr_tpu_torch.experiments import probe_greedy_head  # noqa: E402
from echr_tpu_torch.experiments import probe_mxu_vpu_overlap, probe_streaming_head2  # noqa: E402
from echr_tpu_torch.ops.kernel_probe_head import (  # noqa: E402
    PLAN,
    TILINGS,
    pad_probe_head,
    stream_head,
)
from echr_tpu_torch.ops.kernel_probe_scores import (  # noqa: E402
    probe_scores,
    probe_scores_plus_dot,
)

TOL = 5e-4


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


def _pallas_head(body, out, wp, bp, tr, tv):
    """The probes' head pallas_call (probe_greedy_head.py:79-106,
    probe_streaming_head2.py:78-105) around ``body``, in interpret mode."""
    R, C = out.shape
    vp = wp.shape[1]
    it, mx, lse = pl.pallas_call(
        body,
        out_shape=(jax.ShapeDtypeStruct((R, 1), jnp.int32),
                   jax.ShapeDtypeStruct((R, 1), jnp.float32),
                   jax.ShapeDtypeStruct((R, 1), jnp.float32)),
        grid=(R // tr, vp // tv),
        in_specs=[_vmem((tr, C), lambda i, j: (i, 0)), _vmem((C, tv), lambda i, j: (0, j)),
                  _vmem((1, tv), lambda i, j: (0, j))],
        out_specs=tuple(_vmem((tr, 1), lambda i, j: (i, 0)) for _ in range(3)),
        scratch_shapes=[pltpu.VMEM((tr, 1), jnp.float32), pltpu.VMEM((tr, 1), jnp.float32),
                        pltpu.VMEM((tr, 1), jnp.int32)],
        interpret=True,
    )(jnp.asarray(out).astype(jnp.bfloat16), jnp.asarray(wp, jnp.bfloat16),
      jnp.asarray(bp).reshape(1, vp))
    return np.asarray(it[:, 0]), np.asarray(mx[:, 0]), np.asarray(lse[:, 0])


def _head_inputs(R, C, V1, tv, seed):
    r = np.random.RandomState(seed)
    w = torch.from_numpy((r.randn(C, V1) * 0.05).astype(np.float32))
    b = torch.from_numpy((r.randn(V1) * 0.1).astype(np.float32))
    out = torch.from_numpy((r.randn(R, C) * 0.3).astype(np.float32))
    wp, bp = pad_probe_head(w, b, tv)
    return out, wp, bp


def _assert_head_equal(got, want):
    tok, mx, lse = (x.numpy() for x in got)
    np.testing.assert_array_equal(tok, want[0])
    np.testing.assert_allclose(mx, want[1], atol=TOL, rtol=0)
    np.testing.assert_allclose(lse, want[2], atol=TOL, rtol=0)


@pytest.mark.parametrize("tr", [512, 256])
def test_stream_head_plain_matches_greedy_head_pallas(tr):
    """Kernel 7's plain version against probe_greedy_head's body (its
    TILE_V=512 is a module constant)."""
    out, wp, bp = _head_inputs(512, 64, 1201, PG.TILE_V, seed=0)
    want = _pallas_head(PG._greedy_head_kernel, out.numpy(), wp.float().numpy(), bp.numpy(),
                        tr, PG.TILE_V)
    _assert_head_equal(stream_head(out, wp, bp), want)


@pytest.mark.parametrize("tr,tv", [(256, 512), (128, 256), (512, 128)])
def test_stream_head_plain_matches_streaming_head2_pallas(tr, tv):
    """Kernel 8's plain version against probe_streaming_head2's body at
    several tilings of the Pallas grid."""
    out, wp, bp = _head_inputs(512, 64, 1201, tv, seed=1)
    want = _pallas_head(functools.partial(PS._kernel, tile_v=tv), out.numpy(),
                        wp.float().numpy(), bp.numpy(), tr, tv)
    _assert_head_equal(stream_head(out, wp, bp), want)


def test_stream_head_tie_across_vocab_tiles_keeps_lower_index():
    """Equal logits in two vocab tiles (columns 3 and 600 at TV=512) and
    within one (3 and 5): the lowest index wins, in the plain version and
    in the probe's body."""
    C, V1 = 16, 1000
    w = torch.zeros(C, V1)
    w[:, [3, 5, 600]] = 1.0
    wp, bp = pad_probe_head(w, torch.zeros(V1), 512)
    out = torch.ones(8, C)
    tok, mx, _ = stream_head(out, wp, bp)
    assert bool((tok == 3).all()) and bool((mx == C).all())
    ptok, pmx, _ = _pallas_head(PG._greedy_head_kernel, out.numpy(), wp.float().numpy(),
                                bp.numpy(), 8, 512)
    assert (ptok == 3).all() and (pmx == C).all()
    w[:, [3, 5]] = 0.0  # only the later tile's column is left
    tok, _, _ = stream_head(out, *pad_probe_head(w, torch.zeros(V1), 512))
    assert bool((tok == 600).all())


def test_pad_probe_head_pads_like_the_probe():
    """Zero weights and a -1e30 bias in the pad lanes
    (probe_greedy_head.py:124-126), bf16 weights, VP a multiple of tv."""
    r = np.random.RandomState(2)
    w = torch.from_numpy(r.randn(8, 300).astype(np.float32))
    b = torch.from_numpy(r.randn(1, 300).astype(np.float32))
    wp, bp = pad_probe_head(w, b, 128)
    assert wp.shape == (8, 384) and bp.shape == (384,) and wp.dtype == torch.bfloat16
    assert torch.equal(wp[:, :300], w.to(torch.bfloat16)) and bool((wp[:, 300:] == 0).all())
    assert torch.equal(bp[:300], b[0]) and bool((bp[300:] == -1e30).all())


def _pallas_scores(pre, q, w, wd=None):
    """probe_mxu_vpu_overlap._scores (:77-110) around the probe's bodies,
    per video, in interpret mode; the tiles are its (8, 128)."""
    N, H = q.shape
    T = pre.shape[0]
    tn, tt = PM.TILE_N, PM.TILE_T
    in_specs = [_vmem((tt, H), lambda i, j: (j, 0)), _vmem((tn, H), lambda i, j: (i, 0)),
                _vmem((H, 1), lambda i, j: (0, 0))]
    args = (jnp.asarray(pre), jnp.asarray(q), jnp.asarray(w).reshape(H, 1))
    s_spec = _vmem((tn, tt), lambda i, j: (i, j))
    s_shape = jax.ShapeDtypeStruct((N, T), jnp.float32)
    if wd is None:
        return np.asarray(pl.pallas_call(PM._score_kernel, out_shape=s_shape,
                                         grid=(N // tn, T // tt), in_specs=in_specs,
                                         out_specs=s_spec, interpret=True)(*args))
    kd = wd.shape[1]
    s, d = pl.pallas_call(
        PM._score_plus_dot_kernel,
        out_shape=(s_shape, jax.ShapeDtypeStruct((T // tt, N, kd), jnp.float32)),
        grid=(N // tn, T // tt),
        in_specs=in_specs + [_vmem((H, kd), lambda i, j: (0, 0))],
        out_specs=(s_spec, _vmem((1, tn, kd), lambda i, j: (j, i, 0))),
        interpret=True,
    )(*args, jnp.asarray(wd, jnp.bfloat16))
    return np.asarray(s), np.asarray(d)


def _score_inputs(B, N, T, H, KD, seed):
    r = np.random.RandomState(seed)
    pre = (r.randn(B, T, H) * 0.5).astype(np.float32)
    q = (r.randn(B, N, H) * 0.5).astype(np.float32)
    w = (r.randn(H) * 0.05).astype(np.float32)
    wd = torch.from_numpy((r.randn(H, KD) * 0.05).astype(np.float32)).to(torch.bfloat16)
    return pre, q, w, wd


def test_probe_scores_plain_matches_pallas():
    """Kernel 9's plain version against _score_kernel, two videos, two
    128-frame tiles."""
    pre, q, w, _ = _score_inputs(2, 16, 256, 128, 8, seed=3)
    got = probe_scores(*(torch.from_numpy(x) for x in (pre, q, w)))
    assert got.shape == (2, 16, 256)
    for v in range(2):
        np.testing.assert_allclose(got[v].numpy(), _pallas_scores(pre[v], q[v], w),
                                   atol=TOL, rtol=0)


def test_probe_scores_plus_dot_plain_matches_pallas():
    """Kernel 10's plain version against _score_plus_dot_kernel: the scores,
    and one copy of the product per 128-frame tile."""
    pre, q, w, wd = _score_inputs(2, 16, 256, 128, 256, seed=4)
    s, dot = probe_scores_plus_dot(*(torch.from_numpy(x) for x in (pre, q, w)), wd)
    assert dot.shape == (2, 2, 16, 256)
    for v in range(2):
        ws, wdot = _pallas_scores(pre[v], q[v], w, wd.float().numpy())
        np.testing.assert_allclose(s[v].numpy(), ws, atol=TOL, rtol=0)
        np.testing.assert_allclose(dot[v].numpy(), wdot, atol=TOL, rtol=0)
    none, alone = probe_scores_plus_dot(*(torch.from_numpy(x) for x in (pre, q, w)), wd,
                                        scores=False)
    assert none is None and torch.equal(alone, dot)


def test_probe_dot_plain_ragged_T_counts_copies():
    """A T off the 128-frame tile still gets one copy per (partial) tile."""
    pre, q, w, wd = _score_inputs(1, 8, 200, 32, 128, seed=5)
    s, dot = probe_scores_plus_dot(*(torch.from_numpy(x) for x in (pre, q, w)), wd)
    assert s.shape == (1, 8, 200) and dot.shape == (1, 2, 8, 128)
    assert torch.equal(dot[:, 0], dot[:, 1])


@pytest.mark.parametrize("probe,dims", [
    (probe_greedy_head, dict(B=2, N=32, C=64, V1=1201, steps=2)),
    (probe_streaming_head2, dict(B=2, N=32, C=64, V1=1201, steps=2)),
    (probe_mxu_vpu_overlap, dict(B=2, N=16, T=200, H=32, steps=2, kds=(128, 256))),
])
def test_probe_runs_on_the_cpu_when_asked(probe, dims):
    """Each probe's run(device="cpu") at small dims: it checks, times every
    row and counts the calls it made to each kernel's wrapper."""
    rec = probe.run(device="cpu", **dims)
    assert rec["device"] == "cpu"
    rows = rec["ms_per_step"]
    if probe is probe_mxu_vpu_overlap:
        assert sorted(rows) == [128, 256]
        assert all(sorted(r) == ["S0", "S1", "S2", "SD"] for r in rows.values())
        times = [t for r in rows.values() for t in r.values()]
        assert rec["kernel_calls"] == {"probe_scores": 2 * 4 * 2 * 2,
                                       "probe_scores_plus_dot": 2 * 4 * 2 * 2}
    elif probe is probe_greedy_head:
        assert sorted(rows) == ["K1", "K2", "X0", "X0p", "XM", "XMp"]
        assert rec["check"]["token_mismatches"] == 0 and rec["plan"] == PLAN
        assert rec["kernel_calls"] == {"stream_head": 1 + 4 * 2, "greedy_head": 4 * 2}
        times = list(rows.values())
    else:
        assert sorted(rows) == sorted(["X0", "X0p", "XM", "XMp"]
                                      + [f"{tr}x{tv}" for tr, tv in TILINGS])
        assert all(c["token_mismatches"] == 0 for c in rec["checks"].values())
        assert rec["kernel_calls"] == {"stream_head": len(TILINGS) * (1 + 3 * 4 * 2)}
        times = list(rows.values())
    assert all(np.isfinite(t) and t > 0 for t in times)


def test_probes_refuse_a_missing_card(monkeypatch):
    """A probe runs on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for probe in (probe_greedy_head, probe_streaming_head2, probe_mxu_vpu_overlap):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            probe.run()
