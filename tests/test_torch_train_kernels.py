"""Kernels 3 and 4, the differentiable attention scores, against the Pallas
kernels they replace, on the CPU.

The port's ``attention_scores_diff`` takes its plain forward and backward
here (CPU tensors); the JAX side runs pallas_attention.attention_scores_diff
(kernel 3 forward, kernel 4 backward) in interpret mode, as the JAX
package's own tests do.  Tolerances are those of
tests/test_pallas_attention.py: atol 2e-4, rtol 1e-4 (f32 sums over H, N
and T in another order).  Kernel 3 takes the window mask and is exact
only where it is 1 (the card's kernel writes 0 elsewhere), so raw scores
are compared everywhere only with an all-ones mask; with a window mask
the scores go through the masked softmax, as on the training route.  The
CUDA kernels run only on the card, where chip_smoke.py holds them against
these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from echr_tpu.ops import pallas_attention
from echr_tpu.ops.masked import masked_softmax as jax_masked_softmax

from echr_tpu_torch.ops import force_plain
from echr_tpu_torch.ops.attention import AdditiveAttention, additive_attention_step
from echr_tpu_torch.ops.kernel_attention import (
    attention_scores_bwd,
    attention_scores_bwd_plain,
    attention_scores_dense,
    attention_scores_dense_plain,
    attention_scores_diff,
)
from echr_tpu_torch.ops.masked import masked_softmax

ATOL, RTOL = 2e-4, 1e-4


def _inputs(seed, B, N, T, H):
    r = np.random.RandomState(seed)
    pre = r.randn(B, T, H).astype(np.float32)
    q = r.randn(B, N, H).astype(np.float32)
    w = (r.randn(H) * 0.1).astype(np.float32)
    b = (r.randn(1)).astype(np.float32)
    ct = r.randn(B, N, T).astype(np.float32)
    return pre, q, w, b, ct


def _port_grads(pre, q, w, b, ct):
    """Scores and gradients of sum(scores * ct), every entry live."""
    ts = [torch.from_numpy(x).requires_grad_() for x in (pre, q, w, b)]
    s = attention_scores_diff(*ts, torch.ones(ct.shape))
    s.backward(torch.from_numpy(ct))
    return s.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("B,N,T,H,windowed", [
    pytest.param(1, 8, 128, 128, False, id="1-8-128-128"),  # one Pallas block
    pytest.param(3, 24, 256, 128, False, id="3-24-256-128"),  # several blocks, vmapped
    # the cotangent the masked softmax gives: exactly 0 outside sorted windows,
    # the entries kernel 4 skips
    pytest.param(3, 24, 256, 128, True, id="3-24-256-128-windowed"),
])
def test_scores_diff_matches_pallas(B, N, T, H, windowed):
    pre, q, w, b, ct = _inputs(B + N, B, N, T, H)
    if windowed:
        r = np.random.RandomState(B + N + T)
        starts = np.sort(r.randint(0, T - 8, size=(B, N)), axis=1)
        ends = np.minimum(starts + r.randint(4, 48, size=(B, N)), T)
        t = np.arange(T)
        ct = ct * ((t >= starts[..., None]) & (t < ends[..., None]))
        assert 0.0 < (ct != 0).mean() < 0.2
    assert pallas_attention.supported(jnp.asarray(pre[0]), jnp.asarray(q[0]),
                                      differentiable=True)

    def loss(pre_, q_, w_, b_):
        p = {"w": w_[:, None], "b": b_}
        s = jax.vmap(lambda a, c: pallas_attention.attention_scores_diff(a, c, p))(pre_, q_)
        return jnp.sum(s * ct), s

    (_, want), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (pre, q, w, b)))
    got, grads = _port_grads(pre, q, w, b, ct)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    for name, g, jg in zip(("d_pre", "d_q", "d_w", "d_b"), grads, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg).reshape(g.shape), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def _window_mask(r, B, N, T, hole=None):
    """Windows of 4-47 frames in random order -> [B, N, T] f32; ``hole``
    (b, n) is a row with no live frame."""
    starts = r.randint(0, T - 8, size=(B, N))
    ends = np.minimum(starts + r.randint(4, 48, size=(B, N)), T)
    t = np.arange(T)
    mask = ((t >= starts[..., None]) & (t < ends[..., None])).astype(np.float32)
    if hole is not None:
        mask[hole] = 0.0
    return mask


@pytest.mark.parametrize("B,N,T,H", [
    pytest.param(1, 8, 128, 128, id="1-8-128-128"),
    pytest.param(3, 24, 256, 128, id="3-24-256-128"),
])
def test_scores_diff_window_softmax_matches_pallas(B, N, T, H):
    """The training route: scores with a window mask (here in random
    order, and one row with no live frame) through the masked softmax.
    The port's attention_scores_diff + masked_softmax against JAX's
    pallas_attention.attention_scores_diff (interpret mode) + masked_softmax
    on the same inputs: the weights and every gradient agree; raw scores
    only where mask == 1."""
    pre, q, w, b, ct = _inputs(2 * B + N, B, N, T, H)
    mask = _window_mask(np.random.RandomState(B + T), B, N, T, hole=(B - 1, N // 2))
    assert 0.0 < mask.mean() < 0.3

    def loss(pre_, q_, w_, b_):
        p = {"w": w_[:, None], "b": b_}
        s = jax.vmap(lambda a, c: pallas_attention.attention_scores_diff(a, c, p))(pre_, q_)
        wts = jax_masked_softmax(s, jnp.asarray(mask), axis=-1)
        return jnp.sum(wts * ct), (s, wts)

    (_, (js, jw)), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(x) for x in (pre, q, w, b)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (pre, q, w, b)]
    m = torch.from_numpy(mask)
    s = attention_scores_diff(*ts, m)
    wts = masked_softmax(s, m, dim=-1)
    (wts * torch.from_numpy(ct)).sum().backward()
    live = mask > 0
    np.testing.assert_allclose(s.detach().numpy()[live], np.asarray(js)[live], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(wts.detach().numpy(), np.asarray(jw), atol=ATOL, rtol=RTOL)
    assert not wts.detach()[B - 1, N // 2].any()
    for name, t, jg in zip(("d_pre", "d_q", "d_w", "d_b"), ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg).reshape(t.shape), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


def test_scores_diff_gradcheck_float64():
    """The Function's plain path (forward and recompute-tanh backward)
    against finite differences, in float64."""
    r = np.random.RandomState(0)
    args = [torch.from_numpy(r.randn(*s)).requires_grad_()
            for s in ((2, 5, 4), (2, 3, 4), (4,), (1,))]
    mask = torch.ones(2, 3, 5, dtype=torch.float64)
    assert torch.autograd.gradcheck(attention_scores_diff, args + [mask], eps=1e-6, atol=1e-8)


def test_scores_diff_saves_no_tanh():
    """The forward saves pre, q and w for the backward and never the
    [B, N, T, H] tanh."""
    pre, q, w, b, ct = _inputs(1, 2, 8, 16, 12)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        ts = [torch.from_numpy(x).requires_grad_() for x in (pre, q, w, b)]
        attention_scores_diff(*ts, torch.ones(ct.shape))
    assert sorted(saved) == sorted([(2, 16, 12), (2, 8, 12), (12,)]), saved


def test_kernel_wrappers_take_plain_on_cpu_without_counting():
    pre, q, w, b, ct = (torch.from_numpy(x) for x in _inputs(2, 2, 5, 9, 6))
    f0, b0 = attention_scores_dense.launches, attention_scores_bwd.launches
    mask = (ct > 0).float()  # the plain version computes every entry whatever the mask
    assert torch.equal(attention_scores_dense(pre, q, w, b, mask),
                       attention_scores_dense_plain(pre, q, w, b))
    for got, want in zip(attention_scores_bwd(pre, q, w, ct),
                         attention_scores_bwd_plain(pre, q, w, ct)):
        assert torch.equal(got, want)
    with force_plain():
        _port_grads(*(x.numpy() for x in (pre, q, w, b, ct)))
    assert (attention_scores_dense.launches, attention_scores_bwd.launches) == (f0, b0)


def test_attention_step_training_routes_agree():
    """At f32, the three training routes of additive_attention_step give the
    same values and gradients: the kernel route (attention_scores_diff),
    the checkpointed plain route, and the plain route without remat (the
    last two exactly)."""
    att = AdditiveAttention(20, 16, 24).init_uniform(torch.Generator().manual_seed(0))
    r = np.random.RandomState(3)
    h = torch.from_numpy(r.randn(2, 6, 16).astype(np.float32))
    feats = torch.from_numpy(r.randn(2, 30, 20).astype(np.float32))
    pre = torch.from_numpy(r.randn(2, 30, 24).astype(np.float32))
    mask = torch.from_numpy((r.rand(2, 6, 30) > 0.4).astype(np.float32))
    ct = torch.from_numpy(r.randn(2, 6, 20).astype(np.float32))
    outs = []
    for use_kernel, remat in ((True, True), (False, True), (False, False)):
        hh, pp = h.clone().requires_grad_(), pre.clone().requires_grad_()
        res, _ = additive_attention_step(att, hh, feats, pp, mask, torch.float32, use_kernel,
                                         remat)
        params = list(att.parameters())
        grads = torch.autograd.grad((res * ct).sum(), [hh, pp] + params, allow_unused=True)
        outs.append([res] + [torch.zeros(1) if g is None else g for g in grads])
    for a, o in zip(outs[0], outs[1]):
        np.testing.assert_allclose(a.detach().numpy(), o.detach().numpy(), atol=1e-5, rtol=1e-5)
    for a, o in zip(outs[1], outs[2]):  # remat changes nothing
        assert torch.equal(a, o)
