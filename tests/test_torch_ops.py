"""echr_tpu_torch primitive ops and SST against the JAX package, on CPU.

The same numpy-seeded inputs and weights go through the echr_tpu function
and its echr_tpu_torch counterpart.  Tolerance atol 1e-5: both sides run
f32 on the CPU and differ only in the order of sums (and in ulp-level
differences of exp/tanh/sigmoid between the two libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echr_tpu.config import flagship_config
from echr_tpu.models.registry import init_tap as jax_init_tap
from echr_tpu.models.sst import sst_forward as jax_sst_forward
from echr_tpu.models.sst import sst_forward_batched as jax_sst_forward_batched
from echr_tpu.ops import core as jcore
from echr_tpu.ops import masked as jmasked
from echr_tpu.ops import recurrent as jrec

from echr_tpu_torch.bridge import tap_from_jax
from echr_tpu_torch.models.sst import sst_forward, sst_forward_batched
from echr_tpu_torch.ops import core, masked, recurrent

ATOL = 1e-5
# bf16 compute: a 1-ulp f32 difference that lands on a bf16 rounding
# boundary moves that operand by one bf16 ulp (2^-8 relative), and the
# recurrence carries it on
ATOL_BF16 = 2e-4


@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values; the port's parameters are
    trainable, so run without recording gradients."""
    with torch.no_grad():
        yield


def small_cfg(**over):
    """tiny widths, with a 128-wide attention hidden and a 128-frame bucket
    so that the JAX side takes its (interpret-mode) Pallas score kernel."""
    cfg = flagship_config()
    cfg = cfg.replace_in("data", lda_dim=16, time_buckets=(128,))
    cfg = cfg.replace_in("tap", video_dim=24, hidden_dim=32, K=32, rnn_num_layers=2)
    cfg = cfg.replace_in("fusion", n_head=4, d_feats=32, d_o=32)
    cfg = cfg.replace_in("decoder", CG_rnn_size=32, CG_input_encoding_size=32,
                         CG_att_hid_size=128, CG_vocab_size=50, CG_seq_length=8)
    cfg = cfg.replace_in("runtime", compute_dtype="float32")
    for k, v in over.items():
        section, name = k.split(".")
        cfg = cfg.replace_in(section, **{name: v})
    return cfg.validate()


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def T(x):
    return torch.from_numpy(np.asarray(x))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def _dense_pair(r, din, dout):
    w = (r.randn(din, dout) * 0.3).astype(np.float32)
    b = (r.randn(dout) * 0.1).astype(np.float32)
    d = core.Dense(din, dout)
    with torch.no_grad():
        d.weight.copy_(T(w.T))
        d.bias.copy_(T(b))
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense(dtype):
    r = np.random.RandomState(0)
    jp, d = _dense_pair(r, 40, 24)
    x = (r.randn(3, 5, 40)).astype(np.float32)
    want = jcore.dense(jcore.cast_compute_dtype(jp, dtype), jnp.asarray(x))
    got = core.dense(core.cast_compute_dtype(d, dtype), T(x), core.compute_dtype(dtype))
    assert got.dtype == torch.float32
    close(got, want)


def test_cast_compute_dtype_keeps_biases_f32():
    d = core.Dense(8, 4)
    d.init_uniform(torch.Generator().manual_seed(0))
    c = core.cast_compute_dtype(d, "bfloat16")
    assert torch.equal(c.bias, d.bias)
    assert torch.equal(c.weight, d.weight.to(torch.bfloat16).float())
    assert core.cast_compute_dtype(d, "float32") is d


def test_masked_softmax_fully_masked_row():
    r = np.random.RandomState(1)
    x = r.randn(2, 6, 9).astype(np.float32)
    m = (r.rand(2, 6, 9) > 0.5).astype(np.float32)
    m[0, 2] = 0.0
    got = masked.masked_softmax(T(x), T(m))
    close(got, jmasked.masked_softmax(jnp.asarray(x), jnp.asarray(m)))
    assert torch.all(got[0, 2] == 0)


def test_masked_mean():
    r = np.random.RandomState(2)
    x = r.randn(3, 10, 7).astype(np.float32)
    fm = (r.rand(3, 10) > 0.3).astype(np.float32)
    got = masked.masked_mean(T(x), T(fm), dim=1)
    for b in range(3):
        close(got[b], jmasked.masked_mean(jnp.asarray(x[b]), jnp.asarray(fm[b]), axis=0))


def _windows(r, B, N, T_):
    s = r.randint(0, T_ - 2, size=(B, N))
    e = np.minimum(s + r.randint(1, 12, size=(B, N)), T_)
    return np.stack([s, e], -1).astype(np.int32)


def test_segment_ops():
    r = np.random.RandomState(3)
    B, N, T_, D = 2, 8, 20, 5
    soi = _windows(r, B, N, T_)
    feats = r.randn(B, T_, D).astype(np.float32)
    pm = (r.rand(B, N) > 0.3).astype(np.float32)
    wm = masked.segment_window_mask(T(soi), T_)
    sm = masked.segment_mean(T(feats), T(soi))
    wp = masked.window_mean_padded(T(feats), T(soi), T(pm))
    for b in range(B):
        close(wm[b], jmasked.segment_window_mask(jnp.asarray(soi[b]), T_))
        close(sm[b], jmasked.segment_mean(jnp.asarray(feats[b]), jnp.asarray(soi[b])))
        close(wp[b], jmasked.window_mean_padded(jnp.asarray(feats[b]), jnp.asarray(soi[b]),
                                                jnp.asarray(pm[b])))


def _cell_pair(r, din, H):
    p = {k: (r.randn(*s) * 0.3).astype(np.float32) for k, s in
         (("w_ih", (din, 4 * H)), ("w_hh", (H, 4 * H)), ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))}
    c = recurrent.LSTMCell(din, H)
    with torch.no_grad():
        c.weight_ih.copy_(T(p["w_ih"].T))
        c.weight_hh.copy_(T(p["w_hh"].T))
        c.bias_ih.copy_(T(p["b_ih"]))
        c.bias_hh.copy_(T(p["b_hh"]))
    return {k: jnp.asarray(v) for k, v in p.items()}, c


def test_lstm_cell_and_pre():
    r = np.random.RandomState(4)
    jp, c = _cell_pair(r, 12, 8)
    x, h, cc = (r.randn(5, n).astype(np.float32) for n in (12, 8, 8))
    h1, c1 = recurrent.lstm_cell(c, T(x), T(h), T(cc))
    jh, jc = jrec.lstm_cell(jp, jnp.asarray(x), jnp.asarray(h), jnp.asarray(cc))
    close(h1, jh)
    close(c1, jc)
    pre = recurrent.lstm_input_proj(c, T(x), with_bias=True)
    close(pre, jrec.lstm_input_proj(jp, jnp.asarray(x), with_bias=True))
    h2, c2 = recurrent.lstm_cell_pre(c, pre, T(h), T(cc))
    close(h2, jh)
    close(c2, jc)


def test_lstm_stack():
    r = np.random.RandomState(5)
    jp0, c0 = _cell_pair(r, 6, 8)
    jp1, c1 = _cell_pair(r, 8, 8)
    xs = r.randn(11, 3, 6).astype(np.float32)
    hs, finals = recurrent.lstm_stack([c0, c1], T(xs))
    jhs, jfinals = jrec.lstm_stack([jp0, jp1], jnp.asarray(xs))
    close(hs, jhs)
    for (h, c), (jh, jc) in zip(finals, jfinals):
        close(h, jh)
        close(c, jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sst_forward(dtype):
    cfg = small_cfg(**{"runtime.compute_dtype": dtype})
    jparams = jax_init_tap(jax.random.PRNGKey(0), cfg)
    sst = core.cast_compute_dtype(tap_from_jax(to_np(jparams), cfg), dtype)
    jcast = jcore.cast_compute_dtype(jparams, dtype)
    r = np.random.RandomState(6)
    feats = (r.randn(3, 40, cfg.tap.video_dim) * 0.5).astype(np.float32)
    atol = ATOL if dtype == "float32" else ATOL_BF16
    th, sc = sst_forward_batched(sst, T(feats), core.compute_dtype(dtype))
    jth, jsc = jax_sst_forward_batched(jcast, jnp.asarray(feats))
    close(th, jth, atol)
    close(sc, jsc, atol)
    th1, sc1 = sst_forward(sst, T(feats[1]), core.compute_dtype(dtype))
    jth1, jsc1 = jax_sst_forward(jcast, jnp.asarray(feats[1]))
    close(th1, jth1, atol)
    close(sc1, jsc1, atol)
