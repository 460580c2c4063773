"""The two decode switches the port takes from echr_tpu, on the CPU:
``runtime.decode_early_exit`` (the per-video decode and beam loop: the
video's early exit, or the fixed-L loop) and ``runtime.use_pallas_head``
(False: greedy decode without kernel 2, kernel 1 still on).

tests/test_decode_early_exit.py's setup (flagship widths cut to a 50-word
vocab, 12 steps, 64 frames, 8 proposals, f32) goes through both packages
on the same numpy weights and SST-like features: each loop form of
the port equals the other, and echr_tpu's, in its cases (no caption
ending, every caption ending at step 1, padded proposals, beam 3).
Tolerances: tokens and active equal, logps within 1e-6 (test_decode_early
_exit's gate); against echr_tpu the logps within 5e-4 (the port's parity
gate); kernel 2 off leaves the tokens equal and the logps within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

from echr_tpu import config as jconfig
from echr_tpu.models.beam import beam_search as jax_beam_search
from echr_tpu.models.captioner import ProposalBatch as JProps
from echr_tpu.models.captioner import captioner_sample as jax_captioner_sample
from echr_tpu.models.captioner import make_contexts as jax_make_contexts
from echr_tpu.models.registry import init_captioner

from echr_tpu_torch import config
from echr_tpu_torch.bridge import captioner_from_jax
from echr_tpu_torch.engine import steps
from echr_tpu_torch.models import decoder
from echr_tpu_torch.models.captioner import ProposalBatch
from echr_tpu_torch.ops import attention as attention_mod

TOL, JTOL = 1e-6, 5e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfig.flagship_config().replace_in(
        "data", synthetic=True, lda_dim=100, time_buckets=(64,))
    jcfg = jcfg.replace_in("decoder", CG_vocab_size=50, CG_seq_length=12)
    jcfg = jcfg.replace_in("runtime", compute_dtype="float32", use_pallas=False).validate()
    T, N = 64, 8
    r = np.random.RandomState(0)
    # echr_tpu's captioner tree, each leaf uniform within 1/sqrt(its fan-in)
    shapes = jax.eval_shape(lambda k: init_captioner(k, jcfg), jax.random.PRNGKey(1))
    cg = jax.tree.map(lambda x: (r.uniform(-1.0, 1.0, x.shape) / np.sqrt(
        x.shape[-2] if len(x.shape) > 1 else x.shape[0])).astype(np.float32), shapes)
    feats = r.randn(T, jcfg.tap.video_dim).astype(np.float32)
    lda = r.randn(jcfg.data.lda_dim).astype(np.float32)
    starts = r.randint(0, T - 8, size=N)
    soi = np.stack([starts, np.minimum(starts + r.randint(2, 10, size=N), T)], 1).astype(np.int32)
    tap_feats = np.tanh(r.randn(T, jcfg.tap.hidden_dim)).astype(np.float32)  # SST-like features
    return jcfg, cg, tap_feats, feats, lda, soi


def _biased(cg, bias, vocab=51):
    cg = jax.tree.map(np.array, cg)
    b = np.zeros(vocab, np.float32)
    b[0] = bias
    cg["decoder"]["logit"]["b"] = b
    return cg


def _pm(n, pad):
    pm = np.ones(n, np.float32)
    if pad:
        pm[-3:] = 0.0
    return pm


def _port(setup, cg_np, pad=False, **runtime):
    jcfg, _, tap_feats, feats, lda, soi = setup
    cfg = config.Config.from_json(jcfg.to_json()).replace_in("runtime", **runtime)
    cg = captioner_from_jax(cg_np, cfg)
    props = ProposalBatch(torch.from_numpy(soi[:, 1] - 1), torch.from_numpy(soi),
                          torch.from_numpy(_pm(len(soi), pad)))
    args = (cg, cfg, torch.from_numpy(tap_feats), torch.from_numpy(feats),
            torch.from_numpy(lda), torch.ones(feats.shape[0]), props)
    return cfg, args


def _jax(setup, cg_np, pad=False, **runtime):
    jcfg, _, tap_feats, feats, lda, soi = setup
    jcfg = jcfg.replace_in("runtime", **runtime)
    props = JProps(jnp.asarray(soi[:, 1] - 1), jnp.asarray(soi), jnp.asarray(_pm(len(soi), pad)))
    cg = jax.tree.map(jnp.asarray, cg_np)
    return jcfg, cg, props


@pytest.mark.parametrize("eos_bias", [0.0, 5.0])
@pytest.mark.parametrize("greedy", [True, False])
def test_decode_loops_equal(setup, greedy, eos_bias):
    """steps.decode_step (the per-video decode) with decode_early_exit True
    and False: equal seq and active, logps within 1e-6; the exit fires with
    the end token's bias and the fixed loop takes no host sync.  Greedy,
    both equal echr_tpu's decode (its while loop, which
    tests/test_decode_early_exit.py holds equal to its scan)."""
    cg_np = _biased(setup[1], eos_bias)
    outs = []
    for early in (True, False):
        _, args = _port(setup, cg_np, decode_early_exit=early)
        syncs = decoder.decoder_sample_batched.host_syncs
        outs.append([x.numpy() for x in steps.decode_step(
            *args, greedy=greedy, sample_gen=torch.Generator().manual_seed(3))])
        outs[-1].append(decoder.decoder_sample_batched.host_syncs - syncs)
    (s1, l1, a1, n1), (s2, l2, a2, n2) = outs
    assert np.array_equal(s1, s2) and np.array_equal(a1, a2) and n2 == 0 < n1
    np.testing.assert_allclose(l1, l2, atol=TOL, rtol=0)
    if eos_bias:
        assert a1.sum() < setup[0].decoder.CG_seq_length  # the exit fired
    if not greedy:
        return
    jcfg, cg_j, props = _jax(setup, cg_np)
    js, jl, ja = jax.jit(lambda cg, props: jax_captioner_sample(
        cg, jcfg, jnp.asarray(setup[2]), jnp.asarray(setup[3]), jnp.asarray(setup[4]), props,
        frame_mask=jnp.ones((setup[3].shape[0],)), greedy=True))(cg_j, props)
    np.testing.assert_array_equal(s1, np.asarray(js))
    np.testing.assert_array_equal(a1, np.asarray(ja))
    np.testing.assert_allclose(l1, np.asarray(jl), atol=JTOL, rtol=0)


@pytest.mark.parametrize("case", ["no_bias", "eos_bias", "padded"])
def test_beam_loops_equal(setup, case):
    """steps.beam_decode_step (the per-video beam, k = 3) with
    decode_early_exit True and False: equal tokens, logprobs within 1e-6,
    and padded proposals zeroed by both; with padding, both equal
    echr_tpu's beam_search (test_decode_early_exit.py holds its loops
    equal)."""
    cg_np = _biased(setup[1], 0.0 if case == "no_bias" else 5.0)
    pad = case == "padded"
    got = []
    for early in (True, False):
        _, args = _port(setup, cg_np, pad=pad, decode_early_exit=early)
        got.append([x.numpy() for x in steps.beam_decode_step(*args, beam_size=3)])
    (s1, l1), (s2, l2) = got
    assert np.array_equal(s1, s2)
    np.testing.assert_allclose(l1, l2, atol=TOL, rtol=0)
    if not pad:
        return
    assert not s1[-3:].any() and not l1[-3:].any()
    jcfg, cg_j, props = _jax(setup, cg_np, pad=pad)

    def beam(cg, props):
        ctxs = jax_make_contexts(cg, jcfg, jnp.asarray(setup[2]), jnp.asarray(setup[3]),
                                 jnp.asarray(setup[4]), props,
                                 frame_mask=jnp.ones((setup[3].shape[0],)), train=False)
        res = jax_beam_search(cg["decoder"], jcfg, ctxs, 3)
        return res.seq, res.logprob

    jseq, jlogprob = jax.jit(beam)(cg_j, props)
    np.testing.assert_array_equal(s1, np.asarray(jseq))
    np.testing.assert_allclose(l1, np.asarray(jlogprob), atol=JTOL, rtol=0)


def test_use_pallas_head_off_keeps_kernel_1(setup, monkeypatch):
    """Greedy decode with use_pallas_head False: kernel 2's wrapper is not
    called, kernel 1's is called as often as with it on, and the tokens and
    logps are the head's."""
    calls = {"greedy_head": 0, "attention_scores_masked": 0}

    def counting(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    counting(decoder, "greedy_head")
    counting(attention_mod, "attention_scores_masked")
    got = {}
    for head in (True, False):
        for k in calls:
            calls[k] = 0
        _, args = _port(setup, setup[1], use_pallas=True, use_pallas_head=head)
        got[head] = ([x.numpy() for x in steps.decode_step(*args)], dict(calls))
    (on, on_calls), (off, off_calls) = got[True], got[False]
    assert on_calls["greedy_head"] > 0 and off_calls["greedy_head"] == 0
    assert off_calls["attention_scores_masked"] == on_calls["attention_scores_masked"] > 0
    assert np.array_equal(on[0], off[0]) and np.array_equal(on[2], off[2])
    np.testing.assert_allclose(on[1], off[1], atol=TOL, rtol=0)


def test_switches_round_trip_json_and_cli():
    """decode_early_exit, use_pallas_head and scst_resident_vjp go both
    ways through the JSON and parse from echr_tpu's flags as echr_tpu's
    parser reads them."""
    kw = {"decode_early_exit": False, "use_pallas_head": False, "scst_resident_vjp": True}
    port = config.Config().replace_in("runtime", **kw)
    back = jconfig.Config.from_json(port.to_json())
    assert {k: getattr(back.runtime, k) for k in kw} == kw
    j = jconfig.Config().replace_in("runtime", **kw)
    assert {k: getattr(config.Config.from_json(j.to_json()).runtime, k) for k in kw} == kw
    argv = ["--decode_early_exit", "0", "--use_pallas_head", "0", "--scst_resident_vjp", "1"]
    got, want = config.parse_config(argv).runtime, jconfig.parse_config(argv).runtime
    assert {k: getattr(got, k) for k in kw} == {k: getattr(want, k) for k in kw} == kw
    defaults = {f.name: f.default for f in dataclasses.fields(config.RuntimeConfig)}
    assert {k: defaults[k] for k in kw} == {"decode_early_exit": True, "use_pallas_head": True,
                                            "scst_resident_vjp": False}
