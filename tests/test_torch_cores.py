"""The decoder family: every core of echr_tpu's CORE_REGISTRY but
three_stream (tests/test_torch_serve.py, tests/test_torch_train.py) in the
port against echr_tpu, on the CPU at f32.

The same numpy-seeded contexts go through both decoders; the JAX params
come from echr_tpu.models.registry and reach the port through
bridge.captioner_from_jax.  The JAX side runs its plain jnp path
(runtime.use_pallas and use_pallas_train off), the port its kernel route,
which on the CPU takes the kernels' plain versions, and its window sort;
one case (show_attend_tell at Hatt = 128 in a 128-frame bucket) runs
echr_tpu's Pallas kernels in interpret mode, as echr_tpu's own tests do.

Greedy tokens must be exact, so the logit weights are sharpened (scaled
up) until every argmax margin dwarfs f32 reassociation noise; the decode
test asserts the smallest top-2 margin it relied on.  Tolerances: the
teacher-forced logprobs and the greedy logps within atol 5e-4, the fused
teacher-forced NLL within 1e-5 relative (f32 sums in another order); the
bridge round trip is bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_ops import small_cfg, to_np

from echr_tpu.config import flagship_config
from echr_tpu.models import decoder as jdec
from echr_tpu.models.contexts import Contexts as JaxContexts
from echr_tpu.models.registry import available_caption_models as jax_available
from echr_tpu.models.registry import init_captioner as jax_init_captioner

import echr_tpu_torch.models.decoder as decoder
from echr_tpu_torch.bridge import captioner_from_jax, captioner_to_jax
from echr_tpu_torch.models.contexts import Contexts
from echr_tpu_torch.models.registry import available_caption_models
from echr_tpu_torch.ops.kernel_head import greedy_head_plain

TOL = 5e-4
REL = 1e-5
SHARPEN = 400.0  # the greedy tests' logit weight scale: margins >> f32 noise
MIN_MARGIN = 1e-3
CORES = sorted(set(jdec.CORE_REGISTRY) - {"three_stream"})
# the cores whose state some configs initialise from contexts (init_linear of
# core_num_layers * H), and the feature types they take
FEATS = {"show_attend_tell": ("V+E+C", "V+E"), "all_img": ("V+E+C", "V+E+C"),
         "h3": ("", "E"), "two_stream_3lstm": ("", "V+E"),
         "three_stream_2stream_CC": ("", "V+E+C")}


@pytest.fixture(autouse=True)
def _forward_only():
    with torch.no_grad():
        yield


def core_cfg(model, base=None):
    """tests/test_parity_variants.py's widths cut further (H = E = Hatt =
    32, vocab 100, 8 steps), with the core swapped; CG_num_layers 2 as
    there and in tests/test_decoder_variants.py."""
    c = base or flagship_config().replace_in(
        "tap", video_dim=24, hidden_dim=32).replace_in(
        "fusion", n_head=4, d_feats=32, d_o=32).replace_in(
        "data", lda_dim=16).replace_in(
        "decoder", CG_rnn_size=32, CG_input_encoding_size=32, CG_att_hid_size=32,
        CG_vocab_size=100, CG_seq_length=8)
    c = c.replace_in("decoder", caption_model=model,
                     CG_num_layers=3 if model == "three_stream" else 2)
    inputs, init = FEATS.get(model, ("", ""))
    c = c.replace_in("context", CG_input_feats_type=inputs, CG_init_feats_type=init)
    return c.validate()


def jax_cfg(cfg):
    return cfg.replace_in("runtime", use_pallas=False, use_pallas_train=False)


def contexts(cfg, B=2, N=8, T=40, seed=0):
    """Random contexts of B videos (numpy): windows of 1-24 frames, video 1
    with 2 padding proposals."""
    r = np.random.RandomState(seed)
    s = r.randint(0, T - 4, size=(B, N))
    e = np.minimum(s + r.randint(1, 24, size=(B, N)), T)
    mask = ((np.arange(T) >= s[..., None]) & (np.arange(T) < e[..., None])).astype(np.float32)
    pm = np.ones((B, N), np.float32)
    pm[1, -2:] = 0.0
    mask[1, -2:] = 0.0
    mask[1, -2:, 0] = 1.0  # a padding proposal's [0, 1) window
    return dict(video=r.randn(B, cfg.video_context_dim).astype(np.float32),
                event=np.tanh(r.randn(B, N, cfg.event_context_dim)).astype(np.float32),
                clip_feats=(r.randn(B, T, cfg.clip_context_dim) * 0.5).astype(np.float32),
                clip_mask=mask, prop_mask=pm)


def labels(cfg, B=2, N=8, seed=1):
    """Captions [B, N, L+1] (column 0 BOS) of random lengths, and masks."""
    r = np.random.RandomState(seed)
    L = cfg.decoder.CG_seq_length
    seq = r.randint(1, cfg.decoder.CG_vocab_size + 1, size=(B, N, L + 1)).astype(np.int32)
    lens = r.randint(2, L + 1, size=(B, N))
    pos = np.arange(L + 1)
    seq[pos >= lens[..., None]] = 0
    seq[..., 0] = 0
    masks = (pos <= lens[..., None]).astype(np.float32)
    return seq, masks


def jax_params(cfg, seed=0):
    return to_np(jax_init_captioner(jax.random.PRNGKey(seed), cfg))


def sharpened(params, scale=SHARPEN):
    d = params["decoder"]
    return {**params, "decoder": {**d, "logit": {**d["logit"], "w": d["logit"]["w"] * scale}}}


def jax_outputs(cfg, params, ctx, seq, masks):
    """echr_tpu's teacher-forced logprobs [B, N, L, V+1] and NLL [B]
    (train=True, rng=None: the training routes without dropout), and its
    batched greedy decode (seq, logps, active) on the sharpened weights."""
    jcfg = jax_cfg(cfg)

    @jax.jit
    def run(params, sharp, ctx, seq, masks):
        def one(c, s, m):
            return (jdec.decoder_forward(params, jcfg, c, s, train=True),
                    jdec.teacher_forced_nll(params, jcfg, c, s, m, train=True))
        lp, nll = jax.vmap(one)(ctx, seq, masks)
        return lp, nll, jdec.decoder_sample_batched(sharp, jcfg, ctx, greedy=True)

    out = run(params["decoder"], sharpened(params)["decoder"],
              JaxContexts(**{k: jnp.asarray(v) for k, v in ctx.items()}),
              jnp.asarray(seq), jnp.asarray(masks))
    return jax.tree.map(np.asarray, out)


def port_contexts(ctx):
    return Contexts(**{k: torch.from_numpy(v) for k, v in ctx.items()})


_CACHE = {}


def case(model):
    """(cfg, JAX params, contexts, labels, JAX outputs) of one core, made
    once per module."""
    if model not in _CACHE:
        cfg = core_cfg(model)
        params = jax_params(cfg)
        ctx = contexts(cfg)
        seq, masks = labels(cfg)
        _CACHE[model] = (cfg, params, ctx, seq, masks,
                         jax_outputs(cfg, params, ctx, seq, masks))
    return _CACHE[model]


def recording_greedy(monkeypatch):
    """Patch decoder.greedy_head with its plain version that records each
    call's smallest top-2 logit margin."""
    margins = []

    def head(out, w, b):
        logits = torch.matmul(out.to(w.dtype).float(), w.float().t()) + b
        top2 = torch.topk(logits, 2, dim=1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return greedy_head_plain(out, w, b)

    monkeypatch.setattr(decoder, "greedy_head", head)
    return margins


@pytest.mark.parametrize("model", CORES)
def test_teacher_forced_logprobs_match_jax(model):
    cfg, params, ctx, seq, _, (want, _, _) = case(model)
    cg = captioner_from_jax(params, cfg)
    got = decoder.decoder_forward(cg.decoder, cfg, port_contexts(ctx), torch.from_numpy(seq),
                                  train=True, gen=None)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("model", CORES)
def test_teacher_forced_nll_matches_jax(model):
    cfg, params, ctx, seq, masks, (_, want, _) = case(model)
    cg = captioner_from_jax(params, cfg)
    got = decoder.teacher_forced_nll(cg.decoder, cfg, port_contexts(ctx), torch.from_numpy(seq),
                                     torch.from_numpy(masks), train=True, gen=None)
    np.testing.assert_allclose(got.numpy(), want, rtol=REL)


@pytest.mark.parametrize("model", CORES)
def test_greedy_decode_matches_jax(model, monkeypatch):
    cfg, params, ctx, _, _, (_, _, (jseq, jlogps, jactive)) = case(model)
    cg = captioner_from_jax(sharpened(params), cfg)
    margins = recording_greedy(monkeypatch)
    seq, logps, active = decoder.decoder_sample_batched(cg.decoder, cfg, port_contexts(ctx))
    assert margins and min(margins) > MIN_MARGIN, min(margins)
    np.testing.assert_array_equal(seq.numpy(), jseq)
    np.testing.assert_array_equal(active.numpy(), jactive)
    np.testing.assert_allclose(logps.numpy(), jlogps, atol=TOL, rtol=0)
    assert jseq.any()  # real tokens, not an all-EOS decode


@pytest.mark.parametrize("model", CORES)
def test_bridge_round_trip_is_exact(model):
    cfg = core_cfg(model)
    tree = to_np(jax_init_captioner(jax.random.PRNGKey(3), cfg))
    back = captioner_to_jax(captioner_from_jax(tree, cfg), cfg)
    flat, tdef = jax.tree_util.tree_flatten_with_path(tree)
    assert jax.tree_util.tree_structure(back) == tdef
    for (path, want), got in zip(flat, jax.tree_util.tree_leaves(back)):
        assert got.dtype == want.dtype and np.array_equal(got, want), \
            jax.tree_util.keystr(path)


def test_available_caption_models_match_jax():
    assert available_caption_models() == jax_available() == sorted(jdec.CORE_REGISTRY)
    assert sorted(decoder.CORE_REGISTRY) == sorted(jdec.CORE_REGISTRY)
    for model in jdec.CORE_REGISTRY:
        cfg = core_cfg(model)
        assert decoder.core_num_layers(cfg) == jdec.core_num_layers(cfg), model
        assert decoder._logit_input_size(cfg) == jdec._logit_input_size(cfg), model


def test_show_attend_tell_against_jax_pallas_kernels(monkeypatch):
    """show_attend_tell at Hatt = 128 over a 128-frame bucket: echr_tpu
    takes its Pallas score kernels in interpret mode (greedy decode with
    its window sort, and the differentiable kernel under teacher forcing),
    the port its kernel route."""
    cfg = core_cfg("show_attend_tell", base=small_cfg(**{"decoder.CG_vocab_size": 100}))
    params = sharpened(jax_params(cfg, seed=4))
    ctx = contexts(cfg, T=128, seed=4)
    seq, masks = labels(cfg, seed=5)
    jctx = JaxContexts(**{k: jnp.asarray(v) for k, v in ctx.items()})
    jd = jax.tree.map(jnp.asarray, params["decoder"])
    jseq, jlogps, jactive = jax.tree.map(
        np.asarray, jax.jit(lambda p, c: jdec.decoder_sample_batched(p, cfg, c))(jd, jctx))
    jnll = np.asarray(jax.jit(jax.vmap(
        lambda c, s, m: jdec.teacher_forced_nll(jd, cfg, c, s, m, train=True)))(
        jctx, jnp.asarray(seq), jnp.asarray(masks)))
    cg = captioner_from_jax(params, cfg)
    margins = recording_greedy(monkeypatch)
    ctxs = port_contexts(ctx)
    got_seq, got_logps, got_active = decoder.decoder_sample_batched(cg.decoder, cfg, ctxs)
    assert margins and min(margins) > MIN_MARGIN, min(margins)
    np.testing.assert_array_equal(got_seq.numpy(), jseq)
    np.testing.assert_array_equal(got_active.numpy(), jactive)
    np.testing.assert_allclose(got_logps.numpy(), jlogps, atol=TOL, rtol=0)
    nll = decoder.teacher_forced_nll(cg.decoder, cfg, ctxs, torch.from_numpy(seq),
                                     torch.from_numpy(masks), train=True, gen=None)
    np.testing.assert_allclose(nll.numpy(), jnll, rtol=REL)
