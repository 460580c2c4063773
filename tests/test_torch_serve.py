"""The port's slice against the JAX package, on CPU at f32: batched greedy
decode, the caption service, and loading a JAX format-v2 checkpoint.

Greedy tokens must be exact, so the logit weights are sharpened (scaled
up) until every argmax margin dwarfs f32 reassociation noise; the decode
test asserts the smallest top-2 margin it relied on.  Per-step logps
within 5e-4.
"""
import pickle

import jax
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_ops import small_cfg, to_np

from echr_tpu.engine import steps as jsteps
from echr_tpu.models.captioner import ProposalBatch as JaxProposalBatch
from echr_tpu.models.registry import init_captioner as jax_init_captioner
from echr_tpu.models.registry import init_tap as jax_init_tap

import echr_tpu_torch.models.decoder as decoder
from echr_tpu_torch.bridge import captioner_from_jax, tap_from_jax
from echr_tpu_torch.engine.steps import decode_step_batched
from echr_tpu_torch.models.captioner import ProposalBatch
from echr_tpu_torch.ops.kernel_head import greedy_head_plain
from echr_tpu_torch.serve import CaptionRequest, CaptionService, from_checkpoint

TOL = 5e-4
SHARPEN = 100.0  # logit weight scale: margins >> f32 noise
MIN_MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values; the port's parameters are
    trainable, so run without recording gradients."""
    with torch.no_grad():
        yield


def _params(cfg, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tap = to_np(jax_init_tap(k1, cfg))
    cg = to_np(jax_init_captioner(k2, cfg))
    cg["decoder"]["logit"]["w"] = cg["decoder"]["logit"]["w"] * SHARPEN
    return tap, cg


def _decode_inputs(cfg, B=3, N=16, T=128, seed=0):
    r = np.random.RandomState(seed)
    feats = (r.randn(B, T, cfg.tap.video_dim) * 0.5).astype(np.float32)
    tap_feats = np.tanh(r.randn(B, T, cfg.tap.hidden_dim)).astype(np.float32)
    lda = r.randn(B, cfg.data.lda_dim).astype(np.float32)
    fm = np.ones((B, T), np.float32)
    fm[2, 90:] = 0.0
    s = r.randint(0, 80, size=(B, N))
    e = np.minimum(s + r.randint(4, 48, size=(B, N)), T)
    soi = np.stack([s, e], -1).astype(np.int32)
    pm = np.ones((B, N), np.float32)
    pm[1, 10:] = 0.0
    return feats, tap_feats, lda, fm, (e - 1).astype(np.int32), soi, pm


def test_decode_step_batched_matches_jax(monkeypatch):
    cfg = small_cfg()
    tap, cg_np = _params(cfg)
    feats, tap_feats, lda, fm, ind, soi, pm = _decode_inputs(cfg)
    jseq, jlogps, jactive = jsteps.decode_step_batched(
        cg_np, cfg, tap_feats, feats, lda, fm, JaxProposalBatch(ind, soi, pm))

    margins = []

    def recording_head(out, w, b):
        logits = torch.matmul(out.to(w.dtype).float(), w.float().t()) + b
        top2 = torch.topk(logits, 2, dim=1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return greedy_head_plain(out, w, b)

    monkeypatch.setattr(decoder, "greedy_head", recording_head)
    cg = captioner_from_jax(cg_np, cfg)
    seq, logps, active = decode_step_batched(
        cg, cfg, *(torch.from_numpy(x) for x in (tap_feats, feats, lda, fm)),
        ProposalBatch(*(torch.from_numpy(x) for x in (ind, soi, pm))))
    assert margins and min(margins) > MIN_MARGIN, min(margins)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    np.testing.assert_allclose(logps.numpy(), np.asarray(jlogps), atol=TOL, rtol=0)
    assert np.asarray(jseq).any()  # real tokens, not an all-EOS decode


@pytest.mark.parametrize("init_feats", ["", "VEC"])
def test_step_logits_matches_jax(init_feats):
    """One decode step from contexts: precompute_attention, init_state (with
    and without init_linear) and step_logits against the JAX decoder."""
    import jax.numpy as jnp

    from echr_tpu.models import contexts as jcontexts
    from echr_tpu.models import decoder as jdec

    from echr_tpu_torch.models import contexts

    cfg = small_cfg(**{"context.CG_init_feats_type": init_feats})
    _, cg_np = _params(cfg, seed=5)
    cg = captioner_from_jax(cg_np, cfg)
    feats, tap_feats, lda, fm, ind, soi, pm = (x[2:] for x in _decode_inputs(cfg, seed=5))
    ctxs = contexts.build_contexts(cg.fusion, cfg, *(torch.from_numpy(x) for x in
                                                     (tap_feats, feats, lda, ind, soi, pm, fm)))
    jctxs = jcontexts.build_contexts(cg_np.get("fusion"), cfg,
                                     *(jnp.asarray(x[0]) for x in
                                       (tap_feats, feats, lda, ind, soi, pm)),
                                     frame_mask=jnp.asarray(fm[0]))
    N = pm.shape[1]
    it = np.random.RandomState(5).randint(0, cfg.decoder.CG_vocab_size + 1, size=(1, N))
    pre = decoder.precompute_attention(cg.decoder, cfg, ctxs)
    state = decoder.init_state(cg.decoder, cfg, ctxs, N)
    logits, state2 = decoder.step_logits(cg.decoder, cfg, torch.from_numpy(it), ctxs, pre, state)
    jd = cg_np["decoder"]
    jpre = jdec.precompute_attention(jd, cfg, jctxs)
    jstate = jdec.init_state(jd, cfg, jctxs, N)
    jlogits, jstate2 = jdec.step_logits(jd, cfg, jnp.asarray(it[0]), jctxs, jpre, jstate)
    np.testing.assert_allclose(pre.att[0].numpy(), np.asarray(jpre["att"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(state.h[:, 0].numpy(), np.asarray(jstate.h), atol=1e-4, rtol=0)
    np.testing.assert_allclose(state2.h[:, 0].numpy(), np.asarray(jstate2.h), atol=1e-4, rtol=0)
    np.testing.assert_allclose(state2.c[:, 0].numpy(), np.asarray(jstate2.c), atol=1e-4, rtol=0)
    # sharpened logit weights: logits of magnitude ~10^2, f32 relative noise
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(jlogits), atol=1e-3, rtol=1e-5)


def test_decode_sort_is_exact():
    """With the window sort (kernel route) and without it (eager scores)
    the decode gives the same tokens."""
    cfg = small_cfg()
    _, cg_np = _params(cfg)
    cg = captioner_from_jax(cg_np, cfg)
    feats, tap_feats, lda, fm, ind, soi, pm = _decode_inputs(cfg, seed=1)
    args = [torch.from_numpy(x) for x in (tap_feats, feats, lda, fm)]
    props = ProposalBatch(*(torch.from_numpy(x) for x in (ind, soi, pm)))
    steps0 = decoder.decoder_sample_batched.steps
    seq_k, lp_k, _ = decode_step_batched(cg, cfg, *args, props)
    ran = decoder.decoder_sample_batched.steps - steps0
    assert 1 <= ran <= cfg.decoder.CG_seq_length
    eager = cfg.replace_in("runtime", use_pallas=False)
    seq_e, lp_e, _ = decode_step_batched(cg, eager, *args, props)
    np.testing.assert_array_equal(seq_k.numpy(), seq_e.numpy())
    np.testing.assert_allclose(lp_k.numpy(), lp_e.numpy(), atol=TOL, rtol=0)


def _requests(cfg, n=5, seed=0):
    r = np.random.RandomState(seed)
    return [CaptionRequest(vid=f"v{i}", feats=(r.randn(70 + 20 * i, cfg.tap.video_dim)
                                               * 0.5).astype(np.float32),
                           duration=30.0 + i, lda=r.randn(cfg.data.lda_dim).astype(np.float32))
            for i in range(n)]


def _vocab(cfg):
    return {str(i): f"w{i}" for i in range(1, cfg.decoder.CG_vocab_size + 1)}


def _assert_same_captions(got, want):
    assert set(got) == set(want)
    for vid in want:
        assert len(got[vid]) == len(want[vid]) > 0
        for g, w in zip(got[vid], want[vid]):
            assert g.sentence == w.sentence
            np.testing.assert_allclose(g.timestamp, w.timestamp, rtol=1e-9)
            np.testing.assert_allclose(g.proposal_score, w.proposal_score, atol=1e-5)
            np.testing.assert_allclose(g.sentence_confidence, w.sentence_confidence,
                                       atol=TOL * 10)  # a sum of <= 8 step logps


@pytest.mark.parametrize("nms", [0.0, 0.5])
def test_caption_service_matches_jax(nms):
    """Device top-N selection (nms 0) and the host NMS path (nms 0.5)."""
    from echr_tpu.serve import CaptionRequest as JaxRequest
    from echr_tpu.serve import CaptionService as JaxService

    cfg = small_cfg()
    tap, cg = _params(cfg)
    reqs = _requests(cfg)
    want = JaxService(cfg, tap, cg, _vocab(cfg), batch_videos=3, topN=12,
                      nms_threshold=nms).caption(
        [JaxRequest(r.vid, r.feats, r.duration, r.lda) for r in reqs])
    svc = CaptionService(cfg, tap_from_jax(tap, cfg), captioner_from_jax(cg, cfg),
                         _vocab(cfg), device="cpu", batch_videos=3, topN=12,
                         nms_threshold=nms)
    _assert_same_captions(svc.caption(reqs), want)


def test_caption_service_refuses_missing_cuda_and_beam():
    cfg = small_cfg()
    tap, cg = _params(cfg)
    args = (cfg, tap_from_jax(tap, cfg), captioner_from_jax(cg, cfg), _vocab(cfg))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CaptionService(*args, device="cuda")
    with pytest.raises(ValueError, match="beam_size"):
        CaptionService(*args, device="cpu", beam_size=0)


def _save_jax_checkpoint(path, cfg, tap, cg, vocab):
    from echr_tpu.engine.checkpoint import save_checkpoint
    from echr_tpu.engine.steps import init_train_state

    state = init_train_state(cfg, tap, cg)
    save_checkpoint(str(path), state, cfg, iteration=3, epoch=0, best_val_score=0.0,
                    vocab=vocab)


def test_from_checkpoint_v2_matches_jax(tmp_path):
    from echr_tpu.serve import CaptionRequest as JaxRequest
    from echr_tpu.serve import from_checkpoint as jax_from_checkpoint

    cfg = small_cfg()
    tap, cg = _params(cfg, seed=3)
    path = tmp_path / "model-last.ckpt"
    _save_jax_checkpoint(path, cfg, tap, cg, _vocab(cfg))
    reqs = _requests(cfg, n=3, seed=1)
    want = jax_from_checkpoint(str(path), batch_videos=4, topN=8).caption(
        [JaxRequest(r.vid, r.feats, r.duration, r.lda) for r in reqs])
    got = from_checkpoint(str(path), device="cpu", batch_videos=4, topN=8).caption(reqs)
    _assert_same_captions(got, want)


def test_from_checkpoint_refuses_v1(tmp_path):
    path = tmp_path / "old.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"state": {}, "config_json": small_cfg().to_json()}, f)
    with pytest.raises(ValueError, match="format_version 1"):
        from_checkpoint(str(path), device="cpu")
