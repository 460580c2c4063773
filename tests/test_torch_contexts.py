"""echr_tpu_torch TSRM, contexts and top-N proposal selection against the
JAX package, on CPU.

TSRM and build_contexts within atol 1e-4 (f32 on both sides; the relation
attention sums over N keys and d features in another order).  Proposal
selection is exact: the same indices, windows and confidences as
echr_tpu.engine.steps.select_topk_batched and the host top_proposals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_ops import small_cfg, to_np

from echr_tpu.data.labels import anchor_mask, featstamp_to_time
from echr_tpu.engine import proposals as P
from echr_tpu.engine import steps as jsteps
from echr_tpu.models import contexts as jcontexts
from echr_tpu.models import tsrm as jtsrm
from echr_tpu.models.registry import init_captioner as jax_init_captioner

from echr_tpu_torch.bridge import captioner_from_jax
from echr_tpu_torch.engine.steps import select_topk_batched, unpack_topk_selection
from echr_tpu_torch.models import contexts, tsrm

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _forward_only():
    """These tests compare forward values; the port's parameters are
    trainable, so run without recording gradients."""
    with torch.no_grad():
        yield


def _props(r, B, N, T, n_real):
    s = r.randint(0, T - 8, size=(B, N))
    e = np.minimum(s + r.randint(1, 40, size=(B, N)), T)
    soi = np.stack([s, e], -1).astype(np.int32)
    pm = np.zeros((B, N), np.float32)
    pm[:, :n_real] = 1.0
    return (e - 1).astype(np.int32), soi, pm


def test_position_embedding():
    r = np.random.RandomState(0)
    _, soi, _ = _props(r, 2, 8, 64, 8)
    got = tsrm.position_embedding(tsrm.position_matrix(torch.from_numpy(soi)), 32)
    for b in range(2):
        want = jtsrm.position_embedding(jtsrm.position_matrix(jnp.asarray(soi[b])), 32)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("fst,use_posit", [("fST0", True), ("fST1", True), ("fST2", True),
                                           ("fST3", True), ("fST0", False)])
def test_tsrm_modes(fst, use_posit):
    cfg = small_cfg(**{"fusion.fST_type": fst, "fusion.use_posit": use_posit})
    jp = jax_init_captioner(jax.random.PRNGKey(1), cfg)
    fusion = captioner_from_jax(to_np(jp), cfg).fusion
    r = np.random.RandomState(1)
    B, N = 2, 16
    _, soi, pm = _props(r, B, N, 128, 11)
    feats = r.randn(B, N, cfg.tsrm_input_dim).astype(np.float32)
    got = tsrm.tsrm_forward(fusion, torch.from_numpy(feats), torch.from_numpy(soi),
                            torch.from_numpy(pm), cfg)
    for b in range(B):
        want = jtsrm.tsrm_forward(jp["fusion"], jnp.asarray(feats[b]), jnp.asarray(soi[b]),
                                  jnp.asarray(pm[b]), cfg)
        real = pm[b] > 0  # padded rows' outputs are unspecified
        np.testing.assert_allclose(got[b].numpy()[real], np.asarray(want)[real],
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("ctx", [
    {},  # flagship: VL video, ER3 events through TSRM, CC clips
    {"context.video_context_type": "VL+VC+VH", "context.event_context_type": "EC",
     "context.clip_context_type": "CC+CH"},
])
def test_build_contexts(ctx):
    cfg = small_cfg(**ctx)
    jp = jax_init_captioner(jax.random.PRNGKey(2), cfg)
    cg = captioner_from_jax(to_np(jp), cfg)
    r = np.random.RandomState(2)
    B, N, T = 2, 16, 128
    ind, soi, pm = _props(r, B, N, T, 12)
    tap = r.randn(B, T, cfg.tap.hidden_dim).astype(np.float32)
    c3d = r.randn(B, T, cfg.tap.video_dim).astype(np.float32)
    lda = r.randn(B, cfg.data.lda_dim).astype(np.float32)
    fm = np.ones((B, T), np.float32)
    fm[1, 100:] = 0.0
    got = contexts.build_contexts(cg.fusion, cfg, *(torch.from_numpy(x) for x in
                                                     (tap, c3d, lda, ind, soi, pm, fm)))
    for b in range(B):
        want = jcontexts.build_contexts(
            jp.get("fusion"), cfg, *(jnp.asarray(x[b]) for x in (tap, c3d, lda, ind, soi, pm)),
            frame_mask=jnp.asarray(fm[b]))
        real = pm[b] > 0
        np.testing.assert_allclose(got.video[b].numpy(), np.asarray(want.video), atol=ATOL)
        np.testing.assert_allclose(got.event[b].numpy()[real], np.asarray(want.event)[real],
                                   atol=ATOL)
        np.testing.assert_allclose(got.clip_feats[b].numpy(), np.asarray(want.clip_feats),
                                   atol=ATOL)
        np.testing.assert_array_equal(got.clip_mask[b].numpy(), np.asarray(want.clip_mask))
        np.testing.assert_array_equal(got.prop_mask[b].numpy(), np.asarray(want.prop_mask))


def _host_sel(pp, nf, K, topN, thres, nb):
    ind, soi, _, _, tp = P.top_proposals(pp[:nf], anchor_mask(nf, K), None, 30.0,
                                         featstamp_to_time, val_score_thres=thres, topN=topN)
    return ind[:nb], [list(s) for s in soi[:nb]], tp[:nb]


@pytest.mark.parametrize("case", ["random", "tie_storm", "ties_past_topn"])
def test_select_topk_matches_jax_and_host(case):
    T, K, nb, topN, thres = 96, 64, 1024, 10, 0.0
    r = np.random.RandomState(3)
    pp = r.rand(4, T, K).astype(np.float32)
    nfr = np.array([96, 50, 7, 2], np.int32)
    if case == "tie_storm":
        pp[:] = 0.5
    elif case == "ties_past_topn":
        pp *= 0.5
        pp[:, 40:50, :] = 0.9
        nfr[:] = 96
        thres = 0.0
    idx, cnt, conf = select_topk_batched(torch.from_numpy(pp), torch.from_numpy(nfr),
                                         topN=topN, nb=nb, val_score_thres=thres)
    jidx, jcnt, jconf = jsteps.select_topk_batched(jnp.asarray(pp), jnp.asarray(nfr),
                                                   topN=topN, nb=nb, val_score_thres=thres)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))
    for i in range(4):
        ind, soi, ts, tp = unpack_topk_selection(idx[i].numpy(), int(cnt[i]), nb, K,
                                                 int(nfr[i]), 30.0, conf[i].numpy())
        j = jsteps.unpack_topk_selection(np.asarray(jidx)[i], int(np.asarray(jcnt)[i]), nb, K,
                                         int(nfr[i]), 30.0, featstamp_to_time,
                                         np.asarray(jconf)[i])
        assert (ind, soi, ts, tp) == tuple(j)
        h_ind, h_soi, h_tp = _host_sel(pp[i], int(nfr[i]), K, topN, thres, nb)
        assert ind == h_ind and soi == h_soi
        np.testing.assert_allclose(tp, h_tp, rtol=1e-6)


def test_select_topk_threshold_clamp():
    r = np.random.RandomState(4)
    pp = r.rand(2, 32, 16).astype(np.float32)
    nfr = np.array([32, 20], np.int32)
    idx, cnt, _ = select_topk_batched(torch.from_numpy(pp), torch.from_numpy(nfr),
                                      topN=100, nb=64, val_score_thres=0.9)
    jidx, jcnt, _ = jsteps.select_topk_batched(jnp.asarray(pp), jnp.asarray(nfr),
                                               topN=100, nb=64, val_score_thres=0.9)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
