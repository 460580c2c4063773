"""The port's batched beam search against the JAX package, on CPU at f32.

Weights come from echr_tpu's init through the bridge, with the logit
weights sharpened (scaled up) so that the beams' candidate margins dwarf
f32 reassociation noise.  Tokens must be identical; the best beam's
logprob within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import small_cfg
from test_torch_serve import _decode_inputs, _params, _requests, _vocab

from echr_tpu.engine import steps as jsteps
from echr_tpu.models.captioner import ProposalBatch as JaxProposalBatch

from echr_tpu_torch.bridge import captioner_from_jax, tap_from_jax
from echr_tpu_torch.engine.steps import beam_decode_step_batched, decode_step_batched
from echr_tpu_torch.models import beam
from echr_tpu_torch.models.captioner import ProposalBatch
from echr_tpu_torch.serve import CaptionService

ATOL = 1e-5
ALPHA = 1.0  # cfg.eval.beam_length_alpha at flagship


@pytest.fixture(autouse=True)
def _forward_only():
    with torch.no_grad():
        yield


def _torch_args(tap_feats, feats, lda, fm, ind, soi, pm):
    return ([torch.from_numpy(x) for x in (tap_feats, feats, lda, fm)],
            ProposalBatch(*(torch.from_numpy(x) for x in (ind, soi, pm))))


def _jax_beam(cg_np, cfg, inputs, k):
    feats, tap_feats, lda, fm, ind, soi, pm = inputs
    seq, lp = jsteps.beam_decode_step_batched(
        cg_np, cfg, tap_feats, feats, lda, fm, JaxProposalBatch(ind, soi, pm), k,
        length_alpha=ALPHA)
    return np.asarray(seq), np.asarray(lp)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_beam_decode_step_batched_matches_jax(k):
    """Padded proposals included (_decode_inputs pads video 1 from row 10 on):
    they come back as zeros on both sides."""
    cfg = small_cfg()
    _, cg_np = _params(cfg)
    inputs = _decode_inputs(cfg, N=12, seed=2)
    jseq, jlp = _jax_beam(cg_np, cfg, inputs, k)
    feats, tap_feats, lda, fm, ind, soi, pm = inputs
    args, props = _torch_args(tap_feats, feats, lda, fm, ind, soi, pm)
    steps0 = beam.beam_search_batched.steps
    seq, lp = beam_decode_step_batched(captioner_from_jax(cg_np, cfg), cfg, *args, props, k,
                                       length_alpha=ALPHA)
    assert 1 <= beam.beam_search_batched.steps - steps0 <= cfg.decoder.CG_seq_length
    np.testing.assert_array_equal(seq.numpy(), jseq)
    np.testing.assert_allclose(lp.numpy(), jlp, atol=ATOL, rtol=0)
    assert jseq.any()  # real tokens, not an all-EOS decode
    assert (seq.numpy()[pm == 0] == 0).all() and (lp.numpy()[pm == 0] == 0).all()


@pytest.mark.parametrize("variant", ["no_sort", "fixed_loop"])
def test_beam_sort_and_early_exit_are_exact(variant):
    """The window sort (the kernel route) against no sort, and the early
    exit against the fixed-L loop: identical tensors."""
    cfg = small_cfg()
    _, cg_np = _params(cfg, seed=1)
    cg = captioner_from_jax(cg_np, cfg)
    feats, tap_feats, lda, fm, ind, soi, pm = _decode_inputs(cfg, N=8, seed=4)
    args, props = _torch_args(tap_feats, feats, lda, fm, ind, soi, pm)
    other = (cfg.replace_in("runtime", sort_decode_props=False) if variant == "no_sort"
             else cfg.replace_in("runtime", decode_early_exit_batched=False))
    syncs0 = beam.beam_search_batched.host_syncs
    seq_a, lp_a = beam_decode_step_batched(cg, cfg, *args, props, 3, length_alpha=ALPHA)
    assert beam.beam_search_batched.host_syncs > syncs0
    syncs1 = beam.beam_search_batched.host_syncs
    seq_b, lp_b = beam_decode_step_batched(cg, other, *args, props, 3, length_alpha=ALPHA)
    if variant == "fixed_loop":
        assert beam.beam_search_batched.host_syncs == syncs1
    np.testing.assert_array_equal(seq_a.numpy(), seq_b.numpy())
    if variant == "fixed_loop":
        np.testing.assert_array_equal(lp_a.numpy(), lp_b.numpy())
    else:  # row order changes the order of sums in the batched products
        np.testing.assert_allclose(lp_a.numpy(), lp_b.numpy(), atol=ATOL, rtol=0)


def test_beam_size_one_is_greedy():
    """k = 1 keeps the argmax token every step: the greedy tokens up to
    each row's end."""
    cfg = small_cfg()
    _, cg_np = _params(cfg, seed=3)
    cg = captioner_from_jax(cg_np, cfg)
    feats, tap_feats, lda, fm, ind, soi, pm = _decode_inputs(cfg, N=8, seed=3)
    args, props = _torch_args(tap_feats, feats, lda, fm, ind, soi, pm)
    seq_b, _ = beam_decode_step_batched(cg, cfg, *args, props, 1)
    seq_g, _, _ = decode_step_batched(cg, cfg, *args, props)
    real = pm > 0  # greedy leaves padding rows as decoded; beam zeros them
    np.testing.assert_array_equal(seq_b.numpy()[real], seq_g.numpy()[real])


def test_top_k_tie_order_matches_lax():
    """Exact ties: the lower flat index first, as lax.top_k orders them."""
    r = np.random.RandomState(0)
    x = np.round(r.randn(6, 40) * 2) / 2  # values on a 0.5 grid: many ties
    x[0] = 1.0  # all tied
    x[1, :] = -1e30
    x[1, [7, 3, 30]] = 0.0
    for k in (1, 3, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(x, jnp.float32), k)
        v, i = beam._top_k_first_index(torch.tensor(x, dtype=torch.float32), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_caption_service_beam_matches_jax():
    from echr_tpu.serve import CaptionRequest as JaxRequest
    from echr_tpu.serve import CaptionService as JaxService

    cfg = small_cfg()
    tap, cg = _params(cfg)
    reqs = _requests(cfg, n=3)
    want = JaxService(cfg, tap, cg, _vocab(cfg), batch_videos=2, topN=6,
                      beam_size=3).caption(
        [JaxRequest(r.vid, r.feats, r.duration, r.lda) for r in reqs])
    got = CaptionService(cfg, tap_from_jax(tap, cfg), captioner_from_jax(cg, cfg), _vocab(cfg),
                         device="cpu", batch_videos=2, topN=6, beam_size=3).caption(reqs)
    assert set(got) == set(want)
    for vid in want:
        assert len(got[vid]) == len(want[vid]) > 0
        for g, w in zip(got[vid], want[vid]):
            assert g.sentence == w.sentence
            np.testing.assert_allclose(g.timestamp, w.timestamp, rtol=1e-9)
            np.testing.assert_allclose(g.sentence_confidence, w.sentence_confidence,
                                       atol=ATOL * 10)
