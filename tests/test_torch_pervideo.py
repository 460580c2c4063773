"""The port's per-video paths against echr_tpu's on the CPU at f32, on
tests/test_torch_eval.py's synthetic split and sharpened weights (bridged
from the JAX init, so ties do not flip): decoder_sample / captioner_sample
(greedy, and the forced-token replay of a sampled decode), beam_search, the
per-video steps, eval_split, the per-video SCST step and the eval CLI's
default.  echr_tpu's functions run as its own tests run them on the CPU.

Tolerances: tokens, active masks, sentences, timestamps and "num" equal;
logps within 5e-4; sentence confidences, proposal and re-scores within
5e-4 a token (its words and the end token); val losses within 1e-5
relative.  The multinomial decode is held with forced tokens (its draws
replayed by echr_tpu's decoder_sample), not shared seeds.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_eval import SHARPEN, Split, assert_same_predictions
from test_torch_scst import EOS_BIAS, _eos_biased, _jax_rl
from test_torch_train import REL, _batch, _cfg, _close_trees, _params

from echr_tpu.data.batcher import make_batch as jax_make_batch
from echr_tpu.data.dataset import SyntheticDataset
from echr_tpu.engine import evaluate as jeval
from echr_tpu.engine import rl as jrl
from echr_tpu.engine import steps as jsteps
from echr_tpu.models.captioner import ProposalBatch as JaxProps
from echr_tpu.models.captioner import make_contexts as jax_make_contexts
from echr_tpu.models.decoder import decoder_sample as jax_decoder_sample

from echr_tpu_torch.bridge import captioner_from_jax, captioner_to_jax, tap_from_jax, tap_to_jax
from echr_tpu_torch.cli import eval as cli_eval
from echr_tpu_torch.engine import checkpoint, rl, steps
from echr_tpu_torch.engine import evaluate as E
from echr_tpu_torch.engine import train as T
from echr_tpu_torch.models import beam, decoder
from echr_tpu_torch.models.captioner import ProposalBatch, captioner_sample_one, make_contexts

TOL = 5e-4
N_BUCKET = 64  # the smallest proposal bucket, as eval_split pads


def _kw(**over):
    return {"num_vids_eval": 0, "topN": 15, "language_eval": False, "val_all_metrics": False,
            "get_eval_loss": True, **over}


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """One val video of the split, its 8 sampled proposals padded to the
    64-row bucket (rows past the real ones are padding), and both packages'
    encodes."""
    s = Split(tmp_path_factory.mktemp("pv"))
    s.close()
    ex = s.jds.get_example(s.jds.split_ix["val"][0])
    batch, meta = jax_make_batch(ex, s.jcfg, np.random.RandomState(0), w1=s.jds.w1)
    n = int(batch.prop_mask.sum())
    props = E._pad_props(np.asarray(batch.ind_select)[:n], np.asarray(batch.soi)[:n], N_BUCKET)
    tap, cg = tap_from_jax(s.tap_np, s.cfg), captioner_from_jax(s.cg_np, s.cfg)
    tb = steps.batch_to_device(batch, "cpu")
    tap_feats, _ = steps.encode_step(tap, tb.feats, s.cfg)
    jtap_feats, _ = jsteps.encode_step(s.tap_np, jax.tree.map(jnp.asarray, batch), s.jcfg)
    return types.SimpleNamespace(
        s=s, batch=batch, meta=meta, n=n, tap=tap, cg=cg, tb=tb, tap_feats=tap_feats,
        jtap_feats=jtap_feats, props=ProposalBatch(*(torch.from_numpy(x) for x in props)),
        jprops=JaxProps(*(jnp.asarray(x) for x in props)))


def _args(v):
    return (v.cg, v.s.cfg, v.tap_feats, v.tb.feats, v.tb.lda, v.tb.frame_mask, v.props)


def _jargs(v):
    b = v.batch
    return (v.s.cg_np, v.s.jcfg, v.jtap_feats, jnp.asarray(b.feats), jnp.asarray(b.lda),
            jnp.asarray(b.frame_mask), v.jprops)


def test_decode_step_greedy_matches_jax(video):
    """Per-video greedy decode of a bucket-padded video: tokens and active
    equal for every row, the padding rows included (echr_tpu decodes them
    from their [0, 1) windows and does not zero them), logps within 5e-4;
    captioner_sample_one is the same decode."""
    with torch.inference_mode():
        seq, logps, active = steps.decode_step(*_args(video))
    want = [np.asarray(x) for x in jsteps.decode_step(*_jargs(video))]
    assert seq.shape == (N_BUCKET, video.s.cfg.decoder.CG_seq_length)
    np.testing.assert_array_equal(seq.numpy(), want[0])
    np.testing.assert_array_equal(active.numpy(), want[2])
    np.testing.assert_allclose(logps.numpy(), want[1], atol=TOL, rtol=0)
    assert (seq[: video.n] != 0).any() and bool(active[0])
    v = video
    with torch.inference_mode():
        again = captioner_sample_one(v.cg, v.s.cfg, v.tap_feats, v.tb.feats, v.tb.lda, v.props,
                                     v.tb.frame_mask)
    assert all(torch.equal(a, b) for a, b in zip(again, (seq, logps, active)))


def _ctxs(v):
    with torch.inference_mode():
        c = make_contexts(v.cg, v.s.cfg, v.tap_feats[None], v.tb.feats[None], v.tb.lda[None],
                          ProposalBatch(*(x[None] for x in v.props)), v.tb.frame_mask[None])
    return type(c)(*(None if x is None else x[0] for x in c))


def _jctxs(v):
    b = v.batch
    return jax_make_contexts({"fusion": v.s.cg_np.get("fusion")}, v.s.jcfg, v.jtap_feats,
                             jnp.asarray(b.feats), jnp.asarray(b.lda), v.jprops,
                             frame_mask=jnp.asarray(b.frame_mask))


def test_sampled_decode_replays_in_jax(video):
    """sample_max=0: the port's per-video multinomial decode (draws from a
    seeded generator; the logit weights unsharpened and the end token's
    bias raised, so that captions end at ragged steps) replayed by echr_tpu's
    decoder_sample(forced_tokens=...): seq and active equal, logps within
    5e-4 up to each row's end token (a finished row feeds back its draws in
    the sampled decode and the end token in a replay, so its later logps
    differ); the port's decoder_sample replays the same tokens to itself."""
    v = video
    cg_np = _eos_biased(v.s.cg_np, EOS_BIAS)
    cg_np["decoder"]["logit"]["w"] = cg_np["decoder"]["logit"]["w"] / SHARPEN
    cg = captioner_from_jax(cg_np, v.s.cfg)
    with torch.inference_mode():
        seq, logps, active = steps.decode_step(
            cg, v.s.cfg, v.tap_feats, v.tb.feats, v.tb.lda, v.tb.frame_mask, v.props,
            greedy=False, temperature=1.0, sample_gen=torch.Generator().manual_seed(3))
        ctxs = _ctxs(v)
        replay = decoder.decoder_sample(cg.decoder, v.s.cfg, ctxs, greedy=False,
                                        forced_tokens=seq)
    want = [np.asarray(x) for x in jax_decoder_sample(
        jax.tree.map(jnp.asarray, cg_np["decoder"]), v.s.jcfg, _jctxs(v), greedy=False,
        forced_tokens=jnp.asarray(seq))]
    np.testing.assert_array_equal(seq.numpy(), want[0])
    np.testing.assert_array_equal(active.numpy(), want[2])
    emitted = (seq > 0).numpy()
    upto_end = np.concatenate([np.ones_like(emitted[:, :1]), emitted[:, :-1]], axis=1)
    np.testing.assert_allclose(logps.numpy() * upto_end, want[1] * upto_end, atol=TOL, rtol=0)
    ended = (seq[: v.n] == 0).any(dim=-1)
    assert bool(ended.any()) and not bool(active.all())  # ragged ends, an early exit
    assert torch.equal(replay[0], seq) and torch.equal(replay[2], active)
    np.testing.assert_allclose(replay[1].numpy() * upto_end, logps.numpy() * upto_end,
                               atol=1e-6, rtol=0)


def test_beam_search_matches_jax(video):
    """Per-video beam 2 with the window sort and its un-permute: the best
    sequence equal, logprob within 5e-4, the padding rows zero; the
    fixed-L loop gives the same tensors."""
    v = video
    with torch.inference_mode():
        seq, logprob = steps.beam_decode_step(*_args(v), 2)
        res = beam.beam_search(v.cg.decoder, v.s.cfg, _ctxs(v), 2, early_exit=False)
    want_seq, want_lp = (np.asarray(x) for x in jsteps.beam_decode_step(*_jargs(v), 2))
    np.testing.assert_array_equal(seq.numpy(), want_seq)
    np.testing.assert_allclose(logprob.numpy(), want_lp, atol=TOL, rtol=0)
    assert not seq[v.n:].any() and not logprob[v.n:].any()
    assert torch.equal(res.seq, seq) and torch.equal(res.logprob, logprob)
    assert res.all_seqs.shape == (N_BUCKET, 2, v.s.cfg.decoder.CG_seq_length)


def test_val_loss_step_matches_jax(video):
    v = video
    got = steps.val_loss_step(v.tap, v.cg, v.tb, v.s.cfg)
    want = jsteps.val_loss_step(v.s.tap_np, v.s.cg_np, jax.tree.map(jnp.asarray, v.batch),
                                v.s.jcfg)
    assert set(got) == set(want) == {"tap_loss", "cg_loss", "total_loss"}
    for k in want:
        assert got[k].shape == ()
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=REL, err_msg=k)


EVAL_CASES = [("cg", {}), ("tap", {}), ("tap_cg", {"reranking": True}),
              ("tap_cg", {"nms_threshold": 0.5}), ("tap_cg", {"beam_size": 2})]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    s = Split(tmp_path_factory.mktemp("evs"))
    yield s
    s.close()


@pytest.mark.parametrize("mode,over", EVAL_CASES,
                         ids=["cg", "tap", "tap_cg_rerank", "tap_cg_nms", "tap_cg_beam2"])
def test_eval_split_matches_jax(split, mode, over):
    """eval_split against echr_tpu's per-video eval_split: the same
    predictions and val losses within 1e-5 relative; the selection ran on
    the device for 'tap' / 'tap_cg' without NMS."""
    kw = _kw(**over)
    want, _, want_loss = jeval.eval_split(split.tap_np, split.cg_np, split.jloader, split.jcfg,
                                          str(split.tmp / "jax_pv.json"), dict(kw),
                                          flag_eval_what=mode)
    timing = {}
    got, score, got_loss = E.eval_split(
        tap_from_jax(split.tap_np, split.cfg), captioner_from_jax(split.cg_np, split.cfg),
        split.loader, split.cfg, str(split.tmp / "port_pv.json"), dict(kw, timing_out=timing),
        flag_eval_what=mode, device="cpu")
    assert_same_predictions(got, want)
    assert want_loss[0] > 0 and score == {}
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=0)
    device_sel = mode in ("tap", "tap_cg") and not over.get("nms_threshold")
    assert (timing["device_selections"] > 0) == device_sel
    assert timing["grid_fallbacks"] == 0


def test_eval_split_matches_eval_split_batched(split):
    """The per-video and the batched driver give the same predictions and
    val losses on one split (the port's two loops), and sample_max=0 with
    one seed gives one predictions dict."""
    tap, cg = tap_from_jax(split.tap_np, split.cfg), captioner_from_jax(split.cg_np, split.cfg)
    kw = _kw()
    got, _, got_loss = E.eval_split(tap, cg, split.loader, split.cfg, str(split.tmp / "a.json"),
                                    dict(kw), device="cpu")
    want, _, want_loss = E.eval_split_batched(tap, cg, split.loader, split.cfg,
                                              str(split.tmp / "b.json"), dict(kw),
                                              batch_videos=2, device="cpu")
    assert_same_predictions(got, want)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=0)
    sampled = [E.eval_split(tap, cg, split.loader, split.cfg, str(split.tmp / "c.json"),
                            dict(kw, sample_max=0, sample_seed=4), device="cpu")[0]
               for _ in range(2)]
    assert sampled[0] and sampled[0] == sampled[1]
    assert split.loader.labels_for("val")


@pytest.mark.parametrize("batched", [False, True], ids=["eval_split", "eval_split_batched"])
def test_tap_tie_storm_falls_back_to_the_grid(split, batched):
    """A zeroed SST score head ties every anchor at 0.5, the threshold-tie
    storm of an untrained checkpoint: in 'tap' mode with device selection
    each video's count passes the device slots, the video falls back to
    the host selection over its fetched score grid, and the predictions
    are echr_tpu's, in both drivers."""
    tap_np = jax.tree.map(np.copy, split.tap_np)
    tap_np["scores"] = {k: np.zeros_like(v) for k, v in tap_np["scores"].items()}
    kw = _kw(get_eval_loss=False, device_select=True)
    extra = {"batch_videos": 2} if batched else {}
    jfn, fn = ((jeval.eval_split_batched, E.eval_split_batched) if batched
               else (jeval.eval_split, E.eval_split))
    want_tm, timing = {}, {}
    want, _, _ = jfn(tap_np, split.cg_np, split.jloader, split.jcfg,
                     str(split.tmp / "jax_storm.json"), dict(kw, timing_out=want_tm),
                     flag_eval_what="tap", **extra)
    got, _, _ = fn(tap_from_jax(tap_np, split.cfg), captioner_from_jax(split.cg_np, split.cfg),
                   split.loader, split.cfg, str(split.tmp / "port_storm.json"),
                   dict(kw, timing_out=timing), flag_eval_what="tap", device="cpu", **extra)
    assert_same_predictions(got, want)
    assert timing["grid_fallbacks"] == want_tm["grid_fallbacks"] > 0


def test_eval_split_refuses_missing_cuda(split, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.eval_split(None, None, split.loader, split.cfg, str(split.tmp / "x.json"),
                     device="cuda")


def test_eval_cli_defaults_to_eval_split(tmp_path, split, monkeypatch):
    """cli.eval without --batch_videos runs the per-video eval_split, whose
    predictions JSON it writes; --batch_videos 2 runs eval_split_batched."""
    state = steps.init_train_state(split.cfg, tap_from_jax(split.tap_np, split.cfg),
                                   captioner_from_jax(split.cg_np, split.cfg))
    checkpoint.save_checkpoint(str(tmp_path / "EV" / "model-best.ckpt"), state, split.cfg,
                               iteration=1, epoch=0, best_val_score=0.0,
                               vocab=split.ds.ix_to_word)
    called = []
    for name in ("eval_split", "eval_split_batched"):
        fn = getattr(cli_eval, name)
        monkeypatch.setattr(cli_eval, name, lambda *a, _fn=fn, _n=name, **k: (
            called.append(_n), _fn(*a, **k))[1])
    argv = ["--folder_id", "EV", "--checkpoint_path", str(tmp_path), "--flag_eval_what",
            "tap_cg", "--topN", "15", "--no_language_eval", "--device", "cpu"]
    path = cli_eval.main(argv)
    assert called == ["eval_split"]
    with open(path) as f:
        got = json.load(f)["results"]
    want, _, _ = E.eval_split(state.tap, state.cg, split.loader, split.cfg,
                              str(tmp_path / "want.json"), _kw(get_eval_loss=False),
                              device="cpu")
    assert want and json.loads(json.dumps(want)) == got
    cli_eval.main(argv + ["--batch_videos", "2"])
    assert called == ["eval_split", "eval_split_batched"]


@pytest.mark.parametrize("phase", ["tap_cg", "cg"])
def test_self_critical_step_matches_jax(monkeypatch, phase):
    """The loop's per-video SCST step (batch_size 1), dropout off: its
    rewards are echr_tpu's on the rollout's tokens, and its update equals
    echr_tpu's on those tokens and rewards: loss and metrics within 1e-5
    relative, parameters after the Adam step within 4 * lr.  echr_tpu runs
    its plain attention (the Pallas kernels' reference), which its tests
    hold to the kernels."""
    cfg = _cfg(**{"runtime.use_pallas": False, "runtime.use_pallas_train": False})
    tap, cg = _params(cfg)
    cg = _eos_biased(cg, EOS_BIAS)
    ds = SyntheticDataset(cfg, num_videos=8, seed=3)
    one, meta = jax_make_batch(ds.get_example(0), cfg, np.random.RandomState(0), w1=ds.w1)
    assert _batch(cfg).feats.shape[1:] == one.feats.shape
    state = steps.init_train_state(cfg, tap_from_jax(tap, cfg), captioner_from_jax(cg, cfg))
    rollouts = []
    orig = T.rl_rollout_step_batched

    def keep(*a, **k):
        out = orig(*a, **k)
        rollouts.append(out)
        return out

    monkeypatch.setattr(T, "rl_rollout_step_batched", keep)
    monkeypatch.setattr(T, "default_reward_pool", lambda *_: rl.RewardPool(workers=1))
    vocab = {str(i): f"w{i}" for i in range(1, cfg.decoder.CG_vocab_size + 1)}
    state, metrics, timing = T._self_critical_step(
        state, one, meta, cfg, phase, None, torch.Generator().manual_seed(7),
        types.SimpleNamespace(ix_to_word=vocab), "cpu")
    (_, gen_seq, greedy_seq), = rollouts
    gen_seq, greedy_seq = gen_seq[0], greedy_seq[0]
    if phase == "cg":
        gts, mask = list(meta.sentences), one.gts_mask
    else:
        gts, mask = [meta.sentences[int(j)] for j in meta.cg_select], one.prop_mask
    reward = jrl.self_critical_reward(gen_seq.numpy(), greedy_seq.numpy(), gts, vocab,
                                      np.asarray(mask))
    assert np.abs(reward).sum() > 0 and timing["reward_rows"] == int((mask > 0).sum())
    stacked = jax.tree.map(lambda x: np.asarray(x)[None], one)
    jloss, jm, _, _, _, jtap, jcg = _jax_rl(cfg, tap, cg, stacked, phase,
                                            gen_seq.numpy()[None], reward[None])
    np.testing.assert_allclose(metrics["loss"], jloss, rtol=REL)
    for k in jm:
        np.testing.assert_allclose(metrics[k], jm[k], rtol=REL, err_msg=k)
    assert state.step == 1
    lr = cfg.train.lr
    _close_trees(captioner_to_jax(state.cg, cfg), jcg, 4 * lr, 0)
    _close_trees(tap_to_jax(state.tap), jtap, 4 * lr, 0)
