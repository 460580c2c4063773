"""The port's own copies of echr_tpu's host code give echr_tpu's outputs:
labels, the synthetic dataset and batcher (the labels-off form included),
the loader and its per-split eval state, proposal selection and
reranking, caption rendering, the Config JSON, the metrics (tokenizer,
scorers, eval_score) and the hang watchdog.

The port takes its own C++ paths (IoU grid, NMS, caption joiner;
echr_tpu_torch/native) wherever they build, and they equal its numpy paths
(tests/test_torch_native.py), so the comparisons are exact; the label
grids are compared with echr_tpu's numpy grid.
"""
import dataclasses
import json
import logging
import time

import numpy as np
import pytest
import torch

from echr_tpu import config as jconfig
from echr_tpu import native as jnative
from echr_tpu.data import batcher as jbatcher
from echr_tpu.data import dataset as jdataset
from echr_tpu.data import labels as jlabels
from echr_tpu.data import loader as jloader
from echr_tpu.engine import proposals as jproposals
from echr_tpu.metrics.eval_score import eval_score as jax_eval_score
from echr_tpu.metrics import scorers as jscorers
from echr_tpu.metrics import tokenizer as jtokenizer
from echr_tpu.utils import text as jtext
from echr_tpu.utils import watchdog as jwatchdog

from echr_tpu_torch import config
from echr_tpu_torch.data import batcher, dataset, labels, loader
from echr_tpu_torch.engine import proposals
from echr_tpu_torch.metrics import scorers, tokenizer
from echr_tpu_torch.metrics.eval_score import eval_score
from echr_tpu_torch.utils import text, watchdog


@pytest.fixture
def numpy_grid(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def _cfg(**data):
    cfg = jconfig.flagship_config()
    cfg = cfg.replace_in("tap", K=32, prop_sample_num=8, video_dim=24)
    return cfg.replace_in("data", synthetic=True, lda_dim=16, time_buckets=(64, 128, 192),
                          synthetic_vocab_size=50, synthetic_seq_length=12, **data)


def test_labels_match():
    for T, K in ((1, 4), (7, 4), (40, 16), (130, 32)):
        np.testing.assert_array_equal(labels.anchor_mask(T, K), jlabels.anchor_mask(T, K))
    r = np.random.RandomState(0)
    for _ in range(50):
        n, dur = int(r.randint(3, 300)), float(r.uniform(1, 200))
        a, b = sorted(r.uniform(-5, dur + 5, size=2))
        assert labels.timestamp_to_featstamp((a, b), n, dur) == \
            jlabels.timestamp_to_featstamp((a, b), n, dur)
        s, e = sorted(r.randint(0, n + 2, size=2))
        assert labels.featstamp_to_time(s, e, n, dur) == jlabels.featstamp_to_time(s, e, n, dur)
    soi = r.randint(0, 100, size=(20, 2))
    np.testing.assert_array_equal(labels.featstamps_to_times(soi, 100, 37.5),
                                  jlabels.featstamps_to_times(soi, 100, 37.5))


def test_iou_grid_matches(numpy_grid):
    for gts in ([], [(0, 5)], [(0, 5), (3, 9), (3, 9), (20, 39)]):
        for got, want in zip(labels.iou_grid(gts, 40, 16), jlabels.iou_grid(gts, 40, 16)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["nodrop", "insert", "truncate"])
def test_make_batch_on_synthetic_dataset_matches(numpy_grid, mode):
    """Every VideoBatch field and BatchMeta field, for videos that fit a
    bucket and ones cut to the largest (time_buckets up to 192 frames)."""
    cfg = _cfg(dropsent_mode=mode, synthetic_learnable=(mode == "nodrop"))
    ds, jds = dataset.SyntheticDataset(cfg, num_videos=12, seed=7), \
        jdataset.SyntheticDataset(cfg, num_videos=12, seed=7)
    assert ds.ix_to_word == jds.ix_to_word and ds.split_ix == jds.split_ix
    np.testing.assert_array_equal(ds.w1, jds.w1)
    for ix in range(12):
        ex, jex = ds.get_example(ix), jds.get_example(ix)
        b, m = batcher.make_batch(ex, cfg, np.random.RandomState(ix), w1=ds.w1)
        jb, jm = jbatcher.make_batch(jex, cfg, np.random.RandomState(ix), w1=jds.w1)
        for name, x, y in zip(b._fields, b, jb):
            np.testing.assert_array_equal(x, y, err_msg=name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, name
        for f in dataclasses.fields(m):
            np.testing.assert_equal(getattr(m, f.name), getattr(jm, f.name), err_msg=f.name)
    assert batcher.pick_bucket(500, cfg.data.time_buckets) == 192


def test_loader_batches_match_at_rank_0_of_1(numpy_grid):
    cfg = _cfg().replace_in("data", nthreads=2, prefetch=3)
    ld = loader.Loader(dataset.SyntheticDataset(cfg, num_videos=8, seed=3), cfg,
                       process_index=0, process_count=1, seed=5)
    jld = jloader.Loader(jdataset.SyntheticDataset(cfg, num_videos=8, seed=3), cfg, seed=5,
                         process_index=0, process_count=1)
    try:
        for _ in range(9):  # past the 6-video train split's wrap
            (b, m), (jb, jm) = ld.get_batch("train"), jld.get_batch("train")
            assert (m.vid, m.wrapped) == (jm.vid, jm.wrapped)
            for name, x, y in zip(b._fields, b, jb):
                np.testing.assert_array_equal(x, y, err_msg=name)
        assert ld.state() == jld.state()
    finally:
        ld.load_state(ld.state())  # stops and joins the prefetch threads
        jld.load_state(jld.state())


def test_top_proposals_match():
    r = np.random.RandomState(1)
    for T, K, topN in ((50, 16, 20), (90, 32, 1000), (64, 32, 5)):
        pp = np.round(r.rand(T, K), 2).astype(np.float32)  # rounded: threshold ties
        mask = labels.anchor_mask(T, K)
        gts = r.randint(0, 4, size=(T, K))
        for cg in (None, gts):
            got = proposals.top_proposals(pp, mask, cg, 60.0, labels.featstamp_to_time,
                                          topN=topN)
            want = jproposals.top_proposals(pp, mask, cg, 60.0, jlabels.featstamp_to_time,
                                            topN=topN)
            assert got == want
            for overlap in (0.0, 0.5, 0.8):
                got = proposals.top_proposals_nms(pp, mask, cg, 60.0, labels.featstamp_to_time,
                                                  overlap=overlap, topN=topN)
                want = jproposals.top_proposals_nms(pp, mask, cg, 60.0,
                                                    jlabels.featstamp_to_time,
                                                    overlap=overlap, topN=topN)
                assert got == want


def test_decode_sequence_matches():
    vocab = {str(i): f"w{i}" for i in range(1, 41)}
    r = np.random.RandomState(2)
    seq = r.randint(-1, 45, size=(30, 9))  # END (0), negatives and ids past the vocab
    seq[:, 0] = r.randint(1, 41, size=30)
    assert text.decode_sequence(vocab, seq) == jtext.decode_sequence(vocab, seq)
    assert text.decode_sequence(vocab, seq[3]) == jtext.decode_sequence(vocab, seq[3])


def _kept(jax_dict, port_dict):
    """echr_tpu's config dict cut to the fields the port keeps."""
    return {k: {f: v[f] for f in port_dict[k]} if isinstance(v, dict) else v
            for k, v in jax_dict.items()}


def test_config_json_round_trip_both_ways():
    jcfg = jconfig.flagship_config(**{"decoder.CG_vocab_size": 6000, "runtime.mesh_shape": (2, 4),
                                      "data.time_buckets": (256,), "eval.beam_length_alpha": 0.6,
                                      "runtime.compute_dtype": "float32"})
    cfg = config.Config.from_json(jcfg.to_json())
    # every section and field but echr_tpu's TPU-only runtime knobs
    port, ref = cfg.to_dict(), jcfg.to_dict()
    assert port.keys() == ref.keys()
    for k in port:
        if isinstance(port[k], dict) and k != "runtime":
            assert port[k].keys() == ref[k].keys(), k
    assert set(port["runtime"]) < set(ref["runtime"])
    assert port == _kept(ref, port)
    assert cfg.runtime.compute_dtype == "float32" and cfg.data.time_buckets == (256,)
    for prop in ("video_context_dim", "event_context_dim", "clip_context_dim",
                 "tsrm_input_dim", "uses_tsrm"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    # mesh_shape round-trips both ways; echr_tpu reads the port's JSON with
    # its own defaults for the dropped knobs
    assert cfg.runtime.mesh_shape == (2, 4)
    assert jconfig.Config.from_json(cfg.to_json()) == jcfg
    assert jconfig.Config.from_json(cfg.to_json()).runtime.mesh_shape == (2, 4)
    for port_cfg, jax_cfg in ((config.flagship_config(), jconfig.flagship_config()),
                              (config.Config(), jconfig.Config())):
        assert port_cfg.to_dict() == _kept(jax_cfg.to_dict(), port_cfg.to_dict())
    # a dropped knob is rejected, not ignored; the data-parallel ones are kept
    with pytest.raises(TypeError):
        cfg.replace_in("runtime", spmd_mode="shard_map")
    kept = cfg.replace_in("runtime", mesh_shape=(4, 1), preempt_check_every=2).runtime
    assert (kept.mesh_shape, kept.preempt_check_every) == ((4, 1), 2)
    # sections and fields this tree does not know are ignored when loading
    assert config.Config.from_dict({"decoder": {"CG_rnn_size": 8, "gone": 1},
                                    "other": {}}).decoder.CG_rnn_size == 8


def _assert_batches_equal(b, m, jb, jm):
    for name, x, y in zip(b._fields, b, jb):
        np.testing.assert_array_equal(x, y, err_msg=name)
        assert np.asarray(x).dtype == np.asarray(y).dtype, name
    for f in dataclasses.fields(m):
        np.testing.assert_equal(getattr(m, f.name), getattr(jm, f.name), err_msg=f.name)


@pytest.mark.parametrize("thr", [0.3, 0.7, 0.8, 0.95])
def test_good_proposal_count_matches(thr):
    r = np.random.RandomState(4)
    for T, K in ((40, 16), (130, 32), (5, 8)):
        for _ in range(6):
            gts = [tuple(sorted(r.randint(0, T + 2, size=2))) for _ in range(r.randint(0, 5))]
            assert labels.good_proposal_count(gts, T, K, thr) == \
                jlabels.good_proposal_count(gts, T, K, thr)


def test_make_batch_labels_off_matches(numpy_grid):
    """The decode-only batch, for videos that fit a bucket and ones cut to
    the largest, and its geometry equal to the labels-on batch's."""
    cfg = _cfg()
    ds, jds = dataset.SyntheticDataset(cfg, num_videos=12, seed=7), \
        jdataset.SyntheticDataset(cfg, num_videos=12, seed=7)
    for ix in range(12):
        ex, jex = ds.get_example(ix), jds.get_example(ix)
        b, m = batcher.make_batch(ex, cfg, np.random.RandomState(ix), w1=ds.w1, labels=False)
        jb, jm = jbatcher.make_batch(jex, cfg, np.random.RandomState(ix), w1=jds.w1, labels=False)
        _assert_batches_equal(b, m, jb, jm)
        full, fm = batcher.make_batch(ex, cfg, np.random.RandomState(ix), w1=ds.w1)
        for name in ("feats", "frame_mask", "n_frames", "lda", "tap_masks"):
            np.testing.assert_array_equal(getattr(b, name), getattr(full, name), err_msg=name)
        assert (m.proposal_num, m.n_frames, m.duration) == \
            (fm.proposal_num, fm.n_frames, fm.duration)


def test_loader_eval_state_matches(numpy_grid):
    """set_labels / set_feats_dtype / reset_iterator / split_size on the val
    split: the decode-only batches with bf16 features (a torch tensor in the
    port, an ml_dtypes array in echr_tpu, the same values), then the full
    batches again after a reset; the train split keeps its labels."""
    import jax.numpy as jnp

    cfg = _cfg().replace_in("data", nthreads=2, prefetch=3)
    ld = loader.Loader(dataset.SyntheticDataset(cfg, num_videos=12, seed=3), cfg,
                       process_index=0, process_count=1, seed=5)
    jld = jloader.Loader(jdataset.SyntheticDataset(cfg, num_videos=12, seed=3), cfg, seed=5,
                         process_index=0, process_count=1)
    try:
        assert ld.split_size("val") == jld.split_size("val") == 3
        assert ld.split_size("train") == jld.split_size("train") == 9
        assert ld.labels_for("val") and ld.feats_dtype_for("val") is None
        ld.set_labels(False, "val")
        jld.set_labels(False, "val")
        ld.set_feats_dtype(torch.bfloat16, "val")
        jld.set_feats_dtype(np.dtype(jnp.bfloat16), "val")
        assert not ld.labels_for("val") and ld.labels_for("train")
        assert ld.feats_dtype_for("val") == torch.bfloat16
        for _ in range(4):  # past the wrap
            (b, m), (jb, jm) = ld.get_batch("val"), jld.get_batch("val")
            assert (m.vid, m.wrapped) == (jm.vid, jm.wrapped)
            assert b.feats.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.feats.float().numpy(),
                                          np.asarray(jb.feats).astype(np.float32))
            _assert_batches_equal(b._replace(feats=0), m, jb._replace(feats=0), jm)
        for x in (ld, jld):
            x.set_labels(True, "val")
            x.set_feats_dtype(None, "val")
            x.reset_iterator("val")
        assert ld.state() == jld.state()
        for i in range(2):
            (b, m), (jb, jm) = ld.get_batch("val"), jld.get_batch("val")
            assert m.vid == jm.vid == f"v_synth{9 + i:05d}"
            _assert_batches_equal(b, m, jb, jm)
        (b, m), (jb, jm) = ld.get_batch("train"), jld.get_batch("train")
        _assert_batches_equal(b, m, jb, jm)
    finally:
        ld.load_state(ld.state())  # stops and joins the prefetch threads
        jld.load_state(jld.state())


def test_rerank_top10_matches():
    r = np.random.RandomState(6)
    for n in (1, 5, 10, 11, 40):
        rs = np.round(r.randn(n), 1)  # rounded: ties at the 10th score
        infos = [{"re_score": float(x), "num": [i, n]} for i, x in enumerate(rs)]
        assert proposals.rerank_top10(infos) == jproposals.rerank_top10(infos)


CAPTIONS = [
    "A man's dog can't run, won't stop.",
    "they'll say \u201cyes\u201d \u2014 gonna be 100% of the $5 weights...",
    "Twenty-one people and/or 1,000 caf\u00e9 tables (3.5 m) o'clock",
    "",
]


@pytest.mark.parametrize("caption", CAPTIONS)
def test_tokenizer_matches(caption):
    assert tokenizer.tokenize_caption(caption) == jtokenizer.tokenize_caption(caption)
    caps = {0: [{"caption": caption}], 1: [{"caption": caption.upper()}]}
    assert tokenizer.tokenize(caps) == jtokenizer.tokenize(caps)


GTS = {0: ["a man is playing a guitar on the stage", "someone plays guitar"],
       1: ["the dogs are running in the park", "dogs run across a green park"],
       2: ["a woman cuts vegetables in a kitchen"]}
RES = {0: ["a man plays the guitar"], 1: ["two dogs running through the park"],
       2: ["a woman is cutting onions"]}


@pytest.mark.parametrize("name", ["Bleu", "Rouge", "Cider", "Meteor"])
def test_scorer_matches(name):
    """Both copies under the same stemmer (scorers' nltk PorterStemmer, or the
    identity where nltk is absent)."""
    port = scorers.Bleu(4) if name == "Bleu" else getattr(scorers, name)()
    ref = jscorers.Bleu(4) if name == "Bleu" else getattr(jscorers, name)()
    got, got_each = port.compute_score(GTS, RES)
    want, want_each = ref.compute_score(GTS, RES)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got_each, dtype=float),
                                  np.asarray(want_each, dtype=float))
    assert np.all(np.asarray(got) > 0)


def test_eval_score_matches(tmp_path):
    """One predictions file against one reference file, every metric at the
    four tIoUs, top-N capping and a prediction that overlaps no GT."""
    gt = {"v1": {"duration": 30.0, "timestamps": [[0.0, 10.0], [8.0, 20.0]],
                 "sentences": ["a man plays a guitar", "the man sings a song"]},
          "v2": {"duration": 12.0, "timestamps": [[1.0, 5.0]],
                 "sentences": ["a dog runs in the park"]}}
    preds = {"v1": [{"sentence": "a man plays guitar", "timestamp": [0.5, 9.0],
                     "proposal_score": 0.9, "re_score": 1.0, "sentence_confidence": -1.0},
                    {"sentence": "a man is singing", "timestamp": [7.0, 21.0],
                     "proposal_score": 0.8, "re_score": 0.5, "sentence_confidence": -2.0},
                    {"sentence": "nothing here", "timestamp": [25.0, 29.0],
                     "proposal_score": 0.1, "re_score": 0.1, "sentence_confidence": -3.0}],
             "v2": [{"sentence": "a dog runs", "timestamp": [1.2, 4.0],
                     "proposal_score": 0.7, "re_score": 0.2, "sentence_confidence": -1.5}]}
    (tmp_path / "ref.json").write_text(json.dumps(gt))
    (tmp_path / "pred.json").write_text(json.dumps({"results": preds, "version": "VERSION 1.0",
                                                    "external_data": {}}))
    for only_recall in (False, True):
        kw = dict(only_recall=only_recall, verbose=True, topN=2,
                  references=[str(tmp_path / "ref.json")])
        got = eval_score(str(tmp_path / "pred.json"), **kw)
        want = jax_eval_score(str(tmp_path / "pred.json"), **kw)
        assert got == want
    assert got["Recall"][0] > 0 and len(got["Recall"]) == 4


class _Clock:
    """The watchdog module's clock, driven by the test: ``monotonic`` reads
    ``now``, which only the test advances."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.mark.parametrize("mod", [watchdog, jwatchdog], ids=["port", "echr_tpu"])
def test_watchdog_trips_on_a_stall(mod, caplog, monkeypatch):
    """A stalled loop trips the watchdog (a warning each deadline), a beating
    loop does not, stop() joins its thread, and deadline 0 starts none.  The
    watchdog's clock is the test's (its thread still polls in real time), so
    a main thread delayed by a loaded machine cannot read as a stall: the
    beating loop advances the clock 0.05 s a beat against the 0.2 s
    deadline, and the stall advances it past the deadline.  The watchdog's
    thread counts a trip before it logs it, so the test waits for both."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    wd = mod.HangWatchdog("t", 0.2, dump_stacks=False).start()
    try:
        for _ in range(5):
            clock.now += 0.05
            wd.beat()
            time.sleep(0.05)  # the watchdog's thread polls meanwhile
        assert wd.trips == 0
        with caplog.at_level(logging.WARNING):
            clock.now += 0.25

            def warned():  # the thread counts the trip, then logs it
                return any("no progress" in r.getMessage() for r in caplog.records)
            deadline = time.time() + 5.0
            while not (wd.trips and warned()) and time.time() < deadline:
                time.sleep(0.05)
        assert wd.trips >= 1
        assert warned()
    finally:
        thread = wd._thread
        wd.stop()
    assert thread is not None and not thread.is_alive()
    off = mod.HangWatchdog("off", 0).start()
    assert off._thread is None
    off.stop()
