"""The port's own copies of echr_tpu's host code give echr_tpu's outputs:
labels, the synthetic dataset and batcher, the loader, proposal
selection, caption rendering and the Config JSON.

echr_tpu's optional C++ paths (IoU grid, NMS, caption joiner) are its own
numpy paths' equals, so the comparisons are exact; the label grids are
compared with echr_tpu's numpy grid (the C++ one differs by <= 2e-7,
tests/test_native.py).
"""
import dataclasses

import numpy as np
import pytest

from echr_tpu import config as jconfig
from echr_tpu import native as jnative
from echr_tpu.data import batcher as jbatcher
from echr_tpu.data import dataset as jdataset
from echr_tpu.data import labels as jlabels
from echr_tpu.data import loader as jloader
from echr_tpu.engine import proposals as jproposals
from echr_tpu.utils import text as jtext

from echr_tpu_torch import config
from echr_tpu_torch.data import batcher, dataset, labels, loader
from echr_tpu_torch.engine import proposals
from echr_tpu_torch.utils import text


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
    # echr_tpu reads the port's JSON with its own defaults for the dropped knobs
    assert jconfig.Config.from_json(cfg.to_json()) == jcfg.replace_in("runtime", mesh_shape=(1, 1))
    for port_cfg, jax_cfg in ((config.flagship_config(), jconfig.flagship_config()),
                              (config.Config(), jconfig.Config())):
        assert port_cfg.to_dict() == _kept(jax_cfg.to_dict(), port_cfg.to_dict())
    # a dropped knob is rejected, not ignored
    with pytest.raises(TypeError):
        cfg.replace_in("runtime", mesh_shape=(2, 4))
    # sections and fields this tree does not know are ignored when loading
    assert config.Config.from_dict({"decoder": {"CG_rnn_size": 8, "gone": 1},
                                    "other": {}}).decoder.CG_rnn_size == 8
