"""The port's host library (echr_tpu_torch/native) against its numpy
versions and echr_tpu's functions, on the CPU with g++.

The same numpy-seeded inputs go through each C++ function, the port's numpy
version and echr_tpu's function (its own C++ path where its library builds,
its numpy path otherwise; the two are equal): IoU grids bit-equal, NMS picks
and captions identical.  Also: the port's batches with and without
force_numpy(), four processes building into one empty directory at once,
a build that fails, and a host without a compiler.
"""
import contextlib
import ctypes
import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

from echr_tpu.data import labels as jlabels
from echr_tpu.engine import proposals as jproposals
from echr_tpu.utils import text as jtext

from echr_tpu_torch import native
from echr_tpu_torch.config import flagship_config
from echr_tpu_torch.data import batcher, dataset, labels, loader
from echr_tpu_torch.engine import proposals
from echr_tpu_torch.utils import text

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the port runs its numpy versions")


def _random_gts(r, T, n):
    out = []
    for _ in range(n):
        s = int(r.randint(0, max(1, T - 1)))
        out.append((s, int(r.randint(s + 1, T + 1))))
    return out


# (T, K, featstamps)
IOU_CASES = {
    "no_gt": (40, 16, []),
    "overlapping_and_identical": (64, 32, [(2, 40), (10, 20), (10, 20), (12, 22), (50, 63)]),
    "identical_only": (30, 30, [(5, 9), (5, 9), (5, 9)]),
    # batcher.py's stamp of an event wholly past the cut: never matched
    "sentinel": (48, 32, [(3, 20), (49, 50), (30, 47), (49, 50)]),
    "T_below_K": (12, 32, [(0, 5), (4, 11)]),
    "T_is_1": (1, 8, [(0, 1)]),
    "flagship": (256, 256, _random_gts(np.random.RandomState(0), 256, 4)),
    "many_gts": (90, 48, _random_gts(np.random.RandomState(1), 90, 12)),
}


@pytest.mark.parametrize("case", sorted(IOU_CASES))
def test_iou_grid_bit_equal(case):
    T, K, gts = IOU_CASES[case]
    before = native.iou_grid.calls
    got = labels.iou_grid(gts, T, K)
    assert native.iou_grid.calls == before + 1
    for name, want in (("numpy", labels.iou_grid_numpy(gts, T, K)),
                       ("echr_tpu", jlabels.iou_grid(gts, T, K)),
                       ("direct", native.iou_grid(gts, T, K))):
        for what, x, y in zip(("iou", "gts_index", "mask"), got, want):
            assert x.dtype == np.float32 and x.shape == (T, K), (name, what)
            np.testing.assert_array_equal(x, y, err_msg=f"{name} {what}")
    if case == "identical_only":  # the last GT that reaches the max wins
        iou, gidx, mask = got
        assert (gidx[mask > 0] == len(gts) - 1).all() and iou.max() > 0.9


# (T, K, score rounding or None, overlap, topN)
NMS_TEMPORAL_CASES = {
    "equal_scores": (64, 16, 1, 0.8, 1000),
    "rounded_ties": (90, 32, 2, 0.5, 1000),
    "topN_reached": (80, 32, None, 0.8, 7),
    "overlap_0.8": (128, 64, None, 0.8, 1000),
    "overlap_0.999": (64, 32, None, 0.999, 1000),
    "overlap_0": (64, 32, 2, 0.0, 1000),
    "one_proposal": (2, 4, None, 0.8, 1000),
    "flagship": (256, 256, None, 0.8, 128),
}


@pytest.mark.parametrize("case", sorted(NMS_TEMPORAL_CASES))
def test_nms_temporal_picks_equal(case):
    T, K, dec, overlap, topN = NMS_TEMPORAL_CASES[case]
    r = np.random.RandomState(T * K)
    pp = r.rand(T, K).astype(np.float32)
    if dec is not None:
        pp = np.round(pp, dec).astype(np.float32)
    mask = labels.anchor_mask(T, K)
    gts = r.randint(0, 4, size=(T, K))
    args = (pp, mask, gts, 60.0)
    before = native.nms_temporal.calls
    got = proposals.top_proposals_nms(*args, labels.featstamp_to_time, overlap=overlap,
                                      topN=topN)
    assert native.nms_temporal.calls == before + 1
    with native.force_numpy():
        off = proposals.top_proposals_nms(*args, labels.featstamp_to_time, overlap=overlap,
                                          topN=topN)
    assert native.nms_temporal.calls == before + 1
    want = jproposals.top_proposals_nms(*args, jlabels.featstamp_to_time, overlap=overlap,
                                        topN=topN)
    assert got == off == want
    if case == "one_proposal":
        assert len(got[0]) == 1
    if case == "topN_reached":
        assert len(got[0]) == topN
    # the picks themselves, on the anchors as top_proposals_nms lays them out
    n_idx, k_idx = np.nonzero(mask > 0)
    props = np.stack([n_idx - k_idx, n_idx + 1], axis=1).astype(np.int64)
    scores = pp[n_idx, k_idx].astype(np.float64)
    picks = native.nms_temporal(props, scores, overlap, topN)
    assert picks.dtype == np.int32
    assert picks.tolist() == proposals.nms_temporal_numpy(props, scores, overlap, topN)


# (n, score rounding or None, overlap, topN)
NMS_EXTERNAL_CASES = {
    "equal_scores": (60, 0, 0.8, 1000),
    "rounded_ties": (100, 1, 0.8, 1000),
    "topN_reached": (120, None, 0.8, 5),
    "overlap_0.8": (150, None, 0.8, 1000),
    "overlap_0.999": (150, None, 0.999, 1000),
    "one_proposal": (1, None, 0.8, 1000),
}


@pytest.mark.parametrize("case", sorted(NMS_EXTERNAL_CASES))
def test_nms_external_picks_equal(case):
    n, dec, overlap, topN = NMS_EXTERNAL_CASES[case]
    r = np.random.RandomState(n + 11)
    starts = np.round(r.rand(n) * 50, 1)
    props = np.stack([starts, starts + np.round(r.rand(n) * 20 + 0.5, 1)], 1)
    props[n // 2:n // 2 + 3] = props[:3]  # identical windows: o = 1 in both directions
    scores, sents = r.rand(n), r.rand(n)
    if dec is not None:
        scores, sents = np.round(scores, dec), np.round(sents, dec)
    args = (props.tolist(), scores.tolist(), sents.tolist())
    before = native.nms_external.calls
    got = proposals.external_proposals_nms(*args, nms_overlap=overlap, topN=topN)
    assert native.nms_external.calls == before + 1
    with native.force_numpy():
        off = proposals.external_proposals_nms(*args, nms_overlap=overlap, topN=topN)
    want = jproposals.external_proposals_nms(*args, nms_overlap=overlap, topN=topN)
    assert got == off == want
    assert got[2] == jproposals._external_proposals_nms_numpy(
        props, scores, sents, overlap, topN)[2]
    assert native.nms_external(props, scores, sents, overlap, topN).tolist() == \
        proposals.nms_external_numpy(props, scores, sents, overlap, topN)
    if case == "topN_reached":
        assert len(got[2]) == topN


def _vocab():
    vocab = {str(i): f"w{i}" for i in range(1, 41)}
    vocab.update({"7": "café", "8": "naïve", "9": "日本語", "10": "😀x", "11": ""})
    return vocab


RENDER_CASES = {
    # an id past the vocab mid-row renders as nothing, without a separator
    "out_of_vocab_mid_row": [[1, 99, 2, 0, 3], [99, 0, 1, 1, 1], [1, 2, 3, 99, 41]],
    "zero_or_negative_mid_row": [[1, 2, 0, 3, 4], [5, -1, 6, 7, 8], [3, 4, -7, 0, 9]],
    "empty_rows": [[0, 1, 2, 3, 4], [-2, 5, 5, 5, 5], [0, 0, 0, 0, 0]],
    "non_ascii": [[7, 8, 9, 10, 0], [9, 9, 11, 9, 7], [10, 1, 0, 9, 9]],
    "one_row": [[1, 2, 3, 0, 4]],
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_captions_equal(case):
    vocab = _vocab()
    seq = np.asarray(RENDER_CASES[case], np.int64)
    before = native.render_captions.calls
    got = text.decode_sequence(vocab, seq)
    assert native.render_captions.calls == before + 1
    want = jtext.decode_sequence(vocab, seq)
    assert got == text.decode_sequence_numpy(vocab, seq) == want
    assert text.decode_sequence(vocab, seq[0]) == jtext.decode_sequence(vocab, seq[0])
    _, _, packed, offsets = text._tables(vocab)
    assert native.render_captions(packed, offsets, seq.astype(np.int32)) == want
    if case == "out_of_vocab_mid_row":
        assert got == ["w1 w2", "", "w1 w2 w3"]
    if case == "empty_rows":
        assert got == ["", "", ""]


def test_render_captions_random_rows():
    """A 4096 x 30 chunk at vocab 6000, ids from -1 to past the vocab."""
    vocab = {str(i): f"w{i}" for i in range(1, 6001)}
    r = np.random.RandomState(3)
    seq = r.randint(-1, 6010, size=(4096, 30))
    seq[:, :4] = r.randint(1, 6001, size=(4096, 4))
    assert text.decode_sequence(vocab, seq) == text.decode_sequence_numpy(vocab, seq) == \
        jtext.decode_sequence(vocab, seq)


def _cfg():
    cfg = flagship_config()
    cfg = cfg.replace_in("tap", K=32, prop_sample_num=8, video_dim=24)
    return cfg.replace_in("data", synthetic=True, lda_dim=16, time_buckets=(64, 128, 192),
                          synthetic_vocab_size=50, synthetic_seq_length=12)


@pytest.mark.parametrize("with_labels", [True, False], ids=["labels", "labels_off"])
def test_batches_equal_with_and_without_force_numpy(with_labels):
    """Every field of the port's batches, for videos that fit a bucket and
    ones cut to the largest (the sentinel stamps), with the C++ grid and
    under force_numpy(); the labelled batch counts one grid a video."""
    cfg = _cfg()
    ds = dataset.SyntheticDataset(cfg, num_videos=12, seed=7)
    for ix in range(12):
        ex = ds.get_example(ix)
        before = native.iou_grid.calls
        on = batcher.make_batch(ex, cfg, np.random.RandomState(ix), w1=ds.w1, labels=with_labels)
        if with_labels:
            assert native.iou_grid.calls == before + 1
        with native.force_numpy():
            off = batcher.make_batch(ex, cfg, np.random.RandomState(ix), w1=ds.w1,
                                     labels=with_labels)
            assert not native.active()
        assert native.active()
        for name, x, y in zip(on[0]._fields, on[0], off[0]):
            np.testing.assert_array_equal(x, y, err_msg=name)
            assert np.asarray(x).dtype == np.asarray(y).dtype, name
        for f in dataclasses.fields(on[1]):
            np.testing.assert_equal(getattr(on[1], f.name), getattr(off[1], f.name),
                                    err_msg=f.name)


def test_loader_threads_follow_force_numpy():
    """force_numpy() reaches the loader's prefetch threads, which make the
    labelled batches: no C++ grid inside it, the same batches."""
    cfg = _cfg().replace_in("data", nthreads=2, prefetch=3)
    got = {}
    for mode in ("on", "off"):
        native.reset_counts()
        with (native.force_numpy() if mode == "off" else contextlib.nullcontext()):
            ld = loader.Loader(dataset.SyntheticDataset(cfg, num_videos=8, seed=3), cfg,
                               process_index=0, process_count=1, seed=5)
            try:
                got[mode] = [ld.get_batch("train") for _ in range(4)]
            finally:
                ld.load_state(ld.state())  # stops and joins the prefetch threads
        got[mode + "_grids"] = native.iou_grid.calls
    assert got["on_grids"] >= 4 and got["off_grids"] == 0
    for (b, m), (c, n) in zip(got["on"], got["off"]):
        assert m.vid == n.vid
        for name, x, y in zip(b._fields, b, c):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_good_proposal_count_takes_the_grid_at_low_thresholds():
    gts = [(2, 40), (10, 20), (30, 60)]
    before = native.iou_grid.calls
    n = labels.good_proposal_count(gts, 64, 32, 0.5)
    assert native.iou_grid.calls == before + 1
    with native.force_numpy():
        assert labels.good_proposal_count(gts, 64, 32, 0.5) == n
    assert n == jlabels.good_proposal_count(gts, 64, 32, 0.5) > 0


_BUILD_CHILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    import numpy as np
    from echr_tpu_torch import native
    so = native.build(Path(sys.argv[1]))
    lib = native.load(so)
    iou = np.empty((8, 4), np.float32)
    gts, mask = np.empty_like(iou), np.empty_like(iou)
    lib.iou_grid(np.array([[1, 5]], np.int64), 1, 8, 4, iou, gts, mask)
    print(so.name, float(iou.max()))
""")


def test_concurrent_builds_all_load(tmp_path):
    """Four processes started together on one empty directory: each loads
    a working library, and one library file is left, whole."""
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(build_dir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err[-2000:] for _, err in outs]
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1, lines
    name, best = lines.pop().split()
    assert name == native.library_path(build_dir).name
    assert float(best) == pytest.approx(4 / 4.02)  # anchor (1, 5] against GT (0.99, 5.01)
    assert sorted(p.suffix for p in build_dir.iterdir()) == [".lock", ".so"]


@pytest.fixture
def fresh_library(monkeypatch, tmp_path):
    """native with no library loaded, building into an empty directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_warned_no_compiler", False)
    monkeypatch.delenv("ECHR_TPU_NO_NATIVE", raising=False)
    return tmp_path / "build"


def test_failed_build_raises(fresh_library, tmp_path, monkeypatch):
    """A compiler that exits 1: the build raises with its stderr, and the
    dispatching call sites raise too instead of running numpy."""
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'broken-cxx: fatal error: out of luck' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(cxx))
    with pytest.raises(RuntimeError, match="exited 1.*\n.*out of luck"):
        native.build(fresh_library)
    with pytest.raises(RuntimeError, match="out of luck"):
        native.available()
    with pytest.raises(RuntimeError, match="out of luck"):
        labels.iou_grid([(0, 5)], 10, 4)
    assert native._lib is None
    assert not list(fresh_library.glob("*.so")) and not list(fresh_library.glob("*.tmp"))


def test_library_loads_with_cdll_and_counts():
    """CDLL, not PyDLL: each call releases the GIL."""
    assert native.available()
    assert type(native.library()) is ctypes.CDLL
    native.reset_counts()
    text.decode_sequence({"1": "a"}, np.array([[1, 1, 0]]))
    labels.iou_grid([(0, 3)], 8, 4)
    assert native.counts() == {"iou_grid": 1, "nms_temporal": 0, "nms_external": 0,
                               "render_captions": 1}


def test_numpy_without_compiler_or_under_the_setting(fresh_library, monkeypatch, caplog):
    """No compiler on PATH: available() is False after one warning and the
    call sites run numpy; ECHR_TPU_NO_NATIVE does the same with a library
    loaded."""
    monkeypatch.setattr(native, "CXX", "no-such-compiler-echr")
    native.reset_counts()
    with caplog.at_level("WARNING", logger="echr_tpu_torch.native"):
        assert not native.available() and not native.active()
        got = labels.iou_grid([(0, 5), (3, 9)], 20, 8)
        assert text.decode_sequence({"1": "a"}, np.array([[1, 0]])) == ["a"]
    assert sum("no C++ compiler" in r.getMessage() for r in caplog.records) == 1
    assert native.counts() == dict.fromkeys(native.counts(), 0)
    for x, y in zip(got, labels.iou_grid_numpy([(0, 5), (3, 9)], 20, 8)):
        np.testing.assert_array_equal(x, y)
    assert not list(fresh_library.glob("*"))
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setenv("ECHR_TPU_NO_NATIVE", "1")
    assert not native.available()
    labels.iou_grid([(0, 5)], 20, 8)
    assert native.iou_grid.calls == 0
