"""The port's on-disk data tools against echr_tpu's, on the CPU.

ActivityNetDataset on tests/test_dataset_fixture.py's reference-layout
tree (with its SOTA JSON, C3D alone and with the two-stream CSVs) gives
echr_tpu's examples and external proposals exactly; export_synthetic_corpus
writes the same files as echr_tpu's (arrays exact, JSON equal); reading the
port's export back gives the in-memory examples within atol 2e-6 (the f32
rounding of the C3D moments); validate_data gives echr_tpu's exit code and
report on a clean tree and on each corruption of
tests/test_validate_data.py.  Each runs with h5py and with the port's own
HDF5 reader and writer (data/hdf5.py, taken where h5py is not installed),
whose files h5py reads and which reads h5py's.
"""
import contextlib
import json
import os
import sys
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest

from test_dataset_fixture import fixture_cfg, make_fixture
from test_train_e2e import tiny_cfg
from test_validate_data import _args, _ts_args

from echr_tpu.cli.validate_data import main as jax_validate
from echr_tpu.data.dataset import build_dataset as jax_build_dataset
from echr_tpu.data.export_disk import export_synthetic_corpus as jax_export

from echr_tpu_torch import config
from echr_tpu_torch.cli.validate_data import main as validate
from echr_tpu_torch.data.dataset import ActivityNetDataset, SyntheticDataset, build_dataset
from echr_tpu_torch.data import hdf5
from echr_tpu_torch.data.export_disk import disk_cfg, export_synthetic_corpus

BACKENDS = ["h5py", "builtin"]


@contextlib.contextmanager
def _hdf5_backend(name):
    """Within the block the port opens HDF5 files with h5py or, with h5py
    hidden, with data/hdf5.File."""
    mp = pytest.MonkeyPatch()
    if name == "builtin":
        mp.setitem(sys.modules, "h5py", None)
    try:
        import h5py as visible  # noqa: F401
    except ImportError:
        visible = None
    assert (visible is None) == (name == "builtin")
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(params=BACKENDS)
def backend(request):
    return lambda: _hdf5_backend(request.param)


def _port(jcfg):
    return config.Config.from_json(jcfg.to_json())


def _same_example(a, b):
    assert a.vid == b.vid and a.split == b.split and a.duration == b.duration
    np.testing.assert_array_equal(a.feats, b.feats)
    np.testing.assert_array_equal(a.lda, b.lda)
    np.testing.assert_array_equal(a.cap_labels, b.cap_labels)
    assert [tuple(t) for t in a.timestamps] == [tuple(t) for t in b.timestamps]
    assert a.sentences == b.sentences


@pytest.mark.parametrize("over", [{}, {"data.use_2stream_feature": True}],
                         ids=["c3d", "twostream"])
def test_activitynet_dataset_matches_jax(tmp_path, over, backend):
    jcfg = fixture_cfg(tmp_path, **over)
    jcfg = jcfg.replace_in("data", SOTA_json=str(tmp_path / "data" / "sota.json"))
    jds = jax_build_dataset(jcfg)
    with backend():
        ds = build_dataset(_port(jcfg))
    assert isinstance(ds, ActivityNetDataset)
    assert ds.split_ix == jds.split_ix and ds.ix_to_word == jds.ix_to_word
    assert ds.seq_length == jds.seq_length and len(ds) == len(jds) == 5
    np.testing.assert_array_equal(ds.w1, jds.w1)
    assert ds.sota_proposals == jds.sota_proposals and ds.sota_proposals
    for ix in range(len(ds)):
        a, b = ds.get_example(ix), jds.get_example(ix)
        _same_example(a, b)
        T = a.feats.shape[0]
        got, want = ds.get_sota(a.vid, T, a.duration), jds.get_sota(b.vid, T, b.duration)
        assert got == want and got[0]
    if over:
        assert ds.get_example(0).feats.shape[1] == 24 + 400
    assert ds.get_sota("v_absent", 10, 5.0) == (None, None, None)


def _tree(root: Path):
    """Every file under root: arrays for .npy and .h5, parsed JSON."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_dir():
            continue
        key = str(p.relative_to(root))
        if p.suffix == ".npy":
            out[key] = np.load(p)
        elif p.suffix == ".h5":
            with h5py.File(p, "r") as h5:
                out[key] = {k: np.asarray(h5[k]) for k in h5.keys()}
        else:
            out[key] = json.loads(p.read_text())
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    jcfg = tiny_cfg(root, **{"data.synthetic_num_videos": 12,
                             "data.synthetic_learnable": True})
    jax_export(jcfg, str(root / "jax"), log_every=0)
    cfg = _port(jcfg)
    paths = export_synthetic_corpus(cfg, str(root / "h5py"), log_every=0)
    with _hdf5_backend("builtin"):
        export_synthetic_corpus(cfg, str(root / "builtin"), log_every=0)
    return cfg, root, paths


@pytest.mark.parametrize("writer", BACKENDS)
def test_export_writes_jax_files(corpus, writer):
    cfg, root, paths = corpus
    want, got = _tree(root / "jax"), _tree(root / writer)
    assert sorted(got) == sorted(want) and len(got) == 12 + 7
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif key.endswith(".h5"):
            assert sorted(g) == sorted(w), key
            for k in w:
                assert g[k].dtype == w[k].dtype, (key, k)
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{key}:{k}")
        else:
            assert g == w, key
    assert paths == {k: v for k, v in
                     vars(disk_cfg(cfg, str(root / "h5py")).data).items() if k in paths}


@pytest.mark.parametrize("writer", BACKENDS)
def test_export_round_trip(corpus, writer, backend):
    cfg, root, _ = corpus
    syn = SyntheticDataset(cfg)
    with backend():
        disk = build_dataset(disk_cfg(cfg, str(root / writer)))
    assert isinstance(disk, ActivityNetDataset)
    assert disk.split_ix == syn.split_ix and disk.ix_to_word == syn.ix_to_word
    assert disk.seq_length == syn.seq_length
    np.testing.assert_allclose(disk.w1, syn.w1, rtol=1e-6)
    for ix in range(len(syn)):
        a, b = syn.get_example(ix), disk.get_example(ix)
        assert a.vid == b.vid and a.split == b.split and a.duration == b.duration
        np.testing.assert_allclose(b.feats, a.feats, atol=2e-6, rtol=0)
        np.testing.assert_array_equal(a.cap_labels, b.cap_labels)
        assert [tuple(t) for t in a.timestamps] == [tuple(t) for t in b.timestamps]
        assert a.sentences == b.sentences
        np.testing.assert_array_equal(a.lda, b.lda)


# ------------------------------------- validate_data: tests/test_validate_data.py's trees


def _swap_label_ix(data):
    with h5py.File(data / "train_lm.h5", "r+") as h5:
        start = np.asarray(h5["label_start_ix"])
        end = np.asarray(h5["label_end_ix"])
        start[0], end[0] = end[0], start[0]
        end[-1] = h5["labels"].shape[0] + 7
        del h5["label_start_ix"], h5["label_end_ix"]
        h5["label_start_ix"], h5["label_end_ix"] = start, end
        h5["labels"][0, 1] = 10_000


def _several(data):
    os.remove(data / "c3d_npy" / "v_fix00001.npy")
    np.save(data / "c3d_npy" / "v_fix00002.npy", np.zeros((10, 99), np.float32))
    s = json.loads((data / "sota.json").read_text())
    s["results"] = {("v_" + k): v for k, v in s["results"].items()}
    (data / "sota.json").write_text(json.dumps(s))
    info = json.loads((data / "info.json").read_text())
    info["videos"] = info["videos"][::-1]
    (data / "info.json").write_text(json.dumps(info))


def _drop_h5_dataset(data):
    with h5py.File(data / "val_lm.h5", "r+") as h5:
        del h5["label_end_ix"]


def _nan_npy(data):
    arr = np.load(data / "c3d_npy" / "v_fix00000.npy")
    arr[0, 0] = np.nan
    np.save(data / "c3d_npy" / "v_fix00000.npy", arr)


def _drop_lda_video(data):
    with h5py.File(data / "lda.h5", "r+") as h5:
        del h5["v_fix00003"]


def _truncate_csv(data):
    p = data / "twostream" / "spatial" / "csv_action" / "v_fix00000.csv"
    txt = p.read_text()
    p.write_text(txt[: int(len(txt) * 0.6)].rsplit(",", 1)[0] + ",oops")


def _drop_of_csv(data):
    os.remove(data / "twostream" / "OF" / "csv_action" / "v_fix00000.csv")


def _cut_of_rows(data):
    p = data / "twostream" / "OF" / "csv_action" / "v_fix00000.csv"
    df = pd.read_csv(p)
    df.iloc[: len(df) // 4].to_csv(p, index=False)


def _ghost_event(data):
    anno = json.loads((data / "anno.json").read_text())
    anno["v_fix00000"]["timestamps"].append([0.0, 1.0])
    anno["v_fix00000"]["sentences"].append("ghost event")
    (data / "anno.json").write_text(json.dumps(anno))


_TREES = [  # (id, corruption, argv builder, extra flags, expected exit code)
    ("clean", None, _args, {}, 0),
    ("several", _several, _args, {}, 1),
    ("label_ix", _swap_label_ix, _args, {}, 1),
    ("missing_h5_dataset", _drop_h5_dataset, _args, {}, 1),
    ("nonfinite_npy", _nan_npy, _args, {}, 1),
    ("lda_missing_video", _drop_lda_video, _args, {}, 1),
    ("lda_dim", None, _args, {"--lda_dim": "99"}, 1),
    ("twostream_clean", None, _ts_args, {}, 0),
    ("truncated_csv", _truncate_csv, _ts_args, {}, 1),
    ("of_missing", _drop_of_csv, _ts_args, {}, 1),
    ("severe_truncation", _cut_of_rows, _ts_args, {}, 1),
    ("caption_count", _ghost_event, _args, {}, 1),
]


@pytest.mark.parametrize("corrupt,argv,extra,code", [t[1:] for t in _TREES],
                         ids=[t[0] for t in _TREES])
def test_validate_data_matches_jax(tmp_path, capsys, corrupt, argv, extra, code, backend):
    data = make_fixture(tmp_path)
    if corrupt is not None:
        corrupt(data)
    args = argv(data) if argv is _ts_args else argv(data, **extra)
    capsys.readouterr()
    want_code = jax_validate(args)
    want = capsys.readouterr().out
    with backend():
        got_code = validate(args)
    got = capsys.readouterr().out
    assert got_code == want_code == code
    assert got == want
    assert ("0 error(s)" in got) == (code == 0)


# ----------------------------------------------- data/hdf5.py against h5py, both ways

H5_ARRAYS = {
    "labels": np.arange(6 * 31, dtype=np.int64).reshape(6, 31) % 6001,
    "label_start_ix": np.arange(6, dtype=np.int64),
    "u4": np.array([0, 7, 2**32 - 1], np.uint32),
    "i2_be": np.arange(-3, 3, dtype=">i2"),
    "f32": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
    "f64_be": np.linspace(0, 5, 5).astype(">f8"),
    "empty": np.zeros((0, 31), np.int64),
    **{f"v_synth{i:05d}": np.full(100, i / 7, np.float32) for i in range(300)},
}


def test_hdf5_files_read_both_ways(tmp_path):
    """The built-in writer's file through h5py, and h5py's file (its
    multi-node group B-tree included) through the built-in reader, equal
    the arrays; h5py's in-place deletion is read too."""
    with hdf5.File(tmp_path / "mine.h5", "w") as f:
        for k, v in H5_ARRAYS.items():
            f[k] = v
    with h5py.File(tmp_path / "mine.h5", "r") as h5:
        assert sorted(h5.keys()) == sorted(H5_ARRAYS)
        for k, v in H5_ARRAYS.items():
            got = np.asarray(h5[k])
            assert got.shape == v.shape and got.dtype.kind == v.dtype.kind, k
            np.testing.assert_array_equal(got, v, err_msg=k)
    with h5py.File(tmp_path / "theirs.h5", "w") as h5:
        for k, v in H5_ARRAYS.items():
            h5[k] = v
    with h5py.File(tmp_path / "theirs.h5", "r+") as h5:
        del h5["v_synth00003"]
    with hdf5.File(tmp_path / "theirs.h5") as f:
        want = {k: v for k, v in H5_ARRAYS.items() if k != "v_synth00003"}
        assert f.keys() == sorted(want) and "v_synth00003" not in f
        for k, v in want.items():
            assert f[k].shape == v.shape and f[k].dtype == v.dtype.newbyteorder("="), k
            np.testing.assert_array_equal(f[k], v, err_msg=k)


def test_hdf5_outside_the_subset_raises(tmp_path):
    with h5py.File(tmp_path / "gz.h5", "w") as h5:
        h5.create_dataset("x", data=np.arange(100), chunks=(10,), compression="gzip")
    with pytest.raises(NotImplementedError, match="filter pipeline.*h5py"):
        hdf5.File(tmp_path / "gz.h5")["x"]
    with h5py.File(tmp_path / "latest.h5", "w", libver="latest") as h5:
        h5["x"] = np.arange(3)
    with pytest.raises(NotImplementedError, match="superblock version"):
        hdf5.File(tmp_path / "latest.h5")
    with pytest.raises(ValueError, match="mode"):
        hdf5.File(tmp_path / "latest.h5", "r+")
