"""The port's serve CLI against echr_tpu's, on the CPU at f32.

One format-v2 checkpoint (the port writes tests/test_torch_eval.py's
sharpened weights) and one directory of raw C3D .npy files, one of them
longer than the largest time bucket: both CLIs give the same videos,
sentences and timestamps, proposal scores within 1e-5 and sentence
confidences within 5e-4 a token (the words and the end token).  Greedy
and beam 2, with and without --pre_normalized (with it, durations come
from --duration_json).
"""
import json

import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_eval import Split

from echr_tpu.cli.serve import main as jax_serve_cli

from echr_tpu_torch import bridge
from echr_tpu_torch.cli import serve as cli_serve
from echr_tpu_torch.engine import checkpoint, steps

TOL = 5e-4


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    s = Split(tmp)
    s.close()
    state = steps.init_train_state(s.cfg, bridge.tap_from_jax(s.tap_np, s.cfg),
                                   bridge.captioner_from_jax(s.cg_np, s.cfg))
    ckpt = tmp / "model-best.ckpt"
    checkpoint.save_checkpoint(str(ckpt), state, s.cfg, iteration=1, epoch=0,
                               best_val_score=0.0, vocab=s.ds.ix_to_word)
    fd = tmp / "feats"
    fd.mkdir()
    r = np.random.RandomState(0)
    lengths = (40, 57, 90, 133, 300)  # 300 > the 256-frame bucket: cut to a prefix
    for i, T in enumerate(lengths):
        np.save(fd / f"v_{i}.npy", (r.randn(T, s.cfg.tap.video_dim) * 0.7).astype(np.float32))
    (tmp / "dur.json").write_text(json.dumps({f"v_{i}": 0.9 * T + i
                                              for i, T in enumerate(lengths)}))
    return tmp, ckpt, fd


@pytest.mark.parametrize("beam", [1, 2], ids=["greedy", "beam2"])
@pytest.mark.parametrize("pre_normalized", [False, True], ids=["raw", "pre_normalized"])
def test_serve_cli_matches_jax(served, beam, pre_normalized):
    tmp, ckpt, fd = served
    argv = ["--checkpoint", str(ckpt), "--features_dir", str(fd), "--batch_videos", "2",
            "--topN", "6", "--beam_size", str(beam)]
    if pre_normalized:
        argv += ["--pre_normalized", "--duration_json", str(tmp / "dur.json")]
    jax_serve_cli(argv + ["--output", str(tmp / "jax.json")])
    want = json.loads((tmp / "jax.json").read_text())
    got = cli_serve.main(argv + ["--output", str(tmp / "port.json"), "--device", "cpu"])
    assert json.loads((tmp / "port.json").read_text()) == got
    assert {k: v for k, v in got.items() if k != "results"} == {
        k: v for k, v in want.items() if k != "results"}
    got, want = got["results"], want["results"]
    assert sorted(got) == sorted(want) == [f"v_{i}" for i in range(5)]
    n = 0
    for vid, caps in want.items():
        assert len(got[vid]) == len(caps) > 0, vid
        for g, w in zip(got[vid], caps):
            assert g["sentence"] == w["sentence"], vid
            assert g["timestamp"] == w["timestamp"], vid
            assert abs(g["proposal_score"] - w["proposal_score"]) <= 1e-5, vid
            tol = TOL * (len(w["sentence"].split()) + 1)
            assert abs(g["sentence_confidence"] - w["sentence_confidence"]) <= tol, vid
            n += bool(w["sentence"])
    assert n > 0


def test_serve_cli_needs_cuda_by_default(served, monkeypatch):
    tmp, ckpt, fd = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_serve.main(["--checkpoint", str(ckpt), "--features_dir", str(fd),
                        "--output", str(tmp / "x.json")])
