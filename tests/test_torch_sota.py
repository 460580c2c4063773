"""External (SOTA) proposals in the port against echr_tpu, on the CPU.

The synthetic proposals and BatchMeta's SOTA_* fields are equal, exactly,
on both label forms of make_batch (the crop substream is drawn before the
fork); external_proposals_nms picks the same proposals; and
eval_split_batched(flag_eval_what="SOTA_TEP") on SOTA_json="synthetic",
at f32 with tests/test_torch_eval.py's sharpened logit weights, gives equal
sentences, timestamps and proposal scores, sentence confidences within
5e-4 a token and val losses within 1e-5 relative: with and without NMS,
under a score threshold and topN cap, decode-only, and with a video that
has no external proposals.  Then cli/eval with --flag_eval_what SOTA_TEP
--SOTA_json synthetic against echr_tpu's CLI on one checkpoint, and
cli/score on its JSON.
"""
import json

import numpy as np
import pytest

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_eval import Split, _kw, assert_same_predictions
from test_train_e2e import tiny_cfg

from echr_tpu.cli.eval import main as jax_eval_cli
from echr_tpu.cli.score import main as jax_score_cli
from echr_tpu.data.batcher import make_batch as jax_make_batch
from echr_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from echr_tpu.engine.proposals import _external_proposals_nms_numpy, external_proposals_nms

from echr_tpu_torch import bridge, config
from echr_tpu_torch.cli import eval as cli_eval
from echr_tpu_torch.cli import score as cli_score
from echr_tpu_torch.data.batcher import make_batch
from echr_tpu_torch.data.dataset import SyntheticDataset
from echr_tpu_torch.engine import checkpoint, steps
from echr_tpu_torch.engine.proposals import external_proposals_nms as port_nms
from echr_tpu_torch.metrics.eval_score import gt_from_dataset

SOTA_FIELDS = ("SOTA_featstamps", "SOTA_scores", "SOTA_timestamps", "SOTA_ind", "SOTA_soi",
               "SOTA_cg_select")


def _datasets(tmp_path, n=24):
    jcfg = tiny_cfg(tmp_path, **{"data.synthetic_num_videos": n, "data.SOTA_json": "synthetic"})
    return JaxSynthetic(jcfg), SyntheticDataset(config.Config.from_json(jcfg.to_json()))


def test_batchmeta_sota_fields_match_jax_on_both_label_forms(tmp_path):
    jds, ds = _datasets(tmp_path)
    K = ds.cfg.tap.K
    cropped = 0
    for ix in range(len(ds)):
        ex, jex = ds.get_example(ix), jds.get_example(ix)
        T = ex.feats.shape[0]
        sota = ds.get_sota(ex.vid, T, ex.duration)
        assert sota == jds.get_sota(jex.vid, T, jex.duration) and sota[0]
        metas = {}
        for labels in (True, False):
            _, m = make_batch(ex, ds.cfg, np.random.RandomState(ix), w1=ds.w1, labels=labels,
                              sota_fn=lambda n, d, v=ex.vid: ds.get_sota(v, n, d))
            _, jm = jax_make_batch(jex, jds.cfg, np.random.RandomState(ix), w1=jds.w1,
                                   labels=labels,
                                   sota_fn=lambda n, d, v=jex.vid: jds.get_sota(v, n, d))
            for f in SOTA_FIELDS:
                assert getattr(m, f) == getattr(jm, f), (ix, labels, f)
            metas[labels] = m
        for f in SOTA_FIELDS[:-1]:  # the labels-off form has no caption index
            assert getattr(metas[True], f) == getattr(metas[False], f), (ix, f)
        assert metas[False].SOTA_cg_select == [0] * len(sota[0])
        cropped += sum(f != list(s) for f, s in zip(metas[True].SOTA_featstamps, sota[0]))
        assert all(e - s <= K for s, e in metas[True].SOTA_featstamps)
    assert cropped > 0  # windows longer than K anchors were cropped


@pytest.mark.parametrize("overlap", [0.3, 0.5, 0.8, 0.999])
def test_external_proposals_nms_matches_jax(overlap):
    r = np.random.RandomState(7)
    s = r.rand(120) * 100.0
    props = np.stack([s, s + 1.0 + r.rand(120) * 40.0], 1)
    props[60:80] = props[:20]  # exact duplicates: clusters at overlap 0.999
    scores = r.rand(120).round(2)  # ties in the proposal scores
    sent = r.randn(120)
    for topN in (1000, 7):
        got = port_nms(props.tolist(), scores.tolist(), sent.tolist(), overlap, topN)
        assert got == _external_proposals_nms_numpy(props, scores, sent, overlap, topN)
        assert got == external_proposals_nms(props.tolist(), scores.tolist(), sent.tolist(),
                                             nms_overlap=overlap, topN=topN)
        assert 0 < len(got[2]) <= topN


CASES = [
    ("plain", {}, False),
    ("nms", {"nms_threshold": 0.5}, False),
    ("thres_topN", {"val_score_thres": 0.3, "topN": 4}, False),
    ("decode_only", {"get_eval_loss": False}, False),
    ("no_proposals_video", {}, True),
]


@pytest.mark.parametrize("over,drop_one", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_sota_tep_eval_matches_jax(tmp_path, over, drop_one):
    s = Split(tmp_path, **{"data.SOTA_json": "synthetic"})
    try:
        dropped = "v_synth00010"  # a val video of the 12
        if drop_one:
            for ds in (s.ds, s.jds):
                ds.get_sota = lambda vid, n, d, f=ds.get_sota: (
                    (None, None, None) if vid == dropped else f(vid, n, d))
        kw = _kw(**over)
        want, _, want_loss = s.jax(kw, "SOTA_TEP")
        got, _, got_loss = s.port(kw, "SOTA_TEP")
    finally:
        s.close()
    assert_same_predictions(got, want)
    assert (dropped not in got) == drop_one
    if kw["get_eval_loss"]:
        assert want_loss[1] > 0
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5, atol=0)
    else:
        assert not want_loss.any() and not got_loss.any()
    cap = kw["topN"]
    assert all(len(v) <= cap for v in got.values())
    if "val_score_thres" in over:
        assert all(p["proposal_score"] >= over["val_score_thres"]
                   for v in got.values() for p in v)


def test_eval_cli_sota_tep_and_score_cli(tmp_path):
    """cli/eval --flag_eval_what SOTA_TEP --SOTA_json synthetic on a port
    checkpoint equals echr_tpu's CLI on it; cli/score of that JSON equals
    echr_tpu's score CLI (tests/test_cli.py's flow)."""
    s = Split(tmp_path)
    s.close()
    state = steps.init_train_state(s.cfg, bridge.tap_from_jax(s.tap_np, s.cfg),
                                   bridge.captioner_from_jax(s.cg_np, s.cfg))
    checkpoint.save_checkpoint(str(tmp_path / "EV" / "model-best.ckpt"), state, s.cfg,
                               iteration=1, epoch=0, best_val_score=0.0,
                               vocab=s.ds.ix_to_word)
    argv = ["--folder_id", "EV", "--checkpoint_path", str(tmp_path), "--flag_eval_what",
            "SOTA_TEP", "--SOTA_json", "synthetic", "--topN", "5", "--batch_videos", "2",
            "--no_language_eval"]
    jax_eval_cli(argv)
    path = tmp_path / "EV" / "eval_SOTA_TEP_top5_thr0.0_nms0.0.json"
    want = json.loads(path.read_text())["results"]
    assert cli_eval.main(argv + ["--device", "cpu"]) == str(path)
    got = json.loads(path.read_text())["results"]
    assert_same_predictions(got, want)
    assert len(got) == 3

    ds = SyntheticDataset(s.cfg.replace_in("data", SOTA_json="synthetic"))
    gt = tmp_path / "gt.json"
    gt.write_text(json.dumps(gt_from_dataset(type("L", (), {"dataset": ds})())))
    scores = cli_score.main(["-s", str(path), "-r", str(gt), "-v"])
    assert scores == jax_score_cli(["-s", str(path), "-r", str(gt), "-v"])
    assert scores["tiou"] == [0.3, 0.5, 0.7, 0.9] and len(scores["Recall"]) == 4
    assert "METEOR" in scores and max(scores["Recall"]) > 0
