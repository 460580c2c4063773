"""The port's batched eval loop against echr_tpu's on the CPU at f32:
the same synthetic split and the same weights (bridged from the JAX init,
logit weights sharpened so greedy and beam tokens are exact) give the same
predictions, val losses and scores, in every ported flag_eval_what mode.

Sentences, timestamps and the per-caption "num" must be equal; the
sentence confidence, proposal score and re_score within 5e-4 x the
caption's tokens (its words and the end token); the val losses within
1e-4 relative.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from test_torch_ops import to_np
from test_train_e2e import tiny_cfg

from echr_tpu.data.dataset import build_dataset as jax_build_dataset
from echr_tpu.data.loader import Loader as JaxLoader
from echr_tpu.engine.evaluate import eval_split_batched as jax_eval_split_batched
from echr_tpu.models.registry import init_captioner as jax_init_captioner
from echr_tpu.models.registry import init_tap as jax_init_tap

from echr_tpu_torch import config
from echr_tpu_torch.bridge import captioner_from_jax, tap_from_jax
from echr_tpu_torch.data.dataset import build_dataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import evaluate as E

TOL = 5e-4
SHARPEN = 100.0  # logit weight scale: argmax margins >> f32 noise
BATCH_VIDEOS = 2  # the 3-video val split: two groups, the second padded


class Split:
    """One synthetic split, its loaders and weights in both packages."""

    def __init__(self, tmp_path, **over):
        over = {"data.synthetic_num_videos": 12, "runtime.compute_dtype": "float32", **over}
        jcfg = tiny_cfg(tmp_path, **over)
        self.jds = jax_build_dataset(jcfg)
        self.jcfg = jcfg.replace_in("decoder", CG_vocab_size=self.jds.vocab_size,
                                    CG_seq_length=self.jds.seq_length)
        self.cfg = config.Config.from_json(self.jcfg.to_json())
        self.ds = build_dataset(self.cfg)
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        self.tap_np = to_np(jax_init_tap(k1, self.jcfg))
        self.cg_np = to_np(jax_init_captioner(k2, self.jcfg))
        self.cg_np["decoder"]["logit"]["w"] = self.cg_np["decoder"]["logit"]["w"] * SHARPEN
        self.jloader = JaxLoader(self.jds, self.jcfg, seed=0)
        self.loader = Loader(self.ds, self.cfg, process_index=0, process_count=1, seed=0)
        self.tmp = tmp_path

    def jax(self, kw, mode):
        return jax_eval_split_batched(self.tap_np, self.cg_np, self.jloader, self.jcfg,
                                      str(self.tmp / "jax.json"), dict(kw),
                                      flag_eval_what=mode, batch_videos=BATCH_VIDEOS)

    def port(self, kw, mode, **extra):
        return E.eval_split_batched(tap_from_jax(self.tap_np, self.cfg),
                                    captioner_from_jax(self.cg_np, self.cfg), self.loader,
                                    self.cfg, str(self.tmp / "port.json"), dict(kw),
                                    flag_eval_what=mode, batch_videos=BATCH_VIDEOS,
                                    device="cpu", **extra)

    def close(self):
        for ld in (self.loader, self.jloader):
            ld.load_state(ld.state())  # stops and joins the prefetch threads


@pytest.fixture
def split(tmp_path, request):
    s = Split(tmp_path, **getattr(request, "param", {}))
    yield s
    s.close()


def _kw(**over):
    return {"num_vids_eval": 0, "topN": 15, "language_eval": False, "val_all_metrics": False,
            "get_eval_loss": True, **over}


def assert_same_predictions(got, want):
    assert sorted(got) == sorted(want)
    assert sum(len(v) for v in want.values()) > 0
    for vid, preds in want.items():
        assert len(got[vid]) == len(preds), vid
        for g, w in zip(got[vid], preds):
            assert g["sentence"] == w["sentence"], vid
            assert list(g["timestamp"]) == list(w["timestamp"]), vid
            assert g["num"] == w["num"], vid
            tol = TOL * (len(w["sentence"].split()) + 1)
            for key in ("sentence_confidence", "proposal_score", "re_score"):
                assert abs(g[key] - w[key]) <= tol, (vid, key, g[key], w[key])


MODES = [
    ("cg", {}),
    ("cg_extend", {}),
    ("tap", {}),
    ("tap_cg", {}),
    ("tap_cg", {"nms_threshold": 0.5, "reranking": True}),
    ("tap_cg", {"beam_size": 2}),
]


@pytest.mark.parametrize("mode,over", MODES, ids=["cg", "cg_extend", "tap", "tap_cg",
                                                  "tap_cg_nms_rerank", "tap_cg_beam2"])
def test_eval_split_batched_matches_jax(split, mode, over):
    kw = _kw(**over)
    want, _, want_loss = split.jax(kw, mode)
    timing = {}
    got, score, got_loss = split.port(dict(kw, timing_out=timing), mode)
    assert_same_predictions(got, want)
    assert want_loss[0] > 0
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4, atol=0)
    assert score == {}
    assert timing["groups"] == 2 and timing["grid_fallbacks"] == 0
    assert set(timing) == {"loader", "host_prep", "prep_stack", "prep_put", "prep_encode",
                           "select_fetch", "host_select", "loss_fetch", "decode_dispatch",
                           "decode_fetch", "assemble", "groups", "grid_fallbacks"}


def test_eval_scores_and_json_match_jax(split):
    """language_eval with every metric: the score dicts are equal, and so are
    the predictions files' keys and videos."""
    import json

    kw = _kw(language_eval=True, val_all_metrics=True)
    want, want_score, _ = split.jax(kw, "tap_cg")
    got, got_score, _ = split.port(kw, "tap_cg")
    assert_same_predictions(got, want)
    assert sorted(got_score) == sorted(want_score)
    assert {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "Recall", "Precision"} <= set(got_score)
    for k in want_score:
        np.testing.assert_array_equal(got_score[k], want_score[k], err_msg=k)
        assert np.shape(got_score[k]) == (4,), k
    with open(split.tmp / "jax.json") as f:
        jj = json.load(f)
    with open(split.tmp / "port.json") as f:
        pj = json.load(f)
    assert set(pj) == set(jj) == {"results", "version", "external_data"}
    assert pj["version"] == jj["version"] and pj["external_data"] == jj["external_data"]
    assert sorted(pj["results"]) == sorted(jj["results"])


@pytest.mark.parametrize("split", [{"runtime.transfer_dtype": "bfloat16"}], indirect=True)
@pytest.mark.parametrize("get_eval_loss", [False, True], ids=["decode_only", "with_losses"])
def test_bf16_transfer_matches_jax(split, get_eval_loss):
    """bf16 feature transfer: cast in the prefetch workers on the decode-only
    path, in the prep stage with val losses; both round to nearest even."""
    kw = _kw(get_eval_loss=get_eval_loss)
    want, _, want_loss = split.jax(kw, "tap_cg")
    got, _, got_loss = split.port(kw, "tap_cg")
    assert_same_predictions(got, want)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4, atol=0)
    assert split.loader.labels_for("val") and split.loader.feats_dtype_for("val") is None


@pytest.mark.parametrize("split", [{"runtime.transfer_dtype": "bfloat16"}], indirect=True)
def test_abort_restores_loader_state(split, monkeypatch):
    """An exception mid-pass restores the split's labels and feature dtype
    and leaves no prep or assembler thread behind (echr_tpu's
    test_batched_eval_abort_restores_loader_state)."""
    labels_before = split.loader.labels_for("val")
    dtype_before = split.loader.feats_dtype_for("val")
    threads_before = {t.name for t in threading.enumerate()}

    def boom(*a, **k):
        raise RuntimeError("injected decode failure")

    monkeypatch.setattr(E, "select_proposals", boom)
    kw = _kw(get_eval_loss=False, device_select=False)
    with pytest.raises(RuntimeError, match="injected decode failure"):
        split.port(kw, "tap_cg")
    assert split.loader.labels_for("val") == labels_before
    assert split.loader.feats_dtype_for("val") == dtype_before
    leftover = {t.name for t in threading.enumerate()} - threads_before
    assert not any("eval-assembler" in n or "eval-prep" in n for n in leftover), leftover


def test_unported_modes_raise(split, monkeypatch):
    kw = _kw()
    # sample_max=0 is ported: multinomial decode captions the split
    preds, _, _ = split.port(dict(kw, sample_max=0, sample_seed=3), "tap_cg")
    assert preds and all(p["sentence_confidence"] <= 0.0 for v in preds.values() for p in v)
    with pytest.raises(NotImplementedError, match="A.6"):
        split.port(kw, "SOTA_TEP")
    with pytest.raises(NotImplementedError, match="A.13"):
        split.port(kw, "tap_cg", multihost=True)
    with pytest.raises(NotImplementedError, match="A.9-A.10"):
        E.eval_split(None, None, split.loader, split.cfg, str(split.tmp / "x.json"))
    with pytest.raises(ValueError, match="not supported"):
        split.port(kw, "gt")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.eval_split_batched(None, None, split.loader, split.cfg, str(split.tmp / "x.json"),
                             kw, device="cuda")
    assert split.loader.labels_for("val") and split.loader.feats_dtype_for("val") is None
