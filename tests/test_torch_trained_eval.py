"""Decode at trained weights, in the port against echr_tpu, on the CPU.

A tiny captioner trained by the port's train() on learnable synthetic
captions (100 pre_cg steps at f32: its greedy captions end after 2-5 of
L = 10 tokens) and saved in format v2.  echr_tpu's load_checkpoint reads
the same file; both packages' eval_split_batched, greedy at f32 with the
batch-wide early exit on, give the same predictions token for token
(ROADMAP's greedy gate, on trained weights; confidences within
tests/test_torch_eval.py's 5e-4 a token).  The port's early exits on and
off give the same predictions JSON byte for byte, with fewer decode steps
and one host sync a step on: the batched greedy and beam-4 decodes
(runtime.decode_early_exit_batched) and the per-video eval_split's
greedy and beam-4 loops (runtime.decode_early_exit), and so in the
port's probe_trained_e2e.  SCST from the trained checkpoint at batch_size
1 at bf16 (the recipe's stage 4): its greedy baseline ends before L.
"""
import os
import types

import numpy as np
import pytest

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_eval import assert_same_predictions
from test_train_e2e import tiny_cfg

from echr_tpu.data.dataset import build_dataset as jax_build_dataset
from echr_tpu.data.loader import Loader as JaxLoader
from echr_tpu.engine import checkpoint as jckpt
from echr_tpu.engine.evaluate import eval_split_batched as jax_eval_split_batched

from echr_tpu_torch import config
from echr_tpu_torch.data.dataset import build_dataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import checkpoint, rl
from echr_tpu_torch.engine import train as ttrain
from echr_tpu_torch.engine.evaluate import eval_split, eval_split_batched
from echr_tpu_torch.experiments import probe_trained_e2e as probe
from echr_tpu_torch.models.beam import beam_search_batched
from echr_tpu_torch.models.decoder import decoder_sample_batched

TRAIN_STEPS = 100
BATCH_VIDEOS = 2
KW = {"num_vids_eval": 0, "topN": 10, "language_eval": False, "get_eval_loss": False}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's train() for TRAIN_STEPS pre_cg steps at f32 on 16
    learnable synthetic videos (4 in val), its model-last.ckpt read by
    both packages, and a loader over the val split in each."""
    tmp = tmp_path_factory.mktemp("trained")
    over = {"data.synthetic_learnable": True, "data.synthetic_num_videos": 16,
            "train.lr": 3e-3, "train.cg_epochs": 10**4, "runtime.compute_dtype": "float32"}
    cfg = config.Config.from_json(tiny_cfg(tmp, **over).to_json()).replace(run_id="TR")
    out = ttrain.train(cfg, max_iterations=TRAIN_STEPS, device="cpu")
    path = os.path.join(out["save_folder"], "model-last.ckpt")
    port = checkpoint.load_checkpoint(path, "cpu")
    jax_payload = jckpt.load_checkpoint(path)
    t = types.SimpleNamespace(
        path=path, tmp=tmp, cfg=port["config"], state=port["state"],
        jcfg=jax_payload["config"], jstate=jax_payload["state"])
    t.loader = Loader(build_dataset(t.cfg), t.cfg, 0, 1, seed=0)
    t.jloader = JaxLoader(jax_build_dataset(t.jcfg), t.jcfg, seed=0)
    yield t
    for ld in (t.loader, t.jloader):
        ld.load_state(ld.state())  # stops and joins the prefetch threads


def _port_pass(t, driver, beam, exit_on, name):
    """One pass of the port's batched or per-video eval (tap_cg) with the
    driver's early exit on or off: (predictions, the JSON's text, decode
    steps, early-exit host syncs)."""
    key = "decode_early_exit_batched" if driver == "batched" else "decode_early_exit"
    cfg = t.cfg.replace_in("runtime", **{key: exit_on})
    fn = decoder_sample_batched if beam == 1 else beam_search_batched
    fn.steps = fn.host_syncs = 0
    path = str(t.tmp / f"{name}.json")
    kw = dict(KW, beam_size=beam)
    if driver == "batched":
        preds, _, _ = eval_split_batched(t.state.tap, t.state.cg, t.loader, cfg, path, kw,
                                         flag_eval_what="tap_cg", batch_videos=BATCH_VIDEOS,
                                         device="cpu")
    else:
        preds, _, _ = eval_split(t.state.tap, t.state.cg, t.loader, cfg, path, kw,
                                 flag_eval_what="tap_cg", device="cpu")
    with open(path) as f:
        return preds, f.read(), fn.steps, fn.host_syncs


def test_trained_greedy_matches_jax(trained):
    """Both packages' batched greedy eval of the same trained checkpoint,
    early exit on: the same sentences and timestamps, captions that end
    before L, and a decode that stopped before L steps."""
    t = trained
    want, _, _ = jax_eval_split_batched(t.jstate.tap_params, t.jstate.cg_params, t.jloader,
                                        t.jcfg, str(t.tmp / "jax.json"), dict(KW),
                                        flag_eval_what="tap_cg", batch_videos=BATCH_VIDEOS)
    got, _, steps, syncs = _port_pass(t, "batched", 1, True, "port")
    assert_same_predictions(got, want)
    L = t.cfg.decoder.CG_seq_length
    groups = -(-len(got) // BATCH_VIDEOS)
    lengths = [len(p["sentence"].split()) for v in got.values() for p in v]
    assert max(lengths) < L - 1 and 0 < steps < L * groups and syncs > 0


@pytest.mark.parametrize("driver,beam", [("batched", 1), ("batched", 4), ("per_video", 1),
                                         ("per_video", 4)])
def test_early_exit_changes_no_prediction(trained, driver, beam):
    """The exit on and off: the same predictions JSON, fewer decode steps
    on, one early-exit host sync a step on and none off."""
    _, on_json, on_steps, on_syncs = _port_pass(trained, driver, beam, True, "on")
    _, off_json, off_steps, off_syncs = _port_pass(trained, driver, beam, False, "off")
    assert on_json == off_json and len(on_json) > 100
    assert 0 < on_steps < off_steps and on_syncs > 0 and off_syncs == 0


def test_scst_from_trained_weights_exits_early(trained, monkeypatch):
    """The recipe's stage 4 on the trained checkpoint: SCST at batch_size 1
    at bf16 from --pretrain tap_cg; finite losses and rewards, and the
    greedy baseline's decode ends before L in every step."""
    monkeypatch.setattr(ttrain, "default_reward_pool", lambda *_: rl.RewardPool(workers=1))
    t = trained
    cfg = t.cfg.replace(run_id="RL").replace_in(
        "train", training_mode="cotrain", cg_epochs=0, tapcg_epochs=1, self_critical_after=0,
        lr=5e-6).replace_in("runtime", compute_dtype="bfloat16").replace_in(
        "save", pretrain="tap_cg", pretrain_path=t.path)
    timing = {}
    out = ttrain.train(cfg, max_iterations=3, device="cpu", timing_out=timing)
    assert out["iteration"] == 3 and len(timing["scst"]) == 3
    assert all(np.isfinite(v) for v in out["losses"].values()), out["losses"]
    L = t.cfg.decoder.CG_seq_length
    assert all(0 < s["greedy_steps"] < L for s in timing["scst"]), timing["scst"]


def test_probe_trained_e2e(trained):
    """experiments/probe_trained_e2e.py's counterpart on the trained
    checkpoint over its own synthetic corpus (seed 11): the exit on and off
    write the same predictions JSON in every pass, the exit runs fewer
    decode steps, and both forms report their videos/s and caption
    length."""
    tap, cg, loader, cfg = probe.load(trained.path, num_videos=12, batch_videos=BATCH_VIDEOS,
                                      device="cpu")
    try:
        res = probe.compare(tap, cg, loader, cfg, batch_videos=BATCH_VIDEOS, windows=1,
                            topN=10, device="cpu")
    finally:
        loader.load_state(loader.state())
    ex, scan = res["exit"], res["scan"]
    assert ex["same_json"] and scan["same_json"] and ex["captions"] == scan["captions"] > 0
    assert 0 < ex["steps"] < scan["steps"] and ex["host_syncs"] > 0 == scan["host_syncs"]
    assert ex["mean_len"] == scan["mean_len"] < cfg.decoder.CG_seq_length - 1
    assert ex["videos_per_s"] > 0 and scan["timing"]["groups"] > 0
