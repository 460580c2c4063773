"""Checkpointed training in the port against echr_tpu, on the CPU.

Format v2 both ways (the port's checkpoint loads in echr_tpu and echr_tpu's
in the port, parameters and Adam moments bit-equal after the layout
export, one more step agreeing), resume (exact with dropout and scheduled
sampling off), warm start, the gating eval, SIGTERM and resume in a
subprocess, the resume config overlay, the CLI flag surface, and the
train / eval / score CLIs.

Tolerances: the gate's score and score dicts are exact (as
tests/test_torch_eval.py's scores); one more training step after a load
agrees at tests/test_torch_train.py's tolerances (loss 1e-5 relative,
parameters 4 * lr), and so do the Adam moments after it (atol 2e-4, rtol
1e-3: the new moment takes 0.1 of the step's gradient, the rest is the
loaded moment, which is bit-equal).
"""
import dataclasses
import json
import os
import pickle
import re
import shlex
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_eval import Split
from test_torch_train import GATOL, GRTOL, REL, _batch, _cfg, _close_trees, _params
from test_train_e2e import tiny_cfg

from echr_tpu import config as jconfig
from echr_tpu.engine import checkpoint as jckpt
from echr_tpu.engine import steps as jsteps
from echr_tpu.engine import train as jtrain

from echr_tpu_torch import bridge, config
from echr_tpu_torch.cli import eval as cli_eval
from echr_tpu_torch.cli import score as cli_score
from echr_tpu_torch.cli import train as cli_train
from echr_tpu_torch.data.dataset import build_dataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import checkpoint, steps
from echr_tpu_torch.engine import train as ttrain
from echr_tpu_torch.engine.evaluate import eval_split_batched

REPO = Path(__file__).resolve().parent.parent


def _port_cfg(tmp_path, run_id="R", **over):
    return config.Config.from_json(tiny_cfg(tmp_path, **over).to_json()).replace(run_id=run_id)


def _moments(state, cfg):
    """The port's Adam moments and counts in the JAX layout, per model."""
    out = {}
    for name, spec, groups, opt in checkpoint._specs(state, cfg):
        st = opt.state
        counts = {int(s["step"]) for s in st.values()}
        out[name] = {k: bridge.export_tree(spec, groups, lambda p, k=k: st[p][k])
                     for k in ("exp_avg", "exp_avg_sq")} if st else None
        out[name + "_count"] = counts.pop() if st else 0
    return out


def _params_of(state, cfg):
    return bridge.tap_to_jax(state.tap), bridge.captioner_to_jax(state.cg, cfg)


def _equal_trees(got, want):
    flat_w, tree_w = jax.tree_util.tree_flatten_with_path(want)
    assert jax.tree_util.tree_structure(got) == tree_w
    for (path, w), g in zip(flat_w, jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def _jax_moments(opt_state, params):
    """mu, nu of echr_tpu's optimizer state, restructured as the params."""
    adam = opt_state.inner_state[2]
    tdef = jax.tree_util.tree_structure(params)
    return (jax.tree_util.tree_unflatten(tdef, jax.tree_util.tree_leaves(adam.mu)),
            jax.tree_util.tree_unflatten(tdef, jax.tree_util.tree_leaves(adam.nu)),
            int(adam.count), int(opt_state.count))


# ------------------------------------------------------- (a) port -> echr_tpu


@pytest.mark.parametrize("mode,weight_decay", [("pre_cg", 0.0), ("cotrain", 0.0),
                                               ("cotrain", 1e-4)])
def test_port_checkpoint_loads_in_jax(tmp_path, mode, weight_decay):
    """The port trains 3 steps and writes model-last.ckpt; echr_tpu's
    load_checkpoint rebuilds it with the port's parameters and moments
    bit-equal.  pre_cg never steps the SST: its state is optax's init.
    Weight decay puts add_decayed_weights at the chain's entry 1, where 0
    puts optax.identity(); both keep an empty state."""
    over = {"train.training_mode": mode, "save.losses_log_every": 1,
            "train.weight_decay": weight_decay}
    if mode == "cotrain":
        over.update({"train.cg_epochs": 0, "train.tapcg_epochs": 2})
    cfg = _port_cfg(tmp_path, **over)
    out = ttrain.train(cfg, max_iterations=3, device="cpu")
    path = os.path.join(out["save_folder"], "model-last.ckpt")
    raw = open(path, "rb").read()
    assert b"torch" not in raw and b"echr_tpu" not in raw  # class-free
    payload = jckpt.load_checkpoint(path)
    js = payload["state"]
    tap, cg = _params_of(out["state"], out["config"])
    _equal_trees(js.tap_params, tap)
    _equal_trees(js.cg_params, cg)
    mom = _moments(out["state"], out["config"])
    for name, params in (("tap", js.tap_params), ("cg", js.cg_params)):
        mu, nu, adam_count, count = _jax_moments(getattr(js, f"{name}_opt"), params)
        assert adam_count == count == mom[name + "_count"]
        if mom[name] is None:  # never stepped: zero moments, count 0
            assert count == 0 and not any(np.any(x) for x in jax.tree.leaves((mu, nu)))
        else:
            _equal_trees(mu, mom[name]["exp_avg"])
            _equal_trees(nu, mom[name]["exp_avg_sq"])
    assert mom["cg_count"] == 3 and mom["tap_count"] == (3 if mode == "cotrain" else 0)
    assert int(js.step) == out["state"].step == 3
    port = checkpoint.load_checkpoint(path, "cpu", rebuild_state=False)
    for key in ("iteration", "epoch", "best_val_score", "loader_state", "vocab", "histories"):
        assert payload[key] == port[key], key
    assert payload["iteration"] == 3 and payload["vocab"] == build_dataset(cfg).ix_to_word
    assert payload["histories"]["loss"] and payload["loader_state"]["iterators"]["train"]
    # the learning rate resumes through inject_hyperparams
    assert float(js.cg_opt.hyperparams["learning_rate"]) == np.float32(cfg.train.lr)


# ------------------------------------------------------- (b) echr_tpu -> port


def _jax_stepper(cfg, batch, phase):
    """echr_tpu's step composed from its parts (tests/test_torch_train.py's
    _jax_run) as one jitted function of its TrainState: state -> (state,
    loss)."""
    jb = jax.tree.map(jnp.asarray, batch)
    opt = jsteps.make_optimizer(cfg)

    def loss_fn(tp, cp):
        tc, cc = jsteps._cast(tp, cfg), jsteps._cast(cp, cfg)
        m = jax.vmap(lambda b: jsteps._one_video_losses(tc, cc, cfg, b, phase, None, True,
                                                        0.0))(jb)
        return jsteps._phase_loss(jax.tree.map(jnp.mean, m), phase, cfg)

    @jax.jit
    def step(state):
        loss, (tg, cgg) = jax.value_and_grad(loss_fn, argnums=(0, 1))(state.tap_params,
                                                                      state.cg_params)
        upd, tap_opt = opt.update(tg, state.tap_opt, state.tap_params)
        upd2, cg_opt = opt.update(cgg, state.cg_opt, state.cg_params)
        return state._replace(
            tap_params=optax.apply_updates(state.tap_params, upd), tap_opt=tap_opt,
            cg_params=optax.apply_updates(state.cg_params, upd2), cg_opt=cg_opt,
            step=state.step + 1), loss

    return lambda state: jax.tree.map(np.asarray, step(state))


def test_jax_checkpoint_loads_in_port(tmp_path):
    """echr_tpu writes a checkpoint after two steps; the port's
    load_checkpoint gives its parameters, moments, counts and the rest
    bit-equal, and one more step in each package agrees."""
    jcfg = _cfg(**{"runtime.use_pallas_train": False})  # a quicker compile
    cfg = config.Config.from_json(jcfg.to_json())
    tap, cg = _params(jcfg)
    batch = _batch(jcfg)
    step = _jax_stepper(jcfg, batch, "tap_cg")
    js, _ = step(step(jsteps.init_train_state(jcfg, tap, cg))[0])
    path = str(tmp_path / "model-last.ckpt")
    meta = {"iteration": 2, "epoch": 1, "best_val_score": 0.25,
            "loader_state": {"iterators": {"train": 3}, "split_order": {"train": [2, 0, 1]},
                             "epochs": {"train": 1}, "base_seed": 0},
            "histories": {"loss": {2: {"loss": 3.5}}, "lr": {2: 1e-4}, "val": {}},
            "vocab": {"1": "a", "2": "b"}}
    jckpt.save_checkpoint(path, js, jcfg, **meta)
    payload = checkpoint.load_checkpoint(path, "cpu")
    state = payload["state"]
    for k, v in meta.items():
        assert payload[k] == v, k
    tap_p, cg_p = _params_of(state, cfg)
    _equal_trees(tap_p, js.tap_params)
    _equal_trees(cg_p, js.cg_params)
    mom = _moments(state, cfg)
    for name, params in (("tap", js.tap_params), ("cg", js.cg_params)):
        mu, nu, adam_count, count = _jax_moments(getattr(js, f"{name}_opt"), params)
        _equal_trees(mom[name]["exp_avg"], mu)
        _equal_trees(mom[name]["exp_avg_sq"], nu)
        assert mom[name + "_count"] == adam_count == count == 2
    assert state.step == 2 and state.cg_opt.param_groups[0]["lr"] == np.float32(jcfg.train.lr)

    js2, jloss = step(js)
    state, m = steps.train_step(state, steps.batch_to_device(batch, "cpu"), None, cfg, "tap_cg")
    np.testing.assert_allclose(m["loss"], jloss, rtol=REL)
    lr = jcfg.train.lr
    tap_p, cg_p = _params_of(state, cfg)
    _close_trees(tap_p, js2.tap_params, 4 * lr, 0)
    _close_trees(cg_p, js2.cg_params, 4 * lr, 0)
    mom = _moments(state, cfg)
    for name, params in (("tap", js2.tap_params), ("cg", js2.cg_params)):
        mu, nu, _, count = _jax_moments(getattr(js2, f"{name}_opt"), params)
        _close_trees(mom[name]["exp_avg"], mu, GATOL, GRTOL)
        _close_trees(mom[name]["exp_avg_sq"], nu, GATOL, GRTOL)
        assert mom[name + "_count"] == count == 3


# ---------------------------------------------------------------- (c) resume


def test_resume_is_exact_without_dropout(tmp_path, monkeypatch):
    """k = 2 steps (a gate at 2), then a resume to 2k, equals 2k steps run
    straight through (gates at 2 and 4): parameters, moments, losses and
    the gates' scores.  Dropout off: the three_stream core's dropout (0.5,
    as in the reference) has no setting in either package, so the steps
    take gen=None, as echr_tpu's take rng=None."""
    monkeypatch.setattr(ttrain, "train_step",
                        lambda state, batch, gen, *a, **k: steps.train_step(state, batch, None,
                                                                             *a, **k))
    over = {"train.training_mode": "cotrain", "train.cg_epochs": 0, "train.tapcg_epochs": 3,
            "tap.rnn_dropout": 0.0, "decoder.CG_drop_prob": 0.0,
            "save.save_checkpoint_every": 2}
    straight = ttrain.train(_port_cfg(tmp_path, "S", **over), max_iterations=4, device="cpu")
    first = ttrain.train(_port_cfg(tmp_path, "K", **over), max_iterations=2, device="cpu")
    assert first["iteration"] == 2
    resumed = ttrain.train(_port_cfg(tmp_path, "K", **over).replace_in("save", start_from="K"),
                           max_iterations=4, device="cpu")
    assert resumed["iteration"] == straight["iteration"] == 4
    assert resumed["epoch"] == straight["epoch"]
    assert resumed["losses"] == straight["losses"]
    assert resumed["best_val_score"] == straight["best_val_score"]
    _equal_trees(_params_of(resumed["state"], resumed["config"]),
                 _params_of(straight["state"], straight["config"]))
    _equal_trees(_moments(resumed["state"], resumed["config"]),
                 _moments(straight["state"], straight["config"]))
    hist = [checkpoint.load_checkpoint(os.path.join(o["save_folder"], "model-last.ckpt"), "cpu",
                                       rebuild_state=False)["histories"]
            for o in (resumed, straight)]
    assert hist[0]["val"] == hist[1]["val"] and sorted(hist[0]["val"]) == [2, 4]


# ------------------------------------------------------------ (d) warm start


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """An echr_tpu checkpoint of tiny_cfg's widths, from echr_tpu's init."""
    tmp = tmp_path_factory.mktemp("jaxckpt")
    jcfg = tiny_cfg(tmp)
    ds = build_dataset(config.Config.from_json(jcfg.to_json()))
    jcfg = jcfg.replace_in("decoder", CG_vocab_size=ds.vocab_size, CG_seq_length=ds.seq_length)
    tap, cg = _params(jcfg, seed=5)
    path = str(tmp / "model-best.ckpt")
    jckpt.save_checkpoint(path, jsteps.init_train_state(jcfg, tap, cg), jcfg, iteration=7,
                          epoch=1, best_val_score=0.5, vocab=ds.ix_to_word)
    return path


@pytest.fixture(scope="module")
def fresh_init(tmp_path_factory):
    """The port's seeded init of tiny_cfg, as train() holds it after one
    step at lr 0: {"tap_params": ..., "cg_params": ...} in the JAX layout."""
    cfg = _port_cfg(tmp_path_factory.mktemp("fresh"), "F", **{"train.lr": 0.0})
    out = ttrain.train(cfg, max_iterations=1, device="cpu")
    return dict(zip(("tap_params", "cg_params"), _params_of(out["state"], out["config"])))


@pytest.mark.parametrize("which", ["tap", "cg", "tap_cg"])
def test_warm_start_matches_jax(tmp_path, jax_checkpoint, fresh_init, which):
    """save.pretrain from echr_tpu's checkpoint: the warm-started models
    hold echr_tpu's warm-start trees (its load_params_only, which its
    train() takes as its parameters), the others the port's seeded init.
    lr 0 keeps the parameters through the one step train() takes."""
    cfg = _port_cfg(tmp_path, **{"train.lr": 0.0}).replace_in(
        "save", pretrain=which, pretrain_path=jax_checkpoint)
    out = ttrain.train(cfg, max_iterations=1, device="cpu")
    want = jckpt.load_params_only(jax_checkpoint, which)
    assert checkpoint.load_params_only(jax_checkpoint, which).keys() == want.keys()
    got = dict(zip(("tap_params", "cg_params"), _params_of(out["state"], out["config"])))
    for key in ("tap_params", "cg_params"):
        _equal_trees(got[key], want[key] if key in want else fresh_init[key])


# --------------------------------------------------------------- (e) the gate


@pytest.mark.parametrize("phase", ["tap", "cg"])
def test_gate_matches_jax(tmp_path, phase):
    """The port's _run_eval gives echr_tpu's score and score dict on
    tests/test_torch_eval.py's sharpened weights."""
    s = Split(tmp_path)
    try:
        want, want_scores = jtrain._run_eval(
            types.SimpleNamespace(tap_params=s.tap_np, cg_params=s.cg_np), s.jloader, s.jcfg,
            str(tmp_path / "jax"), 5, phase)
        state = types.SimpleNamespace(tap=bridge.tap_from_jax(s.tap_np, s.cfg),
                                      cg=bridge.captioner_from_jax(s.cg_np, s.cfg))
        got, got_scores = ttrain._run_eval(state, s.loader, s.cfg, str(tmp_path / "port"), 5,
                                           phase, device="cpu")
    finally:
        s.close()
    assert got == want and (phase == "tap" or want > 0)
    assert sorted(got_scores) == sorted(want_scores)
    for k in want_scores:
        np.testing.assert_array_equal(got_scores[k], want_scores[k], err_msg=k)
    names = sorted(os.listdir(tmp_path / "port" / "pred_sent"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "pred_sent"))
    assert names == (["pred_iter5.json"] if phase == "tap"
                     else ["pred_iter5.json", "pred_iter5_gt.json"])


# --------------------------------------------------------- (f) SIGTERM, resume


def test_sigterm_checkpoints_and_resumes(tmp_path):
    """SIGTERM to a training process: it stops at the next iteration
    boundary with a readable model-last.ckpt, and start_from continues
    (tests/test_preemption.py's check of echr_tpu).  The child blocks
    TensorFlow, which torch.utils.tensorboard imports when it is installed
    and which takes seconds to import: TensorBoard then writes through its
    own stub."""
    cfg = _port_cfg(tmp_path, "PRE", **{"train.cg_epochs": 10**6, "save.losses_log_every": 1})
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    script = (
        "import sys; sys.modules['tensorflow'] = None;"
        "import logging;"
        "logging.basicConfig(level=logging.INFO);"
        "from echr_tpu_torch.config import Config;"
        "from echr_tpu_torch.engine.train import train;"
        f"out = train(Config.from_json(open({str(cfg_path)!r}).read()), device='cpu');"
        "print('PREEMPT_EXIT', out['iteration'], flush=True)")
    log_path = tmp_path / "child.log"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    with open(log_path, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", script], env=env, stdout=f,
                                stderr=subprocess.STDOUT, cwd=tmp_path)
        try:
            deadline = time.time() + 120
            while "iter 1 (" not in log_path.read_text():
                assert proc.poll() is None, log_path.read_text()
                assert time.time() < deadline, log_path.read_text()
                time.sleep(0.2)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
    text = log_path.read_text()
    assert rc == 0 and "preemption" in text, text
    it0 = int(re.search(r"PREEMPT_EXIT (\d+)", text).group(1))
    payload = checkpoint.load_checkpoint(str(tmp_path / "PRE" / "model-last.ckpt"), "cpu")
    assert payload["iteration"] == it0 >= 1 and payload["state"].step == it0
    out = ttrain.train(cfg.replace_in("save", start_from="PRE"), max_iterations=it0 + 2,
                       device="cpu")
    assert out["iteration"] == it0 + 2 and out["state"].step == it0 + 2


# ------------------------------------------------------ (g) the resume overlay


@pytest.mark.parametrize("no_exclude_opt", [False, True])
def test_overlay_resumed_config_matches_jax(tmp_path, no_exclude_opt):
    saved = tiny_cfg(tmp_path, **{"train.lr": 1e-3, "train.cg_epochs": 5, "eval.topN": 7,
                                  "save.save_checkpoint_every": 9}).replace(run_id="old")
    cli = jconfig.flagship_config().replace(run_id="new", debug=True).replace_in(
        "save", start_from="old", no_exclude_opt=no_exclude_opt, min_epoch_when_save=3)
    want = jtrain.overlay_resumed_config(cli, saved)
    got = ttrain.overlay_resumed_config(config.Config.from_json(cli.to_json()),
                                        config.Config.from_json(saved.to_json()))
    assert got == config.Config.from_json(want.to_json())
    assert ttrain._RESUME_EXCLUDE == jtrain._RESUME_EXCLUDE


# --------------------------------------------------------- (h) the flag surface


def _script_argvs(path):
    """The argument lists of a script's `python -m echr_tpu.cli.train`
    calls: continuation lines joined, each ${NAME} set to its default
    (NAME=${1:-default}), $SYN expanded and the pass-through "${@:n}"
    dropped."""
    text = path.read_text().replace("\\\n", " ")
    defaults = dict(re.findall(r"^(\w+)=\$\{\d:-([^}]*)\}", text, re.M))
    syn = re.search(r'SYN="([^"]*)"', text)
    out = []
    for line in text.splitlines():
        if "echr_tpu.cli.train" not in line:
            continue
        line = line.split("echr_tpu.cli.train", 1)[1]
        line = line.replace("$SYN", syn.group(1) if syn else "")
        line = re.sub(r'"?\$\{@:\d\}"?', "", line)
        line = re.sub(r"\$\{(\w+)\}", lambda m: defaults[m.group(1)], line)
        out.append(shlex.split(line))
    return out


@pytest.mark.parametrize("script", sorted(p.name for p in (REPO / "experiments").glob("*.sh")))
def test_parse_config_matches_jax_on_experiment_scripts(script):
    """echr_tpu's Config cut to the fields the port keeps (its JSON read by
    the port) equals the port's, for each published command line."""
    (argv,) = _script_argvs(REPO / "experiments" / script)
    assert "--id" in argv and "$" not in " ".join(argv)
    want = jconfig.parse_config(argv)
    assert want != jconfig.Config()
    assert config.parse_config(argv) == config.Config.from_json(want.to_json())


KEPT_RUNTIME_KNOBS = ("mesh_shape", "preempt_check_every", "use_pallas_head",
                      "decode_early_exit", "scst_resident_vjp")


@pytest.mark.parametrize("argv", [["--mesh_shape", "2", "4"], ["--preempt_check_every", "4"],
                                  ["--use_pallas_head", "0"], ["--spmd_mode", "shard_map"],
                                  ["--decode_early_exit", "0"], ["--scst_resident_vjp", "1"]])
def test_parse_config_refuses_dropped_runtime_knobs(argv):
    """A flag for a runtime knob the port dropped (a TPU or XLA knob, or a
    field echr_tpu does not read) raises, naming it; the knobs the port
    keeps (the layout, the preemption check, kernel 2's switch, the
    per-video decode loop, resident-graph SCST) parse as echr_tpu's do."""
    want = jconfig.parse_config(argv)  # echr_tpu takes it
    name = argv[0][2:]
    if name in KEPT_RUNTIME_KNOBS:
        got = config.parse_config(argv)
        assert getattr(got.runtime, name) == getattr(want.runtime, name) != getattr(
            config.RuntimeConfig(), name)
    else:
        with pytest.raises(ValueError, match=re.escape(argv[0])):
            config.parse_config(argv)
    assert set(config._DROPPED_RUNTIME_FLAGS) == (
        {f.name for f in dataclasses.fields(jconfig.RuntimeConfig)}
        - {f.name for f in dataclasses.fields(config.RuntimeConfig)})
    assert not set(KEPT_RUNTIME_KNOBS) & set(config._DROPPED_RUNTIME_FLAGS)
    assert set(config._DROPPED_RUNTIME_FLAGS) == {
        "donate_step_args", "mesh_axis_names", "pallas_decode_t_max",
        "pallas_decode_t_max_sorted", "param_dtype", "spmd_mode"}


# ----------------------------------------------------------------- (i) the CLIs


def test_eval_cli_on_a_port_checkpoint_matches_eval_split_batched(tmp_path):
    """The port writes a checkpoint of tests/test_torch_eval.py's sharpened
    weights; cli.eval's predictions JSON equals eval_split_batched's on the
    checkpoint's state."""
    s = Split(tmp_path)
    s.close()
    state = steps.init_train_state(s.cfg, bridge.tap_from_jax(s.tap_np, s.cfg),
                                   bridge.captioner_from_jax(s.cg_np, s.cfg))
    checkpoint.save_checkpoint(str(tmp_path / "EV" / "model-best.ckpt"), state, s.cfg,
                               iteration=1, epoch=0, best_val_score=0.0,
                               vocab=s.ds.ix_to_word)
    json_path = cli_eval.main(["--folder_id", "EV", "--checkpoint_path", str(tmp_path),
                               "--flag_eval_what", "tap_cg", "--topN", "15", "--batch_videos",
                               "2", "--no_language_eval", "--device", "cpu"])
    assert os.path.basename(json_path) == "eval_tap_cg_top15_thr0.0_nms0.0.json"
    loaded = checkpoint.load_checkpoint(str(tmp_path / "EV" / "model-best.ckpt"), "cpu")
    cfg = loaded["config"]
    loader = Loader(build_dataset(cfg), cfg, process_index=0, process_count=1, seed=0)
    try:
        want, _, _ = eval_split_batched(
            loaded["state"].tap, loaded["state"].cg, loader, cfg, str(tmp_path / "want.json"),
            {"topN": 15, "language_eval": False, "get_eval_loss": False, "num_vids_eval": 0},
            batch_videos=2, device="cpu")
    finally:
        loader.load_state(loader.state())
    with open(json_path) as f:
        got = json.load(f)["results"]
    assert want and json.loads(json.dumps(want)) == got
    # --data_parallel 2 on the CPU: two gloo ranks, each its shard of val,
    # write the same predictions JSON (rank 1 beside it, as .proc1)
    os.remove(json_path)
    dp_path = cli_eval.main(["--folder_id", "EV", "--checkpoint_path", str(tmp_path),
                             "--flag_eval_what", "tap_cg", "--topN", "15", "--batch_videos", "2",
                             "--no_language_eval", "--device", "cpu", "--data_parallel", "2"])
    assert dp_path == json_path and os.path.exists(json_path + ".proc1")
    with open(dp_path) as f:
        assert json.load(f)["results"] == got
    # --sample_max 0 is ported, with --temperature and --sample_seed: one seed
    # gives one predictions JSON, under its own name
    sampled = []
    for _ in range(2):
        path = cli_eval.main(["--folder_id", "EV", "--checkpoint_path", str(tmp_path),
                              "--flag_eval_what", "tap_cg", "--topN", "15", "--batch_videos",
                              "2", "--no_language_eval", "--device", "cpu", "--sample_max", "0",
                              "--temperature", "0.5", "--sample_seed", "3"])
        assert os.path.basename(path) == "eval_tap_cg_top15_thr0.0_nms0.0_sampleT0.5_s3.json"
        with open(path) as f:
            sampled.append(json.load(f)["results"])
    assert sampled[0] and sampled[0] == sampled[1] and sampled[0].keys() == got.keys()


def test_train_cli_writes_a_checkpoint_the_eval_cli_reads(tmp_path):
    """cli.train with reference flags on a config JSON, then cli.eval on
    its model-last.ckpt."""
    cfg = _port_cfg(tmp_path, "CLI", **{"train.cg_epochs": 1})
    (tmp_path / "c.json").write_text(cfg.to_json())
    out = cli_train.main(["--config_json", str(tmp_path / "c.json"), "--id", "CLI",
                          "--cg_epoch", "1", "--save_checkpoint_every", "3",
                          "--min_epoch_when_save", "0", "--device", "cpu"])
    folder = tmp_path / "CLI"
    assert out["iteration"] >= 3 and (folder / "model-best.ckpt").exists()
    assert (folder / "config.json").exists() and (folder / "train.log").exists()
    assert (folder / "src_snapshot" / "echr_tpu_torch" / "engine" / "train.py").exists()
    assert not (folder / "src_snapshot" / "echr_tpu_torch" / "_build").exists()
    json_path = cli_eval.main(["--folder_id", "CLI", "--checkpoint_path", str(tmp_path),
                               "--which", "last", "--flag_eval_what", "cg", "--topN", "10",
                               "--no_language_eval", "--device", "cpu"])
    assert os.path.exists(json_path)
    with pytest.raises(ValueError, match="--spmd_mode"):
        cli_train.main(["--spmd_mode", "auto", "--device", "cpu"])


def test_score_cli_matches_jax(tmp_path):
    from echr_tpu.cli import score as jscore

    refs = tmp_path / "refs.json"
    refs.write_text('{"v1": {"duration": 10.0, "timestamps": [[0, 4], [3, 9]], '
                    '"sentences": ["a man rides a horse", "the horse runs fast"]}}')
    sub = tmp_path / "sub.json"
    sub.write_text(json.dumps({"results": {"v1": [
        {"sentence": "a man rides", "timestamp": [0, 5], "proposal_score": 0.9},
        {"sentence": "horse runs", "timestamp": [2, 9], "proposal_score": 0.4}]}}))
    argv = ["-s", str(sub), "-r", str(refs), "-v"]
    want, got = jscore.main(argv), cli_score.main(argv)
    assert sorted(got) == sorted(want) and "METEOR" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_entry_points_refuse_cuda_without_it(tmp_path, monkeypatch, jax_checkpoint):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(_port_cfg(tmp_path), max_iterations=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checkpoint.load_checkpoint(jax_checkpoint)
    assert not (tmp_path / "R").exists()
    with open(jax_checkpoint, "rb") as f:
        assert pickle.load(f)["format_version"] == checkpoint.FORMAT_VERSION
