"""The published recipe's chain in the port against echr_tpu, on the CPU.

echr_tpu_torch/experiments/recipe.py holds the four stages' command lines
(experiments/train_SST.sh, train_ECHR.sh, finetune.sh and
soak_synthetic.sh's SCST stage, with soak_synthetic.sh's SYN flags); here
they are read from the scripts themselves, so the port's copy cannot
drift.  Each stage's command line parses to echr_tpu's config, and its
learning-rate schedule is echr_tpu's at every epoch.
tests/test_pipeline_3stage.py's two tests run on the port's train().  The
chain at tiny widths (each stage's flags, then --config_json and the
widths) warm-starts every stage exactly: the leaves the first step starts
from equal the checkpoint's bit for bit, within the port and across the
packages (echr_tpu's stage 1 into the port's stage 2, the port's stage 2
into echr_tpu's stage 3), and show_attend_tell's checkpoint gives
three_stream its TAP leaves only.
"""
import contextlib
import functools
import os
import re
import shlex

import jax
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_checkpoint import REPO, _equal_trees, _script_argvs
from test_train_e2e import tiny_cfg

from echr_tpu import config as jconfig
from echr_tpu.engine import checkpoint as jckpt
from echr_tpu.engine import train as jtrain

from echr_tpu_torch import bridge, config
from echr_tpu_torch.engine import checkpoint, rl
from echr_tpu_torch.engine import train as ttrain
from echr_tpu_torch.experiments import recipe
from echr_tpu_torch.models.registry import init_captioner, init_tap

SCRIPTS = REPO / "experiments"
# the widths of tiny_cfg, after each stage's flags (which set the flagship
# video_dim, K and lda_dim)
TINY = ["--video_dim", "24", "--K", "32", "--lda_dim", "16"]


def _script_argv(path, args):
    """The `python -m echr_tpu.cli.train` argument list that ``path`` runs
    when called with ``args``: NAME=${k:-default} takes args[k - 1] where
    given, "${@:n}" passes args[n - 1:] through."""
    text = path.read_text().replace("\\\n", " ")
    names = {name: args[int(k) - 1] if len(args) >= int(k) else default
             for name, k, default in re.findall(r"^(\w+)=\$\{(\d):-([^}]*)\}", text, re.M)}
    line = next(ln for ln in text.splitlines() if "echr_tpu.cli.train" in ln)
    line = line.split("echr_tpu.cli.train", 1)[1]
    passed = re.search(r'"?\$\{@:(\d)\}"?', line)
    line = re.sub(r'"?\$\{@:\d\}"?', "", line)
    line = re.sub(r"\$\{(\w+)\}", lambda m: names[m.group(1)], line)
    return shlex.split(line) + (list(args[int(passed.group(1)) - 1:]) if passed else [])


def _soak_commands():
    """soak_synthetic.sh's four training command lines: each `time
    experiments/<stage>.sh ...` line through that script, then stage 4."""
    path = SCRIPTS / "soak_synthetic.sh"
    text = path.read_text().replace("\\\n", " ")
    tag = re.search(r"^TAG=\$\{1:-([^}]*)\}", text, re.M).group(1)
    syn = re.search(r'SYN="([^"]*)"', text).group(1)
    out = []
    for m in re.finditer(r"^time experiments/(\S+\.sh) (.*)$", text, re.M):
        args = shlex.split(m.group(2).replace("$SYN", syn).replace("${TAG}", tag))
        out.append(_script_argv(SCRIPTS / m.group(1), args))
    return out + _script_argvs(path)


@pytest.mark.parametrize("script,ours", [("train_SST.sh", recipe.train_sst),
                                         ("train_ECHR.sh", recipe.train_echr),
                                         ("finetune.sh", recipe.finetune),
                                         ("soak_synthetic.sh", recipe.scst)])
def test_stage_argvs_are_the_scripts(script, ours):
    """Each stage's command line is its script's, flag for flag, at the
    script's default names; the soak's four are soak_synthetic.sh's."""
    assert ours() == _script_argvs(SCRIPTS / script)[0]
    assert recipe.stage_argvs() == _soak_commands()
    soak = (SCRIPTS / "soak_synthetic.sh").read_text().replace("\\\n", " ")
    assert recipe.SYN == shlex.split(re.search(r'SYN="([^"]*)"', soak).group(1))


@pytest.mark.parametrize("stage", range(4))
def test_stage_configs_parse_as_in_jax(stage):
    argv = recipe.stage_argvs()[stage]
    want = jconfig.parse_config(argv)
    got = config.parse_config(argv)
    assert got == config.Config.from_json(want.to_json())
    assert got.data.synthetic and got.data.synthetic_learnable


@pytest.mark.parametrize("stage", range(4))
def test_learning_rate_schedule_matches_jax(stage):
    """The per-epoch learning rate of each stage's decay flags (stage 3's
    lr 1e-6, stage 4's 5e-6 with the defaults) is echr_tpu's at every epoch
    of its curriculum and past it."""
    argv = recipe.stage_argvs()[stage]
    jcfg, cfg = jconfig.parse_config(argv), config.parse_config(argv)
    epochs = len(ttrain.get_training_list(cfg))
    assert epochs == len(jtrain.get_training_list(jcfg)) > 0
    rates = [ttrain.current_lr(cfg, e) for e in range(epochs + 20)]
    assert rates == [jtrain.current_lr(jcfg, e) for e in range(epochs + 20)]
    if stage in (1, 2):  # decay after epoch 8, every 3 epochs, by 0.5
        assert rates[8] == rates[10] == cfg.train.lr
        assert rates[11] == rates[13] == 0.5 * cfg.train.lr and rates[14] == 0.25 * cfg.train.lr


def _tiny_json(tmp_path):
    """tiny_cfg as a config JSON (echr_tpu's; both packages read it)."""
    path = tmp_path / "tiny.json"
    path.write_text(tiny_cfg(tmp_path).to_json())
    return str(path)


def test_loop_sets_the_schedule(tmp_path, monkeypatch):
    """Stage 3 (finetune.sh) at tiny widths, 15 epochs of 3 videos so that
    its decay (after epoch 8, every 3) steps twice: the rate the loop gives
    the optimizers at each epoch is echr_tpu's current_lr."""
    seen = []

    def set_lr(state, lr, set_lr=ttrain.set_lr):
        seen.append(lr)
        return set_lr(state, lr)
    monkeypatch.setattr(ttrain, "set_lr", set_lr)
    argv = recipe.finetune() + ["--config_json", _tiny_json(tmp_path), *TINY,
                                "--checkpoint_path", str(tmp_path), "--pretrain", "",
                                "--tapcg_epoch", "15", "--synthetic_num_videos", "4"]
    out = recipe.run_stage(argv, "cpu")
    jcfg = jconfig.parse_config(argv)
    want = []
    for e in range(out["epoch"]):
        if not want or want[-1] != jtrain.current_lr(jcfg, e):
            want.append(jtrain.current_lr(jcfg, e))
    assert out["epoch"] == 15 and seen == want == [1e-6, 5e-7, 2.5e-7]
    assert [g["lr"] for g in out["state"].cg_opt.param_groups] == [2.5e-7]


def _port_cfg(tmp_path, run_id, **over):
    return config.Config.from_json(tiny_cfg(tmp_path, **over).to_json()).replace(run_id=run_id)


def test_three_stage_pipeline(tmp_path):
    """tests/test_pipeline_3stage.py's chain on the port: pre_tap -> pre_cg
    (TAP warm start) -> cotrain (both models), each capped at 4 steps."""
    cfg1 = _port_cfg(tmp_path, "SST", **{"train.training_mode": "pre_tap",
                                         "train.tap_epochs": 1, "train.cg_epochs": 0})
    out1 = ttrain.train(cfg1, max_iterations=4, device="cpu")
    sst_ckpt = os.path.join(out1["save_folder"], "model-last.ckpt")
    assert os.path.exists(sst_ckpt)

    cfg2 = _port_cfg(tmp_path, "EC").replace_in("save", pretrain="tap", pretrain_path=sst_ckpt)
    out2 = ttrain.train(cfg2, max_iterations=4, device="cpu")
    ec_ckpt = os.path.join(out2["save_folder"], "model-last.ckpt")
    assert os.path.exists(ec_ckpt)
    # pre_cg never steps the SST: it is stage 1's, bit for bit
    _equal_trees(bridge.tap_to_jax(out2["state"].tap),
                 checkpoint.load_params_only(sst_ckpt, "tap")["tap_params"])

    cfg3 = _port_cfg(tmp_path, "JT", **{"train.training_mode": "cotrain",
                                        "train.cg_epochs": 0, "train.tapcg_epochs": 1,
                                        "train.lr": 1e-5})
    cfg3 = cfg3.replace_in("save", pretrain="tap_cg", pretrain_path=ec_ckpt)
    out3 = ttrain.train(cfg3, max_iterations=4, device="cpu")
    assert out3["iteration"] == 4
    assert np.isfinite(out3["best_val_score"]) or out3["best_val_score"] == -1.0


def test_resume_continues_iteration(tmp_path):
    cfg = _port_cfg(tmp_path, "R")
    out = ttrain.train(cfg, max_iterations=3, device="cpu")
    assert out["iteration"] == 3
    cfg2 = cfg.replace_in("save", start_from="R", start_from_mode="last")
    out2 = ttrain.train(cfg2, max_iterations=5, device="cpu")
    assert out2["iteration"] == 5 and out2["state"].step == 5  # resumed from 3, ran 2 more


# ------------------------------------------------------- the chain, warm starts


@contextlib.contextmanager
def first_step_leaves(starts):
    """Within the block, the port's train loop appends to ``starts`` the
    JAX-layout trees (tap, cg) that each run's first step starts from."""
    seen = set()  # the per-video SCST step calls the batched one

    def hook(fn):
        @functools.wraps(fn)
        def step(state, *args, **kw):
            if state.step == 0 and id(state) not in seen:  # a run's first step
                seen.add(id(state))
                cfg = next(a for a in args if isinstance(a, config.Config))
                # copies: the exported leaves share the parameters' memory
                starts.append(jax.tree.map(np.copy, (bridge.tap_to_jax(state.tap),
                                                     bridge.captioner_to_jax(state.cg, cfg))))
            return fn(state, *args, **kw)
        return step
    names = ("train_step", "_self_critical_step", "_self_critical_step_batched")
    saved = {n: getattr(ttrain, n) for n in names}
    try:
        for n in names:
            setattr(ttrain, n, hook(saved[n]))
        yield
    finally:
        for n, fn in saved.items():
            setattr(ttrain, n, fn)


def _fresh(cfg):
    """The port's seeded init that train() builds for ``cfg`` (run config,
    vocab filled in), in the JAX layout."""
    gen = torch.Generator().manual_seed(cfg.train.seed)
    return bridge.tap_to_jax(init_tap(gen, cfg)), bridge.captioner_to_jax(
        init_captioner(gen, cfg), cfg)


@pytest.fixture(scope="module")
def soaked(tmp_path_factory):
    """recipe.soak at tiny widths on the CPU, each stage capped at 3 steps
    (the SCST stage at 2) and gated at step 2, with the leaves each stage's
    first step started from."""
    tmp = tmp_path_factory.mktemp("soak")
    extra = ["--config_json", _tiny_json(tmp), *TINY, "--save_checkpoint_every", "2",
             "--min_epoch_when_save", "0"]
    starts = []
    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "default_reward_pool", lambda *_: rl.RewardPool(workers=1))
    try:
        with first_step_leaves(starts):
            outs = recipe.soak("T", 1, str(tmp), "cpu", extra, max_iterations=[3, 3, 3, 2])
    finally:
        mp.undo()
    return outs, starts


def test_soak_chains_the_stages(soaked):
    """Four stages, each from the previous stage's model-best.ckpt (every
    stage gated at step 2), their first steps starting from its leaves:
    stage 2 the TAP only, stages 3-4 both models.  Finite losses; stage 4
    took SCST steps."""
    outs, starts = soaked
    assert [o["iteration"] for o in outs] == [3, 3, 3, 2] and len(starts) == 4
    assert [o["config"].train.training_mode for o in outs] == [
        "pre_tap", "pre_cg", "cotrain", "cotrain"]
    for i in (1, 2, 3):
        cfg = outs[i]["config"]
        path = os.path.join(outs[i - 1]["save_folder"], "model-best.ckpt")
        assert cfg.save.pretrain_path == path
        warm = checkpoint.load_params_only(path, cfg.save.pretrain)
        tap, cg = starts[i]
        _equal_trees(tap, warm["tap_params"])
        _equal_trees(cg, warm["cg_params"] if "cg_params" in warm else _fresh(cfg)[1])
    for o in outs:
        assert all(np.isfinite(v) for v in o["losses"].values()), o["losses"]
    assert "avg_reward" in outs[3]["losses"] and outs[3]["config"].train.self_critical_after == 0


def test_show_attend_tell_to_three_stream_takes_tap_only(soaked):
    """Stage 1's checkpoint holds a show_attend_tell captioner of 3 layers;
    stage 2 (--pretrain tap) builds three_stream from the port's seeded
    init, whatever that checkpoint's captioner."""
    outs, starts = soaked
    saved = checkpoint.load_checkpoint(
        os.path.join(outs[0]["save_folder"], "model-best.ckpt"), "cpu", rebuild_state=False)
    assert saved["config"].decoder.caption_model == "show_attend_tell"
    assert len(saved["state"]["cg_params"]["decoder"]["core"]["layers"]) == 3
    assert outs[1]["config"].decoder.caption_model == "three_stream"
    assert (jax.tree_util.tree_structure(starts[1][1])
            != jax.tree_util.tree_structure(saved["state"]["cg_params"]))
    _equal_trees(starts[1][1], _fresh(outs[1]["config"])[1])


@contextlib.contextmanager
def jax_starting_leaves(starts):
    """Within the block, echr_tpu's train() appends to ``starts`` the trees
    (tap, cg) its TrainState starts from."""
    fn = jtrain.init_train_state

    def init(cfg, tap_params, cg_params):
        starts.append((tap_params, cg_params))
        return fn(cfg, tap_params, cg_params)
    jtrain.init_train_state = init
    try:
        yield
    finally:
        jtrain.init_train_state = fn


@pytest.fixture(scope="module")
def across(tmp_path_factory):
    """Stage 1 in echr_tpu (capped at 2 steps, no gate), then stage 2 in
    the port from its model-last.ckpt (3 steps), at tiny widths."""
    tmp = tmp_path_factory.mktemp("across")
    extra = ["--config_json", _tiny_json(tmp), *TINY, "--checkpoint_path", str(tmp)]
    jout = jtrain.train(jconfig.parse_config(recipe.train_sst("J_SST") + extra),
                        max_iterations=2)
    ckpt1 = recipe.warm_start_path(jout["save_folder"], capped=True)
    assert ckpt1.endswith("model-last.ckpt")
    starts = []
    argv = recipe.with_pretrain_path(recipe.train_echr("J_SST", "P_EC") + extra, ckpt1)
    with first_step_leaves(starts):
        out2 = recipe.run_stage(argv, "cpu", max_iterations=3)
    return ckpt1, out2, starts[0], tmp, extra


def test_port_stage2_from_jax_stage1(across):
    """The port's stage 2 starts from echr_tpu's stage-1 TAP leaves, as
    echr_tpu's load_params_only reads them, and from its own seeded
    three_stream captioner."""
    ckpt1, out2, (tap, cg), _, _ = across
    _equal_trees(tap, jckpt.load_params_only(ckpt1, "tap")["tap_params"])
    _equal_trees(cg, _fresh(out2["config"])[1])
    assert out2["iteration"] == 3


def test_jax_stage3_from_port_stage2(across):
    """echr_tpu's stage 3 (finetune.sh) from the port's stage-2 checkpoint
    starts from its leaves, both models, as the port wrote them."""
    _, out2, _, tmp, extra = across
    ckpt2 = recipe.warm_start_path(out2["save_folder"], capped=True)
    starts = []
    argv = recipe.with_pretrain_path(recipe.finetune("P_EC", "J_JT") + extra, ckpt2)
    with jax_starting_leaves(starts):
        jout = jtrain.train(jconfig.parse_config(argv), max_iterations=1)
    assert jout["iteration"] == 1 and len(starts) == 1
    want = checkpoint.load_params_only(ckpt2, "tap_cg")
    _equal_trees(starts[0][0], want["tap_params"])
    _equal_trees(starts[0][1], want["cg_params"])
    _equal_trees(want["tap_params"], bridge.tap_to_jax(out2["state"].tap))
    _equal_trees(want["cg_params"], bridge.captioner_to_jax(out2["state"].cg, out2["config"]))
