"""The port's data parallelism (echr_tpu_torch/parallel/, the multi-rank
paths of engine/train.py, engine/evaluate.py and both CLIs) on gloo ranks
on the CPU, against echr_tpu and against the port's own single process.

The ranks are child processes of this file (``python test_torch_parallel.py
<workdir> <rank>``): one pair is started for the whole module and runs every
scenario in turn (``SCENARIOS``), each rank writing what it saw to
``<workdir>/out<rank>.pkl``.  Every group and every child has a timeout of
its own, so that a hang fails the tests and does not stall the suite.  The
children import the port alone; JAX is imported by the tests here.

Tolerances: as tests/test_torch_train.py: losses within 1e-5 relative,
gradient leaves within atol 2e-4, rtol 1e-3, parameters after two Adam
steps within 4 * lr; the ranks' parameters bit-equal.  The val losses of
the sharded eval within 1e-5 relative of one process's.
"""
import json
import os
import pickle
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from echr_tpu_torch import config
from echr_tpu_torch.bridge import captioner_from_jax, tap_from_jax
from echr_tpu_torch.data.dataset import build_dataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import evaluate as E
from echr_tpu_torch.engine import rl, steps
from echr_tpu_torch.engine import train as T
from echr_tpu_torch.parallel import distributed as pdist
from echr_tpu_torch.parallel import mesh

if __name__ != "__main__":  # the ranks' processes run the port alone
    from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
GROUP_TIMEOUT_S = 300  # a collective's wait for its peer
CHILD_TIMEOUT_S = 420  # the pair's whole run
WORLD = 2


# ------------------------------------------------------------------ the ranks


def _digest(state) -> float:
    return float(sum(np.abs(p.detach().double().numpy()).sum()
                     for m in (state.tap, state.cg) for p in m.parameters()))


def _params(state):
    return [p.detach().numpy().copy() for m in (state.tap, state.cg) for p in m.parameters()]


def _files(folder):
    return {n: os.path.exists(os.path.join(folder, n))
            for n in ("model-last.ckpt", "train.log", "config.json", "src_snapshot")}


def _no_dropout(state, batch, gen, *a, **k):
    return steps.train_step(state, batch, None, *a, **k)


def _w_xe(job, r):
    """echr_tpu's two XE steps on the ref batch, rank r holding video r."""
    cfg = config.Config.from_json(job["xe_cfg"])
    out = {}
    for phase in ("tap_cg", "cg"):
        state = steps.init_train_state(cfg, tap_from_jax(job["xe_tap"], cfg),
                                       captioner_from_jax(job["xe_cg"], cfg))
        batch = steps.batch_to_device(mesh.shard_rows(job["xe_batch"], r, WORLD), "cpu")
        runs = []
        for _ in range(2):
            (tg, cgg), m = steps.grad_step(state, batch, None, cfg, phase)
            runs.append((steps.fetch_metrics(m)[0], [g.numpy().copy() for g in tg],
                         [g.numpy().copy() for g in cgg]))
            steps.apply_grads(state, tg, cgg, cfg, phase)
        out[phase] = (runs, _params(state))
    return out


def _train_cfg(job, r, run_id, shared=False, **over):
    cfg = config.Config.from_json(job["topo_cfg" if shared else "train_cfg"]).replace(
        run_id=run_id)
    folder = job["workdir"] if shared else os.path.join(job["workdir"], f"p{r}")
    cfg = cfg.replace_in("save", checkpoint_path=folder)
    for k, v in over.items():
        section, name = k.split(".")
        cfg = cfg.replace_in(section, **{name: v})
    return cfg


def _summary(out):
    return {"iteration": out["iteration"], "epoch": out["epoch"],
            "best_val_score": out["best_val_score"], "digest": _digest(out["state"]),
            "files": _files(out["save_folder"]), "losses": out["losses"]}


def _w_train(job, r):
    """train() with a gate at 2 (echr_tpu's multihost_worker 'TRAIN')."""
    cfg = _train_cfg(job, r, "MH", **{"save.save_checkpoint_every": 2})
    return _summary(T.train(cfg, max_iterations=3, device="cpu"))


def _w_resume(job, r):
    """Rank 0's model-last.ckpt (copied, a shared file system's stand-in)
    resumed for one more step, with a gate at 4 ('RESUME')."""
    pdist.allgather_object("rank 0's files are on disk")
    if r != 0:
        src = os.path.join(job["workdir"], "p0", "MH")
        for name in ("model-last.ckpt", "model-last.ckpt.config.json"):
            shutil.copyfile(os.path.join(src, name),
                            os.path.join(job["workdir"], f"p{r}", "MH", name))
    cfg = _train_cfg(job, r, "MH", **{"save.save_checkpoint_every": 2, "save.start_from": "MH",
                                      "save.start_from_mode": "last"})
    return _summary(T.train(cfg, max_iterations=4, device="cpu"))


def _w_scst(job, r):
    """Two batched SCST steps, each rank rolling out and scoring its rows
    ('RLTRAIN'); a one-worker pool scores in-process."""
    T.default_reward_pool = lambda *_: rl.RewardPool(workers=1)
    cfg = _train_cfg(job, r, "RL", **{"train.self_critical_after": 0, "train.lr": 5e-4})
    return _summary(T.train(cfg, max_iterations=2, device="cpu"))


def _w_preempt(job, r):
    """SIGTERM on rank 1 alone after its third step; with
    preempt_check_every 2 both ranks stop at iteration 4."""
    fn, n = T.train_step, [0]

    def step(*a, **k):
        out = fn(*a, **k)
        n[0] += 1
        if r == 1 and n[0] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    T.train_step = step
    try:
        cfg = _train_cfg(job, r, "PRE", **{"runtime.preempt_check_every": 2})
        return _summary(T.train(cfg, max_iterations=10, device="cpu"))
    finally:
        T.train_step = fn


def _w_topology(job, r):
    """A one-process checkpoint at iteration 2 resumed under two ranks for
    one step, f32 and dropout off, in a folder the ranks share."""
    fn, T.train_step = T.train_step, _no_dropout
    try:
        cfg = _train_cfg(job, r, "TOPO", shared=True, **{"save.start_from": "TOPO"})
        out = T.train(cfg, max_iterations=3, device="cpu")
    finally:
        T.train_step = fn
    return {**_summary(out), "params": _params(out["state"])}


def _w_eval(job, r):
    """eval_split_batched(multihost=True) over the rank's val shard."""
    cfg = config.Config.from_json(job["eval_cfg"])
    loader = Loader(build_dataset(cfg), cfg, process_index=r, process_count=WORLD, seed=0,
                    shard_splits=("val",))
    json_path = os.path.join(job["workdir"], "eval.json")
    try:
        preds, scores, losses = E.eval_split_batched(
            tap_from_jax(job["eval_tap"], cfg), captioner_from_jax(job["eval_cg"], cfg), loader,
            cfg, json_path, job["eval_kw"], flag_eval_what="tap_cg", batch_videos=2,
            device="cpu", multihost=True)
        shard = list(loader.split_order["val"])
    finally:
        loader.load_state(loader.state())
    written = json_path if r == 0 else f"{json_path}.proc{r}"
    with open(written) as f:
        on_disk = json.load(f)["results"]
    return {"preds": preds, "scores": {k: np.asarray(v).tolist() for k, v in scores.items()},
            "losses": losses.tolist(), "shard": shard, "written": written,
            "on_disk": on_disk == json.loads(json.dumps(preds))}


def _w_refusals(job, r):
    """train() refuses, before any collective, what two ranks cannot run."""
    out = {}
    for name, over in (("batch_size", {"train.batch_size": 3}),
                       ("m_batch", {"train.m_batch": 2}),
                       ("mesh_dp", {"runtime.mesh_shape": (4, 1)}),
                       ("mesh_tp", {"runtime.mesh_shape": (1, 2)})):
        try:
            T.train(_train_cfg(job, r, "NO", **over), max_iterations=1, device="cpu")
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


SCENARIOS = {"xe": _w_xe, "train": _w_train, "resume": _w_resume, "scst": _w_scst,
             "preempt": _w_preempt, "topology": _w_topology, "eval": _w_eval,
             "refusals": _w_refusals}


def _rank_main(workdir: str, r: int) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "in.pkl"), "rb") as f:
        job = pickle.load(f)
    pdist.initialize(f"127.0.0.1:{job['port']}", WORLD, r, device="cpu",
                     timeout_s=GROUP_TIMEOUT_S)
    out = {}
    try:
        for name in job["scenarios"]:
            out[name] = SCENARIOS[name](job, r)
    finally:
        with open(os.path.join(workdir, f"out{r}.pkl"), "wb") as f:
            pickle.dump(out, f)
        pdist.destroy()


# ------------------------------------------------------------- the launcher


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
    return env


def _launch(workdir: Path, job: dict):
    job = dict(job, port=_free_port(), workdir=str(workdir))
    with open(workdir / "in.pkl", "wb") as f:
        pickle.dump(job, f)
    return [subprocess.Popen([sys.executable, str(Path(__file__)), str(workdir), str(r)],
                             stdout=open(workdir / f"log{r}.txt", "w"), stderr=subprocess.STDOUT,
                             env=_child_env())
            for r in range(WORLD)]


def _join(procs, workdir: Path, timeout: float):
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for r, p in enumerate(procs):
        assert p.returncode == 0, (workdir / f"log{r}.txt").read_text()[-4000:]
    outs = []
    for r in range(WORLD):
        with open(workdir / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _tiny(tmp, **over):
    from test_train_e2e import tiny_cfg

    return config.Config.from_json(tiny_cfg(tmp, **over).to_json())


TRAIN_OVER = {"data.synthetic_num_videos": 12, "train.batch_size": 2,
              "save.min_epoch_when_save": -1, "eval.num_vids_eval": 0,
              "eval.fast_eval_cg": True, "eval.batch_videos": 2}
TOPO_OVER = {"train.training_mode": "cotrain", "train.cg_epochs": 0, "train.tapcg_epochs": 3,
             "tap.rnn_dropout": 0.0, "decoder.CG_drop_prob": 0.0,
             "runtime.compute_dtype": "float32"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the pair, and meanwhile compute in this process what the ranks
    are held to: echr_tpu's XE steps, one process's eval of the split, and
    the one-process halves of the topology runs."""
    import test_torch_eval as TE
    import test_torch_train as TT

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    work = tmp_path_factory.mktemp("ranks")
    xe_cfg = TT._cfg()
    xe_tap, xe_cg = TT._params(xe_cfg)
    xe_batch = TT._batch(xe_cfg)
    split = TE.Split(tmp_path_factory.mktemp("split"))
    eval_kw = TE._kw(language_eval=True)
    train_cfg = _tiny(work, **TRAIN_OVER)
    topo = train_cfg.replace(run_id="TOPO").replace_in("save", checkpoint_path=str(work))
    for k, v in TOPO_OVER.items():
        section, name = k.split(".")
        topo = topo.replace_in(section, **{name: v})
    mp = pytest.MonkeyPatch()
    mp.setattr(T, "train_step", _no_dropout)
    try:
        first = T.train(topo, max_iterations=2, device="cpu")  # the 1-process half, to 2
        job = {"scenarios": list(SCENARIOS),
               "xe_cfg": xe_cfg.to_json(), "xe_tap": xe_tap, "xe_cg": xe_cg, "xe_batch": xe_batch,
               "train_cfg": train_cfg.to_json(), "topo_cfg": topo.to_json(),
               "eval_cfg": split.cfg.to_json(), "eval_tap": split.tap_np, "eval_cg": split.cg_np,
               "eval_kw": eval_kw}
        procs = _launch(work, job)
        try:
            runs = {p: TT._jax_run(xe_cfg, xe_tap, xe_cg, xe_batch, p, 2)
                    for p in ("tap_cg", "cg")}
            straight = T.train(topo.replace(run_id="STRAIGHT"), max_iterations=4, device="cpu")
            single_eval = split.port(eval_kw, "tap_cg")
            outs = _join(procs, work, CHILD_TIMEOUT_S)
        except BaseException:
            for p in procs:
                p.kill()
            raise
        # the 2-rank checkpoint at 3 resumed in one process, to 4
        last = T.train(topo.replace_in("save", start_from="TOPO"), max_iterations=4,
                       device="cpu")
    finally:
        mp.undo()
        split.close()
        torch.set_num_threads(threads)
    return {"outs": outs, "work": work, "xe": (xe_cfg, xe_tap, xe_cg, runs),
            "first": first, "straight": straight, "last": last, "single_eval": single_eval,
            "split": split, "train_cfg": train_cfg}


def _both(ranks_, name):
    return [o[name] for o in ranks_["outs"]]


# -------------------------------------------------------- parity with echr_tpu


@pytest.mark.parametrize("phase", ["tap_cg", "cg"])
def test_two_ranks_take_jaxs_xe_steps(ranks, phase):
    """Two ranks, one video each, take echr_tpu's two steps on the whole
    batch: losses, metrics and every gradient leaf within the gates,
    parameters within 4 * lr, and the ranks' parameters bit-equal."""
    import test_torch_train as TT
    from echr_tpu_torch.bridge import captioner_to_jax, tap_to_jax

    cfg, tap, cg, runs = ranks["xe"]
    jruns, jtap, jcg = runs[phase]
    (got, params0), (got1, params1) = _both(ranks, "xe")[0][phase], _both(ranks, "xe")[1][phase]
    assert all(np.array_equal(a, b) for a, b in zip(params0, params1))
    state = steps.init_train_state(cfg, tap_from_jax(tap, cfg), captioner_from_jax(cg, cfg))
    for (m, tg, cgg), (m1, _, _), (jloss, jm, jtg, jcgg) in zip(got, got1, jruns):
        assert m == m1
        np.testing.assert_allclose(m["loss"], jloss, rtol=TT.REL)
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], rtol=TT.REL, err_msg=k)
        TT._close_trees(TT._as_jax(state.tap, [torch.from_numpy(g) for g in tg], tap_to_jax),
                        jtg, TT.GATOL, TT.GRTOL)
        TT._close_trees(TT._as_jax(state.cg, [torch.from_numpy(g) for g in cgg],
                                   lambda mod: captioner_to_jax(mod, cfg)),
                        jcgg, TT.GATOL, TT.GRTOL)
    with torch.no_grad():
        for p, v in zip([*state.tap.parameters(), *state.cg.parameters()], params0):
            p.copy_(torch.from_numpy(v))
    lr = cfg.train.lr
    TT._close_trees(captioner_to_jax(state.cg, cfg), jcg, 4 * lr, 0)
    TT._close_trees(tap_to_jax(state.tap), jtap, 4 * lr, 0)


@pytest.mark.parametrize("shard_splits", [None, ("val",)])
@pytest.mark.parametrize("count", [2, 3])
def test_loader_shards_match_jax(tmp_path, shard_splits, count):
    """Each rank's split orders equal echr_tpu's Loader with the same
    explicit rank, count and shard_splits."""
    from test_train_e2e import tiny_cfg

    from echr_tpu.data.dataset import build_dataset as jax_build_dataset
    from echr_tpu.data.loader import Loader as JaxLoader

    jcfg = tiny_cfg(tmp_path, **{"data.synthetic_num_videos": 16})
    cfg = config.Config.from_json(jcfg.to_json())
    ds, jds = build_dataset(cfg), jax_build_dataset(jcfg)
    kw = {} if shard_splits is None else {"shard_splits": shard_splits}
    union = []
    for r in range(count):
        got = Loader(ds, cfg, process_index=r, process_count=count, seed=3, **kw).split_order
        want = JaxLoader(jds, jcfg, seed=3, process_index=r, process_count=count,
                         **kw).split_order
        assert got == want
        union += got["val"]
    sharded = shard_splits is not None
    assert sorted(union) == (sorted(ds.split_ix["val"]) if sharded
                             else sorted(ds.split_ix["val"] * count))


def test_gather_predictions_merge_matches_jax(monkeypatch):
    """The union of the ranks' predictions, the lowest rank's records
    winning a duplicated video, equals echr_tpu's merge of the same parts."""
    from echr_tpu.parallel import distributed as jdist

    parts = [{"v1": [{"sentence": "a"}], "v3": [{"sentence": "c"}]},
             {"v2": [{"sentence": "b"}], "v3": [{"sentence": "other"}]},
             {"v4": []}]
    monkeypatch.setattr(pdist, "allgather_object", lambda obj: parts)
    monkeypatch.setattr(jdist, "allgather_object", lambda obj: parts)
    got, want = pdist.gather_predictions({}), jdist.gather_predictions({})
    assert got == want and list(got) == list(want) == ["v1", "v3", "v2", "v4"]
    assert got["v3"] == [{"sentence": "c"}]
    # without a group: the process's own predictions
    monkeypatch.undo()
    assert pdist.allgather_object(parts[0]) == [parts[0]]
    assert pdist.gather_predictions(parts[1]) == parts[1]
    assert (pdist.rank(), pdist.world_size()) == (0, 1) and not pdist.any_rank(False)


# ---------------------------------------------------------------- train()


def test_train_on_two_ranks_has_one_writer(ranks):
    """echr_tpu's multi-host train(): equal best score, stop iteration and
    parameters on both ranks, and rank 0 alone writes the run's files."""
    a, b = _both(ranks, "train")
    assert a["iteration"] == b["iteration"] >= 3
    assert a["best_val_score"] == b["best_val_score"] > -1.0  # the gate at 2 ran, rank 0's
    assert a["digest"] == b["digest"] and a["losses"] == b["losses"]
    assert all(a["files"].values()) and not any(b["files"].values())


def test_resume_on_two_ranks(ranks):
    a, b = _both(ranks, "resume")
    first = _both(ranks, "train")[0]
    assert a["iteration"] == b["iteration"] == 4
    assert a["digest"] == b["digest"] != first["digest"]  # a step was taken
    assert a["best_val_score"] == b["best_val_score"]


def test_scst_on_two_ranks(ranks):
    a, b = _both(ranks, "scst")
    assert a["iteration"] == b["iteration"] == 2
    assert a["digest"] == b["digest"] and a["losses"] == b["losses"]
    assert "avg_reward" in a["losses"]


def test_preemption_on_one_rank_stops_both_at_a_check(ranks):
    """SIGTERM on rank 1 after step 3; preempt_check_every 2: both ranks
    stop at iteration 4 and rank 0 checkpoints there."""
    a, b = _both(ranks, "preempt")
    assert a["iteration"] == b["iteration"] == 4
    assert a["digest"] == b["digest"] and a["files"]["model-last.ckpt"]
    from echr_tpu_torch.engine import checkpoint

    folder = ranks["work"] / "p0" / "PRE"
    assert checkpoint.load_checkpoint(str(folder / "model-last.ckpt"), "cpu",
                                      rebuild_state=False)["iteration"] == 4


def test_resume_across_topologies(ranks):
    """One process to 2, two ranks to 3, one process to 4 (f32, dropout
    off): each leg continues at the exact iteration, and the parameters are
    within the gradient gate of 4 steps in one process."""
    import test_torch_train as TT

    a, b = _both(ranks, "topology")
    assert ranks["first"]["iteration"] == 2
    assert a["iteration"] == b["iteration"] == 3 and a["epoch"] == b["epoch"]
    assert all(np.array_equal(x, y) for x, y in zip(a["params"], b["params"]))
    assert a["files"]["model-last.ckpt"] and a["files"]["config.json"]
    last, straight = ranks["last"], ranks["straight"]
    assert last["iteration"] == straight["iteration"] == 4
    assert last["epoch"] == straight["epoch"]
    got = [p.detach().numpy() for m in (last["state"].tap, last["state"].cg)
           for p in m.parameters()]
    want = [p.detach().numpy() for m in (straight["state"].tap, straight["state"].cg)
            for p in m.parameters()]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TT.GATOL, rtol=TT.GRTOL)


# ------------------------------------------------------------------- eval


def test_sharded_eval_equals_one_process(ranks):
    """eval_split_batched(multihost=True) over disjoint val shards: the
    merged predictions equal one process's over the whole split token for
    token on both ranks, the val losses within 1e-5 relative, the same
    scores; rank 1 writes <json>.proc1."""
    import test_torch_eval as TE

    a, b = _both(ranks, "eval")
    want_preds, want_scores, want_losses = ranks["single_eval"]
    assert sorted(a["shard"] + b["shard"]) == sorted(ranks["split"].ds.split_ix["val"])
    assert not set(a["shard"]) & set(b["shard"]) and a["shard"] and b["shard"]
    assert a["preds"] == b["preds"] and a["losses"] == b["losses"]
    TE.assert_same_predictions(a["preds"], want_preds)
    np.testing.assert_allclose(a["losses"], want_losses, rtol=1e-5)
    # each rank scores the merged split itself: METEOR sums over sets, whose
    # order follows each process's string hashes, so within rounding
    for k, v in want_scores.items():
        for got in (a, b):
            np.testing.assert_allclose(got["scores"][k], np.asarray(v), rtol=1e-12, err_msg=k)
    assert b["written"].endswith("eval.json.proc1") and a["on_disk"] and b["on_disk"]


# -------------------------------------------------------------------- the CLIs


def test_cli_train_joins_the_group_named_by_the_environment(tmp_path):
    """cli.train launched twice under ECHR_COORDINATOR / ECHR_NUM_PROCESSES
    / ECHR_PROCESS_ID with --device cpu trains as one group of 2: rank 1
    joins and writes nothing (echr_tpu's test_cli_multihost_env_init)."""
    cfg = _tiny(tmp_path, **TRAIN_OVER).replace(run_id="CLIMH")
    cfg = cfg.replace_in("train", cg_epochs=1).replace_in("save", losses_log_every=1)
    port, procs = _free_port(), []
    for r in range(WORLD):
        cfg_path = tmp_path / f"cli_{r}.json"
        cfg_path.write_text(cfg.replace_in("save", checkpoint_path=str(tmp_path / f"p{r}"))
                            .to_json())
        env = _child_env(ECHR_COORDINATOR=f"127.0.0.1:{port}", ECHR_NUM_PROCESSES=str(WORLD),
                         ECHR_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "echr_tpu_torch.cli.train", "--config_json", str(cfg_path),
             "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(REPO)))
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-4000:]
        assert f"rank {r} of 2 joined" in out
    assert (tmp_path / "p0" / "CLIMH" / "config.json").exists()
    assert (tmp_path / "p0" / "CLIMH" / "model-last.ckpt").exists()
    assert not (tmp_path / "p1" / "CLIMH" / "config.json").exists()
    assert not (tmp_path / "p1" / "CLIMH" / "model-last.ckpt").exists()


def test_cli_eval_data_parallel_needs_the_devices(tmp_path):
    """--data_parallel N on CUDA raises when N exceeds the local devices,
    before any rank starts (echr_tpu's check)."""
    from echr_tpu_torch.cli import eval as cli_eval

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"exceeds the {n} local devices"):
        cli_eval.main(["--folder_id", "X", "--checkpoint_path", str(tmp_path),
                       "--data_parallel", str(max(n + 1, 2))])


# -------------------------------------------------------------------- refusals


def test_refusals_name_what_to_do(ranks, tmp_path):
    """tp > 1, a mesh dp that is not the world size, a batch_size that the
    ranks do not divide (SCST at batch_size 1 too) and m_batch > 1 under two
    ranks each raise, naming what to do; train() raises them on both ranks
    before any collective, and in one process for the mesh."""
    cfg = _tiny(tmp_path)
    with pytest.raises(NotImplementedError, match="A.13"):
        mesh.check_layout(cfg.replace_in("runtime", mesh_shape=(1, 2)), 1)
    with pytest.raises(ValueError, match="launch 2 ranks"):
        mesh.check_layout(cfg.replace_in("runtime", mesh_shape=(2, 1)), 1)
    mesh.check_layout(cfg.replace_in("runtime", mesh_shape=(2, 1)), 2)
    mesh.check_layout(cfg, 4)
    for over, exc, what in ((dict(batch_size=3), ValueError, "multiple of 2"),
                            (dict(batch_size=1, self_critical_after=0), ValueError,
                             "multiple of 2"),
                            (dict(batch_size=2, m_batch=2), NotImplementedError,
                             "raise train.batch_size")):
        with pytest.raises(exc, match=what):
            T.check_data_parallel(cfg.replace_in("train", **over), 2)
    T.check_data_parallel(cfg.replace_in("train", batch_size=4), 2)
    for a in _both(ranks, "refusals"):
        assert a["batch_size"].startswith("ValueError") and "multiple of 2" in a["batch_size"]
        assert a["m_batch"].startswith("NotImplementedError")
        assert a["mesh_dp"].startswith("ValueError") and "launch 4 ranks" in a["mesh_dp"]
        assert a["mesh_tp"].startswith("NotImplementedError") and "A.13" in a["mesh_tp"]
    with pytest.raises(NotImplementedError, match="A.13"):
        T.train(cfg.replace_in("runtime", mesh_shape=(1, 2)), max_iterations=1, device="cpu")


class _Pool:
    def __init__(self, workers):
        self.workers = workers

    def shutdown(self, wait=False):
        pass


def test_reward_pool_takes_its_share_of_the_cores(monkeypatch):
    """Each rank's SCST reward pool takes cpu_count // ranks_on_host - 1
    workers; the ranks on a host are torchrun's LOCAL_WORLD_SIZE, else
    the group's size."""
    monkeypatch.setattr(rl.os, "cpu_count", lambda: 8)
    monkeypatch.setattr(rl, "RewardPool", _Pool)
    monkeypatch.setattr(rl, "_DEFAULT_POOL", None)
    assert rl.default_reward_pool().workers == 7
    assert rl.default_reward_pool(2).workers == 3
    assert rl.default_reward_pool(8).workers == 0
    assert rl.default_reward_pool(8) is rl.default_reward_pool(8)
    assert pdist.local_world_size() == 1
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert pdist.local_world_size() == 4

if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
