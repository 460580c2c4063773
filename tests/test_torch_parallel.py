"""The port's data and tensor parallelism and the sequence ring
(echr_tpu_torch/parallel/, the multi-rank paths of engine/train.py,
engine/evaluate.py and both CLIs) on gloo ranks on the CPU, against
echr_tpu and against the port's own single process.

The ranks are child processes of this file (``python test_torch_parallel.py
<workdir> <rank>``): one pair is started for the whole module and runs every
scenario in turn (``SCENARIOS``), each rank writing what it saw to
``<workdir>/out<rank>.pkl``.  Every group and every child has a timeout of
its own, so that a hang fails the tests and does not stall the suite.  The
children import the port alone; JAX is imported by the tests here.

The tensor-parallel scenarios run the pair as the mesh (1, 2) (V+1 = 62
cut 31 + 31, TSRM's 4 heads 2 + 2), and a second launch of four ranks
runs the XE steps as (2, 2).  Both the XE steps and one SCST step of the
train loop are held against echr_tpu's unsharded update.

Tolerances: as tests/test_torch_train.py: losses within 1e-5 relative,
gradient leaves within atol 2e-4, rtol 1e-3, parameters after two Adam
steps within 4 * lr; the ranks' parameters bit-equal.  The val losses of
the sharded eval within 1e-5 relative of one process's.  The ring within
atol 1e-5 of echr_tpu's (tests/test_sequence_sharding.py's gate).
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
TP_VOCAB = 61  # V+1 = 62 divides over tp = 2, as tests/multihost_worker.py chooses
RING_T = 128  # the ring's frames
RL_SEED = 7  # the tp SCST step's draws


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
    """train() refuses, before any collective, what two ranks cannot run;
    the mesh (1, 2) trains."""
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


def _whole_params(state):
    whole = mesh.gather_modules(state)
    return _params(whole)


def _w_tp_xe(job, r):
    """echr_tpu's two XE steps (tap_cg) on the vocab-61 batch under the
    job's mesh: row d holds video d of the dp-row split; the gradients
    (the sharded leaves gathered), the whole parameters after the steps,
    the rank's replicated leaves and the shapes of its cut leaves."""
    cfg = config.Config.from_json(job["tp_cfg"]).replace_in(
        "runtime", mesh_shape=tuple(job["mesh_shape"]))
    lay = mesh.build_mesh(cfg)
    state = steps.init_train_state(cfg, tap_from_jax(job["tp_tap"], cfg),
                                   captioner_from_jax(job["tp_cg"], cfg))
    mesh.shard_modules(state, lay)
    batch = steps.batch_to_device(mesh.shard_rows(job["tp_batch"], lay.d, lay.dp), "cpu")
    runs = []
    for _ in range(2):
        (tg, cgg), m = steps.grad_step(state, batch, None, cfg, "tap_cg")
        runs.append((steps.fetch_metrics(m)[0], [g.numpy().copy() for g in tg],
                     [g.numpy().copy() for g in mesh.gather_grads(state.cg, cgg)]))
        steps.apply_grads(state, tg, cgg, cfg, "tap_cg")
    cut = {n: tuple(p.shape) for n, p, _ in mesh.sharded_leaves(state.cg)}
    replicated = [p.detach().numpy().copy() for n, p in state.cg.named_parameters()
                  if n not in cut]
    return {"runs": runs, "params": _whole_params(state), "cut": cut,
            "replicated": replicated, "layout": (lay.dp, lay.tp, lay.d, lay.m)}


def _tp_cfg(job, r, run_id, shared=True, **over):
    """The tiny loop's config at vocab 61 under (1, 2), in the ranks'
    shared folder or in the rank's own."""
    over = {"data.synthetic_vocab_size": TP_VOCAB, "runtime.mesh_shape": (1, 2), **over}
    cfg = config.Config.from_json(job["train_cfg"]).replace(run_id=run_id)
    folder = job["workdir"] if shared else os.path.join(job["workdir"], f"p{r}")
    cfg = cfg.replace_in("save", checkpoint_path=folder)
    for k, v in over.items():
        section, name = k.split(".")
        cfg = cfg.replace_in(section, **{name: v})
    return cfg


def _w_tp_train(job, r):
    """train() under (1, 2) with a gate at 2 and the end at 3: rank 0 the
    one writer, the whole parameters the same on both ranks."""
    out = T.train(_tp_cfg(job, r, "TPT", shared=False, **{"save.save_checkpoint_every": 2}),
                  max_iterations=3, device="cpu")
    cut = {n: tuple(p.shape) for n, p, _ in mesh.sharded_leaves(out["state"].cg)}
    return {**_summary(out), "params": _whole_params(out["state"]), "cut": cut,
            "files": _files(out["save_folder"])}


def _w_layouts(job, r):
    """Rank 0's (1, 2) checkpoint of TPT at 3 (copied to the ranks' shared
    folder as LAY) resumed under (2, 1) for a step, then that checkpoint
    resumed under (1, 2) for a step: the state each run holds right after
    its load (the (1, 2) run's gathered back from its blocks), and the
    runs' ends."""
    pdist.allgather_object("rank 0's TPT files are on disk")
    if r == 0:
        src, dst = (os.path.join(job["workdir"], *p) for p in (("p0", "TPT"), ("LAY",)))
        os.makedirs(dst, exist_ok=True)
        for name in ("model-last.ckpt", "model-last.ckpt.config.json"):
            shutil.copyfile(os.path.join(src, name), os.path.join(dst, name))
    loaded = {}

    def keep(name, fn):
        def wrapped(state, *a):
            out = fn(state, *a)
            if name == "shard":
                loaded["params"] = _whole_params(out)
            else:
                loaded["params"] = _params(state)
            return out
        return wrapped

    out = {}
    for leg, (layout, start, stop, hook) in enumerate((((2, 1), 3, 4, "broadcast_state"),
                                                       ((1, 2), 4, 5, "shard_modules"))):
        pdist.allgather_object("the last checkpoint is on disk")
        fn = getattr(T, hook)
        setattr(T, hook, keep("shard" if hook == "shard_modules" else "bcast", fn))
        try:
            res = T.train(_tp_cfg(job, r, "LAY", **{"runtime.mesh_shape": layout,
                                                      "save.start_from": "LAY"}),
                          max_iterations=stop, device="cpu")
        finally:
            setattr(T, hook, fn)
        out[leg] = {"loaded": loaded.pop("params"), "iteration": res["iteration"],
                    "params": _whole_params(res["state"])}
        if r == 0:
            shutil.copyfile(os.path.join(res["save_folder"], "model-last.ckpt"),
                            os.path.join(job["workdir"], f"layout{leg}.ckpt"))
    return out


def _w_tp_scst(job, r):
    """Two batched SCST steps under (1, 2) (the two-program steps; the
    rewards of rank 0 of the row)."""
    T.default_reward_pool = lambda *_: rl.RewardPool(workers=1)
    cfg = _tp_cfg(job, r, "TPRL", **{"train.self_critical_after": 0, "train.lr": 5e-4})
    out = T.train(cfg.replace_in("save", checkpoint_path=os.path.join(job["workdir"], f"p{r}")),
                  max_iterations=2, device="cpu")
    return {**_summary(out), "params": _whole_params(out["state"])}


def _w_tp_rl(job, r):
    """One SCST step of train's _self_critical_step_batched under (1, 2) on
    the vocab-61 batch (tap_cg, dropout off; runtime.scst_resident_vjp on,
    which a group takes as the two-program steps, counted): the rollout
    from the seeded generator, the rewards the row's m = 0 rank is
    handed (rank m = 1 is handed their negation, so that only the broadcast
    from the row root makes the ranks agree), and the update's gradients
    caught on their way to Adam, the cut leaves gathered."""
    from types import SimpleNamespace

    cfg = config.Config.from_json(job["tp_cfg"]).replace_in(
        "runtime", mesh_shape=(1, WORLD), scst_resident_vjp=True)
    lay = mesh.build_mesh(cfg)
    state = steps.init_train_state(cfg, tap_from_jax(job["tp_tap"], cfg),
                                   captioner_from_jax(job["rl_cg"], cfg))
    mesh.shard_modules(state, lay)
    batch = steps.batch_to_device(job["tp_batch"], "cpu")
    handed = job["rl_reward"] * (1.0 if lay.m == 0 else -1.0)
    seen, caught, calls = {}, [], {"replay": 0, "graph": 0}
    apply, score = steps.apply_grads, T.self_critical_reward_batched
    updates = {k: getattr(T, k) for k in ("rl_update_step_batched",
                                          "rl_graph_update_step_batched")}

    def counted(name, key):
        def call(*a, **k):
            calls[key] += 1
            return updates[name](*a, **k)
        return call

    def reward(gen, *a, **k):
        seen["gen_seq"] = np.stack([gen[i] for i in range(len(gen))])
        return handed

    def catch(state_, tg, cgg, *a):
        caught.append((tg, cgg))
        return apply(state_, tg, cgg, *a)

    T.default_reward_pool = lambda *_: rl.RewardPool(workers=1)
    T.self_critical_reward_batched, steps.apply_grads = reward, catch
    T.rl_update_step_batched = counted("rl_update_step_batched", "replay")
    T.rl_graph_update_step_batched = counted("rl_graph_update_step_batched", "graph")
    try:
        metas = [SimpleNamespace(sentences=[], cg_select=[])] * len(handed)
        state, metrics, _ = T._self_critical_step_batched(
            state, batch, metas, cfg, "tap_cg", None, torch.Generator().manual_seed(job["rl_seed"]),
            SimpleNamespace(ix_to_word={}))
    finally:
        T.self_critical_reward_batched, steps.apply_grads = score, apply
        for name, fn in updates.items():
            setattr(T, name, fn)
    tg, cgg = caught[0]
    return {"gen_seq": seen["gen_seq"], "metrics": metrics, "calls": calls,
            "tap_grads": [g.numpy().copy() for g in tg],
            "cg_grads": [g.numpy().copy() for g in mesh.gather_grads(state.cg, cgg)],
            "params": _whole_params(state)}


def _w_ring(job, r):
    """The SST ring over the pair on rank r's half of the frames, and its
    refusals: a call under autograd, and frames that do not split."""
    from echr_tpu_torch.parallel import sequence

    cfg = config.Config.from_json(job["ring_cfg"])
    sst = tap_from_jax(job["ring_tap"], cfg)
    feats = torch.from_numpy(job["ring_feats"])
    with torch.no_grad():
        h, s = sequence.sequence_sharded_sst(sst, sequence.local_frames(feats))
    out = {"h": h.numpy(), "s": s.numpy()}
    for name, fn in (("grad", lambda: sequence.sequence_sharded_sst(sst, feats[:64])),
                     ("odd", lambda: sequence.local_frames(feats[:127]))):
        try:
            fn()
            out[name] = None
        except (RuntimeError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


SCENARIOS = {"xe": _w_xe, "train": _w_train, "resume": _w_resume, "scst": _w_scst,
             "preempt": _w_preempt, "topology": _w_topology, "eval": _w_eval,
             "refusals": _w_refusals, "tp_xe": _w_tp_xe, "tp_train": _w_tp_train,
             "layouts": _w_layouts, "tp_scst": _w_tp_scst, "tp_rl": _w_tp_rl, "ring": _w_ring}


def _rank_main(workdir: str, r: int) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "in.pkl"), "rb") as f:
        job = pickle.load(f)
    pdist.initialize(f"127.0.0.1:{job['port']}", job["world"], r, device="cpu",
                     timeout_s=GROUP_TIMEOUT_S)
    out = {"seconds": {}}
    try:
        for name in job["scenarios"]:
            t0 = time.time()
            out[name] = SCENARIOS[name](job, r)
            out["seconds"][name] = time.time() - t0
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


def _launch(workdir: Path, job: dict, world: int = WORLD):
    job = dict(job, port=_free_port(), workdir=str(workdir), world=world)
    with open(workdir / "in.pkl", "wb") as f:
        pickle.dump(job, f)
    return [subprocess.Popen([sys.executable, str(Path(__file__)), str(workdir), str(r)],
                             stdout=open(workdir / f"log{r}.txt", "w"), stderr=subprocess.STDOUT,
                             env=_child_env())
            for r in range(world)]


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
    for r in range(len(procs)):
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
    import test_torch_scst as TS
    import test_torch_train as TT

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    work = tmp_path_factory.mktemp("ranks")
    xe_cfg = TT._cfg()
    xe_tap, xe_cg = TT._params(xe_cfg)
    xe_batch = TT._batch(xe_cfg)
    tp_cfg = TT._cfg(**{"data.synthetic_vocab_size": TP_VOCAB, "decoder.CG_vocab_size": TP_VOCAB})
    tp_tap, tp_cg = TT._params(tp_cfg)
    tp_batch = TT._batch(tp_cfg)
    ring_feats = np.random.RandomState(2).randn(RING_T, tp_cfg.tap.video_dim).astype(np.float32)
    # one process's SCST rollout of the tp batch (captions that end early)
    # and random rewards: what echr_tpu's update takes
    rl_cg = TS._eos_biased(tp_cg, TS.EOS_BIAS)
    _, rl_seq, _ = steps.rl_rollout_step_batched(
        TS._state(tp_cfg, tp_tap, rl_cg), steps.batch_to_device(tp_batch, "cpu"), tp_cfg,
        "tap_cg", None, torch.Generator().manual_seed(RL_SEED))
    rl_seq = rl_seq.numpy()
    rl_reward = np.broadcast_to(np.random.RandomState(5).randn(*rl_seq.shape[:2], 1),
                                rl_seq.shape).astype(np.float32)
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
               "eval_kw": eval_kw, "tp_cfg": tp_cfg.to_json(), "tp_tap": tp_tap,
               "tp_cg": tp_cg, "tp_batch": tp_batch, "mesh_shape": (1, WORLD),
               "ring_cfg": tp_cfg.to_json(), "ring_tap": tp_tap, "ring_feats": ring_feats,
               "rl_cg": rl_cg, "rl_reward": rl_reward, "rl_seed": RL_SEED}
        quad_work = tmp_path_factory.mktemp("quad")
        procs = _launch(work, job) + _launch(
            quad_work, dict(job, scenarios=["tp_xe"], mesh_shape=(2, 2)), world=4)
        try:
            runs = {p: TT._jax_run(xe_cfg, xe_tap, xe_cg, xe_batch, p, 2)
                    for p in ("tap_cg", "cg")}
            tp_run = TT._jax_run(tp_cfg, tp_tap, tp_cg, tp_batch, "tap_cg", 2)
            rl_run = TS._jax_rl(tp_cfg, tp_tap, rl_cg, tp_batch, "tap_cg", rl_seq, rl_reward)
            ring_want = _jax_ring(tp_cfg, tp_tap, ring_feats)
            straight = T.train(topo.replace(run_id="STRAIGHT"), max_iterations=4, device="cpu")
            single_eval = split.port(eval_kw, "tap_cg")
            outs = _join(procs[:WORLD], work, CHILD_TIMEOUT_S)
            quad = _join(procs[WORLD:], quad_work, CHILD_TIMEOUT_S)
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
            "split": split, "train_cfg": train_cfg, "quad": quad,
            "tp": (tp_cfg, tp_tap, tp_cg, tp_run), "ring": ring_want,
            "tp_rl": (rl_cg, rl_seq, rl_run),
            "tp_rl_ended": bool(((rl_seq == 0).any(-1) & (tp_batch.prop_mask > 0)).any())}


def _jax_ring(cfg, tap, feats):
    """echr_tpu's ring over two of the suite's virtual CPU devices, and its
    unsharded sst_forward, on the same weights and frames."""
    import jax

    from echr_tpu.models.sst import sst_forward
    from echr_tpu.parallel.mesh import build_mesh
    from echr_tpu.parallel.sequence import sequence_sharded_sst

    jmesh = build_mesh(shape=(2, 1), devices=jax.devices()[:2])
    # jitted: op by op, the scans' bodies would compile one by one
    ring = jax.jit(lambda t, f: sequence_sharded_sst(t, f, jmesh, "data"))(tap, feats)
    return [np.asarray(x) for x in ring], [np.asarray(x) for x in jax.jit(sst_forward)(tap, feats)]


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


# ---------------------------------------------------------- tensor parallel


def _want_cut(cfg):
    """The leaves (1, 2) cuts at the tests' widths, and their blocks."""
    v1, d = (cfg.decoder.CG_vocab_size + 1) // 2, cfg.fusion
    return {"decoder.embed": (v1, cfg.decoder.CG_input_encoding_size),
            "decoder.logit.weight": (v1, 3 * cfg.decoder.CG_rnn_size),
            "decoder.logit.bias": (v1,), "fusion.out.weight": (d.d_o // 2, d.d_feats)}


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_tp_ranks_take_jaxs_xe_steps(ranks, layout):
    """(1, 2) on the pair and (2, 2) on four ranks take echr_tpu's two
    unsharded XE steps (tap_cg, V+1 = 62): the loss and metrics within
    1e-5 relative, every gradient leaf (the cut ones gathered) within the
    gate, the whole parameters within 4 * lr; the vocab and TSRM-head
    leaves cut in halves, and the replicated leaves bit-equal on every rank."""
    import test_torch_train as TT
    from echr_tpu_torch.bridge import captioner_to_jax, tap_to_jax

    cfg, tap, cg, (jruns, jtap, jcg) = ranks["tp"]
    outs = [o["tp_xe"] for o in (ranks["outs"] if layout == "1x2" else ranks["quad"])]
    dp, tp = (1, 2) if layout == "1x2" else (2, 2)
    assert [o["layout"] for o in outs] == [(dp, tp, r // tp, r % tp) for r in range(dp * tp)]
    state = steps.init_train_state(cfg, tap_from_jax(tap, cfg), captioner_from_jax(cg, cfg))
    for o in outs:
        assert o["cut"] == _want_cut(cfg)
        assert all(np.array_equal(a, b) for a, b in zip(o["replicated"], outs[0]["replicated"]))
        assert all(np.array_equal(a, b) for a, b in zip(o["params"], outs[0]["params"]))
        for (m, tg, cgg), (jloss, jm, jtg, jcgg) in zip(o["runs"], jruns):
            np.testing.assert_allclose(m["loss"], jloss, rtol=TT.REL)
            for k in jm:
                np.testing.assert_allclose(m[k], jm[k], rtol=TT.REL, err_msg=k)
            TT._close_trees(TT._as_jax(state.tap, [torch.from_numpy(g) for g in tg], tap_to_jax),
                            jtg, TT.GATOL, TT.GRTOL)
            TT._close_trees(TT._as_jax(state.cg, [torch.from_numpy(g) for g in cgg],
                                       lambda mod: captioner_to_jax(mod, cfg)),
                            jcgg, TT.GATOL, TT.GRTOL)
    with torch.no_grad():
        for p, v in zip([*state.tap.parameters(), *state.cg.parameters()], outs[0]["params"]):
            p.copy_(torch.from_numpy(v))
    lr = cfg.train.lr
    TT._close_trees(captioner_to_jax(state.cg, cfg), jcg, 4 * lr, 0)
    TT._close_trees(tap_to_jax(state.tap), jtap, 4 * lr, 0)


def _ckpt_params(path):
    from echr_tpu_torch.engine import checkpoint

    return _params(checkpoint.load_checkpoint(str(path), "cpu")["state"])


def test_tp_train_writes_a_one_process_checkpoint(ranks):
    """train() under (1, 2) at vocab 61: the vocab and head leaves cut,
    rank 0 the one writer, the whole parameters bit-equal on both ranks,
    and rank 0's checkpoint loads in one process bit-equal to them."""
    a, b = _both(ranks, "tp_train")
    cfg = config.Config.from_json(ranks["train_cfg"].to_json())
    assert a["iteration"] == b["iteration"] == 3 and a["best_val_score"] == b["best_val_score"]
    assert a["best_val_score"] > -1.0  # the gate at 2 ran on the gathered model
    assert set(a["cut"]) == set(_want_cut(cfg)) and a["cut"]["decoder.embed"][0] == 31
    assert all(np.array_equal(x, y) for x, y in zip(a["params"], b["params"]))
    assert a["losses"] == b["losses"]
    assert all(a["files"].values()) and not any(b["files"].values())
    got = _ckpt_params(ranks["work"] / "p0" / "TPT" / "model-last.ckpt")
    assert len(got) == len(a["params"])
    assert all(np.array_equal(x, y) for x, y in zip(got, a["params"]))


def test_checkpoints_resume_across_layouts(ranks):
    """The (1, 2) checkpoint resumed under (2, 1), and that run's checkpoint
    resumed under (1, 2): right after each load the state (the (1, 2) run's
    gathered back from its blocks) is bit-equal to the file's, on both
    ranks; each run takes its step and ends as the file it writes."""
    a, b = _both(ranks, "layouts")
    work = ranks["work"]
    for leg, src, stop in ((0, work / "p0" / "TPT" / "model-last.ckpt", 4),
                           (1, work / "layout0.ckpt", 5)):
        want = _ckpt_params(src)
        for o in (a, b):
            assert o[leg]["iteration"] == stop
            assert all(np.array_equal(x, y) for x, y in zip(o[leg]["loaded"], want)), leg
            assert all(np.array_equal(x, y) for x, y in zip(o[leg]["params"],
                                                            a[leg]["params"]))
        end = _ckpt_params(work / f"layout{leg}.ckpt")
        assert all(np.array_equal(x, y) for x, y in zip(a[leg]["params"], end))
        assert not all(np.array_equal(x, y) for x, y in zip(end, want))  # a step was taken


def test_tp_scst_on_two_ranks(ranks):
    """Two SCST steps under (1, 2), the two-program steps: the same losses
    and whole parameters on both ranks."""
    a, b = _both(ranks, "tp_scst")
    assert a["iteration"] == b["iteration"] == 2
    assert a["losses"] == b["losses"] and "avg_reward" in a["losses"]
    assert all(np.array_equal(x, y) for x, y in zip(a["params"], b["params"]))


def test_tp_scst_update_takes_jaxs_step(ranks):
    """One SCST step of train's _self_critical_step_batched under (1, 2)
    (tap_cg, V+1 = 62), rank 1 handed the negation of rank 0's rewards: on
    both ranks runtime.scst_resident_vjp falls back to the replay, the
    rollout's tokens equal one process's from the same generator, and the
    update on them with rank 0's rewards is echr_tpu's:
    the loss and metrics within 1e-5 relative, every gradient leaf (the
    cut ones gathered) within the gate, the whole parameters after the Adam
    step within 4 * lr."""
    import test_torch_train as TT
    from echr_tpu_torch.bridge import captioner_to_jax, tap_to_jax

    cfg, tap, _, _ = ranks["tp"]
    rl_cg, rl_seq, (jloss, jm, _, jtg, jcgg, jtap, jcg) = ranks["tp_rl"]
    assert ranks["tp_rl_ended"]  # some real captions end early
    state = steps.init_train_state(cfg, tap_from_jax(tap, cfg), captioner_from_jax(rl_cg, cfg))
    for o in _both(ranks, "tp_rl"):
        assert o["calls"] == {"replay": 1, "graph": 0}
        np.testing.assert_array_equal(o["gen_seq"], rl_seq)
        np.testing.assert_allclose(o["metrics"]["loss"], jloss, rtol=TT.REL)
        assert set(jm) <= set(o["metrics"])
        for k in jm:
            np.testing.assert_allclose(o["metrics"][k], jm[k], rtol=TT.REL, err_msg=k)
        TT._close_trees(TT._as_jax(state.tap, [torch.from_numpy(g) for g in o["tap_grads"]],
                                   tap_to_jax), jtg, TT.GATOL, TT.GRTOL)
        TT._close_trees(TT._as_jax(state.cg, [torch.from_numpy(g) for g in o["cg_grads"]],
                                   lambda mod: captioner_to_jax(mod, cfg)),
                        jcgg, TT.GATOL, TT.GRTOL)
        after = steps.init_train_state(cfg, tap_from_jax(tap, cfg),
                                       captioner_from_jax(rl_cg, cfg))
        with torch.no_grad():
            for p, v in zip([*after.tap.parameters(), *after.cg.parameters()], o["params"]):
                p.copy_(torch.from_numpy(v))
        lr = cfg.train.lr
        TT._close_trees(captioner_to_jax(after.cg, cfg), jcg, 4 * lr, 0)
        TT._close_trees(tap_to_jax(after.tap), jtap, 4 * lr, 0)


def test_ring_matches_jax(ranks):
    """parallel/sequence.py's ring over the pair, each rank on half of the
    128 frames, against echr_tpu's sequence_sharded_sst over two devices
    and its unsharded sst_forward, within atol 1e-5; under autograd and on
    frames that do not split it raises."""
    a, b = _both(ranks, "ring")
    (ring_h, ring_s), (one_h, one_s) = ranks["ring"]
    h = np.concatenate([a["h"], b["h"]])
    sc = np.concatenate([a["s"], b["s"]])
    for want_h, want_s in ((ring_h, ring_s), (one_h, one_s)):
        np.testing.assert_allclose(h, want_h, atol=1e-5, rtol=0)
        np.testing.assert_allclose(sc, want_s, atol=1e-5, rtol=0)
    for o in (a, b):
        assert o["grad"].startswith("RuntimeError") and "A.13" in o["grad"]
        assert o["odd"].startswith("ValueError") and "must divide" in o["odd"]


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
    """A mesh whose dp x tp is not the world size, a batch_size that the
    dp rows do not divide (SCST at batch_size 1 too) and m_batch > 1 under
    two ranks each raise, naming what to do; train() raises them on both
    ranks before any collective, and in one process for the mesh.  The
    mesh (1, 2) is accepted on two ranks, and trains."""
    cfg = _tiny(tmp_path)
    with pytest.raises(ValueError, match="launch 2 ranks"):
        mesh.check_layout(cfg.replace_in("runtime", mesh_shape=(1, 2)), 1)
    with pytest.raises(ValueError, match="launch 2 ranks"):
        mesh.check_layout(cfg.replace_in("runtime", mesh_shape=(2, 1)), 1)
    assert mesh.check_layout(cfg.replace_in("runtime", mesh_shape=(2, 1)), 2) == (2, 1)
    assert mesh.check_layout(cfg.replace_in("runtime", mesh_shape=(1, 2)), 2) == (1, 2)
    assert mesh.check_layout(cfg.replace_in("runtime", mesh_shape=(2, 2)), 4) == (2, 2)
    assert mesh.check_layout(cfg, 4) == (4, 1)
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
        assert a["mesh_tp"] is None  # (1, 2) on two ranks trains
    with pytest.raises(ValueError, match="launch 2 ranks"):
        T.train(cfg.replace_in("runtime", mesh_shape=(1, 2)), max_iterations=1, device="cpu")
    with pytest.raises(ValueError, match="multiple of 2"):
        T.check_data_parallel(cfg.replace_in("runtime", mesh_shape=(2, 2)).replace_in(
            "train", batch_size=3), 4)
    T.check_data_parallel(cfg.replace_in("runtime", mesh_shape=(1, 2)).replace_in(
        "train", batch_size=3), 2)  # the tp ranks of one row share its videos


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
