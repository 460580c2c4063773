"""The port's pipelined train loop (engine/train.py _TrainPrep,
_loop_pipelined), transfer compression and utils/profiling on the CPU,
held against the port's synchronous loop and against echr_tpu
(tests/test_train_pipeline.py's checks of echr_tpu, on the port).

The trajectory of the pipelined loop is bitwise the synchronous loop's,
dropout on from the same generator; its bookkeeping (iterations, epochs,
the learning rate at each log line, the bad videos, the saved loader
state) is echr_tpu's exactly; the compressed bits are echr_tpu's; and a
bf16-transfer step at f32 compute is echr_tpu's within the training gate
(gradient leaves atol 2e-4, rtol 1e-3; losses 1e-5 relative).
"""
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import (GATOL, GRTOL, REL, _as_jax, _batch, _cfg, _close_trees,
                              _params, _state)
from test_train_e2e import tiny_cfg

from echr_tpu.engine import steps as jsteps
from echr_tpu.engine import train as jtrain

from echr_tpu_torch import config
from echr_tpu_torch.bridge import captioner_to_jax, tap_to_jax
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import checkpoint, steps
from echr_tpu_torch.engine import train as T
from echr_tpu_torch.ops import core
from echr_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
PRODUCER_THREADS = ("train-prep", "train-put")


def _jax_cfg(tmp_path, pipelined: bool, run_id: str, **over):
    """tests/test_train_pipeline.py's config: 8 synthetic videos in groups
    of 4, so the 8-epoch curriculum wraps often (bad videos and dropped
    partial groups among them), and a step-decay learning rate."""
    cfg = tiny_cfg(tmp_path, **{"train.batch_size": 4, **over})
    cfg = cfg.replace_in("train", cg_epochs=8, learning_rate_decay_start=1,
                         learning_rate_decay_every=2, learning_rate_decay_rate=0.5)
    cfg = cfg.replace_in("runtime", train_pipeline=pipelined, train_inflight=3)
    return cfg.replace(run_id=run_id)


def _pipeline_cfg(tmp_path, pipelined: bool, run_id: str, **over):
    return config.Config.from_json(_jax_cfg(tmp_path, pipelined, run_id, **over).to_json())


def _train(cfg, **kw):
    return T.train(cfg, device="cpu", **kw)


def _assert_same_params(a, b):
    for m_a, m_b in ((a.tap, b.tap), (a.cg, b.cg)):
        for (name, p), q in zip(m_a.named_parameters(), m_b.parameters()):
            assert torch.equal(p, q), name


def _log_lines(folder):
    """(iteration, epoch, lr, phase, bad_vid) of each log line of train.log."""
    text = (Path(folder) / "train.log").read_text()
    return [(int(i), int(e), lr, ph, int(b)) for i, e, lr, ph, b in re.findall(
        r"iter (\d+) \(epoch (\d+), lr (\S+), phase (\w+)\) .*? bad_vid=(\d+)", text)]


def test_pipelined_matches_sync_trajectory(tmp_path):
    """Same seed, same iterations, dropout on: the pipelined loop's
    parameters are bitwise the synchronous loop's, with the same losses and
    epochs; the curriculum runs out (10 updates) before max_iterations."""
    outs, timing = {}, {}
    for name, flag in (("sync", False), ("pipe", True)):
        timing[name] = {}
        outs[name] = _train(_pipeline_cfg(tmp_path / name, flag, name), max_iterations=12,
                            timing_out=timing[name])
    s, p = outs["sync"], outs["pipe"]
    assert timing["pipe"]["pipelined"] and not timing["sync"]["pipelined"]
    assert p["iteration"] == s["iteration"] == 10
    assert p["epoch"] == s["epoch"] == 8
    assert p["losses"] == s["losses"]
    _assert_same_params(s["state"], p["state"])
    assert timing["pipe"]["put_bytes"] == timing["sync"]["put_bytes"] > 0
    for key in ("loader", "compress", "collate", "put", "step", "fetch"):
        assert key in timing["pipe"], key


def test_pipelined_loss_histories_match_sync(tmp_path):
    """histories['loss'] at the log boundaries, summed through the deferred
    fetches, equal the synchronous loop's per-step sums."""
    hist = {}
    for name, flag in (("sync", False), ("pipe", True)):
        cfg = _pipeline_cfg(tmp_path / name, flag, name).replace_in("save", losses_log_every=4)
        out = _train(cfg, max_iterations=8)
        hist[name] = checkpoint.load_checkpoint(
            os.path.join(out["save_folder"], "model-last.ckpt"), "cpu",
            rebuild_state=False)["histories"]["loss"]
    assert hist["pipe"] == hist["sync"]
    assert set(hist["pipe"]) == {4, 8}


def test_pipelined_checkpoint_rewinds_producer_runahead(tmp_path):
    """Checkpoints store the consumed loader cursor, not the producer's run
    ahead: stopped at 4 and resumed to 8, the pipelined run ends bitwise
    where the synchronous run stopped and resumed alike does."""
    finals = {}
    for name, flag in (("sync", False), ("pipe", True)):
        cfg = _pipeline_cfg(tmp_path / name, flag, name)
        assert _train(cfg, max_iterations=4)["iteration"] == 4
        out = _train(cfg.replace_in("save", start_from=name), max_iterations=8)
        assert out["iteration"] == 8
        finals[name] = out["state"]
    _assert_same_params(finals["sync"], finals["pipe"])


def test_pipelined_sigterm_preempts_cleanly(tmp_path):
    """SIGTERM mid-run: the pipelined loop stops at an iteration boundary,
    joins its threads, rewinds the loader, writes a resumable
    model-last.ckpt and exits 0; the checkpoint resumes, pipelined again.
    The child blocks TensorFlow (see test_torch_checkpoint's SIGTERM
    test)."""
    cfg = _pipeline_cfg(tmp_path, True, "PREP")
    cfg = cfg.replace_in("train", cg_epochs=10**6).replace_in("save", losses_log_every=1)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    script = (
        "import sys; sys.modules['tensorflow'] = None;"
        "import logging, threading;"
        "logging.basicConfig(level=logging.INFO);"
        "from echr_tpu_torch.config import Config;"
        "from echr_tpu_torch.engine.train import train;"
        f"out = train(Config.from_json(open({str(cfg_path)!r}).read()), device='cpu');"
        "left = [t.name for t in threading.enumerate() if t.name in ('train-prep', 'train-put')];"
        "print('PREEMPT_EXIT', out['iteration'], left, flush=True)")
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
    it0 = int(re.search(r"PREEMPT_EXIT (\d+) \[\]", text).group(1))
    payload = checkpoint.load_checkpoint(str(tmp_path / "PREP" / "model-last.ckpt"), "cpu")
    assert payload["iteration"] == it0 >= 1
    out = _train(cfg.replace_in("save", start_from="PREP"), max_iterations=it0 + 2)
    assert out["iteration"] == it0 + 2


def test_pipelined_preempt_before_first_item_keeps_pristine_cursor(tmp_path, monkeypatch):
    """A preemption while the producer still stages the first group
    checkpoints the loader cursor from before the producer started: the
    producer pulls from its constructor, so a later snapshot could hold
    pulled but never trained videos."""
    cfg = _pipeline_cfg(tmp_path, True, "ZERO")
    monkeypatch.setattr(T, "_install_preemption_handler", lambda: {"hit": True})
    monkeypatch.setattr(T, "_restore_preemption_handler", lambda box: None)
    pulled = threading.Event()
    orig_compress, orig_get = T._compress_batch, Loader.get_batch

    def slow_compress(batch, cfg_):
        pulled.set()
        time.sleep(2.0)  # hold the producer past the consumer's exit
        return orig_compress(batch, cfg_)

    def get_and_signal(self, *a, **k):
        out = orig_get(self, *a, **k)
        pulled.set()
        return out

    monkeypatch.setattr(T, "_compress_batch", slow_compress)
    monkeypatch.setattr(Loader, "get_batch", get_and_signal)
    out = _train(cfg)
    assert pulled.wait(timeout=20), "the producer never pulled a batch"
    assert out["iteration"] == 0
    st = checkpoint.load_checkpoint(os.path.join(out["save_folder"], "model-last.ckpt"), "cpu",
                                    rebuild_state=False)["loader_state"]
    assert st["iterators"].get("train", 0) == 0, "the checkpoint holds the producer's run-ahead"
    assert st["epochs"].get("train", 0) == 0


def _producer_threads():
    return [t for t in threading.enumerate() if t.name in PRODUCER_THREADS]


def test_pipelined_prep_failure_propagates(tmp_path, monkeypatch):
    """A failure in the producer is raised on the main thread, and no
    producer thread is left."""
    cfg = _pipeline_cfg(tmp_path, True, "FAIL")
    calls = {"n": 0}
    orig = T._compress_batch

    def boom(batch, cfg_):
        calls["n"] += 1
        if calls["n"] > 5:
            raise RuntimeError("synthetic prep failure")
        return orig(batch, cfg_)

    monkeypatch.setattr(T, "_compress_batch", boom)
    with pytest.raises(RuntimeError, match="synthetic prep failure"):
        _train(cfg, max_iterations=50)
    deadline = time.time() + 15
    while _producer_threads() and time.time() < deadline:
        time.sleep(0.2)
    assert not _producer_threads()


def test_pipelined_bookkeeping_matches_jax(tmp_path):
    """echr_tpu's pipelined run and the port's on one config: the same
    iteration and epoch, the same log lines (iteration, epoch, learning
    rate, phase, bad videos), learning-rate history and saved loader
    state, exactly."""
    runs = {}
    jcfg = _jax_cfg(tmp_path / "jax", True, "J").replace_in("save", losses_log_every=2)
    jout = jtrain.train(jcfg, max_iterations=12)
    out = _train(config.Config.from_json(
        _jax_cfg(tmp_path / "port", True, "P").replace_in("save", losses_log_every=2).to_json()),
        max_iterations=12)
    for name, o, load in (("jax", jout, lambda p: jtrain.ckpt.load_checkpoint(p)),
                          ("port", out, lambda p: checkpoint.load_checkpoint(
                              p, "cpu", rebuild_state=False))):
        payload = load(os.path.join(o["save_folder"], "model-last.ckpt"))
        runs[name] = (o["iteration"], o["epoch"], payload["histories"]["lr"],
                      payload["loader_state"], _log_lines(o["save_folder"]))
    assert runs["port"][:2] == runs["jax"][:2] == (10, 8)
    assert runs["port"][2] == runs["jax"][2] and len(runs["port"][2]) == 5
    assert runs["port"][3] == runs["jax"][3]
    assert runs["port"][4] == runs["jax"][4]
    assert sum(line[4] for line in runs["port"][4]) > 0  # bad videos were skipped


def test_compress_batch_bits_match_jax():
    """_compress_batch's bf16 features (bits viewed as 16-bit integers,
    values at rounding ties included) and uint8 grids equal echr_tpu's; a
    float32 transfer_dtype returns the batch as it is."""
    cfg = _cfg()
    batch = _batch(cfg)
    r = np.random.RandomState(0)
    feats = r.standard_normal(batch.feats.shape).astype(np.float32)
    # exact halfway points between bf16 neighbours, below even and odd ones
    # and on both signs: round to nearest even
    flat = feats.reshape(-1)
    ties = np.uint32(0x3F800000) + (np.arange(64, dtype=np.uint32) << 16) | np.uint32(0x8000)
    flat[:64] = ties.view(np.float32)
    flat[64:128] = -ties.view(np.float32)
    batch = batch._replace(feats=feats)
    on = cfg.replace_in("runtime", transfer_dtype="bfloat16")
    got, want = T._compress_batch(batch, on), jtrain._compress_batch(batch, on)
    assert got.feats.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.feats.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(want.feats).view(np.uint16))
    for f in T._BINARY_FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype == np.uint8, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert T._BINARY_FIELDS == jtrain._BINARY_FIELDS
    assert T._compress_batch(batch, cfg) is batch
    lifted = steps.batch_to_device(got, "cpu")
    np.testing.assert_array_equal(lifted.feats.numpy(),
                                  np.asarray(jsteps.decompress_batch(want).feats))
    assert all(x.dtype in (torch.float32, torch.int64) for x in lifted)


def test_bf16_transfer_step_matches_jax():
    """A compressed batch at f32 compute: the port's loss, metrics and
    gradients against echr_tpu's step on its decompressed batch, dropout
    off, within the training gate.  echr_tpu runs its plain attention (the
    Pallas training kernels' reference), which its tests hold to the
    kernels."""
    cfg = _cfg().replace_in("runtime", transfer_dtype="bfloat16", compute_dtype="float32",
                            use_pallas_train=False)
    tap, cg = _params(cfg)
    host = _batch(cfg)
    jb = jsteps.decompress_batch(jax.tree.map(jnp.asarray, jtrain._compress_batch(host, cfg)))

    def loss_fn(tp, cp):
        m = jax.vmap(lambda b: jsteps._one_video_losses(tp, cp, cfg, b, "tap_cg", None, True,
                                                        0.0))(jb)
        m = jax.tree.map(jnp.mean, m)
        return jsteps._phase_loss(m, "tap_cg", cfg), m

    (jloss, jm), (jtg, jcg) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1),
                                                         has_aux=True))(tap, cg)
    state = _state({"cfg": cfg, "tap": tap, "cg": cg})
    (tg, cgg), m = steps.grad_step(state, steps.batch_to_device(
        T._compress_batch(host, cfg), "cpu"), None, cfg, "tap_cg")
    (m,) = steps.fetch_metrics(m)
    np.testing.assert_allclose(m["loss"], float(jloss), rtol=REL)
    for k in jm:
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=REL, err_msg=k)
    _close_trees(_as_jax(state.tap, tg, tap_to_jax), jtg, GATOL, GRTOL)
    _close_trees(_as_jax(state.cg, cgg, lambda mod: captioner_to_jax(mod, cfg)), jcg, GATOL,
                 GRTOL)


def test_producer_runs_no_product(tmp_path, monkeypatch):
    """ops.core.matmul is never entered from a producer thread (TF32 is
    process-wide: a product there would change the main thread's f32
    products), while the steps on the main thread do enter it."""
    callers = []
    orig = core.matmul

    def spy(*a, **k):
        callers.append(threading.current_thread().name)
        return orig(*a, **k)

    for mod in [m for name, m in sys.modules.items()
                if name.startswith("echr_tpu_torch") and getattr(m, "matmul", None) is orig]:
        monkeypatch.setattr(mod, "matmul", spy)
    cfg = _pipeline_cfg(tmp_path, True, "TF32", **{"runtime.transfer_dtype": "bfloat16"})
    timing = {}
    out = _train(cfg, max_iterations=3, timing_out=timing)
    assert out["iteration"] == 3 and timing["pipelined"]
    assert callers and set(callers) == {threading.main_thread().name}, set(callers)


def test_profiling_matches_jax_keys(tmp_path):
    """utils.profiling: time_fn returns echr_tpu's keys, StepTimer counts,
    and device_trace writes a Chrome trace whose timeline reads (on the
    CPU: no device events, so no busy time)."""
    from echr_tpu.utils import profiling as jprof

    x = torch.ones(64, 64)
    got = profiling.time_fn(torch.matmul, x, x, iters=3, warmup=1)
    want = jprof.time_fn(lambda a: a @ a, jnp.ones((4, 4)), iters=3, warmup=1)
    assert set(got) == set(want) and got["iters"] == 3 and got["min_s"] <= got["mean_s"]
    timer = profiling.StepTimer()
    timer.tick()
    timer.tick()
    assert timer.n == 2 and timer.rate() >= 0.0
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.matmul(x, x)
    tl = profiling.device_timeline(str(tmp_path / "trace" / profiling.TRACE_FILE))
    assert tl["window_ms"] > 0 and tl["kernels"] == 0 and tl["busy_share"] == 0.0
    assert tl["h2d_overlap_share"] is None


def test_watchdog_beats_while_the_producer_works(tmp_path, monkeypatch):
    """Waiting on a slow but live producer beats the hang watchdog (more
    beats than iterations); the producer's progress is what feeds it."""
    beats = []

    class Counting(T.HangWatchdog):
        def beat(self):
            beats.append(1)
            super().beat()

    orig = T._compress_batch

    def slow(batch, cfg_):
        time.sleep(0.3)
        return orig(batch, cfg_)

    monkeypatch.setattr(T, "HangWatchdog", Counting)
    monkeypatch.setattr(T, "_compress_batch", slow)
    out = _train(_pipeline_cfg(tmp_path, True, "WD"), max_iterations=2)
    assert out["iteration"] == 2 and len(beats) > 2 * out["iteration"]
