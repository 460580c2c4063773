"""Kernel 11 (ops/kernel_recurrence.py, the LSTM recurrence in one launch)
on the CPU: its plain version against the loop lstm_layer ran before it
and against echr_tpu's lax.scan, the routing of ops.recurrent.lstm_layer
(SCST's rollout and its replay on one recurrence among it), the launch
helper's checks, and the counter the benchmark reads.

The CUDA kernel itself runs only on the card: chip_smoke.py phase 35 holds
it against this plain version there.  Tolerances: the plain version and
the earlier loop run the same ops, so they are bit-equal; against JAX,
1e-5 at f32 and 2e-4 at bf16 (test_torch_ops.py's ATOL and ATOL_BF16).
"""
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import ATOL, ATOL_BF16, _cell_pair, close, one_torch_thread  # noqa: F401
from echr_tpu.ops import recurrent as jrec

from echr_tpu_torch.ops import core, recurrent
from echr_tpu_torch.ops.kernel_recurrence import (lstm_recurrence, lstm_recurrence_plain,
                                                  recurrence_on, smem_bytes)

DTYPES = {"float32": (torch.float32, ATOL), "bfloat16": (torch.bfloat16, ATOL_BF16)}


def earlier_lstm_layer(p, xs, h0=None, c0=None, dtype=torch.float32):
    """ops.recurrent.lstm_layer as it was before kernel 11: the loop inline."""
    T, B, _ = xs.shape
    H = p.hidden_dim
    h = torch.zeros(B, H) if h0 is None else h0
    c = torch.zeros(B, H) if c0 is None else c0
    pre_x = recurrent.lstm_input_proj(p, xs, dtype=dtype, with_bias=True)
    w_hh_t = p.weight_hh.t()
    hs = []
    for t in range(T):
        pre = pre_x[t] + core.matmul(core.round_to(h, dtype), w_hh_t, dtype)
        sig = torch.sigmoid(pre)
        i, f, o = sig[..., :H], sig[..., H:2 * H], sig[..., 3 * H:]
        g = torch.tanh(pre[..., 2 * H:3 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs), (h, c)


def _layer(seed, din, H, dtype):
    """A (JAX params, torch LSTMCell) pair, its matrices rounded to ``dtype``
    as cast_compute_dtype rounds the serving weights."""
    jp, cell = _cell_pair(np.random.RandomState(seed), din, H)
    if dtype == torch.bfloat16:
        cell = core.cast_compute_dtype(cell, "bfloat16")
        jp = dict(jp, w_ih=jnp.asarray(cell.weight_ih.detach().numpy().T),
                  w_hh=jnp.asarray(cell.weight_hh.detach().numpy().T))
    return jp, cell


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "h0_c0"])
@pytest.mark.parametrize("T,B,din,H", [(9, 1, 6, 8), (12, 5, 10, 16)])
def test_plain_matches_the_earlier_loop_and_jax(T, B, din, H, carry, dtype):
    dt, atol = DTYPES[dtype]
    jp, cell = _layer(T * B + H, din, H, dt)
    r = np.random.RandomState(B)
    xs = r.randn(T, B, din).astype(np.float32)
    h0 = r.randn(B, H).astype(np.float32) * 0.5 if carry else None
    c0 = r.randn(B, H).astype(np.float32) if carry else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        want, (want_h, want_c) = earlier_lstm_layer(cell, t(xs), t(h0), t(c0), dt)
        pre_x = recurrent.lstm_input_proj(cell, t(xs), dtype=dt, with_bias=True)
        got, (got_h, got_c) = lstm_recurrence_plain(pre_x, cell.weight_hh, t(h0), t(c0), dt)
        layer, (layer_h, layer_c) = recurrent.lstm_layer(cell, t(xs), t(h0), t(c0), dt)
        if dt == torch.bfloat16:  # the wrapper on the CPU: the plain version at bf16
            wrapped, (wrapped_h, wrapped_c) = lstm_recurrence(pre_x, cell.weight_hh, t(h0), t(c0))
            for a, b in ((wrapped, got), (wrapped_h, got_h), (wrapped_c, got_c)):
                assert torch.equal(a, b)
    for a, b in ((got, want), (got_h, want_h), (got_c, want_c), (layer, want),
                 (layer_h, want_h), (layer_c, want_c)):
        assert torch.equal(a, b)
    j = lambda a: None if a is None else jnp.asarray(a)
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    jhs, (jh, jc) = jrec.lstm_layer(jp, jnp.asarray(xs), j(h0), j(c0), compute_dtype=jdt)
    close(got, jhs, atol)
    close(got_h, jh, atol)
    close(got_c, jc, atol)


@pytest.mark.parametrize("grad,dtype,train,kernel", [
    (False, torch.bfloat16, False, True),   # serving, eval, SCST's greedy baseline
    (False, torch.bfloat16, True, False),   # SCST's sampled rollout (replayed under grad)
    (True, torch.bfloat16, False, False),   # under autograd
    (True, torch.bfloat16, True, False),    # training's forward
    (False, torch.float32, False, False),   # the f32 parity runs
    (True, torch.float32, False, False),
])
def test_takes_kernel_only_on_cuda_in_bf16_without_grad(grad, dtype, train, kernel):
    cuda_like = SimpleNamespace(device=torch.device("cuda"))
    with torch.set_grad_enabled(grad):
        assert recurrent.takes_kernel(cuda_like, dtype, train) is kernel
        assert not recurrent.takes_kernel(torch.zeros(1), dtype, train)
        if not train:
            assert recurrent.takes_kernel(cuda_like, dtype) is kernel  # eval mode by default


@pytest.mark.parametrize("batch_size", [1, 2])
def test_scst_rollout_and_its_replay_share_the_loop(tmp_path, monkeypatch, batch_size):
    """ROADMAP C.2 with kernel 11 in reach: train()'s first SCST step at
    bf16, with takes_kernel's device test met (a CUDA-like stand-in for xs)
    and the kernel a stand-in that moves hs and hT by 1e-3, as its other
    order of sums moves them by less.  The sampled rollout's train-mode
    encode runs without grad, its replay under autograd: both take the
    loop, so the replay's logps are the rollout's.  The eval-mode greedy
    baseline takes the kernel, once a layer."""
    from echr_tpu_torch.engine import rl
    from echr_tpu_torch.engine import train as ttrain
    from echr_tpu_torch.experiments import probe_scst_replay as probe
    from test_torch_train import _loop_cfg

    rule, launched = recurrent.takes_kernel, []
    cuda_like = SimpleNamespace(device=torch.device("cuda"))

    def moved(pre_x, w_hh, h0=None, c0=None):
        launched.append(tuple(pre_x.shape))
        hs, (h, c) = lstm_recurrence_plain(pre_x, w_hh, h0, c0)
        return hs + 1e-3, (h + 1e-3, c)

    monkeypatch.setattr(recurrent, "takes_kernel",
                        lambda xs, dtype, train=False: rule(cuda_like, dtype, train))
    monkeypatch.setattr(recurrent, "lstm_recurrence", moved)
    monkeypatch.setattr(ttrain, "default_reward_pool", lambda *_: rl.RewardPool(workers=1))
    cfg = _loop_cfg(tmp_path).replace_in("train", self_critical_after=0).replace_in(
        "runtime", compute_dtype="bfloat16")
    r = probe.train_pass("cpu", cfg, batch_size=batch_size)
    assert r["tokens_equal"] and r["logps_max_abs_d"] == 0.0
    assert [shape[1] for shape in launched] == [batch_size] * cfg.tap.rnn_num_layers


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_layers_take_the_loop_without_counting(grad, dtype):
    """On the CPU, with grad or without, in either dtype, lstm_layer and
    lstm_stack run the loop and kernel 11's counter does not move."""
    _, c0 = _cell_pair(np.random.RandomState(1), 6, 8)
    _, c1 = _cell_pair(np.random.RandomState(2), 8, 8)
    xs = torch.randn(7, 3, 6)
    n0 = lstm_recurrence.launches
    with torch.set_grad_enabled(grad):
        hs, _ = recurrent.lstm_stack([c0, c1], xs, dtype=dtype)
        want, _ = earlier_lstm_layer(c1, earlier_lstm_layer(c0, xs, dtype=dtype)[0], dtype=dtype)
    assert torch.equal(hs, want)
    assert hs.requires_grad is grad
    assert lstm_recurrence.launches == n0


def test_lstm_layer_routes_to_the_wrapper(monkeypatch):
    """Where takes_kernel holds, lstm_layer hands the wrapper the input
    projection and W_hh (and h0, c0), and returns what it returns."""
    _, cell = _cell_pair(np.random.RandomState(3), 6, 8)
    xs, h0, c0 = torch.randn(5, 2, 6), torch.randn(2, 8), torch.randn(2, 8)
    seen = []

    def spy(pre_x, w_hh, h, c):
        seen.append((pre_x, w_hh, h, c))
        return lstm_recurrence(pre_x, w_hh, h, c)

    monkeypatch.setattr(recurrent, "takes_kernel", lambda xs, dtype, train: True)
    monkeypatch.setattr(recurrent, "lstm_recurrence", spy)
    with torch.no_grad():
        got, _ = recurrent.lstm_layer(cell, xs, h0, c0, torch.bfloat16)
        want, _ = earlier_lstm_layer(cell, xs, h0, c0, torch.bfloat16)
        pre_x = recurrent.lstm_input_proj(cell, xs, dtype=torch.bfloat16, with_bias=True)
    (p, w, h, c), = seen
    assert torch.equal(p, pre_x) and w is cell.weight_hh and h is h0 and c is c0
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,match", [
    ((4, 2, 4 * 32), "is on cpu"),
    ((4, 2, 4 * 24), "not a multiple of 32"),
    ((0, 2, 4 * 32), "empty"),
    ((4, 2, 30), "expected \\[T, B, 4H\\]"),
])
def test_launch_helper_raises_before_the_library(shape, match):
    """recurrence_on takes CUDA tensors of the kernel's shapes only: it
    raises before it reaches the library, and the counter stays."""
    n0 = lstm_recurrence.launches
    H = shape[2] // 4
    with pytest.raises(ValueError, match=match):
        recurrence_on(None, torch.zeros(shape), torch.zeros(4 * H, H))
    assert lstm_recurrence.launches == n0


def test_shared_memory_fits_the_serving_batches():
    """A block's shared memory at H = 512: the greedy chunk's 128 videos and
    beyond fit the 227 KB a block may use; ~1,500 rows do not."""
    assert smem_bytes(128, 512) == 16 * 544 * 2 + 2 * 128 * 16 * 4 + 128 * 4 * 4 + 8 * 32 * 8 * 4
    assert smem_bytes(1024, 512) <= 232448 < smem_bytes(1500, 512)


def test_counter_is_found_by_the_benchmark(monkeypatch):
    """The benchmark's traced run reads every int counter of the port's
    functions (benchmark/harness.port_counters); kernel 11's is one."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    from benchmark.harness import port_counters

    found = {key: obj_attr for key, obj_attr in port_counters().items()
             if obj_attr == (lstm_recurrence, "launches")}
    assert list(found) == ["lstm_recurrence.launches"]
    assert type(lstm_recurrence.launches) is int
