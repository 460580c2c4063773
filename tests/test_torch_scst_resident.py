"""Resident-graph SCST (runtime.scst_resident_vjp) against the port's
replay path and echr_tpu's update, on the CPU.

The port's rollout under autograd (steps.rl_rollout_graph_step_batched)
draws the same tokens as its no-grad rollout from the same generators,
and its update (rl_graph_update_step_batched) backpropagates the reward
loss through the kept graph instead of replaying it.  Held, at tap_cg and
cg with dropout off, to the replay (steps._phase_grads over _rl_losses)
and to echr_tpu's update composed from its parts (test_torch_scst._jax_rl,
as tests/test_rl_vjp.py holds echr_tpu's resident path to its two
programs); with dropout on, to the replay from the rollout's generator
state; and train() takes the resident steps in one process.

Tolerances: tests/test_torch_train.py's: the loss and metrics within 1e-5
relative, gradient leaves within atol 2e-4, rtol 1e-3, parameters after
the Adam step within 4 * lr.
"""
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_scst import EOS_BIAS, PHASES, _eos_biased, _jax_rl, _state
from test_torch_train import GATOL, GRTOL, REL, _as_jax, _batch, _cfg, _close_trees, _loop_cfg
from test_torch_train import _params

from echr_tpu_torch.bridge import captioner_to_jax, tap_to_jax
from echr_tpu_torch.engine import rl, steps
from echr_tpu_torch.engine import train as ttrain


def _reward(B, N, L, seed):
    return np.broadcast_to(np.random.RandomState(seed).randn(B, N, 1), (B, N, L)).astype(
        np.float32)


def _resident(cfg, state, tb, phase, gen, seed, reward, monkeypatch):
    """The resident rollout and update: (gen_seq, greedy_seq, grads,
    metrics) with the update's gradients caught on their way to Adam."""
    caught = []
    apply = steps.apply_grads

    def catch(state_, tap_g, cg_g, *a):
        caught.append((tap_g, cg_g))
        return apply(state_, tap_g, cg_g, *a)

    monkeypatch.setattr(steps, "apply_grads", catch)
    kept, gen_seq, greedy_seq = steps.rl_rollout_graph_step_batched(
        state, tb, cfg, phase, gen, torch.Generator().manual_seed(seed))
    _, m = steps.rl_graph_update_step_batched(state, tb, cfg, phase, kept,
                                              torch.from_numpy(reward))
    monkeypatch.undo()
    return gen_seq, greedy_seq, caught[0], m


@pytest.fixture(scope="module")
def ref():
    cfg = _cfg()
    tap, cg = _params(cfg)
    cg = _eos_biased(cg, EOS_BIAS)
    return {"cfg": cfg, "tap": tap, "cg": cg, "batch": _batch(cfg)}


@pytest.mark.parametrize("phase", PHASES)
def test_resident_update_matches_the_replay_and_jax(ref, phase, monkeypatch):
    """The same tokens as the two-program rollout; the loss, metrics and
    every gradient leaf of the resident update against the replay's and
    echr_tpu's; the parameters after its Adam step against echr_tpu's."""
    cfg, i = ref["cfg"], PHASES.index(phase)
    tb = steps.batch_to_device(ref["batch"], "cpu")
    state = _state(cfg, ref["tap"], ref["cg"])
    _, want_seq, want_greedy = steps.rl_rollout_step_batched(
        state, tb, cfg, phase, None, torch.Generator().manual_seed(7 + i))
    B, N, L = want_seq.shape
    reward = _reward(B, N, L, 5 + i)
    gen_seq, greedy_seq, (tg, cgg), m = _resident(cfg, state, tb, phase, None, 7 + i, reward,
                                                  monkeypatch)
    assert torch.equal(gen_seq, want_seq) and torch.equal(greedy_seq, want_greedy)
    assert state.step == 1
    fresh = _state(cfg, ref["tap"], ref["cg"])
    (rtg, rcgg), rm = steps._phase_grads(fresh, cfg, phase, steps._rl_losses, tb, phase, None,
                                         gen_seq, torch.from_numpy(reward))
    jloss, jm, _, jtg, jcgg, jtap, jcg = _jax_rl(cfg, ref["tap"], ref["cg"], ref["batch"], phase,
                                                 gen_seq.numpy(), reward)
    assert set(m) == set(rm)
    np.testing.assert_allclose(m["loss"], jloss, rtol=REL)
    for k in rm:
        np.testing.assert_allclose(m[k], rm[k], rtol=REL, err_msg=k)
        if k in jm:
            np.testing.assert_allclose(m[k], jm[k], rtol=REL, err_msg=k)
    for got, replay, want, mod, export in ((tg, rtg, jtg, fresh.tap, tap_to_jax),
                                           (cgg, rcgg, jcgg, fresh.cg,
                                            lambda x: captioner_to_jax(x, cfg))):
        for a, b in zip(got, replay):
            torch.testing.assert_close(a, b, atol=GATOL, rtol=GRTOL)
        _close_trees(_as_jax(mod, got, export), want, GATOL, GRTOL)
    lr = cfg.train.lr
    _close_trees(captioner_to_jax(state.cg, cfg), jcg, 4 * lr, 0)
    _close_trees(tap_to_jax(state.tap), jtap, 4 * lr, 0)


def test_resident_update_with_dropout_is_the_replays(ref, monkeypatch):
    """Dropout on: the resident update's gradients against the replay of
    its tokens from the rollout's dropout generator state."""
    cfg = ref["cfg"]
    tb = steps.batch_to_device(ref["batch"], "cpu")
    state = _state(cfg, ref["tap"], ref["cg"])
    gen = torch.Generator().manual_seed(11)
    start = gen.get_state()
    B, N = ref["batch"].prop_mask.shape
    reward = _reward(B, N, cfg.decoder.CG_seq_length, 9)
    gen_seq, _, (tg, cgg), m = _resident(cfg, state, tb, "tap_cg", gen, 13, reward, monkeypatch)
    gen.set_state(start)
    fresh = _state(cfg, ref["tap"], ref["cg"])
    (rtg, rcgg), rm = steps._phase_grads(fresh, cfg, "tap_cg", steps._rl_losses, tb, "tap_cg",
                                         gen, gen_seq, torch.from_numpy(reward))
    for k in rm:
        np.testing.assert_allclose(m[k], rm[k], rtol=REL, err_msg=k)
    for a, b in zip(tg + cgg, rtg + rcgg):
        torch.testing.assert_close(a, b, atol=GATOL, rtol=GRTOL)


def test_train_takes_the_resident_steps(tmp_path, monkeypatch):
    """train() with scst_resident_vjp in one process: every SCST step is the
    resident one, none replays, and the loop's steps run."""
    monkeypatch.setattr(ttrain, "default_reward_pool", lambda *_: rl.RewardPool(workers=1))
    calls = {"graph": 0, "replay": 0}
    for name, key in (("rl_graph_update_step_batched", "graph"),
                      ("rl_update_step_batched", "replay")):
        fn = getattr(ttrain, name)

        def counted(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ttrain, name, counted)
    cfg = _loop_cfg(tmp_path).replace_in("train", self_critical_after=0).replace_in(
        "runtime", scst_resident_vjp=True)
    out = ttrain.train(cfg, max_iterations=2, device="cpu")
    assert out["iteration"] == 2 and calls == {"graph": 2, "replay": 0}
    assert np.isfinite(out["losses"]["loss"]) and "avg_reward" in out["losses"]
