"""The port's XE training slice against the JAX package, on the CPU.

The same numpy-seeded weights and batches go through echr_tpu and
echr_tpu_torch.  JAX's dropout cannot be replayed in torch, so parity runs
train=True with rng=None on the JAX side and gen=None on the port's: the
training routes (the differentiable score kernels, in interpret mode on
the JAX side; remat; fused inputs; the fused loss head) with dropout off.
The JAX step is composed here from its parts (steps._one_video_losses under
vmap, make_optimizer), once per module.

Tolerances: losses within 1e-5 relative and gradient leaves within atol
2e-4, rtol 1e-3 (f32 sums in another order, through a 7-step recurrence
and a 128-step LSTM); parameters after two Adam steps within 4 * lr (an
early Adam step is about lr * sign(g), so a gradient at noise level may
step either way); a bf16 loss within 2e-3 relative (bf16 rounds at other
places in the two frameworks).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_ops import small_cfg, to_np

from echr_tpu import losses as jlosses
from echr_tpu.data.batcher import make_batch
from echr_tpu.data.dataset import SyntheticDataset
from echr_tpu.engine import steps as jsteps
from echr_tpu.engine import train as jtrain
from echr_tpu.models.registry import init_captioner as jax_init_captioner
from echr_tpu.models.registry import init_tap as jax_init_tap

from echr_tpu_torch import losses
from echr_tpu_torch.bridge import captioner_from_jax, captioner_to_jax, tap_from_jax, tap_to_jax
from echr_tpu_torch.engine import checkpoint, steps
from echr_tpu_torch.engine import train as ttrain
from echr_tpu_torch.ops.core import dropout

REL = 1e-5
GATOL, GRTOL = 2e-4, 1e-3
BF16_REL = 2e-3


def _cfg(**over):
    """small_cfg with 8 sampled proposals, vocab 50 and 7 teacher-forced
    steps; N % 8, T = 128 and Hatt = 128 keep JAX on its Pallas kernels."""
    base = {"tap.prop_sample_num": 8, "data.synthetic": True,
            "data.synthetic_vocab_size": 50, "data.synthetic_seq_length": 8}
    base.update(over)
    return small_cfg(**base)


def _batch(cfg):
    """Two videos of 99 and 68 frames in the 128 bucket, with 6 and 2 GT
    events, and captions of different lengths; video 1 keeps 5 of its 8
    sampled proposals, so the rest are padding."""
    ds = SyntheticDataset(cfg, num_videos=8, seed=3)
    vids = [make_batch(ds.get_example(i), cfg, np.random.RandomState(i), w1=ds.w1)[0]
            for i in range(2)]
    pm = vids[1].prop_mask.copy()
    pm[5:] = 0.0
    vids[1] = vids[1]._replace(prop_mask=pm, cg_masks=vids[1].cg_masks * pm[:, None],
                               cg_labels=vids[1].cg_labels * pm[:, None].astype(np.int32))
    batch = ttrain._collate(vids)
    assert list(batch.n_frames) == [99.0, 68.0] and list(batch.gts_mask.sum(1)) == [6.0, 2.0]
    return batch


def _params(cfg, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return to_np(jax_init_tap(k1, cfg)), to_np(jax_init_captioner(k2, cfg))


def _jax_run(cfg, tap, cg, batch, phase, n_steps):
    """The reference step composed from its parts: (loss, metrics, grads) of
    each step and the parameters after n_steps updates."""
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(tp, cp):
        tc, cc = jsteps._cast(tp, cfg), jsteps._cast(cp, cfg)
        m = jax.vmap(lambda b: jsteps._one_video_losses(tc, cc, cfg, b, phase, None, True,
                                                        0.0))(jb)
        m = jax.tree.map(jnp.mean, m)
        return jsteps._phase_loss(m, phase, cfg), m

    opt = jsteps.make_optimizer(cfg)
    tap_opt, cg_opt = opt.init(tap), opt.init(cg)
    if n_steps == 0:
        return jax.jit(loss_fn)(tap, cg)[0], None, None
    vg = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    out = []
    for _ in range(n_steps):
        (loss, m), (tg, cgg) = vg(tap, cg)
        out.append((float(loss), {k: float(v) for k, v in m.items()}, to_np(tg), to_np(cgg)))
        if phase in jsteps.UPDATES_TAP:
            upd, tap_opt = opt.update(tg, tap_opt, tap)
            tap = optax.apply_updates(tap, upd)
        if phase in jsteps.UPDATES_CG:
            upd, cg_opt = opt.update(cgg, cg_opt, cg)
            cg = optax.apply_updates(cg, upd)
    return out, to_np(tap), to_np(cg)


@pytest.fixture(scope="module")
def ref():
    cfg = _cfg()
    tap, cg = _params(cfg)
    batch = _batch(cfg)
    runs = {phase: _jax_run(cfg, tap, cg, batch, phase, 2) for phase in ("tap_cg", "cg")}
    bf16 = _jax_run(cfg.replace_in("runtime", compute_dtype="bfloat16"), tap, cg, batch,
                    "tap_cg", 0)[0]
    return {"cfg": cfg, "tap": tap, "cg": cg, "batch": batch, "runs": runs,
            "bf16_loss": float(bf16)}


def _state(ref_, cfg=None):
    cfg = cfg or ref_["cfg"]
    return steps.init_train_state(cfg, tap_from_jax(ref_["tap"], cfg),
                                  captioner_from_jax(ref_["cg"], cfg))


def _as_jax(module, grads, export):
    clone = copy.deepcopy(module)
    with torch.no_grad():
        for p, g in zip(clone.parameters(), grads):
            p.copy_(g)
    return export(clone)


def _close_trees(got, want, atol, rtol):
    flat_w, tree_w = jax.tree_util.tree_flatten_with_path(want)
    flat_g, tree_g = jax.tree_util.tree_flatten(got)[0], jax.tree_util.tree_structure(got)
    assert tree_g == tree_w
    for (path, w), g in zip(flat_w, flat_g):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


def _port_grads_as_jax(ref_, state, cfg, phase):
    batch = steps.batch_to_device(ref_["batch"], "cpu")
    (tg, cgg), metrics = steps.grad_step(state, batch, None, cfg, phase)
    return (_as_jax(state.tap, tg, tap_to_jax),
            _as_jax(state.cg, cgg, lambda m: captioner_to_jax(m, cfg)), metrics)


# --------------------------------------------------------------------- losses


def _tap_inputs(seed, T=6, K=5):
    r = np.random.RandomState(seed)
    scores = r.uniform(0.05, 0.95, (T, K)).astype(np.float32)
    labels = (r.rand(T, K) > 0.5).astype(np.float32)
    masks = np.ones((T, K), np.float32)
    masks[-1] = 0.0
    w1 = r.uniform(0.1, 0.3, K).astype(np.float32)
    return scores, masks, labels, w1, np.float32(T - 1)


def _port_tap_loss(scores, masks, labels, w1, n):
    s = torch.from_numpy(scores).requires_grad_()
    got = losses.tap_loss(s, *(torch.from_numpy(x) for x in (masks, labels, w1)),
                          torch.tensor(n))
    got.backward()
    return float(got.detach()), s.grad.numpy()


def test_tap_loss_matches_jax():
    scores, masks, labels, w1, n = _tap_inputs(0)
    got, grad = _port_tap_loss(scores, masks, labels, w1, n)
    want, jg = jax.value_and_grad(jlosses.tap_loss)(jnp.asarray(scores), masks, labels, w1, n)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    np.testing.assert_allclose(grad, np.asarray(jg), atol=1e-6, rtol=1e-5)


def test_tap_loss_saturated_hits_clamp_without_nan():
    """Scores of exactly 0 for positives and 1 for negatives: each such term
    is the BCE clamp, weight * 100, and the gradient has no NaN.  (The JAX
    package gives inf here on the CPU: its 1e-38 floor is an f32 subnormal,
    which XLA's CPU backend flushes to zero, so the clamp never fires.)"""
    scores, masks, labels, w1, n = _tap_inputs(0)
    scores[0, :] = labels[0, :] == 0
    got, grad = _port_tap_loss(scores, masks, labels, w1, n)
    weights = labels * (1 - w1) + (1 - labels) * w1
    bce = -(labels * np.log(np.maximum(scores, 1e-30))
            + (1 - labels) * np.log(np.maximum(1 - scores, 1e-30)))
    bce[0, :] = 100.0
    np.testing.assert_allclose(got, float((weights * bce * masks).sum() / n), rtol=1e-5)
    assert np.isfinite(grad).all()


def test_language_reward_loss_and_clip_match_jax():
    r = np.random.RandomState(1)
    B, N, L, V1 = 2, 4, 6, 11
    logprobs = np.log(r.dirichlet(np.ones(V1), size=(B, N, L))).astype(np.float32)
    targets = r.randint(0, V1, size=(B, N, L + 2)).astype(np.int32)
    masks = (r.rand(B, N, L + 2) > 0.3).astype(np.float32)
    got = losses.language_model_loss(*(torch.from_numpy(x) for x in (logprobs, targets, masks)))
    seq = r.randint(0, 5, size=(B, N, L)).astype(np.int32)
    reward = r.randn(B, N, L).astype(np.float32)
    pm = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32)
    got_r = losses.reward_loss(*(torch.from_numpy(x) for x in (logprobs[..., 0], seq, reward,
                                                                pm)))
    for b in range(B):
        want = jlosses.language_model_loss(logprobs[b], targets[b], masks[b])
        np.testing.assert_allclose(float(got[b]), float(want), rtol=1e-6)
        want_r = jlosses.reward_loss(logprobs[b, ..., 0], seq[b], reward[b], pm[b])
        np.testing.assert_allclose(float(got_r[b]), float(want_r), rtol=1e-6)
    g = [torch.from_numpy(r.randn(3, 4).astype(np.float32) * 200), None]
    want_c = jlosses.clip_grads_elementwise([np.asarray(g[0])], 100.0)[0]
    losses.clip_grads_elementwise(g, 100.0)
    np.testing.assert_array_equal(g[0].numpy(), np.asarray(want_c))


# -------------------------------------------------------------------- dropout


def test_dropout_keep_rate_scale_and_seed():
    x = torch.ones(200_000)
    y = dropout(x, 0.3, torch.Generator().manual_seed(0), True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(y, dropout(x, 0.3, torch.Generator().manual_seed(0), True))
    assert dropout(x, 0.3, None, True) is x and dropout(x, 0.3, torch.Generator(), False) is x


def test_dropout_seeded_step_is_reproducible_and_none_is_eval(ref):
    """The same generator seed gives an identical step; gen=None at train
    time equals eval mode."""
    cfg, batch = ref["cfg"], steps.batch_to_device(ref["batch"], "cpu")
    runs = []
    for _ in range(2):
        st = _state(ref)
        st, m = steps.train_step(st, batch, torch.Generator().manual_seed(5), cfg, "tap_cg")
        runs.append((m, list(st.cg.parameters()) + list(st.tap.parameters())))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    st = _state(ref)
    with torch.no_grad():
        drop = steps._one_video_losses(st.tap, st.cg, cfg, batch, "tap_cg",
                                       torch.Generator().manual_seed(5), True, 0.0)
        off = steps._one_video_losses(st.tap, st.cg, cfg, batch, "tap_cg", None, True, 0.0)
        ev = steps._one_video_losses(st.tap, st.cg, cfg, batch, "tap_cg", None, False, 0.0)
    assert not torch.equal(drop["cg_loss"], off["cg_loss"])
    for k in off:
        np.testing.assert_allclose(off[k].numpy(), ev[k].numpy(), atol=1e-6, rtol=1e-6)


def test_scheduled_sampling_draws_from_the_generator(ref):
    """ss_prob > 0 takes the un-fused forward and replaces input tokens with
    draws from the generator: reproducible for a seed, different from
    ss_prob = 0, and off without a generator (as JAX's is without an rng)."""
    cfg, batch = ref["cfg"], steps.batch_to_device(ref["batch"], "cpu")
    st = _state(ref)

    def cg_loss(gen, ss_prob):
        with torch.no_grad():
            return steps._one_video_losses(st.tap, st.cg, cfg, batch, "tap_cg", gen, True,
                                           ss_prob)["cg_loss"]

    seeded = [cg_loss(torch.Generator().manual_seed(9), 1.0) for _ in range(2)]
    assert torch.equal(seeded[0], seeded[1]) and torch.isfinite(seeded[0]).all()
    assert not torch.equal(seeded[0], cg_loss(torch.Generator().manual_seed(9), 0.0))
    np.testing.assert_allclose(cg_loss(None, 1.0).numpy(), cg_loss(None, 0.0).numpy(),
                               rtol=1e-6)


# -------------------------------------------------------------------- decoder


def test_fused_head_equals_decoder_forward_and_jax(ref):
    """teacher_forced_nll (the fused head) equals
    language_model_loss(decoder_forward(...)) in value and in every gradient
    leaf, and both match JAX's caption loss and its gradients (the 'cg'
    phase: GT proposals, loss = the caption NLL)."""
    _, want_m, _, want_cg = ref["runs"]["cg"][0][0]
    out = {}
    for fused in (True, False):
        cfg = ref["cfg"].replace_in("runtime", fused_loss_head=fused)
        _, cg_g, m = _port_grads_as_jax(ref, _state(ref, cfg), cfg, "cg")
        out[fused] = (m, cg_g)
        np.testing.assert_allclose(m["cg_loss"], want_m["cg_loss"], rtol=REL)
        _close_trees(cg_g, want_cg, GATOL, GRTOL)
    np.testing.assert_allclose(out[True][0]["cg_loss"], out[False][0]["cg_loss"], rtol=1e-6)
    _close_trees(out[True][1], out[False][1], 1e-6, 1e-5)


# ----------------------------------------------------------------------- step


@pytest.mark.parametrize("phase", ["tap_cg", "cg"])
def test_train_step_matches_jax(ref, phase):
    cfg = ref["cfg"]
    jruns, jtap, jcg = ref["runs"][phase]
    state = _state(ref)
    tap0 = [p.detach().clone() for p in state.tap.parameters()]
    for i, (jloss, jm, jtg, jcgg) in enumerate(jruns):
        tg, cgg, m = _port_grads_as_jax(ref, state, cfg, phase)
        np.testing.assert_allclose(m["loss"], jloss, rtol=REL)
        for k in jm:
            np.testing.assert_allclose(m[k], jm[k], rtol=REL, err_msg=k)
        _close_trees(tg, jtg, GATOL, GRTOL)
        _close_trees(cgg, jcgg, GATOL, GRTOL)
        state, _ = steps.train_step(state, steps.batch_to_device(ref["batch"], "cpu"), None,
                                    cfg, phase)
    assert state.step == 2
    lr = cfg.train.lr
    _close_trees(captioner_to_jax(state.cg, cfg), jcg, 4 * lr, 0)
    _close_trees(tap_to_jax(state.tap), jtap, 4 * lr, 0)
    if phase == "cg":  # the SST and its Adam state are untouched
        assert all(torch.equal(a, b) for a, b in zip(tap0, state.tap.parameters()))
        assert not state.tap_opt.state and len(state.cg_opt.state) > 0


def test_losses_are_per_video_means(ref):
    """The batch loss is the mean of each video's loss, each normalised by
    its own frame and token counts, not pooled over the batch."""
    cfg = ref["cfg"]
    st = _state(ref)
    batch = steps.batch_to_device(ref["batch"], "cpu")
    with torch.no_grad():
        both = steps._one_video_losses(st.tap, st.cg, cfg, batch, "tap_cg", None, True, 0.0)
        for b in range(2):
            one = steps._one_video_losses(st.tap, st.cg, cfg,
                                          type(batch)(*(x[b:b + 1] for x in batch)),
                                          "tap_cg", None, True, 0.0)
            for k in both:
                np.testing.assert_allclose(float(both[k][b]), float(one[k][0]), rtol=1e-5)
    assert float(both["tap_loss"][0]) != float(both["tap_loss"][1])


def test_bf16_train_step(ref):
    cfg = ref["cfg"].replace_in("runtime", compute_dtype="bfloat16")
    state = _state(ref, cfg)
    masters = [p.detach().clone() for p in state.cg.parameters()]
    state, m = steps.train_step(state, steps.batch_to_device(ref["batch"], "cpu"), None, cfg,
                                "tap_cg")
    assert all(p.dtype == torch.float32 for p in state.cg.parameters())
    assert any(not torch.equal(a, b) for a, b in zip(masters, state.cg.parameters()))
    np.testing.assert_allclose(m["loss"], ref["bf16_loss"], rtol=BF16_REL)


# ----------------------------------------------------------------------- loop


def _loop_cfg(tmp_path):
    cfg = _cfg(**{"data.synthetic_num_videos": 8, "train.batch_size": 2,
                  "train.training_mode": "cotrain", "train.tap_epochs": 0,
                  "train.cg_epochs": 0, "train.tapcg_epochs": 100, "train.lr": 5e-3,
                  "save.checkpoint_path": str(tmp_path), "save.losses_log_every": 3,
                  "data.nthreads": 1})
    return cfg


def test_train_loop_runs(tmp_path):
    timing = {}
    out = ttrain.train(_loop_cfg(tmp_path), max_iterations=6, device="cpu", timing_out=timing)
    assert out["iteration"] == 6 and out["epoch"] >= 1
    assert set(out["losses"]) == {"tap_loss", "cg_loss", "total_loss", "loss"}
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert out["state"].step == 6 and [i for i, _ in timing["iters"]] == list(range(1, 7))
    # the run folder: its config and a readable model-last.ckpt at iteration 6
    folder = tmp_path / "default"
    assert out["save_folder"] == str(folder) and (folder / "config.json").exists()
    payload = checkpoint.load_checkpoint(str(folder / "model-last.ckpt"), "cpu")
    assert payload["iteration"] == 6 and payload["state"].step == 6


def test_train_loop_raises_for_what_is_not_ported(tmp_path):
    # SCST is ported: self_critical_after=0 takes a self-critical step
    cfg = _loop_cfg(tmp_path).replace_in("train", self_critical_after=0)
    out = ttrain.train(cfg, max_iterations=1, device="cpu")
    assert out["iteration"] == 1 and "avg_reward" in out["losses"]
    cfg = _loop_cfg(tmp_path).replace_in("runtime", transfer_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="transfer compression"):
        ttrain.train(cfg, max_iterations=1, device="cpu")


def test_schedule_helpers_match_jax():
    base = _cfg()
    modes = {"pre_tap+cotrain": dict(tap_epochs=2, cg_epochs=1, tapcg_epochs=3),
             "cotrain": dict(tap_epochs=0, cg_epochs=0, tapcg_epochs=4),
             "pre_cg": dict(tap_epochs=0, cg_epochs=3), "pre_LP_cg": dict(tap_epochs=0),
             "gt_tap_cg": dict(tap_epochs=0), "pre_tap": dict(cg_epochs=0, tap_epochs=2),
             "alter": dict(tap_epochs=0, cg_epochs=0, tapcg_epochs=2),
             "alter2": dict(tap_epochs=0, cg_epochs=0, tapcg_epochs=1),
             "alter3": dict(tap_epochs=0, cg_epochs=0, tapcg_epochs=1)}
    for mode, kw in modes.items():
        cfg = base.replace_in("train", training_mode=mode, **kw)
        assert ttrain.get_training_list(cfg) == jtrain.get_training_list(cfg), mode
    for kw in (dict(), dict(learning_rate_decay_start=-1),
               dict(learning_rate_decay_start=2, learning_rate_decay_every=1,
                    scheduled_sampling_start=0, scheduled_sampling_increase_every=2),
               dict(scheduled_sampling_start=3, scheduled_sampling_max_prob=0.5)):
        cfg = base.replace_in("train", **kw)
        for epoch in range(30):
            assert ttrain.current_lr(cfg, epoch) == jtrain.current_lr(cfg, epoch)
            assert ttrain.current_ss_prob(cfg, epoch) == jtrain.current_ss_prob(cfg, epoch)
