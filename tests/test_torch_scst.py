"""The port's self-critical training (SCST) and multinomial decode against
echr_tpu, on the CPU.

JAX's random streams cannot be replayed in torch, so the parity tests
take the draws from the port (a seeded rollout) and replay them in both
packages with dropout off: echr_tpu's side is composed from its parts with
train=True and rng=None (sst_forward, make_contexts, decoder_sample with
forced_tokens; kernels 3 and 4 in interpret mode, as
tests/test_torch_train.py runs them), the port's takes gen=None.  With
dropout on, the port is held to itself: the replay of a rollout's tokens
from the rollout's generator state gives the rollout's logps.

Tolerances: rewards exact (the same pure-Python METEOR on the same
strings); the replay's logps within 5e-4 and its seq and active equal;
the update's loss and metrics within 1e-5 relative, gradient leaves
within atol 2e-4, rtol 1e-3 and parameters after one Adam step within
4 * lr (tests/test_torch_train.py's gates); the rollout against its
replay within 1e-6 (the same ops on the same shapes); draw frequencies
within 0.03 of softmax(logits / T) over 4000 draws (about 4 standard
deviations).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_eval import Split
from test_torch_train import GATOL, GRTOL, REL, _as_jax, _batch, _cfg, _close_trees, _loop_cfg
from test_torch_train import _params

from echr_tpu import losses as jlosses
from echr_tpu.engine import rl as jrl
from echr_tpu.engine import steps as jsteps
from echr_tpu.models.captioner import make_contexts as jax_make_contexts
from echr_tpu.models.decoder import decoder_sample as jax_decoder_sample
from echr_tpu.models.sst import sst_forward as jax_sst_forward

from echr_tpu_torch.bridge import captioner_from_jax, captioner_to_jax, tap_from_jax, tap_to_jax
from echr_tpu_torch.engine import rl, steps
from echr_tpu_torch.engine import train as ttrain
from echr_tpu_torch.models import decoder
from echr_tpu_torch.models.captioner import captioner_sample, captioner_train_rl, make_contexts
from echr_tpu_torch.models.registry import init_captioner, init_tap
from echr_tpu_torch.models.sst import sst_forward_batched
from echr_tpu_torch.ops.kernel_attention import attention_scores_diff

TOL = 5e-4  # the replay's logps against echr_tpu's
EOS_BIAS = 3.0  # added to the end token's logit bias: rollouts that end early
PHASES = ("tap_cg", "cg")

# ----------------------------------------------------------------- rewards

WORDS = ["a", "man", "is", "playing", "guitar", "the", "woman", "dog", "runs", "on",
         "grass", "Running"]
VOCAB = {str(i): w for i, w in enumerate(WORDS, start=1)}


def _reward_inputs(seed, N=7, L=6):
    """Sampled and greedy tokens with end tokens anywhere and ids past the
    vocab, one GT sentence fewer than rows, and padded rows."""
    r = np.random.RandomState(seed)
    gen_seq = r.randint(0, len(WORDS) + 3, (N, L)).astype(np.int32)
    greedy_seq = r.randint(0, len(WORDS) + 1, (N, L)).astype(np.int32)
    gts = [" ".join(r.choice(WORDS, r.randint(2, 7))) + "." for _ in range(N - 1)]
    pm = (r.rand(N) > 0.25).astype(np.float32)
    return gen_seq, greedy_seq, gts, pm


@pytest.mark.parametrize("weight", [1.0, 0.5])
def test_self_critical_reward_matches_jax(weight):
    gen_seq, greedy_seq, gts, pm = _reward_inputs(0)
    got = rl.self_critical_reward(gen_seq, greedy_seq, gts, VOCAB, pm, meteor_weight=weight)
    want = jrl.self_critical_reward(gen_seq, greedy_seq, gts, VOCAB, pm, meteor_weight=weight)
    assert got.dtype == np.float32 and got.shape == gen_seq.shape
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).sum() > 0


def test_self_critical_reward_batched_matches_jax_and_pool():
    """The batched rewards equal echr_tpu's; a pool of 2 workers gives the
    serial scores."""
    inputs = [_reward_inputs(seed) for seed in (1, 2, 3)]
    args = ({b: x[0] for b, x in enumerate(inputs)}, {b: x[1] for b, x in enumerate(inputs)},
            {b: x[2] for b, x in enumerate(inputs)}, VOCAB,
            {b: x[3] for b, x in enumerate(inputs)}, len(inputs))
    got = rl.self_critical_reward_batched(*args)
    np.testing.assert_array_equal(got, jrl.self_critical_reward_batched(*args))
    pool = rl.RewardPool(workers=2)
    try:
        np.testing.assert_array_equal(rl.self_critical_reward_batched(*args, pool=pool), got)
        rows = rl._reward_rows(*(inputs[0][i] for i in (0, 1)), inputs[0][2], VOCAB,
                               inputs[0][3])
        assert len(rows) >= 4
        assert sorted(pool.score(rows, 1.0)) == sorted(rl._score_rows(rows, 1.0))
    finally:
        pool.shutdown(wait=True)
    assert rl.RewardPool(workers=1)._pool is None  # one worker scores in-process


# ------------------------------------------------------ replay and update


def _state(cfg, tap, cg):
    return steps.init_train_state(cfg, tap_from_jax(tap, cfg), captioner_from_jax(cg, cfg))


def _eos_biased(cg, bias):
    cg = jax.tree.map(np.array, cg)  # a copy
    cg["decoder"]["logit"]["b"][0] += bias
    return cg


def _jax_rl(cfg, tap, cg, batch, phase, gen_seq, reward):
    """echr_tpu's update composed from its parts, dropout off: (loss,
    metrics, (seq, logps, active), grads, parameters after one Adam
    step)."""
    jb = jax.tree.map(jnp.asarray, batch)

    def loss_fn(tp, cp):
        tc, cc = jsteps._cast(tp, cfg), jsteps._cast(cp, cfg)

        def one(b, gs, rw):
            tap_feats, scores = jax_sst_forward(tc, b.feats, train=True, rng=None,
                                                dropout_rate=cfg.tap.rnn_dropout)
            tap_l = jlosses.tap_loss(scores, b.tap_masks, b.tap_labels, b.w1, b.n_frames)
            props = jsteps._select_props(b, phase)[0]
            ctxs = jax_make_contexts({"fusion": cc.get("fusion")}, cfg, tap_feats, b.feats,
                                     b.lda, props, frame_mask=b.frame_mask, train=True,
                                     rng=None)
            out = jax_decoder_sample(cc["decoder"], cfg, ctxs, greedy=False, train=True,
                                     forced_tokens=gs)
            pm = props.prop_mask
            rl_l = jlosses.reward_loss(out[1], gs, rw, prop_mask=pm)
            return {"tap_loss": tap_l, "cg_loss": rl_l,
                    "total_loss": cfg.train.lambda1 * tap_l + cfg.train.lambda2 * rl_l,
                    "avg_reward": jnp.sum(rw[:, 0] * pm) / jnp.maximum(jnp.sum(pm), 1.0)}, out

        m, outs = jax.vmap(one)(jb, jnp.asarray(gen_seq), jnp.asarray(reward))
        m = jax.tree.map(jnp.mean, m)
        return jsteps._phase_loss(m, phase, cfg), (m, outs)

    (loss, (m, outs)), (tg, cgg) = jax.jit(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(tap, cg)
    opt = jsteps.make_optimizer(cfg)
    # one jitted Adam step a tree: op by op, each leaf's shape compiles anew
    adam = jax.jit(lambda g, p: optax.apply_updates(p, opt.update(g, opt.init(p), p)[0]))
    new_tap = adam(tg, tap) if phase in ("tap_cg", "gt_tap_cg") else tap
    new_cg = adam(cgg, cg)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (float(loss), {k: float(v) for k, v in m.items()}, to_np(outs), to_np(tg),
            to_np(cgg), to_np(new_tap), to_np(new_cg))


@pytest.fixture(scope="module")
def rl_ref():
    """The port's seeded rollout of each phase (dropout off) and random
    rewards, replayed by echr_tpu."""
    cfg = _cfg()
    tap, cg = _params(cfg)
    cg = _eos_biased(cg, EOS_BIAS)
    batch = _batch(cfg)
    tb = steps.batch_to_device(batch, "cpu")
    state = _state(cfg, tap, cg)
    B, N = batch.prop_mask.shape
    L = cfg.decoder.CG_seq_length
    runs = {}
    for i, phase in enumerate(PHASES):
        _, gen_seq, greedy_seq = steps.rl_rollout_step_batched(
            state, tb, cfg, phase, None, torch.Generator().manual_seed(7 + i))
        reward = np.broadcast_to(np.random.RandomState(5 + i).randn(B, N, 1),
                                 (B, N, L)).astype(np.float32)
        runs[phase] = (gen_seq, greedy_seq, reward,
                       _jax_rl(cfg, tap, cg, batch, phase, gen_seq.numpy(), reward))
    return {"cfg": cfg, "tap": tap, "cg": cg, "batch": batch, "runs": runs}


@pytest.mark.parametrize("phase", PHASES)
def test_replay_matches_jax(rl_ref, phase):
    """decoder_sample_batched(forced=...) on the port's contexts against echr_tpu's
    decoder_sample(forced_tokens=...): seq and active equal, logps within
    5e-4; the rollout ended some captions early and left padded rows."""
    cfg = rl_ref["cfg"]
    gen_seq, greedy_seq, _, jax_run = rl_ref["runs"][phase]
    want_seq, want_logps, want_active = jax_run[2]
    state = _state(cfg, rl_ref["tap"], rl_ref["cg"])
    tb = steps.batch_to_device(rl_ref["batch"], "cpu")
    with torch.no_grad():
        _, ctxs = steps._rl_prepare(state.tap, state.cg, cfg, tb, phase, None)
        seq, logps, active = decoder.decoder_sample_batched(state.cg.decoder, cfg, ctxs,
                                                            greedy=False, forced=gen_seq)
    np.testing.assert_array_equal(seq.numpy(), want_seq)
    np.testing.assert_array_equal(active.numpy(), want_active)
    np.testing.assert_allclose(logps.numpy(), want_logps, atol=TOL, rtol=0)
    assert torch.equal(seq, gen_seq)  # a rollout's seq replays to itself
    ended = (gen_seq == 0).any(dim=-1) & (tb.prop_mask > 0)
    assert bool(ended.any()) and greedy_seq.shape == gen_seq.shape


@pytest.mark.parametrize("phase", PHASES)
def test_rl_update_matches_jax(rl_ref, phase):
    """rl_update_step_batched's loss, metrics and gradients against
    echr_tpu's, then its parameters after the dual-Adam step (the SST only
    in 'tap_cg')."""
    cfg = rl_ref["cfg"]
    gen_seq, _, reward, (jloss, jm, _, jtg, jcgg, jtap, jcg) = rl_ref["runs"][phase]
    state = _state(cfg, rl_ref["tap"], rl_ref["cg"])
    tb = steps.batch_to_device(rl_ref["batch"], "cpu")
    reward_t = torch.from_numpy(reward)
    (tg, cgg), m = steps._phase_grads(state, cfg, phase, steps._rl_losses, tb, phase, None,
                                      gen_seq, reward_t)
    np.testing.assert_allclose(m["loss"], jloss, rtol=REL)
    assert set(m) == {"tap_loss", "cg_loss", "total_loss", "avg_reward", "loss"}
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], rtol=REL, err_msg=k)
    _close_trees(_as_jax(state.tap, tg, tap_to_jax), jtg, GATOL, GRTOL)
    _close_trees(_as_jax(state.cg, cgg, lambda mod: captioner_to_jax(mod, cfg)), jcgg, GATOL,
                 GRTOL)
    tap0 = [p.detach().clone() for p in state.tap.parameters()]
    state, m2 = steps.rl_update_step_batched(state, tb, cfg, phase, None, gen_seq, reward_t)
    assert m2 == m and state.step == 1
    lr = cfg.train.lr
    _close_trees(captioner_to_jax(state.cg, cfg), jcg, 4 * lr, 0)
    _close_trees(tap_to_jax(state.tap), jtap, 4 * lr, 0)
    if phase == "cg":  # the SST and its Adam state are untouched
        assert all(torch.equal(a, b) for a, b in zip(tap0, state.tap.parameters()))
        assert not state.tap_opt.state


def _reward_mask(seq):
    """reward_loss's token mask: every emitted token and the end token."""
    m = (seq > 0).float()
    return torch.cat([torch.ones_like(m[..., :1]), m[..., :-1]], dim=-1)


def test_replay_equals_rollout_with_dropout(rl_ref):
    """Dropout on (SST, contexts, decoder): the replay of a rollout's tokens
    from the generator state the rollout started from gives the rollout's
    logps on every token the reward counts, though the rollout exited
    early and the replay ran all L steps; another generator state gives
    other logps."""
    cfg = rl_ref["cfg"]
    L = cfg.decoder.CG_seq_length
    state = _state(cfg, rl_ref["tap"], _eos_biased(rl_ref["cg"], 1.5))
    tb = steps.batch_to_device(rl_ref["batch"], "cpu")
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    decoder.decoder_sample_batched.steps = 0
    with torch.no_grad():
        _, seq, logps = steps._rl_forward(state.tap, state.cg, cfg, tb, "tap_cg", gen,
                                          torch.Generator().manual_seed(4))
    assert 1 < decoder.decoder_sample_batched.steps < L  # the early exit fired
    assert ttrain._executed_steps(seq.numpy()) == decoder.decoder_sample_batched.steps
    gen.set_state(before)
    _, seq2, logps2 = steps._rl_forward(state.tap, state.cg, cfg, tb, "tap_cg", gen,
                                        forced=seq)
    assert logps2.requires_grad and torch.equal(seq2, seq)
    m = _reward_mask(seq)
    np.testing.assert_allclose((logps2.detach() * m).numpy(), (logps * m).numpy(), atol=1e-6,
                               rtol=0)
    _, _, logps3 = steps._rl_forward(state.tap, state.cg, cfg, tb, "tap_cg",
                                     torch.Generator().manual_seed(99), forced=seq)
    assert not torch.allclose(logps3.detach() * m, logps * m, atol=1e-3)


# ------------------------------------------------------------ sampled decode


def _eval_ctxs(cfg, state, tb, phase="tap_cg"):
    tap_feats, _ = sst_forward_batched(state.tap, tb.feats)
    props = steps._select_props(tb, phase)[0]
    return make_contexts(state.cg, cfg, tap_feats, tb.feats, tb.lda, props,
                         frame_mask=tb.frame_mask)


@pytest.mark.parametrize("train", [False, True])
def test_sampled_and_train_decodes_do_not_sort(rl_ref, monkeypatch, train):
    """With the sort gate on, the greedy eval decode sorts and the sampled
    one (eval or train mode) does not."""
    cfg = rl_ref["cfg"].replace_in("runtime", use_pallas=True, sort_decode_props=True)
    state = _state(cfg, rl_ref["tap"], rl_ref["cg"])
    ctxs = _eval_ctxs(cfg, state, steps.batch_to_device(rl_ref["batch"], "cpu"))
    assert decoder.sort_gate(cfg, ctxs)
    calls = []
    sort = decoder.sort_ctxs_by_window
    monkeypatch.setattr(decoder, "sort_ctxs_by_window", lambda c: calls.append(1) or sort(c))
    with torch.no_grad():
        decoder.decoder_sample_batched(state.cg.decoder, cfg, ctxs)
        assert calls == [1]
        decoder.decoder_sample_batched(state.cg.decoder, cfg, ctxs, greedy=False,
                                       sample_gen=torch.Generator().manual_seed(0),
                                       train=train, gen=torch.Generator().manual_seed(1))
    assert calls == [1]
    with pytest.raises(ValueError, match="sample_gen"):
        decoder.decoder_sample_batched(state.cg.decoder, cfg, ctxs, greedy=False)


def _pattern(kind, B, N, L, prop_mask):
    """Token draws [B, N, L] with end tokens at chosen steps, nonzero draws
    after them, and padded rows that never end."""
    r = np.random.RandomState(11)
    tok = r.randint(1, 50, (B, N, L)).astype(np.int64)
    ends = r.randint(0, L - 3, (B, N))
    if kind == "ragged_ends":
        ends[1] = r.randint(0, 2, N)  # video 1 ends first: it writes zeros while 0 runs
    for b in range(B):
        for n in range(N):
            if prop_mask[b, n] > 0:
                tok[b, n, ends[b, n]] = 0
    if kind == "one_never_ends":
        tok[0, 2] = r.randint(1, 50, L)
    return tok


@pytest.mark.parametrize("kind", ["ragged_ends", "one_never_ends"])
def test_sampled_decode_masking_matches_jax(rl_ref, monkeypatch, kind):
    """The sampled decode with its draws replaced by fixed token patterns
    (end tokens, draws after them, padded rows that never end) zero-masks
    and sets active as echr_tpu's decoder_sample does on those tokens;
    logps within 5e-4.  The batch-wide exit stops after the last step in
    which a real proposal is unfinished."""
    cfg, batch = rl_ref["cfg"], rl_ref["batch"]
    B, N = batch.prop_mask.shape
    L = cfg.decoder.CG_seq_length
    pattern = _pattern(kind, B, N, L, batch.prop_mask)
    drawn = []

    def draw(logits, temperature, gen):
        drawn.append(1)
        return torch.from_numpy(pattern[:, :, len(drawn) - 1].reshape(-1))

    monkeypatch.setattr(decoder, "_categorical", draw)
    state = _state(cfg, rl_ref["tap"], rl_ref["cg"])
    ctxs = _eval_ctxs(cfg, state, steps.batch_to_device(batch, "cpu"))
    with torch.no_grad():
        seq, logps, active = decoder.decoder_sample_batched(
            state.cg.decoder, cfg, ctxs, greedy=False, sample_gen=torch.Generator())
    jb = jax.tree.map(jnp.asarray, batch)

    def one(tap, cg, b, forced):
        tap_feats, _ = jax_sst_forward(tap, b.feats)
        props = jsteps._select_props(b, "tap_cg")[0]
        ctxs = jax_make_contexts({"fusion": cg.get("fusion")}, cfg, tap_feats, b.feats, b.lda,
                                 props, frame_mask=b.frame_mask)
        return jax_decoder_sample(cg["decoder"], cfg, ctxs, greedy=False, forced_tokens=forced)

    run_jax = jax.jit(jax.vmap(one, in_axes=(None, None, 0, 0)))
    want = jax.tree.map(np.asarray, run_jax(rl_ref["tap"], rl_ref["cg"], jb,
                                            jnp.asarray(pattern, jnp.int32)))
    run = int(want[2].any(axis=0).sum()) + (0 if want[2].all() else 1)
    assert len(drawn) == min(run, L)
    np.testing.assert_array_equal(active.numpy(), want[2])
    np.testing.assert_array_equal(seq.numpy(), want[0])
    np.testing.assert_allclose(logps.numpy(), want[1], atol=TOL, rtol=0)
    if kind == "ragged_ends":
        assert len(drawn) < L and not active[1].all() and active[0, 1]


def test_captioner_train_rl_is_a_rollout_and_a_baseline(rl_ref):
    """captioner_train_rl gives captioner_sample's train-mode multinomial
    rollout from the same generators and its eval-mode greedy decode."""
    cfg = rl_ref["cfg"]
    state = _state(cfg, rl_ref["tap"], rl_ref["cg"])
    tb = steps.batch_to_device(rl_ref["batch"], "cpu")
    tap_feats, _ = sst_forward_batched(state.tap, tb.feats)
    props = steps._select_props(tb, "tap_cg")[0]
    args = (state.cg, cfg, tap_feats, tb.feats, tb.lda, props)
    def gens():
        return torch.Generator().manual_seed(5), torch.Generator().manual_seed(6)

    with torch.no_grad():
        sample_gen, gen = gens()
        (gen_seq, gen_logps), (greedy_seq, greedy_logps) = captioner_train_rl(
            *args, sample_gen, frame_mask=tb.frame_mask, gen=gen)
        sample_gen, gen = gens()
        want = captioner_sample(*args, tb.frame_mask, greedy=False, sample_gen=sample_gen,
                                train=True, gen=gen)
        want_greedy = captioner_sample(*args, tb.frame_mask)
    assert torch.equal(gen_seq, want[0]) and torch.equal(gen_logps, want[1])
    assert torch.equal(greedy_seq, want_greedy[0]) and torch.equal(greedy_logps, want_greedy[1])
    assert not torch.equal(gen_seq, greedy_seq)


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_draws_follow_tempered_softmax(temperature):
    """4000 proposals with the same inputs on a 5-token vocab: the first
    draws' frequencies follow softmax(logits / T) within 0.03, and the
    recorded logp is the untempered log-softmax of the drawn token."""
    cfg = _cfg(**{"decoder.CG_vocab_size": 4, "decoder.CG_seq_length": 2})
    g = torch.Generator().manual_seed(0)
    tap, cg = init_tap(g, cfg), init_captioner(g, cfg)
    with torch.no_grad():
        cg.decoder.logit.bias.copy_(torch.tensor([-0.5, 0.8, 0.0, -1.2, 0.4]))
    tb = steps.batch_to_device(_batch(cfg), "cpu")
    tap_feats, _ = sst_forward_batched(tap, tb.feats)
    props = steps._select_props(tb, "tap_cg")[0]
    one = make_contexts(cg, cfg, tap_feats, tb.feats, tb.lda, props, frame_mask=tb.frame_mask)
    R = 4000
    ctxs = one._replace(video=one.video[:1], event=one.event[:1, :1].expand(1, R, -1),
                        clip_feats=one.clip_feats[:1], clip_mask=one.clip_mask[:1, :1].expand(
                            1, R, -1), prop_mask=torch.ones(1, R))
    with torch.no_grad():
        seq, logps, _ = decoder.decoder_sample_batched(
            cg.decoder, cfg, ctxs, greedy=False, temperature=temperature,
            sample_gen=torch.Generator().manual_seed(1))
        pre = decoder.precompute_attention(cg.decoder, cfg, ctxs)
        st = decoder.init_state(cg.decoder, cfg, ctxs, R)
        logits, _ = decoder.step_logits(cg.decoder, cfg, torch.zeros(1, R, dtype=torch.int32),
                                        ctxs, pre, st)
    logits = logits[0, 0]
    assert float(logits.max() - logits.min()) > 1.0  # not near uniform
    freq = np.bincount(seq[0, :, 0].numpy(), minlength=5) / R
    np.testing.assert_allclose(freq, torch.softmax(logits / temperature, -1).numpy(), atol=0.03)
    want = torch.log_softmax(logits, -1)[seq[0, :, 0].long()]
    np.testing.assert_allclose(logps[0, :, 0].numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_training_scores_function_without_grad():
    """attention_scores_diff (kernel 3's autograd.Function; its plain version
    here) gives the same scores under no_grad as with autograd."""
    r = np.random.RandomState(0)
    pre, q = (torch.from_numpy(r.randn(*s).astype(np.float32)) for s in ((2, 9, 16), (2, 5, 16)))
    w, b = torch.from_numpy(r.randn(16).astype(np.float32)), torch.zeros(1)
    mask = torch.from_numpy((r.rand(2, 5, 9) > 0.5).astype(np.float32))
    with torch.no_grad():
        s0 = attention_scores_diff(pre, q, w, b, mask)
    s1 = attention_scores_diff(pre, q.requires_grad_(), w, b, mask)
    assert s1.requires_grad and not s0.requires_grad
    assert torch.equal(s0, s1.detach())


@pytest.mark.parametrize("earlier", [False, True], ids=["folded", "torch_dispatch"])
def test_replay_products_are_the_rollouts_at_batch_size_1(tmp_path, monkeypatch, earlier):
    """ROADMAP C.2: train()'s first SCST step at batch_size 1 and bf16.
    Every product of the replay's forward equals the rollout's on equal
    inputs, and so do the logps: ops.core.matmul folds a [..., K] left
    operand into one 2-D product.  With torch.matmul's own dispatch (the
    earlier form), the SST's input projection ran as a batched product in
    the rollout (its [T, 1, D] operand cannot fold without a copy) and as
    a 2-D one in the replay (b requires grad), and the two differ: here at
    f32 rounding, on the H100 enough to move the logps by 3.8e-4."""
    from echr_tpu_torch.experiments import probe_scst_replay as probe

    monkeypatch.setattr(ttrain, "default_reward_pool", lambda *_: rl.RewardPool(workers=1))
    cfg = _loop_cfg(tmp_path).replace_in("train", self_critical_after=0).replace_in(
        "runtime", compute_dtype="bfloat16")
    r = probe.train_pass("cpu", cfg, batch_size=1, earlier=earlier)
    assert r["tokens_equal"] and r["calls"][0] > r["calls"][1] > 0
    first = r["first_product"]
    if earlier:
        assert first["call"] == 0 and first["a"][1] == 1 and first["max_abs_d"] > 0
        assert not first["rollout"]["b_requires_grad"] and first["replay"]["b_requires_grad"]
    else:
        assert first is None and r["logps_max_abs_d"] == 0.0


# ------------------------------------------------------------------- loop


def test_train_loop_takes_scst_steps(tmp_path):
    """train() with self_critical_after=0 takes SCST steps on the CPU: finite
    losses, avg_reward logged, parameters moved, the timing of each step's
    rollouts, rewards and update."""
    cfg = _loop_cfg(tmp_path).replace_in("train", self_critical_after=0)
    timing = {}
    out = ttrain.train(cfg, max_iterations=3, device="cpu", timing_out=timing)
    assert out["iteration"] == 3 and out["state"].step == 3
    assert set(out["losses"]) == {"tap_loss", "cg_loss", "total_loss", "avg_reward", "loss"}
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert len(timing["scst"]) == 3
    L = out["config"].decoder.CG_seq_length
    for t in timing["scst"]:
        assert t["rollout"] > 0 and t["update"] > 0 and t["reward_rows"] > 0
        assert 1 <= t["sample_steps"] <= L and 1 <= t["greedy_steps"] <= L
    log = (tmp_path / "default" / "train.log").read_text()
    assert "avg_reward" in log


@pytest.mark.parametrize("resume_after", [0, -1])
def test_scst_checkpoint_resumes(tmp_path, resume_after):
    """A run stopped during SCST resumes into SCST; self_critical_after is
    the resuming command's (the CLI's value wins, as in echr_tpu): -1
    resumes into XE."""
    cfg = _loop_cfg(tmp_path).replace_in("train", self_critical_after=0)
    first = ttrain.train(cfg, max_iterations=2, device="cpu")
    assert "avg_reward" in first["losses"]
    again = cfg.replace_in("train", self_critical_after=resume_after).replace_in(
        "save", start_from="default")
    timing = {}
    out = ttrain.train(again, max_iterations=3, device="cpu", timing_out=timing)
    assert out["iteration"] == 3 and out["state"].step == 3
    assert out["config"].train.self_critical_after == resume_after
    assert ("avg_reward" in out["losses"]) == (resume_after == 0)
    assert len(timing["scst"]) == (1 if resume_after == 0 else 0)


def test_executed_steps():
    seq = np.zeros((2, 3, 6), np.int32)
    assert ttrain._executed_steps(seq) == 1
    seq[1, 2, 2] = 4
    assert ttrain._executed_steps(seq) == 4
    seq[0, 0, 5] = 1
    assert ttrain._executed_steps(seq) == 6


# ------------------------------------------------------------ multinomial eval


def test_multinomial_eval(tmp_path):
    """eval_split_batched with sample_max=0: a valid predictions JSON, the
    same JSON for the same sample_seed, other sentences for another seed,
    and echr_tpu's videos, proposals and timestamps (its draws are its
    own)."""
    s = Split(tmp_path)
    try:
        kw = {"num_vids_eval": 0, "topN": 15, "language_eval": False, "get_eval_loss": False,
              "sample_max": 0, "temperature": 1.0}
        runs = []
        for seed in (0, 0, 1):
            preds, _, _ = s.port(dict(kw, sample_seed=seed), "tap_cg")
            with open(tmp_path / "port.json") as f:
                runs.append((preds, json.load(f)))
        want, _, _ = s.jax(dict(kw, sample_seed=0), "tap_cg")
    finally:
        s.close()
    (got, got_json), (again, again_json), (other, _) = runs
    assert got_json == again_json and got_json["results"] == json.loads(json.dumps(got))
    words = set(s.ds.ix_to_word.values())
    assert sorted(got) == sorted(want) and want
    for vid, preds in want.items():
        assert [p["timestamp"] for p in got[vid]] == [list(p["timestamp"]) for p in preds]
        assert [p["proposal_score"] for p in got[vid]] == pytest.approx(
            [p["proposal_score"] for p in preds], abs=1e-6)
        for p in got[vid]:
            assert set(p["sentence"].split()) <= words
            assert p["sentence_confidence"] <= 0.0
            assert p["re_score"] == pytest.approx(10 * p["proposal_score"]
                                                  + p["sentence_confidence"], abs=1e-9)
    sents = lambda preds: [p["sentence"] for v in sorted(preds) for p in preds[v]]  # noqa: E731
    assert sents(got) != sents(other)
