"""The decoder family through the port's entry points, against echr_tpu on
the CPU at f32: an XE gradient step, beam search, the SCST replay, the
window sort, show_attend_tell's dead attention, format-v2 checkpoints both
ways, the default Config, and stage 1 -> stage 2 of the published recipe
through the train CLI.

Tolerances: the XE loss within 1e-5 relative and each gradient leaf within
1e-4 of its largest entry (f32 sums in another order, through a 7-step
recurrence and a 128-step SST), a leaf that is zero in exact arithmetic
within 1e-8; beam tokens equal and the best beam's
logprob within 1e-5; replay logps within 5e-4; the window sort and the
dead attention bit-exact; checkpoints bit-equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_checkpoint import (
    REPO,
    _equal_trees,
    _jax_moments,
    _moments,
    _params_of,
    _script_argvs,
)
from test_torch_cores import contexts, core_cfg, port_contexts, sharpened
from test_torch_ops import small_cfg, to_np
from test_torch_serve import _assert_same_captions, _decode_inputs, _requests, _vocab
from test_torch_train import _batch, _cfg, _jax_run
from test_train_e2e import tiny_cfg

from echr_tpu.engine import checkpoint as jckpt
from echr_tpu.engine import steps as jsteps
from echr_tpu.models import decoder as jdec
from echr_tpu.models.captioner import ProposalBatch as JaxProposalBatch
from echr_tpu.models.contexts import Contexts as JaxContexts
from echr_tpu.models.registry import init_captioner as jax_init_captioner
from echr_tpu.models.registry import init_tap as jax_init_tap

from echr_tpu_torch import bridge, config, serve
from echr_tpu_torch.cli import train as cli_train
from echr_tpu_torch.engine import checkpoint, steps
from echr_tpu_torch.models import decoder
from echr_tpu_torch.models.captioner import Captioner, ProposalBatch

REL = 1e-5
GRAD_REL = 1e-4  # of each leaf's largest entry
# alpha_net's bias: a shift of every score under a masked softmax, its
# gradient zero in exact arithmetic and f32 noise on both sides
GRAD_FLOOR = 1e-8
BEAM_ATOL = 1e-5
BEAM_SHARPEN = 100.0  # tests/test_torch_beam.py's scale, at its tolerance
TOL = 5e-4


def _jax_pair(cfg, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return to_np(jax_init_tap(k1, cfg)), to_np(jax_init_captioner(k2, cfg))


def _train_cfg(model):
    """tests/test_torch_train.py's _cfg (8 sampled proposals, vocab 50, 7
    teacher-forced steps, T = 128, Hatt = 128) with the core swapped."""
    return core_cfg(model, base=_cfg())


@pytest.mark.parametrize("model", ["show_attend_tell", "all_img", "h3_dense_add",
                                   "two_stream_3lstm"])
def test_xe_grad_step_matches_jax(model):
    """One tap_cg grad_step, dropout off (gen=None; echr_tpu's rng=None),
    the port on its training kernel route (plain versions on the CPU),
    echr_tpu on its jnp one."""
    cfg = _train_cfg(model)
    tap, cg = _jax_pair(cfg)
    batch = _batch(cfg)
    (jloss, jm, jtg, jcgg), = _jax_run(cfg.replace_in("runtime", use_pallas_train=False), tap,
                                        cg, batch, "tap_cg", 1)[0]
    state = steps.init_train_state(cfg, bridge.tap_from_jax(tap, cfg),
                                   bridge.captioner_from_jax(cg, cfg))
    (tg, cgg), m = steps.grad_step(state, steps.batch_to_device(batch, "cpu"), None, cfg,
                                   "tap_cg")
    np.testing.assert_allclose(m["loss"], jloss, rtol=REL)
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], rtol=REL, err_msg=k)
    specs = ((bridge.tap_spec(state.tap), tg, state.tap.parameters(), jtg, 1),
             (bridge.captioner_spec(state.cg), cgg, state.cg.parameters(), jcgg,
              cfg.fusion.n_head))
    for spec, grads, params, want, groups in specs:
        by_param = dict(zip(params, grads))
        got = bridge.export_tree(spec, groups, lambda p: by_param[p])
        flat_w, tdef = jax.tree_util.tree_flatten_with_path(want)
        assert jax.tree_util.tree_structure(got) == tdef
        for (path, w), g in zip(flat_w, jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * np.abs(w).max() + GRAD_FLOOR,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("model", ["show_attend_tell", "h3_dense_add"])
def test_beam_matches_jax(model):
    """Beam 3 through beam_decode_step_batched: echr_tpu's jnp route, the
    port's window sort and kernel route; padded proposals included."""
    cfg = core_cfg(model, base=small_cfg(**{"decoder.CG_vocab_size": 100}))
    tap, cg = _jax_pair(cfg, seed=2)
    cg = sharpened(cg, BEAM_SHARPEN)
    feats, tap_feats, lda, fm, ind, soi, pm = _decode_inputs(cfg, N=12, seed=2)
    jseq, jlp = jsteps.beam_decode_step_batched(
        cg, cfg.replace_in("runtime", use_pallas=False), tap_feats, feats, lda, fm,
        JaxProposalBatch(ind, soi, pm), 3, length_alpha=1.0)
    with torch.no_grad():
        seq, lp = steps.beam_decode_step_batched(
            bridge.captioner_from_jax(cg, cfg), cfg,
            *(torch.from_numpy(x) for x in (tap_feats, feats, lda, fm)),
            ProposalBatch(*(torch.from_numpy(x) for x in (ind, soi, pm))), 3,
            length_alpha=1.0)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=BEAM_ATOL, rtol=0)
    assert np.asarray(jseq).any()


def test_scst_replay_matches_jax():
    """two_stream_jump: a sampled rollout with dropout on, replayed with
    forced= (dropout off, train route) against echr_tpu's
    decoder_sample(forced_tokens=..., train=True, rng=None)."""
    cfg = core_cfg("two_stream_jump")
    _, cg = _jax_pair(cfg, seed=3)
    cg = jax.tree.map(np.array, cg)
    cg["decoder"]["logit"]["b"][0] += 3.0  # rollouts that end early
    ctx = contexts(cfg, seed=3)
    dec = bridge.captioner_from_jax(cg, cfg).decoder
    with torch.no_grad():
        gen_seq, _, _ = decoder.decoder_sample_batched(
            dec, cfg, port_contexts(ctx), greedy=False,
            sample_gen=torch.Generator().manual_seed(1), train=True,
            gen=torch.Generator().manual_seed(2))
    seq, logps, active = decoder.decoder_sample_batched(dec, cfg, port_contexts(ctx),
                                                        greedy=False, train=True,
                                                        forced=gen_seq)
    assert logps.requires_grad
    jcfg = cfg.replace_in("runtime", use_pallas=False, use_pallas_train=False)
    want = jax.jit(jax.vmap(lambda c, f: jdec.decoder_sample(
        jax.tree.map(jnp.asarray, cg["decoder"]), jcfg, c, greedy=False, train=True,
        forced_tokens=f)))(JaxContexts(**{k: jnp.asarray(v) for k, v in ctx.items()}),
                           jnp.asarray(gen_seq.numpy()))
    wseq, wlogps, wactive = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(seq.numpy(), wseq)
    np.testing.assert_array_equal(active.numpy(), wactive)
    np.testing.assert_allclose(logps.detach().numpy(), wlogps, atol=TOL, rtol=0)
    assert torch.equal(seq, gen_seq)
    assert bool(((gen_seq == 0).any(-1) & (torch.from_numpy(ctx["prop_mask"]) > 0)).any())


@pytest.mark.parametrize("model", ["all_img", "show_attend_tell"])
def test_window_sort_is_exact(model):
    """Greedy decode with the window sort (the kernel route's) and without
    it gives identical tokens and logps."""
    cfg = core_cfg(model)
    dec = bridge.captioner_from_jax(sharpened(_jax_pair(cfg, seed=4)[1]), cfg).decoder
    ctxs = port_contexts(contexts(cfg, seed=4))
    assert decoder.sort_gate(cfg, ctxs)
    with torch.no_grad():
        sorted_out = decoder.decoder_sample_batched(dec, cfg, ctxs)
        plain_out = decoder.decoder_sample_batched(
            dec, cfg.replace_in("runtime", sort_decode_props=False), ctxs)
    for a, b in zip(sorted_out, plain_out):
        assert torch.equal(a, b)
    assert bool(sorted_out[0].any())


def test_dead_attention_is_not_computed(monkeypatch):
    """show_attend_tell without "C" in CG_input_feats_type (train_SST.sh's
    ''): no attention step and no ctx2att projection run, and the greedy
    decode and teacher-forced logprobs equal those with the attention
    computed."""
    cfg = core_cfg("show_attend_tell").replace_in(
        "context", CG_input_feats_type="V+E", CG_init_feats_type="")
    dec = bridge.captioner_from_jax(sharpened(_jax_pair(cfg, seed=5)[1]), cfg).decoder
    ctxs = port_contexts(contexts(cfg, seed=5))
    seq_in = torch.from_numpy(np.random.RandomState(5).randint(
        0, 101, size=(2, 8, cfg.decoder.CG_seq_length + 1)))
    calls = []
    for name in ("additive_attention_step", "additive_attention_precompute"):
        monkeypatch.setattr(decoder, name, lambda *a, fn=getattr(decoder, name), name=name,
                            **k: calls.append(name) or fn(*a, **k))

    def run():
        with torch.no_grad():
            return (*decoder.decoder_sample_batched(dec, cfg, ctxs),
                    decoder.decoder_forward(dec, cfg, ctxs, seq_in, train=True))

    dead = run()
    assert calls == []
    monkeypatch.setattr(decoder, "attention_live", lambda cfg: True)
    live = run()
    assert set(calls) == {"additive_attention_step", "additive_attention_precompute"}
    for a, b in zip(dead, live):
        assert torch.equal(a, b)


def _sat3_cfg():
    """show_attend_tell as train_SST.sh builds it (CG_num_layers 3) with
    its attention and init_linear live, at tests/test_torch_train.py's
    widths."""
    return _cfg(**{"decoder.caption_model": "show_attend_tell",
                        "decoder.CG_num_layers": 3, "context.CG_input_feats_type": "V+E+C",
                        "context.CG_init_feats_type": "V+E"})


def test_jax_checkpoint_serves_in_port(tmp_path):
    from echr_tpu.serve import CaptionRequest as JaxRequest
    from echr_tpu.serve import from_checkpoint as jax_from_checkpoint

    cfg = _sat3_cfg()
    tap, cg = _jax_pair(cfg, seed=6)
    cg = sharpened(cg)
    path = str(tmp_path / "model-best.ckpt")
    jckpt.save_checkpoint(path, jsteps.init_train_state(cfg, tap, cg), cfg, iteration=3,
                          epoch=0, best_val_score=0.0, vocab=_vocab(cfg))
    reqs = _requests(cfg, n=3, seed=6)
    want = jax_from_checkpoint(path, batch_videos=4, topN=8).caption(
        [JaxRequest(r.vid, r.feats, r.duration, r.lda) for r in reqs])
    svc = serve.from_checkpoint(path, device="cpu", batch_videos=4, topN=8)
    assert type(svc.cg.decoder.core).__name__ == "ShowAttendTellCore"
    _assert_same_captions(svc.caption(reqs), want)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port takes one Adam step and writes; echr_tpu's load_checkpoint
    gives the parameters (the "layers" list verbatim) and the moments
    bit-equal."""
    cfg = _sat3_cfg()
    tap, cg = _jax_pair(cfg, seed=7)
    state = steps.init_train_state(cfg, bridge.tap_from_jax(tap, cfg),
                                   bridge.captioner_from_jax(cg, cfg))
    state, _ = steps.train_step(state, steps.batch_to_device(_batch(cfg), "cpu"), None, cfg,
                                "tap_cg")
    path = str(tmp_path / "model-last.ckpt")
    checkpoint.save_checkpoint(path, state, cfg, iteration=1, epoch=0, best_val_score=0.0)
    js = jckpt.load_checkpoint(path)["state"]
    assert isinstance(js.cg_params["decoder"]["core"]["layers"], list)
    tap_p, cg_p = _params_of(state, cfg)
    _equal_trees(tap_p, js.tap_params)
    _equal_trees(cg_p, js.cg_params)
    mu, nu, count, _ = _jax_moments(js.cg_opt, js.cg_params)
    mom = _moments(state, cfg)
    _equal_trees(mom["cg"]["exp_avg"], mu)
    _equal_trees(mom["cg"]["exp_avg_sq"], nu)
    assert count == mom["cg_count"] == 1


def test_default_config_builds():
    """Captioner(Config()) with the vocab filled in: show_attend_tell, one
    layer, the parameter tree of echr_tpu's init_captioner."""
    from echr_tpu.config import Config as JaxConfig

    jcfg = JaxConfig().replace_in("decoder", CG_vocab_size=120, CG_seq_length=10)
    cfg = config.Config.from_json(jcfg.to_json())
    cg = Captioner(cfg)
    assert type(cg.decoder.core).__name__ == "ShowAttendTellCore"
    want = jax.eval_shape(lambda: jax_init_captioner(jax.random.PRNGKey(0), jcfg))
    got = bridge.export_tree(bridge.captioner_spec(cg), cfg.fusion.n_head)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape


def test_stage1_to_stage2_through_the_train_cli(tmp_path):
    """experiments/train_SST.sh's flags (TAP pretraining with a
    show_attend_tell CG_num_layers 3 captioner) train and checkpoint on the
    port; train_ECHR.sh's warm-start from that checkpoint (--pretrain tap)
    with its three_stream captioner.  Synthetic data at tiny widths from a
    config JSON; an epoch each, checkpoints every 4 iterations."""
    base = tiny_cfg(tmp_path, **{"data.synthetic_num_videos": 6})
    (tmp_path / "c.json").write_text(config.Config.from_json(base.to_json()).to_json())
    over = ["--config_json", str(tmp_path / "c.json"), "--checkpoint_path", str(tmp_path),
            "--device", "cpu"]
    (sst_argv,) = _script_argvs(REPO / "experiments" / "train_SST.sh")
    out1 = cli_train.main(sst_argv + over + ["--tap_epoch", "1", "--save_checkpoint_every",
                                             "4"])
    cfg1 = out1["config"]
    assert cfg1.decoder.caption_model == "show_attend_tell" and cfg1.decoder.CG_num_layers == 3
    assert type(out1["state"].cg.decoder.core).__name__ == "ShowAttendTellCore"
    ckpt1 = os.path.join(out1["save_folder"], "model-best.ckpt")
    assert os.path.exists(ckpt1)
    saved = checkpoint.load_checkpoint(ckpt1, "cpu", rebuild_state=False)
    assert len(saved["state"]["cg_params"]["decoder"]["core"]["layers"]) == 3

    (echr_argv,) = _script_argvs(REPO / "experiments" / "train_ECHR.sh")
    i = echr_argv.index("--pretrain_path")
    echr_argv[i + 1] = ckpt1
    out2 = cli_train.main(echr_argv + over + ["--cg_epoch", "1"])
    assert out2["config"].decoder.caption_model == "three_stream"
    assert out2["iteration"] >= 1
    # pre_cg trains the captioner only: the SST is the warm start
    tap_p, _ = _params_of(out2["state"], out2["config"])
    _equal_trees(tap_p, saved["state"]["tap_params"])
