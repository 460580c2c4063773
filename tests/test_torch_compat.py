"""The reference .pth importer in the port against echr_tpu.compat, on the
CPU.

echr_tpu params (logit weights sharpened, as tests/test_torch_serve.py's)
go through tests/oracle_torch.py's modules into reference-layout
state_dicts, with parameters the model does not read, and are
torch.save'd as the reference's train.py saves them.  The port's
import_reference_checkpoint gives modules bit-equal to
bridge.*_from_jax of echr_tpu.compat's import of the same state_dicts,
for the SST with three_stream + TSRM and with show_attend_tell; their
greedy tokens equal echr_tpu's (logps within 5e-4).  An unsupported core
raises in both packages.
"""
import jax
import numpy as np
import pytest
import torch

from oracle_torch import ShowAttendTellOracle, SSTOracle, ThreeStreamOracle, TSRMOracle
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_cores import core_cfg
from test_torch_ops import small_cfg, to_np
from test_torch_serve import SHARPEN, TOL, _decode_inputs

from echr_tpu import compat as jcompat
from echr_tpu.engine import steps as jsteps
from echr_tpu.models.captioner import ProposalBatch as JaxProposalBatch
from echr_tpu.models.registry import init_captioner as jax_init_captioner
from echr_tpu.models.registry import init_tap as jax_init_tap

from echr_tpu_torch import bridge, compat, config
from echr_tpu_torch.engine.steps import decode_step_batched
from echr_tpu_torch.models.captioner import ProposalBatch


def _prefixed(prefix, mod):
    return {f"{prefix}.{k}": v for k, v in mod.state_dict().items()}


def reference_state_dicts(tap_np, cg_np, cfg):
    """The reference's 'tap_model' / 'cg_model' state_dicts of echr_tpu
    params, written by the oracle modules (tests/test_torch_import.py's
    layout), plus parameters the model does not read."""
    dec = cg_np["decoder"]
    cg_sd = {}
    if cfg.decoder.caption_model == "three_stream":
        o = ThreeStreamOracle(dec, cfg)
        for name in ("layer0", "layer1", "layer2"):
            cg_sd.update(_prefixed(f"lm_model.core.{name}", getattr(o, name)))
        for name in ("ctx2att", "h2att", "alpha_net"):
            cg_sd.update(_prefixed(f"lm_model.core.attention.{name}", getattr(o, name)))
        cg_sd["lm_model.core.fusion_layer.weight"] = torch.zeros(8, 8)
    else:
        o = ShowAttendTellOracle(dec, cfg)
        cg_sd.update(_prefixed("lm_model.core.rnn", o.rnn))
        for name in ("ctx2att", "h2att", "alpha_net"):
            cg_sd.update(_prefixed(f"lm_model.core.{name}", getattr(o, name)))
        if o.init_linear is not None:
            cg_sd.update(_prefixed("lm_model.init_linear", o.init_linear))
    cg_sd.update(_prefixed("lm_model.embed", o.embed))
    cg_sd.update(_prefixed("lm_model.logit", o.logit))
    if cfg.uses_tsrm:
        f = cfg.fusion
        ts = TSRMOracle(cg_np["fusion"], cfg.tsrm_input_dim, f.d_feats, f.n_head, f.d_o,
                        f.fST_type, f.use_posit)
        cg_sd.update(_prefixed("fusion_model.event_emb", ts.event_emb))
        for name, mod in (("query_1", ts.query), ("key_1", ts.key), ("pair_pos_fc1", ts.fc1),
                          ("pair_pos_fc2", ts.fc2), ("linear_out_1", ts.out)):
            cg_sd.update(_prefixed(f"fusion_model.enc_attn.{name}", mod))
        cg_sd["fusion_model.h2a_layer.weight"] = torch.zeros(10, 10)
    return _tap_state_dict(tap_np, cfg), cg_sd


def _tap_state_dict(tap_np, cfg):
    t = cfg.tap
    sst = SSTOracle(tap_np, t.video_dim, t.hidden_dim, t.K, t.rnn_num_layers)
    return {**_prefixed("rnn", sst.rnn), **_prefixed("scores", sst.scores)}


def _params(cfg, seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tap = to_np(jax_init_tap(k1, cfg))
    cg = to_np(jax_init_captioner(k2, cfg))
    cg["decoder"]["logit"]["w"] = cg["decoder"]["logit"]["w"] * SHARPEN
    return tap, cg


def _same_module(got, want):
    g, w = got.state_dict(), want.state_dict()
    assert list(g) == list(w)
    for k in w:
        assert torch.equal(g[k], w[k]), k


CFGS = {
    "three_stream": lambda: small_cfg(),
    "show_attend_tell": lambda: core_cfg("show_attend_tell").replace_in(
        "runtime", compute_dtype="float32"),
}


@pytest.fixture(autouse=True)
def _forward_only():
    with torch.no_grad():
        yield


@pytest.mark.parametrize("core", sorted(CFGS))
def test_import_matches_jax_compat(tmp_path, core):
    jcfg = CFGS[core]()
    assert jcfg.uses_tsrm
    cfg = config.Config.from_json(jcfg.to_json())
    tap_np, cg_np = _params(jcfg, seed=3)
    tap_sd, cg_sd = reference_state_dicts(tap_np, cg_np, jcfg)
    pth = tmp_path / "ref.pth"
    torch.save({"tap_model": tap_sd, "cg_model": cg_sd, "iteration": 7}, pth)

    sst, cg = compat.import_reference_checkpoint(str(pth), cfg, device="cpu")
    jtap, jcg = jcompat.import_reference_checkpoint(str(pth), jcfg)
    _same_module(sst, bridge.tap_from_jax(jtap, cfg))
    _same_module(cg, bridge.captioner_from_jax(jcg, cfg))
    # the imported trees are echr_tpu's, leaf for leaf
    np_sd = {k: v.numpy() for k, v in cg_sd.items()}
    want_tree = jcompat.import_cg_state_dict(np_sd, jcfg)
    got_tree = compat.import_cg_state_dict(np_sd, cfg)
    assert jax.tree_util.tree_structure(got_tree) == jax.tree_util.tree_structure(want_tree)
    for g, w in zip(jax.tree_util.tree_leaves(got_tree), jax.tree_util.tree_leaves(want_tree)):
        np.testing.assert_array_equal(g, w)

    # greedy tokens of the imported modules equal echr_tpu's on its params
    feats, tap_feats, lda, fm, ind, soi, pm = _decode_inputs(jcfg, seed=3)
    jseq, jlogps, jactive = jsteps.decode_step_batched(
        jcg, jcfg, tap_feats, feats, lda, fm, JaxProposalBatch(ind, soi, pm))
    seq, logps, active = decode_step_batched(
        cg, cfg, *(torch.from_numpy(x) for x in (tap_feats, feats, lda, fm)),
        ProposalBatch(*(torch.from_numpy(x) for x in (ind, soi, pm))))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))
    np.testing.assert_allclose(logps.numpy(), np.asarray(jlogps), atol=TOL, rtol=0)
    assert np.asarray(jseq).any()


def test_unsupported_core_raises(tmp_path):
    jcfg = core_cfg("two_stream_3lstm")
    cfg = config.Config.from_json(jcfg.to_json())
    tap_np, cg_np = _params(jcfg, seed=0)
    dec = cg_np["decoder"]
    cg_sd = {"lm_model.embed.weight": torch.from_numpy(dec["embed"]),
             "lm_model.logit.weight": torch.from_numpy(dec["logit"]["w"].T.copy()),
             "lm_model.logit.bias": torch.from_numpy(dec["logit"]["b"])}
    pth = tmp_path / "ref.pth"
    torch.save({"tap_model": _tap_state_dict(tap_np, jcfg), "cg_model": cg_sd}, pth)
    with pytest.raises(NotImplementedError, match="two_stream_3lstm"):
        jcompat.import_reference_checkpoint(str(pth), jcfg)
    with pytest.raises(NotImplementedError, match="two_stream_3lstm"):
        compat.import_reference_checkpoint(str(pth), cfg, device="cpu")
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            compat.import_reference_checkpoint(str(pth), cfg)
    finally:
        monkey.undo()
