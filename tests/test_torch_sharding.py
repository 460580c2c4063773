"""The port's model-axis sharding rule (parallel/mesh.param_sharding_rule)
against echr_tpu's param_sharding_rules, and the bridge's sharded import.

echr_tpu's rule runs on a (1, tp) mesh of the suite's virtual CPU devices;
the port's on the leaf names of the same captioner, mapped to echr_tpu's
tree paths by the bridge's layout.  Exact: the same leaves are cut, over
the same dimension.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_ops import small_cfg, to_np

from echr_tpu.models.registry import init_captioner as jax_init_captioner
from echr_tpu.parallel.mesh import build_mesh, param_sharding_rules

from echr_tpu_torch import bridge
from echr_tpu_torch.parallel import mesh
from echr_tpu_torch.parallel.tensor import shard_of

# (vocab V, TSRM heads, d_o, tp): V+1 62 and 64 divide, 61 does not; 3
# heads do not divide over 2
CASES = [(61, 4, 32, 2), (60, 4, 32, 2), (61, 3, 24, 2), (63, 4, 32, 4), (61, 4, 32, 4)]


@functools.lru_cache(maxsize=None)
def _case(vocab, n_head, d_o):
    cfg = small_cfg(**{"decoder.CG_vocab_size": vocab, "fusion.n_head": n_head,
                       "fusion.d_o": d_o})
    return cfg, to_np(jax_init_captioner(jax.random.PRNGKey(0), cfg))


def _port_names(cg):
    """echr_tpu's tree path ("decoder/logit/w", ...) -> the port's leaf name."""
    names = {id(p): n for n, p in cg.named_parameters()}
    out = {}

    def walk(spec, path):
        if isinstance(spec, tuple):
            out["/".join(path)] = names[id(spec[0])]
        elif isinstance(spec, list):
            for i, s in enumerate(spec):
                walk(s, path + [str(i)])
        else:
            for k, s in spec.items():
                walk(s, path + [k])

    walk(bridge.captioner_spec(cg), [])
    return out


@pytest.mark.parametrize("vocab,n_head,d_o,tp", CASES)
def test_rule_cuts_the_leaves_jax_cuts(vocab, n_head, d_o, tp):
    """Every captioner leaf: cut by the port's rule exactly where echr_tpu's
    rule gives it a model-axis spec, over the dimension that spec names in
    the port's layout (JAX's [H, V+1] logit and [g, d, d_o/g] heads are
    [V+1, H] and [d_o, d] here)."""
    cfg, tree = _case(vocab, n_head, d_o)
    cg = bridge.captioner_from_jax(tree, cfg)
    rule = param_sharding_rules(build_mesh(shape=(1, tp), devices=jax.devices()[:tp]))
    names = _port_names(cg)
    params = dict(cg.named_parameters())
    cut = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        spec = rule(path, leaf).spec
        name = names[key]
        got = mesh.param_sharding_rule("cg." + name, params[name], tp, n_head)
        assert (got is not None) == (spec != P()), (key, spec, got)
        if got is not None:
            cut[name] = got
    want = {"decoder.embed", "decoder.logit.weight", "decoder.logit.bias"} \
        if (vocab + 1) % tp == 0 else set()
    if n_head % tp == 0:
        want.add("fusion.out.weight")
    assert set(cut) == want and set(cut.values()) <= {0}


@pytest.mark.parametrize("vocab,n_head,d_o,tp", [CASES[0], CASES[3]])
def test_bridge_imports_a_ranks_blocks(vocab, n_head, d_o, tp, tmp_path):
    """captioner_from_jax(..., shard=(m, tp)): rank m holds rows
    [m n/tp, (m+1) n/tp) of each cut leaf, the TSRM's those of its heads
    (echr_tpu's out_w heads [m g/tp, (m+1) g/tp) in the grouped layout), the
    other leaves whole, and the decoder and TSRM marked with the block; a
    train state of such blocks is refused a checkpoint."""
    from echr_tpu_torch.engine import checkpoint, steps
    from echr_tpu_torch.models.registry import init_tap

    cfg, tree = _case(vocab, n_head, d_o)
    whole = dict(bridge.captioner_from_jax(tree, cfg).named_parameters())
    heads = n_head // tp
    for m in range(tp):
        cg = bridge.captioner_from_jax(tree, cfg, shard=(m, tp))
        for mod in (cg.decoder, cg.fusion):
            assert (shard_of(mod).m, shard_of(mod).tp) == (m, tp)
        cut = {n for n, _, _ in mesh.sharded_leaves(cg)}
        assert cut == {"decoder.embed", "decoder.logit.weight", "decoder.logit.bias",
                       "fusion.out.weight"}
        for name, p in cg.named_parameters():
            w = whole[name]
            if name in cut:
                n = w.shape[0] // tp
                assert torch.equal(p, w[m * n:(m + 1) * n]), name
            else:
                assert torch.equal(p, w), name
        out_w = tree["fusion"]["out_w"][m * heads:(m + 1) * heads]
        assert np.array_equal(cg.fusion.out.weight.detach().numpy(),
                              bridge._TO_PORT["grouped"](out_w))
    state = steps.init_train_state(cfg, init_tap(torch.Generator().manual_seed(0), cfg), cg)
    with pytest.raises(ValueError, match="gather_modules"):
        checkpoint.save_checkpoint(str(tmp_path / "x.ckpt"), state, cfg, iteration=0, epoch=0,
                                   best_val_score=0.0)
