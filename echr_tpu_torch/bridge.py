"""JAX param trees <-> the port's modules.

echr_tpu keeps its params as nested dicts / lists of arrays; given as
numpy (what a format-v2 checkpoint stores), they become the port's
modules here, and the port's modules export back to the same tree.
Layout rules (as tests/oracle_torch.py and echr_tpu/compat/torch_import.py):

  * a Linear is w [in, out] in JAX and weight [out, in] here;
  * an LSTM cell keeps the gate order i, f, g, o (w_ih / w_hh transpose);
  * TSRM's out_w [g, d, d_o/g] becomes the grouped projection's
    weight [d_o, d], rows of group i at [i * d_o/g, (i+1) * d_o/g).

The same rules carry any per-parameter tensor of the port's layout, such
as Adam's moments (``export_tree`` / ``import_tree``).

Tensor parallelism: ``captioner_from_jax(..., shard=(m, tp[, group]))``
gives rank m's sharded captioner (``parallel.mesh.shard_captioner``) of a
whole JAX tree, and ``captioner_to_jax`` of a sharded captioner gathers
it over its tp group (a collective: every rank of the group calls it) and
gives the whole tree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch
from torch import nn

from echr_tpu_torch.config import Config
from echr_tpu_torch.models.captioner import Captioner
from echr_tpu_torch.models.sst import SST
from echr_tpu_torch.ops.attention import AdditiveAttention
from echr_tpu_torch.ops.core import Dense
from echr_tpu_torch.ops.recurrent import LSTMCell
from echr_tpu_torch.parallel.mesh import gather_captioner, shard_captioner

# leaf transforms: JAX array -> port tensor layout, and back
_TO_PORT = {
    "id": lambda a: a,
    "T": lambda a: a.T,
    "grouped": lambda a: np.transpose(a, (0, 2, 1)).reshape(-1, a.shape[1]),
}


def _from_port(kind: str, x: np.ndarray, groups: int = 1) -> np.ndarray:
    if kind == "T":
        return x.T
    if kind == "grouped":
        d_o, d = x.shape
        return np.transpose(x.reshape(groups, d_o // groups, d), (0, 2, 1))
    return x


def _dense(d: Dense) -> Dict[str, Any]:
    s = {"w": (d.weight, "T")}
    if d.bias is not None:
        s["b"] = (d.bias, "id")
    return s


def _cell(c: LSTMCell) -> Dict[str, Any]:
    s = {"w_ih": (c.weight_ih, "T"), "w_hh": (c.weight_hh, "T")}
    if c.bias_ih is not None:
        s["b_ih"] = (c.bias_ih, "id")
        s["b_hh"] = (c.bias_hh, "id")
    return s


def tap_spec(sst: SST) -> Dict[str, Any]:
    """The JAX tree of init_sst, with (port parameter, transform) leaves."""
    s = {"rnn": [_cell(c) for c in sst.rnn], "scores": _dense(sst.scores)}
    if sst.reduce_dim is not None:
        s["reduce_dim"] = _dense(sst.reduce_dim)
    return s


def _core_spec(core: nn.Module) -> Dict[str, Any]:
    """The core's tree from its own children: a cell as layer0, layer1,
    ..., a stack of cells as the list "layers", the attention's three
    Linears under "attention"."""
    s: Dict[str, Any] = {}
    for name, m in core.named_children():
        if isinstance(m, LSTMCell):
            s[name] = _cell(m)
        elif isinstance(m, nn.ModuleList):
            s[name] = [_cell(c) for c in m]
        elif isinstance(m, AdditiveAttention):
            s[name] = {k: _dense(getattr(m, k)) for k in ("ctx2att", "h2att", "alpha_net")}
        else:
            raise TypeError(f"core child {name}: {type(m).__name__} has no JAX layout")
    return s


def captioner_spec(cg: Captioner) -> Dict[str, Any]:
    """The JAX tree of init_captioner, with (port parameter, transform)
    leaves."""
    dec = cg.decoder
    d = {
        "embed": (dec.embed, "id"),
        "logit": _dense(dec.logit),
        "core": _core_spec(dec.core),
    }
    if dec.init_linear is not None:
        d["init_linear"] = _dense(dec.init_linear)
    s = {"decoder": d}
    if cg.fusion is not None:
        f = cg.fusion
        s["fusion"] = {
            "event_emb": _dense(f.event_emb),
            "query": _dense(f.query),
            "key": _dense(f.key),
            "out_w": (f.out.weight, "grouped"),
            "out_b": (f.out.bias, "id"),
        }
        if f.pair_pos_fc1 is not None:
            s["fusion"]["pair_pos_fc1"] = _dense(f.pair_pos_fc1)
            s["fusion"]["pair_pos_fc2"] = _dense(f.pair_pos_fc2)
    return s


def import_tree(spec, tree, store: Callable[[torch.Tensor, torch.Tensor], None],
                path: str = "") -> None:
    """Walk a JAX-layout tree (numpy leaves) along ``spec`` and call
    store(port parameter, tensor in the port's layout) for every leaf.  A
    list of the spec may come as flax's state dict of a list, a dict keyed
    "0", "1", ... (an optax state's moments in a checkpoint)."""
    if isinstance(spec, tuple):
        param, kind = spec
        arr = np.array(_TO_PORT[kind](np.asarray(tree, np.float32)), order="C")
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {arr.shape} does not fit {tuple(param.shape)}")
        store(param, torch.from_numpy(arr))
        return
    if isinstance(spec, list):
        if isinstance(tree, dict) and set(tree) == {str(i) for i in range(len(spec))}:
            tree = [tree[str(i)] for i in range(len(spec))]
        if not isinstance(tree, (list, tuple)) or len(tree) != len(spec):
            raise ValueError(f"{path}: expected a list of {len(spec)}")
        for i, (s, t) in enumerate(zip(spec, tree)):
            import_tree(s, t, store, f"{path}[{i}]")
        return
    if set(spec) != set(tree):
        raise ValueError(f"{path}: keys {sorted(tree)} differ from {sorted(spec)}")
    for k in spec:
        import_tree(spec[k], tree[k], store, f"{path}.{k}")


def _copy_into(param: torch.Tensor, value: torch.Tensor) -> None:
    with torch.no_grad():
        param.copy_(value)


def export_tree(spec, groups: int,
                value: Callable[[torch.Tensor], torch.Tensor] = lambda p: p):
    """The JAX-layout tree (numpy leaves) of value(parameter) for every
    leaf of ``spec``: the parameters themselves by default."""
    if isinstance(spec, tuple):
        param, kind = spec
        return np.ascontiguousarray(
            _from_port(kind, value(param).detach().cpu().numpy(), groups))
    if isinstance(spec, list):
        return [export_tree(s, groups, value) for s in spec]
    return {k: export_tree(v, groups, value) for k, v in spec.items()}


def tap_from_jax(tree, cfg: Config, device="cpu") -> SST:
    """An init_sst-shaped tree (numpy leaves) -> SST on ``device``."""
    t = cfg.tap
    sst = SST(t.video_dim, t.hidden_dim, t.K, t.rnn_num_layers,
              raw_input_dim=t.raw_input_dim if t.reduce_input_dim_layer else 0)
    import_tree(tap_spec(sst), tree, _copy_into, "tap")
    return sst.to(device)


def captioner_from_jax(tree, cfg: Config, device="cpu", shard=None) -> Captioner:
    """An init_captioner-shaped tree (numpy leaves) -> Captioner; with
    ``shard`` (m, tp) or (m, tp, tp group) rank m's block of it on the
    model axis."""
    cg = Captioner(cfg)
    import_tree(captioner_spec(cg), tree, _copy_into, "captioner")
    if shard is not None:
        shard_captioner(cg, *shard)
    return cg.to(device)


def tap_to_jax(sst: SST):
    return export_tree(tap_spec(sst), 1)


def captioner_to_jax(cg: Captioner, cfg: Config):
    """The whole init_captioner tree of a whole or a sharded captioner."""
    return export_tree(captioner_spec(gather_captioner(cg)[0]), cfg.fusion.n_head)
