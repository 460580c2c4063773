"""Checkpoints in echr_tpu's format v2 (echr_tpu/engine/checkpoint.py),
written and read by the port.

One class-free file format for both packages: the pickle holds only
dicts, lists, numpy arrays and numbers, so each package resumes, serves and
evaluates the other's checkpoints.  The payload keys are echr_tpu's:
``format_version`` (2), ``state``, ``config_json``, ``iteration``,
``epoch``, ``best_val_score``, ``loader_state``, ``histories``, ``vocab``
and ``extra``, written through ``path + ".tmp"`` and ``os.replace``, with
the config also in a ``.config.json`` sidecar.

``state`` holds ``tap_params`` and ``cg_params`` as the JAX param trees
(``bridge``), ``step``, and ``tap_opt`` / ``cg_opt`` as the dicts that
flax.serialization.to_state_dict makes of echr_tpu's optimizer state
(``inject_hyperparams`` over a five-entry chain: clip, weight decay or
identity, ``scale_by_adam``, scale(-1), the learning rate):

    {"count", "hyperparams": {"learning_rate"}, "hyperparams_states": {},
     "inner_state": {"0": {}, "1": {}, "2": {"count", "mu", "nu"},
                     "3": {}, "4": {}}}

where mu / nu are torch Adam's ``exp_avg`` / ``exp_avg_sq`` in the JAX
layout, with every list of the param tree written as a dict keyed "0",
"1", ... as flax does, and both counts are torch's per-parameter ``step``
(one value per model: every parameter of a model steps together).  A
model the run never stepped has no torch state; it is written as optax's
init writes it, count 0 and zero moments, and such a state loads as torch
step 0 with zero moments, which steps exactly like a fresh Adam.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from echr_tpu_torch import bridge
from echr_tpu_torch.config import Config
from echr_tpu_torch.engine.steps import TrainState, init_train_state

FORMAT_VERSION = 2
_ADAM = "2"  # scale_by_adam's index in echr_tpu's optimizer chain
_CHAIN = ("0", "1", _ADAM, "3", "4")


def _as_state_dict(tree):
    """flax.serialization.to_state_dict of a param tree: lists become
    dicts keyed "0", "1", ..."""
    if isinstance(tree, (list, tuple)):
        return {str(i): _as_state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _as_state_dict(v) for k, v in tree.items()}
    return tree


def _specs(state: TrainState, cfg: Config):
    """(name, JAX spec, TSRM groups, optimizer) of each model."""
    return (("tap", bridge.tap_spec(state.tap), 1, state.tap_opt),
            ("cg", bridge.captioner_spec(state.cg), cfg.fusion.n_head, state.cg_opt))


def _params(opt: torch.optim.Adam):
    return [p for group in opt.param_groups for p in group["params"]]


def _opt_to_dict(opt: torch.optim.Adam, spec, groups: int) -> Dict[str, Any]:
    params = _params(opt)
    stepped = [p for p in params if opt.state.get(p)]
    counts = {int(opt.state[p]["step"]) for p in stepped}
    if stepped and (len(stepped) != len(params) or len(counts) != 1):
        raise ValueError(f"Adam state of {len(stepped)} of {len(params)} parameters, steps "
                         f"{sorted(counts)}: optax keeps one count for the whole model")
    count = np.asarray(counts.pop() if counts else 0, np.int32)

    def moment(key):
        return _as_state_dict(bridge.export_tree(
            spec, groups, lambda p: opt.state[p][key] if stepped else torch.zeros_like(p)))

    inner = {k: {} for k in _CHAIN}
    inner[_ADAM] = {"count": count.copy(), "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}
    return {"count": count,
            "hyperparams": {"learning_rate": np.asarray(opt.param_groups[0]["lr"], np.float32)},
            "hyperparams_states": {}, "inner_state": inner}


def _opt_from_dict(opt: torch.optim.Adam, spec, sd: Dict[str, Any]) -> None:
    adam = sd["inner_state"][_ADAM]
    count = int(np.asarray(adam["count"]))
    moments: Dict[str, Dict[torch.Tensor, torch.Tensor]] = {"exp_avg": {}, "exp_avg_sq": {}}
    for key, tree in (("exp_avg", adam["mu"]), ("exp_avg_sq", adam["nu"])):
        bridge.import_tree(spec, tree, lambda p, t, key=key: moments[key].__setitem__(p, t))
    for group in opt.param_groups:
        group["lr"] = float(np.asarray(sd["hyperparams"]["learning_rate"]))
    for p in _params(opt):
        # torch keeps a non-capturable Adam's step on the CPU, as f32
        opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": moments["exp_avg"][p].to(p.device),
                        "exp_avg_sq": moments["exp_avg_sq"][p].to(p.device)}


def _state_to_dict(state: TrainState, cfg: Config) -> Dict[str, Any]:
    specs = _specs(state, cfg)
    out = {f"{name}_params": bridge.export_tree(spec, groups)
           for name, spec, groups, _ in specs}
    out.update({f"{name}_opt": _opt_to_dict(opt, spec, groups)
                for name, spec, groups, opt in specs})
    out["step"] = np.asarray(state.step, np.int32)
    return out


def _state_from_dict(sd: Dict[str, Any], cfg: Config, device) -> TrainState:
    """A live TrainState on ``device``: the modules from the param trees,
    fresh optimizers (make_optimizer) whose state and learning rate come
    from the file."""
    state = init_train_state(cfg, bridge.tap_from_jax(sd["tap_params"], cfg, device),
                             bridge.captioner_from_jax(sd["cg_params"], cfg, device))
    for name, spec, _, opt in _specs(state, cfg):
        _opt_from_dict(opt, spec, sd[f"{name}_opt"])
    state.step = int(np.asarray(sd["step"]))
    return state


def save_checkpoint(path: str, state: TrainState, cfg: Config, *, iteration: int, epoch: int,
                    best_val_score: float, loader_state: Optional[Dict] = None,
                    histories: Optional[Dict] = None, vocab: Optional[Dict] = None,
                    extra: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "format_version": FORMAT_VERSION,
        "state": _state_to_dict(state, cfg),
        "config_json": cfg.to_json(),
        "iteration": iteration,
        "epoch": epoch,
        "best_val_score": best_val_score,
        "loader_state": loader_state,
        "histories": histories or {},
        "vocab": vocab,
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    with open(path + ".config.json", "w") as f:
        f.write(cfg.to_json())


def _read(path: str) -> Dict[str, Any]:
    """The raw format-v2 payload with "config" (a Config) added, from the
    .config.json sidecar or else the embedded config_json."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    version = payload.get("format_version", 1)
    if version != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path} has format_version {version}; echr_tpu_torch "
            "reads format 2 only (re-save a v1 checkpoint with echr_tpu)")
    sidecar = path + ".config.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            payload["config"] = Config.from_json(f.read())
    elif payload.get("config_json"):
        payload["config"] = Config.from_json(payload["config_json"])
    else:
        raise ValueError(f"checkpoint {path} has neither a .config.json sidecar "
                         "nor an embedded config_json")
    return payload


def load_checkpoint(path: str, device="cuda", *, rebuild_state: bool = True) -> Dict[str, Any]:
    """Read a format-v2 checkpoint of either package.  Returns the payload
    with "config" and with "state" as a live TrainState on ``device``
    (rebuild_state=False keeps the raw state dict, on no device)."""
    payload = _read(path)
    if rebuild_state:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"load_checkpoint(device={device!r}): CUDA is not available")
        payload["state"] = _state_from_dict(payload["state"], payload["config"], dev)
    return payload


def load_params_only(path: str, which: str = "tap_cg") -> Dict[str, Any]:
    """Warm-start weights only (reference pretrain semantics,
    train.py:183-194): which in {'tap', 'cg', 'tap_cg'}; numpy trees."""
    state = _read(path)["state"]
    out = {}
    if which in ("tap", "tap_cg"):
        out["tap_params"] = state["tap_params"]
    if which in ("cg", "tap_cg"):
        out["cg_params"] = state["cg_params"]
    return out


def load_checkpoint_params(path: str):
    """(cfg, tap_params, cg_params, vocab) of a format-v2 checkpoint:
    numpy param trees, for serving."""
    payload = _read(path)
    state = payload["state"]
    return payload["config"], state["tap_params"], state["cg_params"], payload.get("vocab")
