"""Model construction with seeded init (echr_tpu/models/registry.py).

Same tree, shapes and uniform bounds as echr_tpu's init_tap /
init_captioner and the *_init functions they call; the values come from
an explicit torch.Generator, so they are not JAX's values.  Modules are
built on the CPU, where the generator draws, and then moved to ``device``.
"""
from __future__ import annotations

import torch

from echr_tpu_torch.config import Config
from echr_tpu_torch.models.captioner import Captioner
from echr_tpu_torch.models.decoder import CORE_REGISTRY
from echr_tpu_torch.models.sst import SST


def init_tap(gen: torch.Generator, cfg: Config, device="cpu") -> SST:
    """SST, the only shipped TAP model."""
    if cfg.tap.tap_model != "SST":
        raise ValueError(f"tap model not supported: {cfg.tap.tap_model}")
    t = cfg.tap
    raw = t.raw_input_dim if t.reduce_input_dim_layer else 0
    sst = SST(t.video_dim, t.hidden_dim, t.K, t.rnn_num_layers, raw_input_dim=raw)
    for cell in sst.rnn:
        cell.init_uniform(gen)
    sst.scores.init_uniform(gen)
    if sst.reduce_dim is not None:
        sst.reduce_dim.init_uniform(gen)
    return sst.to(device)


def init_captioner(gen: torch.Generator, cfg: Config, device="cpu") -> Captioner:
    """Fusion (TSRM) + decoder, for any core of decoder.CORE_REGISTRY."""
    if cfg.uses_tsrm and cfg.fusion.fusion_model != "TSRM8":
        raise ValueError(f"fusion model not supported: {cfg.fusion.fusion_model}")
    cg = Captioner(cfg)
    cg.decoder.init_uniform(gen)
    if cg.fusion is not None:
        cg.fusion.init_uniform(gen)
    return cg.to(device)


def available_caption_models():
    return sorted(CORE_REGISTRY)
