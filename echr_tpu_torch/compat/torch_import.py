"""Reference-trained ``.pth`` checkpoints into the port's modules
(echr_tpu/compat/torch_import.py, the port's copy).

The reference saves ``{'tap_model': state_dict, 'cg_model': state_dict,
...}`` (reference: train.py:456-467).  The state_dicts are first mapped
onto echr_tpu's parameter-tree layout (numpy leaves), which
``bridge.tap_from_jax`` / ``bridge.captioner_from_jax`` then load:

  * Linear: weight [out, in] -> w [in, out], bias -> b;
  * LSTM / LSTMCell: weight_ih / hh [4H, in] -> w_ih / hh [in, 4H], the
    biases as they are (the same i, f, g, o gate order);
  * TSRM's grouped 1x1 conv: weight [d_o, d, 1, 1] -> out_w [g, d, d_o/g];
  * parameters the model does not read (h2a_layer, ThreeStream's
    fusion_layer, ...) are ignored.

Covers what echr_tpu's importer covers: the SST, the TSRM, and the
three_stream and show_attend_tell decoders; any other caption core
raises NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from echr_tpu_torch.bridge import captioner_from_jax, tap_from_jax
from echr_tpu_torch.config import Config
from echr_tpu_torch.models.captioner import Captioner
from echr_tpu_torch.models.sst import SST


def _lin(sd: Dict, prefix: str):
    p = {"w": np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight"]).T)}
    if f"{prefix}.bias" in sd:
        p["b"] = np.asarray(sd[f"{prefix}.bias"])
    return p


def _cell(sd: Dict, prefix: str):
    p = {"w_ih": np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight_ih"]).T),
         "w_hh": np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight_hh"]).T)}
    if f"{prefix}.bias_ih" in sd:
        p["b_ih"] = np.asarray(sd[f"{prefix}.bias_ih"])
        p["b_hh"] = np.asarray(sd[f"{prefix}.bias_hh"])
    return p


def _lstm_layers(sd: Dict, prefix: str, num_layers: int, bias: bool = True):
    layers = []
    for l in range(num_layers):
        p = {"w_ih": np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight_ih_l{l}"]).T),
             "w_hh": np.ascontiguousarray(np.asarray(sd[f"{prefix}.weight_hh_l{l}"]).T)}
        if bias and f"{prefix}.bias_ih_l{l}" in sd:
            p["b_ih"] = np.asarray(sd[f"{prefix}.bias_ih_l{l}"])
            p["b_hh"] = np.asarray(sd[f"{prefix}.bias_hh_l{l}"])
        layers.append(p)
    return layers


def _attention(sd: Dict, prefix: str):
    return {k: _lin(sd, f"{prefix}.{k}") for k in ("ctx2att", "h2att", "alpha_net")}


def import_tap_state_dict(sd: Dict, cfg: Config):
    """The reference SST's state_dict -> echr_tpu's init_sst tree."""
    p = {"rnn": _lstm_layers(sd, "rnn", cfg.tap.rnn_num_layers), "scores": _lin(sd, "scores")}
    if "reduce_dim_layer.weight" in sd:
        p["reduce_dim"] = _lin(sd, "reduce_dim_layer")
    return p


def _import_tsrm(sd: Dict, cfg: Config, prefix: str = "fusion_model"):
    f = cfg.fusion
    conv_w = np.asarray(sd[f"{prefix}.enc_attn.linear_out_1.weight"])  # [d_o, d, 1, 1]
    g, og = f.n_head, f.d_o // f.n_head
    out_w = conv_w[:, :, 0, 0].reshape(g, og, f.d_feats).transpose(0, 2, 1)
    p = {"event_emb": _lin(sd, f"{prefix}.event_emb"),
         "query": _lin(sd, f"{prefix}.enc_attn.query_1"),
         "key": _lin(sd, f"{prefix}.enc_attn.key_1"),
         "out_w": np.ascontiguousarray(out_w),
         "out_b": np.asarray(sd[f"{prefix}.enc_attn.linear_out_1.bias"])}
    if f.use_posit:
        p["pair_pos_fc1"] = _lin(sd, f"{prefix}.enc_attn.pair_pos_fc1")
        p["pair_pos_fc2"] = _lin(sd, f"{prefix}.enc_attn.pair_pos_fc2")
    return p


def import_cg_state_dict(sd: Dict, cfg: Config):
    """The reference CaptionGenerator's state_dict (keys 'lm_model.*' and
    'fusion_model.*') -> echr_tpu's init_captioner tree."""
    m = cfg.decoder.caption_model
    dec = {"embed": np.asarray(sd["lm_model.embed.weight"]), "logit": _lin(sd, "lm_model.logit")}
    if m == "three_stream":
        dec["core"] = {"layer0": _cell(sd, "lm_model.core.layer0"),
                       "layer1": _cell(sd, "lm_model.core.layer1"),
                       "layer2": _cell(sd, "lm_model.core.layer2"),
                       "attention": _attention(sd, "lm_model.core.attention")}
    elif m == "show_attend_tell":
        # the reference's nn.LSTM here is built with bias=False
        dec["core"] = {"layers": _lstm_layers(sd, "lm_model.core.rnn",
                                              cfg.decoder.CG_num_layers, bias=False),
                       "attention": _attention(sd, "lm_model.core")}
    else:
        raise NotImplementedError(f"torch import for caption_model {m!r}")
    if "lm_model.init_linear.weight" in sd:
        dec["init_linear"] = _lin(sd, "lm_model.init_linear")
    params = {"decoder": dec}
    if cfg.uses_tsrm:
        params["fusion"] = _import_tsrm(sd, cfg)
    return params


def import_reference_checkpoint(pth_path: str, cfg: Config, device="cuda"
                                ) -> Tuple[SST, Captioner]:
    """A reference .pth (train.py:456-461: a torch.save'd dict with the
    'tap_model' and 'cg_model' state_dicts) -> the port's (SST, Captioner)
    on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"import_reference_checkpoint(device={device!r}): "
                           "CUDA is not available")
    payload = torch.load(pth_path, map_location="cpu", weights_only=True)
    tap_sd = {k: v.numpy() for k, v in payload["tap_model"].items()}
    cg_sd = {k: v.numpy() for k, v in payload["cg_model"].items()}
    return (tap_from_jax(import_tap_state_dict(tap_sd, cfg), cfg, dev),
            captioner_from_jax(import_cg_state_dict(cg_sd, cfg), cfg, dev))
