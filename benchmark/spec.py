"""A configuration file's flags read as the widths the yardstick needs.

A file under ``benchmark/configs/`` names its model by the reference's
command-line flags (``flags``: flag name -> value).  The port parses the
same flags with its own parser; the reference, the weights and the
arithmetic read them here, without the port.  Every width the yardstick
uses is a flag of the file: a missing one raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Spec:
    caption_model: str
    video_dim: int  # D, C3D width
    hidden_dim: int  # SST's H
    K: int  # anchors a frame
    rnn_num_layers: int
    lda_dim: int
    video_context_type: str
    event_context_type: str
    clip_context_type: str
    fusion_model: str
    n_head: int
    d_feats: int
    d_o: int
    use_posit: bool
    fST_type: str
    H: int  # CG_rnn_size
    E: int  # CG_input_encoding_size
    Hatt: int  # CG_att_hid_size
    vocab: int  # CG_vocab_size (the logits have vocab + 1 columns, 0 = END)
    seq_length: int  # CG_seq_length
    compute_dtype: str
    beam_length_alpha: float

    @property
    def Dv(self) -> int:
        t = self.video_context_type
        return (("VL" in t) * self.lda_dim + ("VC" in t) * self.video_dim
                + ("VH" in t) * self.hidden_dim)

    @property
    def uses_tsrm(self) -> bool:
        return "TSRM" in self.fusion_model and "ER" in self.event_context_type

    @property
    def tsrm_in(self) -> int:
        t = self.event_context_type
        if "ER1" in t:
            return self.video_dim
        if "ER2" in t:
            return self.hidden_dim
        return self.video_dim + self.hidden_dim

    @property
    def De(self) -> int:
        if "ER" in self.event_context_type:
            return self.d_o
        t = self.event_context_type
        return ("EC" in t) * self.video_dim + ("EH" in t) * self.hidden_dim

    @property
    def Dc(self) -> int:
        t = self.clip_context_type
        return ("CC" in t) * self.video_dim + ("CH" in t) * self.hidden_dim

    @property
    def logit_in(self) -> int:
        from benchmark.reference.cores import core_module

        return core_module(self.caption_model).LOGIT_WIDTH * self.H


_FLAGS = {  # Spec field -> flag
    "caption_model": "caption_model", "video_dim": "video_dim", "hidden_dim": "hidden_dim",
    "K": "K", "rnn_num_layers": "rnn_num_layers", "lda_dim": "lda_dim",
    "video_context_type": "video_context_type", "event_context_type": "event_context_type",
    "clip_context_type": "clip_context_type", "fusion_model": "fusion_model",
    "n_head": "n_head", "d_feats": "d_feats", "d_o": "d_o", "use_posit": "use_posit",
    "fST_type": "fST_type", "H": "CG_rnn_size", "E": "CG_input_encoding_size",
    "Hatt": "CG_att_hid_size", "vocab": "CG_vocab_size", "seq_length": "CG_seq_length",
    "compute_dtype": "compute_dtype",
    "beam_length_alpha": "beam_length_alpha",
}


def spec_of(flags: Dict) -> Spec:
    missing = [f for f in _FLAGS.values() if f not in flags]
    if missing:
        raise ValueError(f"configuration flags lack {missing}")
    kw = {field: flags[flag] for field, flag in _FLAGS.items()}
    kw["use_posit"] = bool(kw["use_posit"])
    return Spec(**kw)


def argv_of(flags: Dict) -> list:
    """The flags as a command line for the port's parser."""
    argv = []
    for k, v in flags.items():
        vals = v if isinstance(v, (list, tuple)) else [v]
        argv += [f"--{k}", *(str(int(x)) if isinstance(x, bool) else str(x) for x in vals)]
    return argv
