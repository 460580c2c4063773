"""The configuration tree (echr_tpu/config.py), the port's own copy.

Immutable dataclasses with the reference's field names, so that
``Config.from_json`` reads the JSON that echr_tpu writes beside a
checkpoint (its ``.config.json`` sidecar or embedded ``config_json``) and
``to_json`` writes JSON that echr_tpu reads.  Derived dimensions are
properties, as in echr_tpu.

RuntimeConfig holds only the runtime fields the port reads:
``compute_dtype``, ``transfer_dtype``, ``use_pallas`` (the decode kernels),
``use_pallas_train`` (the training kernels), ``use_pallas_head`` (kernel 2
alone), ``sort_decode_props``, ``decode_early_exit`` (the per-video decode
and beam loop) and ``decode_early_exit_batched`` (the batched ones),
``fused_loss_head``, ``scst_resident_vjp`` (SCST's update from the
rollout's own graph), ``hang_warn_s`` (the eval loop's watchdog),
``train_pipeline`` and ``train_inflight`` (the pipelined train loop),
``mesh_shape`` (the (dp, tp) layout, checked against the group's size) and
``preempt_check_every`` (the ranks' preemption agreement).  echr_tpu's
other runtime fields are TPU and XLA knobs (mesh axis names, SPMD mode,
buffer donation, the Pallas T ceilings) or a field echr_tpu never reads
(``param_dtype``); they are dropped.
``from_json`` ignores them in echr_tpu's JSON, and ``replace_in`` and the
CLI parser (``build_argparser`` / ``parse_config``, echr_tpu's flag
surface) reject them, so setting one fails instead of doing nothing.
echr_tpu reads the port's JSON with its defaults for them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Dataset paths and label-synthesis knobs."""

    dataset: str = "ActivityNet"
    video_json: str = "data/video_data_with_annotation.json"
    input_c3d_dir2: str = "data/c3d_npy"
    input_lda_path: str = "data/lda.h5"
    video_data_for_cg: str = "data/train_val_video_data.json"
    train_label_for_cg: str = "data/train_label_for_lm.h5"
    val_label_for_cg: str = "data/val_label_for_lm.h5"
    w1_json: str = "data/w1.json"
    SOTA_json: Optional[str] = None
    use_c3d_feature: bool = True
    use_2stream_feature: bool = False
    input_twostream_dir: str = "data/twostream"
    other_features: Tuple[str, ...] = ("lda",)
    lda_dim: int = 200
    shuffle: bool = True
    nthreads: int = 4
    prefetch: int = 4  # prefetch-queue depth per split
    dropsent_mode: str = "nodrop"  # nodrop | insert | truncate
    train_only: int = 0
    # frame-axis buckets: a video is padded to the smallest bucket >= T
    time_buckets: Tuple[int, ...] = (64, 128, 192, 256, 384, 512, 768, 1024)
    synthetic: bool = False
    synthetic_num_videos: int = 64
    synthetic_vocab_size: int = 3000
    synthetic_seq_length: int = 30
    synthetic_learnable: bool = False  # pattern-derived captions
    synthetic_cache_videos: int = 256  # LRU cache of generated examples; 0 = off

    @property
    def use_lda(self) -> bool:
        return "lda" in self.other_features


@dataclass(frozen=True)
class TAPConfig:
    """SST temporal-action-proposal model."""

    tap_model: str = "SST"
    tap_rnn_type: str = "LSTM"
    rnn_num_layers: int = 2
    rnn_dropout: float = 0.5
    video_dim: int = 500
    raw_input_dim: int = 10240
    reduce_input_dim_layer: int = 0
    hidden_dim: int = 512
    K: int = 256
    prop_sample_num: int = 64
    iou_threshold: float = 0.5
    iou_threshold_for_good_proposal: float = 0.8


@dataclass(frozen=True)
class FusionConfig:
    """TSRM cross-event relation attention."""

    fusion_model: str = "TSRM8"
    use_posit: bool = True
    n_head: int = 16
    d_feats: int = 512
    d_o: int = 512
    fST_type: str = "fST0"  # fST0 multiply | fST1 add | fST2 log-add | fST3 pos-only


@dataclass(frozen=True)
class ContextConfig:
    """Hierarchical context composition strings."""

    video_context_type: str = "VL+VC+VH"
    event_context_type: str = "EL+EC+EH+ER1+ER2+ER3"
    clip_context_type: str = "CC+CH"
    CG_input_feats_type: str = ""
    CG_init_feats_type: str = ""


@dataclass(frozen=True)
class DecoderConfig:
    """Caption generator."""

    caption_model: str = "show_attend_tell"
    CG_rnn_size: int = 512
    CG_num_layers: int = 1
    CG_rnn_type: str = "lstm"
    CG_input_encoding_size: int = 512
    CG_att_hid_size: int = 512
    CG_fc_feat_size: int = 512
    CG_drop_prob: float = 0.5
    # filled from the dataset at build time
    CG_vocab_size: int = 0
    CG_seq_length: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and curriculum."""

    training_mode: str = "pre_tap+cotrain"
    tap_epochs: int = 3
    cg_epochs: int = 0
    tapcg_epochs: int = 20
    batch_size: int = 1
    m_batch: int = 1
    lr: float = 5e-5
    lambda1: float = 0.01
    lambda2: float = 1.0
    grad_clip: float = 100.0
    optim: str = "adam"
    optim_alpha: float = 0.9
    optim_beta: float = 0.999
    optim_epsilon: float = 1e-8
    weight_decay: float = 0.0
    scheduled_sampling_start: int = -1
    scheduled_sampling_increase_every: int = 5
    scheduled_sampling_increase_prob: float = 0.05
    scheduled_sampling_max_prob: float = 0.25
    learning_rate_decay_start: float = 8
    learning_rate_decay_every: float = 3
    learning_rate_decay_rate: float = 0.5
    self_critical_after: int = -1
    meteor_reward_weight: float = 1.0
    reverse_w0: bool = False
    seed: int = 0


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation options."""

    language_eval: bool = True
    num_vids_eval: int = 0
    beam_size: int = 1
    sample_max: int = 1  # 1 greedy, 0 multinomial at `temperature`
    temperature: float = 1.0
    # GNMT length penalty exponent for beam ranking; 0.0 = raw sum-logprob
    beam_length_alpha: float = 1.0
    fast_eval_cg: bool = False
    topN: int = 1000
    val_score_thres: float = 0.0
    nms_threshold: float = 0.0
    reranking: bool = False
    val_all_metrics: bool = False
    references: Tuple[str, ...] = ()
    batch_videos: int = 8
    device_select: bool = True
    eval_inflight: int = 3
    meteor_synonyms: str = ""
    meteor_paraphrases: str = ""


@dataclass(frozen=True)
class SaveConfig:
    """Checkpointing and logging."""

    checkpoint_path: str = "save"
    losses_log_every: int = 2000
    save_checkpoint_every: int = 10000
    save_all_checkpoint: bool = False
    min_epoch_when_save: int = -1
    start_from: Optional[str] = None
    start_from_mode: str = "last"
    no_exclude_opt: bool = False
    pretrain: str = ""
    pretrain_path: str = ""


@dataclass(frozen=True)
class RuntimeConfig:
    """Runtime knobs the port reads; see the module docstring."""

    compute_dtype: str = "bfloat16"  # matmul operands; sums stay f32
    # host->device C3D payload: "bfloat16" halves it, and the synchronous
    # loop (SCST, m_batch > 1, batch_size 1) then pays the host cast on its
    # main thread, where the pipelined loop pays it on the producer's
    transfer_dtype: str = "float32"
    use_pallas: bool = True  # the port: the no-grad decode kernels
    use_pallas_train: bool = True  # the port: kernels 3 and 4
    # False: greedy decode takes the plain logits head instead of kernel 2,
    # while kernel 1 stays on (echr_tpu's switch of its streaming head)
    use_pallas_head: bool = True
    sort_decode_props: bool = True  # decode sorts proposals by window start
    # the per-video decode and beam loops: the video's early exit (one host
    # sync a step), or the fixed-L loop; equal outputs either way
    decode_early_exit: bool = True
    decode_early_exit_batched: bool = True  # batched decode: one batch-wide exit
    fused_loss_head: bool = True
    # one process: SCST's sampled rollout keeps its autograd graph across the
    # host reward, and the update backpropagates the reward loss through it
    # instead of replaying the rollout; under a group the two-program steps
    scst_resident_vjp: bool = False
    hang_warn_s: float = 600.0  # watchdog deadline of the eval loop; <= 0 disables it
    # the pipelined train loop (engine/train.py, _TrainPrep): a host thread
    # pulls, compresses and collates, a second uploads, and the metrics of
    # the steps are fetched in deferred batches; the trajectory is the
    # synchronous loop's.  Taken with batch_size > 1, m_batch 1 and no SCST.
    # echr_tpu's default, kept: on an NVIDIA H100 80GB HBM3 at 700.00 W
    # (chip_smoke.py phase 28, B=32 at the flagship width, bf16 compute, f32
    # transfer, 24 pairs in turns over 6 runs of phase 28) it won 13 of 24
    # pairs, median 756.0 against 780.65 ms/step, within the spread between
    # runs; with transfer_dtype "bfloat16" it won all 6
    train_pipeline: bool = True
    # dispatched-but-unfetched steps before the pipelined loop fetches the
    # older half of their metrics, which waits for those steps to finish
    train_inflight: int = 2
    # (dp, tp) over the torch.distributed group (parallel/mesh.check_layout):
    # dp x tp the world size, (1, 1) every rank on the data axis; tp > 1
    # cuts the vocab and TSRM-head leaves over the ranks of a row
    mesh_shape: Tuple[int, int] = (1, 1)
    # under more than one rank, the train loop's iterations between the
    # ranks' agreement on a SIGTERM (an all-reduce MAX of the flag)
    preempt_check_every: int = 16


@dataclass(frozen=True)
class Config:
    run_id: str = "default"
    comment: str = ""
    debug: bool = False
    data: DataConfig = field(default_factory=DataConfig)
    tap: TAPConfig = field(default_factory=TAPConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    context: ContextConfig = field(default_factory=ContextConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    save: SaveConfig = field(default_factory=SaveConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    @property
    def video_context_dim(self) -> int:
        t = self.context.video_context_type
        return (("VL" in t) * self.data.lda_dim + ("VC" in t) * self.tap.video_dim
                + ("VH" in t) * self.tap.hidden_dim)

    @property
    def event_context_dim(self) -> int:
        t = self.context.event_context_type
        if "ER" in t:
            return self.fusion.d_o
        return ("EC" in t) * self.tap.video_dim + ("EH" in t) * self.tap.hidden_dim

    @property
    def clip_context_dim(self) -> int:
        t = self.context.clip_context_type
        return ("CC" in t) * self.tap.video_dim + ("CH" in t) * self.tap.hidden_dim

    @property
    def tsrm_input_dim(self) -> int:
        t = self.context.event_context_type
        if "ER1" in t:
            return self.tap.video_dim
        if "ER2" in t:
            return self.tap.hidden_dim
        if "ER3" in t:
            return self.tap.video_dim + self.tap.hidden_dim
        raise ValueError(f"event_context_type {t!r} selects no ER feature")

    @property
    def uses_tsrm(self) -> bool:
        return "TSRM" in self.fusion.fusion_model and "ER" in self.context.event_context_type

    def validate(self) -> "Config":
        if "L" in self.context.video_context_type:
            assert self.data.use_lda, "video_context_type uses LDA but lda not enabled"
        if self.decoder.caption_model == "three_stream":
            assert self.decoder.CG_num_layers == 3, "three_stream requires CG_num_layers==3"
        assert self.train.batch_size >= 1
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        """Sections and fields that this tree lacks are ignored; JSON lists
        become tuples."""
        kw: Dict[str, Any] = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            if f.name in _SUBCONFIGS:
                sub_cls = _SUBCONFIGS[f.name]
                kw[f.name] = sub_cls(**{
                    sf.name: tuple(v[sf.name]) if isinstance(v[sf.name], list) else v[sf.name]
                    for sf in dataclasses.fields(sub_cls) if sf.name in v})
            else:
                kw[f.name] = v
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def replace_in(self, section: str, **kw: Any) -> "Config":
        """A new Config with fields of one sub-config replaced."""
        sub = dataclasses.replace(getattr(self, section), **kw)
        return dataclasses.replace(self, **{section: sub})


_SUBCONFIGS = {
    "data": DataConfig,
    "tap": TAPConfig,
    "fusion": FusionConfig,
    "context": ContextConfig,
    "decoder": DecoderConfig,
    "train": TrainConfig,
    "eval": EvalConfig,
    "save": SaveConfig,
    "runtime": RuntimeConfig,
}


# ---------------------------------------------------------------------------
# CLI: echr_tpu's flag surface, the reference's flag names (opts.py)
# ---------------------------------------------------------------------------

# flag -> (section, field) for flags whose name matches the dataclass field
_FLAG_MAP: Dict[str, Tuple[str, str]] = {}
for _section, _cls in _SUBCONFIGS.items():
    for _f in dataclasses.fields(_cls):
        _FLAG_MAP.setdefault(_f.name, (_section, _f.name))

# reference flags with singular/plural or renamed spellings
_ALIASES = {
    "tap_epoch": ("train", "tap_epochs"),
    "cg_epoch": ("train", "cg_epochs"),
    "tapcg_epoch": ("train", "tapcg_epochs"),
    "other_feature": ("data", "other_features"),
    "id": (None, "run_id"),
    "save_all": ("save", "save_all_checkpoint"),
}

# reference flags that are declared but never read anywhere in the
# reference (opts.py declares them, no module consumes them): accepted as
# no-ops so reference command lines translate 1:1; setting one logs a notice
_DEAD_FLAGS = (
    "crit_type", "d_pos_emb", "data_type", "diff", "fast_eval_for_challenge",
    "lambda3", "lda_hidden_size", "lda_input_size", "lda_output_size",
    "num_samples", "use_bottomup_feature",
)

# flags the reference declares but overwrites at runtime
# (CaptionGenerator.change_context_dim, CaptionGenerator.py:82-84): derived
# Config properties here, so a passed value is accepted and ignored
_OVERWRITTEN_FLAGS = (
    "video_context_dim", "event_context_dim", "clip_context_dim",
)

# echr_tpu's runtime fields that the port dropped, each a TPU or XLA knob
# or unread: donate_step_args donates jit buffers (an eager step has none
# to donate); mesh_axis_names and spmd_mode name GSPMD's choices (each
# rank's program is explicit); pallas_decode_t_max(_sorted) are the TPU
# kernel's T ceilings (the port's kernels take any T); param_dtype is read
# nowhere in echr_tpu.  A flag setting one is refused, naming it
_DROPPED_RUNTIME_FLAGS = (
    "donate_step_args", "mesh_axis_names", "pallas_decode_t_max",
    "pallas_decode_t_max_sorted", "param_dtype", "spmd_mode",
)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("echr_tpu_torch", allow_abbrev=False)
    p.add_argument("--id", type=str, default=None)
    p.add_argument("--comment", type=str, default=None)
    p.add_argument("--debug", action="store_true", default=None)
    p.add_argument("--config_json", type=str, default=None, help="load a Config JSON first")
    for flag, (section, name) in sorted(_FLAG_MAP.items()):
        cls = _SUBCONFIGS[section]
        f = next(sf for sf in dataclasses.fields(cls) if sf.name == name)
        default = getattr(cls(), name)
        if f.type in ("bool", bool) or isinstance(default, bool):
            # nargs="?" takes both the reference's bare store_true spelling
            # (--fast_eval_cg, opts.py:268) and the valued one
            p.add_argument(f"--{flag}", type=int, nargs="?", const=1, default=None)
        elif isinstance(default, tuple):
            p.add_argument(f"--{flag}", type=str, nargs="+", default=None)
        elif f.type in ("float", float) or isinstance(default, float):
            # the annotation wins over the default's type: a float field with
            # an int default (learning_rate_decay_start=8) takes fractions
            p.add_argument(f"--{flag}", type=float, default=None)
        elif isinstance(default, int):
            p.add_argument(f"--{flag}", type=int, default=None)
        else:
            p.add_argument(f"--{flag}", type=str, default=None)
    for alias in _ALIASES:
        if alias == "id":
            continue
        if alias == "save_all":
            p.add_argument("--save_all", action="store_true", default=None)
        elif alias == "other_feature":
            p.add_argument("--other_feature", type=str, nargs="+", default=None)
        else:
            p.add_argument(f"--{alias}", type=int, default=None)
    for dead in _DEAD_FLAGS + _OVERWRITTEN_FLAGS:
        p.add_argument(f"--{dead}", nargs="?", const="1", default=None,
                       help="accepted no-op (declared but never read, or overwritten at "
                            "runtime, in the reference)")
    for dropped in _DROPPED_RUNTIME_FLAGS:
        p.add_argument(f"--{dropped}", nargs="*", default=None,
                       help="refused: an echr_tpu runtime knob the port does not have")
    return p


def parse_config(argv: Optional[Sequence[str]] = None) -> Config:
    """Parse a reference-style command line into a Config (reference:
    opts.py:3-294), as echr_tpu's parse_config does.  A flag that sets one
    of echr_tpu's dropped runtime fields raises ValueError."""
    plog = logging.getLogger("echr_tpu_torch.config")
    ns, unknown = build_argparser().parse_known_args(argv)
    if unknown:
        plog.warning("ignoring unknown flags: %s", unknown)
    for dropped in _DROPPED_RUNTIME_FLAGS:
        if getattr(ns, dropped) is not None:
            raise ValueError(f"--{dropped} sets echr_tpu's runtime.{dropped}, which "
                             "echr_tpu_torch does not have (a TPU or XLA knob, or a field "
                             "echr_tpu does not read)")
    for dead in _DEAD_FLAGS:
        if getattr(ns, dead, None) is not None:
            plog.info("--%s is declared but never read in the reference; ignored", dead)
    for over in _OVERWRITTEN_FLAGS:
        if getattr(ns, over, None) is not None:
            plog.info("--%s is overwritten at runtime in the reference "
                      "(change_context_dim); derived here, ignored", over)
    cfg = Config()
    if ns.config_json:
        with open(ns.config_json) as fh:
            cfg = Config.from_json(fh.read())

    updates: Dict[str, Dict[str, Any]] = {}
    top: Dict[str, Any] = {}
    for flag, (section, name) in list(_FLAG_MAP.items()) + list(_ALIASES.items()):
        v = getattr(ns, flag, None)
        if v is None:
            continue
        if section is None:
            top[name] = v
            continue
        default = getattr(_SUBCONFIGS[section](), name)
        if isinstance(default, bool):
            v = bool(v)
        elif isinstance(default, tuple):
            v = tuple(v) if isinstance(v, (list, tuple)) else (v,)
            if default and isinstance(default[0], int):
                v = tuple(int(x) for x in v)  # nargs="+" parses strings
        updates.setdefault(section, {})[name] = v
    if ns.comment is not None:
        top["comment"] = ns.comment
    if ns.debug:
        top["debug"] = True

    for section, kw in updates.items():
        cfg = cfg.replace_in(section, **kw)
    if top:
        cfg = cfg.replace(**top)
    if cfg.debug:
        # reference: opts.py:288-293, the --debug preset
        cfg = cfg.replace_in("save", min_epoch_when_save=0, save_checkpoint_every=100,
                             losses_log_every=50)
        cfg = cfg.replace_in("eval", num_vids_eval=10)
        cfg = cfg.replace_in("data", shuffle=False)
    return cfg.validate()


def flagship_config(**overrides: Any) -> Config:
    """The published ECHR stage-2 configuration (reference:
    experiments/train_ECHR.sh): three_stream decoder, TSRM over ER3 event
    features, VL video context, CC clips.  Overrides are ``"section.field"``
    or top-level names."""
    cfg = Config()
    cfg = cfg.replace_in("data", lda_dim=100)
    cfg = cfg.replace_in("context", video_context_type="VL", event_context_type="ER3",
                         clip_context_type="CC", CG_input_feats_type="",
                         CG_init_feats_type="")
    cfg = cfg.replace_in("decoder", caption_model="three_stream", CG_num_layers=3)
    cfg = cfg.replace_in("train", training_mode="pre_cg", tap_epochs=0, cg_epochs=30,
                         tapcg_epochs=0)
    for k, v in overrides.items():
        if "." in k:
            section, name = k.split(".", 1)
            cfg = cfg.replace_in(section, **{name: v})
        else:
            cfg = cfg.replace(**{k: v})
    return cfg.validate()
