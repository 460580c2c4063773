"""Caption generator: hierarchical contexts + decoder
(echr_tpu/models/captioner.py): contexts, the teacher-forced training
forward and fused loss, greedy or multinomial decode (``captioner_sample``)
and SCST's two rollouts (``captioner_train_rl``), each over a batch of
videos.  Contexts run in f32 (make_contexts' default, as in the
reference); the decoder in the compute dtype."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from echr_tpu_torch.config import Config
from echr_tpu_torch.models.contexts import Contexts, build_contexts
from echr_tpu_torch.models.decoder import (
    Decoder,
    decoder_forward,
    decoder_sample_batched,
    teacher_forced_nll,
)
from echr_tpu_torch.models.tsrm import TSRM
from echr_tpu_torch.utils.profiling import span


class ProposalBatch(NamedTuple):
    """Statically shaped proposal selection, batched over videos."""

    ind_select: torch.Tensor  # [B, N] int
    soi: torch.Tensor  # [B, N, 2] int
    prop_mask: torch.Tensor  # [B, N] float


class Captioner(nn.Module):
    """Fusion (TSRM, when the config routes events through it) + decoder."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.fusion = TSRM(cfg) if cfg.uses_tsrm else None
        self.decoder = Decoder(cfg)


def make_contexts(
    cg: Captioner,
    cfg: Config,
    tap_feats: torch.Tensor,
    c3d_feats: torch.Tensor,
    lda_feats: torch.Tensor,
    props: ProposalBatch,
    frame_mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
    train: bool = False,
    gen: Optional[torch.Generator] = None,
) -> Contexts:
    """The decoder's contexts (TSRM over the events where the config routes
    them through it); ``make_contexts.host_ns``: the host's time issuing
    them."""
    with span("decode.contexts", make_contexts):
        return build_contexts(cg.fusion, cfg, tap_feats, c3d_feats, lda_feats,
                              props.ind_select, props.soi, props.prop_mask,
                              frame_mask=frame_mask, dtype=dtype, train=train, gen=gen)


make_contexts.host_ns = 0


def captioner_train_forward(
    cg: Captioner,
    cfg: Config,
    tap_feats: torch.Tensor,  # [B, T, H]
    c3d_feats: torch.Tensor,  # [B, T, D]
    lda_feats: torch.Tensor,  # [B, lda_dim]
    cg_labels: torch.Tensor,  # [B, N, L+1]
    props: ProposalBatch,
    frame_mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,  # the decoder's compute dtype
    train: bool = True,
    gen: Optional[torch.Generator] = None,
    ss_prob: float = 0.0,
) -> torch.Tensor:
    """Teacher-forced logprobs [B, N, L, V+1] (mode 'train')."""
    ctxs = make_contexts(cg, cfg, tap_feats, c3d_feats, lda_feats, props, frame_mask,
                         train=train, gen=gen)
    return decoder_forward(cg.decoder, cfg, ctxs, cg_labels, dtype, train, gen, ss_prob)


def captioner_train_loss(
    cg: Captioner,
    cfg: Config,
    tap_feats: torch.Tensor,
    c3d_feats: torch.Tensor,
    lda_feats: torch.Tensor,
    cg_labels: torch.Tensor,  # [B, N, L+1]
    cg_masks: torch.Tensor,  # [B, N, L+1]
    props: ProposalBatch,
    frame_mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
    train: bool = True,
    gen: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Per-video caption NLL [B] with the fused loss head: equals
    language_model_loss(captioner_train_forward(...), cg_labels[..., 1:],
    cg_masks[..., 1:]) without the [B, N, L, V+1] logprobs."""
    ctxs = make_contexts(cg, cfg, tap_feats, c3d_feats, lda_feats, props, frame_mask,
                         train=train, gen=gen)
    return teacher_forced_nll(cg.decoder, cfg, ctxs, cg_labels, cg_masks, dtype, train, gen)


def captioner_sample(
    cg: Captioner,
    cfg: Config,
    tap_feats: torch.Tensor,
    c3d_feats: torch.Tensor,
    lda_feats: torch.Tensor,
    props: ProposalBatch,
    frame_mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
    greedy: bool = True,
    temperature: float = 1.0,
    sample_gen: Optional[torch.Generator] = None,
    train: bool = False,
    gen: Optional[torch.Generator] = None,
    early_exit: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy or multinomial decode of B videos' proposals (mode 'eval';
    reference: CaptionGenerator.py:39-44): (seq [B, N, L], per-step logps
    [B, N, L], active [B, L]).  Draws come from ``sample_gen``, dropout
    (with ``train``) from ``gen``; ``early_exit`` as decoder_sample_batched."""
    ctxs = make_contexts(cg, cfg, tap_feats, c3d_feats, lda_feats, props, frame_mask,
                         train=train, gen=gen)
    return decoder_sample_batched(cg.decoder, cfg, ctxs, dtype, greedy, temperature, sample_gen,
                                  train, gen, early_exit=early_exit)


def captioner_train_rl(
    cg: Captioner,
    cfg: Config,
    tap_feats: torch.Tensor,
    c3d_feats: torch.Tensor,
    lda_feats: torch.Tensor,
    props: ProposalBatch,
    sample_gen: torch.Generator,
    frame_mask: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.float32,
    gen: Optional[torch.Generator] = None,
):
    """Mode 'train_rl' (reference: CaptionGenerator.py:32-38): a multinomial
    rollout with train-mode contexts and dropout, and a greedy baseline
    with eval-mode contexts.  Returns ((gen_seq, gen_logps), (greedy_seq,
    greedy_logps)).  The SCST step (engine/steps.rl_rollout_step_batched)
    feeds the two its own train- and eval-mode SST features instead."""
    gen_seq, gen_logps, _ = captioner_sample(cg, cfg, tap_feats, c3d_feats, lda_feats, props,
                                             frame_mask, dtype, greedy=False,
                                             sample_gen=sample_gen, train=True, gen=gen)
    greedy_seq, greedy_logps, _ = captioner_sample(cg, cfg, tap_feats, c3d_feats, lda_feats,
                                                   props, frame_mask, dtype)
    return (gen_seq, gen_logps), (greedy_seq, greedy_logps)


def captioner_sample_one(
    cg: Captioner,
    cfg: Config,
    tap_feats: torch.Tensor,  # [T, H]
    c3d_feats: torch.Tensor,  # [T, D]
    lda_feats: torch.Tensor,  # [lda_dim]
    props: ProposalBatch,  # [N] rows
    frame_mask: Optional[torch.Tensor] = None,  # [T]
    dtype: torch.dtype = torch.float32,
    greedy: bool = True,
    temperature: float = 1.0,
    sample_gen: Optional[torch.Generator] = None,
    train: bool = False,
    gen: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One video's decode (echr_tpu's per-video captioner_sample):
    captioner_sample on a batch of one, its loop chosen by
    runtime.decode_early_exit.  Returns (seq [N, L], logps [N, L], active
    [L])."""
    seq, logps, active = captioner_sample(
        cg, cfg, tap_feats[None], c3d_feats[None], lda_feats[None],
        ProposalBatch(*(x[None] for x in props)),
        None if frame_mask is None else frame_mask[None], dtype, greedy, temperature,
        sample_gen, train, gen, early_exit=bool(cfg.runtime.decode_early_exit))
    return seq[0], logps[0], active[0]
