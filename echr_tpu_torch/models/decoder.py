"""Caption decoder, three_stream core, batched greedy decode
(echr_tpu/models/decoder.py).

The ECHR decoder: an embedding and a logit head around three parallel
LSTMCells over the event context, the attended clip frames and the video
context; the core output is concat(h0, h1, h2).  Every tensor carries a
leading video axis B and a proposal axis N.  Decode carries the core
output [B*N, 3H] between steps and selects tokens with the streaming
greedy head (ops/kernel_head): the kernel for CUDA tensors, its plain
version on the CPU.  The other eleven cores of echr_tpu's CORE_REGISTRY,
multinomial and beam decode are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from echr_tpu.config import Config
from echr_tpu_torch.models.contexts import Contexts
from echr_tpu_torch.ops.attention import (
    AdditiveAttention,
    additive_attention_precompute,
    additive_attention_step,
)
from echr_tpu_torch.ops.core import Dense, dense, parameter, uniform_
from echr_tpu_torch.ops.kernel_head import greedy_head, prepare_head
from echr_tpu_torch.ops.masked import window_mean_padded
from echr_tpu_torch.ops.recurrent import LSTMCell, lstm_cell

_NOT_PORTED = ("caption_model {!r} is not ported to echr_tpu_torch yet; only "
               "three_stream is (ROADMAP.md, queue A item 11)")


class DecoderState(NamedTuple):
    h: torch.Tensor  # [3, B, N, H]
    c: torch.Tensor  # [3, B, N, H]


def _init_feats_dim(cfg: Config) -> int:
    t = cfg.context.CG_init_feats_type
    return (("V" in t) * cfg.video_context_dim + ("E" in t) * cfg.event_context_dim
            + ("C" in t) * cfg.clip_context_dim)


class ThreeStreamCore(nn.Module):
    """Three LSTMCells over [word | event], [word | attended clip] and
    [word | video]; the reference's unused fusion_layer is omitted."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        E, H = d.CG_input_encoding_size, d.CG_rnn_size
        self.layer0 = LSTMCell(cfg.event_context_dim + E, H)
        self.layer1 = LSTMCell(cfg.clip_context_dim + E, H)
        self.layer2 = LSTMCell(cfg.video_context_dim + E, H)
        self.attention = AdditiveAttention(cfg.clip_context_dim, H, d.CG_att_hid_size)

    def init_uniform(self, gen: torch.Generator):
        for m in (self.layer0, self.layer1, self.layer2, self.attention):
            m.init_uniform(gen)
        return self


class Decoder(nn.Module):
    """embed [V+1, E], logit Dense(3H, V+1), the core, and init_linear when
    the config initialises the state from contexts."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        if d.caption_model != "three_stream":
            raise NotImplementedError(_NOT_PORTED.format(d.caption_model))
        V, E = d.CG_vocab_size, d.CG_input_encoding_size
        self.embed = parameter(V + 1, E)
        self.logit = Dense(3 * d.CG_rnn_size, V + 1)  # concat(h0, h1, h2)
        self.core = ThreeStreamCore(cfg)
        n_init = _init_feats_dim(cfg)
        self.init_linear = Dense(n_init, 3 * d.CG_rnn_size) if n_init else None

    def init_uniform(self, gen: torch.Generator):
        """The reference init: embed and logit weight U(-0.1, 0.1), logit
        bias 0, torch defaults elsewhere (init_decoder)."""
        uniform_(self.embed, 0.1, gen)
        uniform_(self.logit.weight, 0.1, gen)
        with torch.no_grad():
            self.logit.bias.zero_()
        self.core.init_uniform(gen)
        if self.init_linear is not None:
            self.init_linear.init_uniform(gen)
        return self


def _video_rows(ctxs: Contexts, N: int) -> torch.Tensor:
    B, Dv = ctxs.video.shape
    return ctxs.video[:, None, :].expand(B, N, Dv)


def ctxs_soi(ctxs: Contexts) -> torch.Tensor:
    """[B, N, 2] windows recovered from the clip mask."""
    m = ctxs.clip_mask
    T = m.shape[-1]
    idx = torch.arange(T, device=m.device)
    start = torch.where(m > 0, idx, T).amin(dim=-1)
    end = torch.where(m > 0, idx + 1, 0).amax(dim=-1)
    return torch.stack([start, end], dim=-1)


def init_state(dec: Decoder, cfg: Config, ctxs: Contexts, N: int,
               dtype: torch.dtype = torch.float32) -> DecoderState:
    B = ctxs.prop_mask.shape[0]
    H = cfg.decoder.CG_rnn_size
    if dec.init_linear is None:
        z = torch.zeros(3, B, N, H, device=ctxs.prop_mask.device)
        return DecoderState(z, z)
    t = cfg.context.CG_init_feats_type
    parts = []
    if "V" in t:
        parts.append(_video_rows(ctxs, N))
    if "E" in t:
        parts.append(ctxs.event)
    if "C" in t:
        parts.append(window_mean_padded(ctxs.clip_feats, ctxs_soi(ctxs), ctxs.prop_mask))
    m = dense(dec.init_linear, torch.cat(parts, dim=-1), dtype).reshape(B, N, 3, H)
    m = m.permute(2, 0, 1, 3)
    return DecoderState(m, m)


def precompute_attention(dec: Decoder, ctxs: Contexts,
                         dtype: torch.dtype = torch.float32) -> Optional[torch.Tensor]:
    """ctx2att(clip_feats) [B, T, Hatt], hoisted out of the decode loop
    (the un-fused inputs decode uses: fuse_inputs=False)."""
    if ctxs.clip_feats is None:
        return None
    return additive_attention_precompute(dec.core.attention, ctxs.clip_feats, dtype)


def _step_three_stream(core: ThreeStreamCore, cfg: Config, xt: torch.Tensor, ctxs: Contexts,
                       pre_att: torch.Tensor, state: DecoderState, dtype: torch.dtype,
                       use_kernel: bool) -> Tuple[torch.Tensor, DecoderState]:
    """The reference ThreeStream_Core.forward, eval mode; xt [B, N, E]."""
    N = xt.shape[1]
    pre_h1 = state.h[1]
    h0, c0 = lstm_cell(core.layer0, torch.cat([xt, ctxs.event], -1), state.h[0], state.c[0],
                       dtype)
    att, _ = additive_attention_step(core.attention, pre_h1, ctxs.clip_feats, pre_att,
                                     ctxs.clip_mask, dtype, use_kernel=use_kernel)
    h1, c1 = lstm_cell(core.layer1, torch.cat([xt, att], -1), state.h[1], state.c[1], dtype)
    h2, c2 = lstm_cell(core.layer2, torch.cat([xt, _video_rows(ctxs, N)], -1), state.h[2],
                       state.c[2], dtype)
    new_state = DecoderState(torch.stack([h0, h1, h2]), torch.stack([c0, c1, c2]))
    return torch.cat([h0, h1, h2], dim=-1), new_state


def step_core_out(dec: Decoder, cfg: Config, it: torch.Tensor, ctxs: Contexts,
                  pre_att: torch.Tensor, state: DecoderState,
                  dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, DecoderState]:
    """One decode step without the logit head: token ids [B, N] -> core
    output [B, N, 3H]."""
    xt = dec.embed[it.long()]
    return _step_three_stream(dec.core, cfg, xt, ctxs, pre_att, state, dtype,
                              use_kernel=bool(cfg.runtime.use_pallas))


def step_logits(dec: Decoder, cfg: Config, it: torch.Tensor, ctxs: Contexts,
                pre_att: torch.Tensor, state: DecoderState,
                dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, DecoderState]:
    """One decode step: token ids -> logits [B, N, V+1]."""
    out, state = step_core_out(dec, cfg, it, ctxs, pre_att, state, dtype)
    return dense(dec.logit, out, dtype), state


def sort_gate(cfg: Config, ctxs: Contexts) -> bool:
    """The window sort runs with the score kernel (runtime.use_pallas)."""
    return bool(cfg.runtime.sort_decode_props and cfg.runtime.use_pallas
                and ctxs.clip_mask is not None)


def sort_ctxs_by_window(ctxs: Contexts) -> Tuple[Contexts, torch.Tensor]:
    """Permute each video's proposal rows by window start, so that the score
    kernel sees clustered windows and skips whole tiles.  Every decoder op
    is independent across rows, so un-permuting the outputs with the
    returned inverse [B, N] gives exactly the unsorted results."""
    m = ctxs.clip_mask
    T = m.shape[-1]
    starts = torch.where(m > 0, torch.arange(T, device=m.device), T).amin(dim=-1)
    order = torch.argsort(starts, dim=-1, stable=True)
    inv_order = torch.argsort(order, dim=-1, stable=True)

    def rows(x):
        idx = order.reshape(*order.shape, *([1] * (x.ndim - 2))).expand(x.shape)
        return torch.gather(x, 1, idx)

    ctxs = ctxs._replace(
        event=None if ctxs.event is None else rows(ctxs.event),
        clip_mask=rows(m),
        prop_mask=rows(ctxs.prop_mask),
    )
    return ctxs, inv_order


def decoder_sample_batched(dec: Decoder, cfg: Config, ctxs: Contexts,
                           dtype: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy decode of a [B]-video Contexts batch with one batch-wide early
    exit: the loop stops once no real proposal of any video is unfinished,
    which costs one host sync per step (``decoder_sample_batched.host_syncs``).

    Returns (seq [B, N, L] int32, logps [B, N, L] f32, active [B, L] bool),
    equal to echr_tpu's greedy decoder_sample_batched; unexecuted steps
    hold zeros.  Multinomial decode is not ported yet (ROADMAP.md A.10).
    """
    B, N = ctxs.prop_mask.shape
    L = cfg.decoder.CG_seq_length
    dev = ctxs.prop_mask.device

    inv = None
    if sort_gate(cfg, ctxs):
        ctxs, inv = sort_ctxs_by_window(ctxs)
    pre_att = precompute_attention(dec, ctxs, dtype)
    state = init_state(dec, cfg, ctxs, N, dtype)
    head_w, head_b = prepare_head(dec.logit, dtype)  # once, outside the loop

    it = torch.zeros(B, N, dtype=torch.int32, device=dev)  # <bos> == 0
    out, state = step_core_out(dec, cfg, it, ctxs, pre_att, state, dtype)
    real = ctxs.prop_mask > 0
    unfinished = torch.ones(B, N, dtype=torch.bool, device=dev)
    seq = torch.zeros(B, N, L, dtype=torch.int32, device=dev)
    logps = torch.zeros(B, N, L, dtype=torch.float32, device=dev)
    active_buf = torch.zeros(B, L, dtype=torch.bool, device=dev)
    for t in range(L):
        tok, mx, lse = greedy_head(out.reshape(B * N, -1), head_w, head_b)
        it = tok.reshape(B, N)
        unfinished = unfinished & (it > 0)
        active = (unfinished & real).any(dim=1)  # [B]
        # a finished video keeps writing zeros while others run
        seq[:, :, t] = it * unfinished * active[:, None]
        logps[:, :, t] = (mx - lse).reshape(B, N) * active[:, None]
        active_buf[:, t] = active
        decoder_sample_batched.steps += 1
        if t == L - 1:
            break
        decoder_sample_batched.host_syncs += 1
        if not bool(active.any()):
            break
        out, state = step_core_out(dec, cfg, it, ctxs, pre_att, state, dtype)
    if inv is not None:
        idx = inv[:, :, None].expand(B, N, L)
        seq = torch.gather(seq, 1, idx)
        logps = torch.gather(logps, 1, idx)
    return seq, logps, active_buf


# token selections run, and early-exit host syncs taken, by all calls
decoder_sample_batched.steps = 0
decoder_sample_batched.host_syncs = 0
