"""Caption decoder: the family of recurrent cores of echr_tpu's
CORE_REGISTRY, teacher forcing and batched greedy decode
(echr_tpu/models/decoder.py).

An embedding and a logit head around one of twelve cores.  Each core is
an nn.Module that holds its LSTMCells and attention, with a plain step
function on tensors (``CORE_REGISTRY``: module class, step function,
number of layers in the state).  The cores and their outputs:

  three_stream      — the ECHR decoder: three parallel LSTMCells over the
                      event context, the attended clip frames and the
                      video context; output concat(h0, h1, h2) [3H].
  show_attend_tell  — a stack of CG_num_layers bias-free LSTMCells over
                      [word | CG_input_feats_type contexts]; the attention
                      is queried by the top layer's hidden before the
                      update and enters only through "C"; output [H].
  all_img           — the same stack without attention: the clip enters
                      as its padded-window mean; output [H].
  h3, h3_dense, h3_dense_add — three stacked LSTMCells, video -> event ->
                      attended clip, the attention queried by the updated
                      h1; output [H], [3H] and [H].
  two_stream, three_stream_2stream, two_stream_jump, two_stream_3lstm,
  three_stream_2stream_LDA, three_stream_2stream_CC — two streams (event
                      or video, and the attended clip) and variants of
                      them; output [2H].

Every tensor carries a leading video axis B and a proposal axis N; the
state is [L, B, N, H] for a core of L layers.  Decode carries the core
output [B*N, C] between steps and selects tokens with the streaming
greedy head (ops/kernel_head): the kernel for CUDA tensors, its plain
version on the CPU.  Teacher forcing (training) takes the training
attention route (``remat``: kernels 3 and 4, or the checkpointed plain
scores), the fused three_stream input projections (``fuse_inputs=True``)
and train-time dropout drawn from a torch.Generator, at each core's
rates and on the output at CG_drop_prob.  torch cannot replay JAX's
random streams, so ``gen=None`` (no dropout, no scheduled sampling) is
the parity mode.

echr_tpu computes show_attend_tell's attention on every step and XLA drops
it when "C" is not in CG_input_feats_type, its result unused; the port
runs eagerly, so it computes the attention (and its ctx2att projection)
only where the result is used (``attention_live``).  The outputs are the
same.

Tensor parallelism (echr_tpu/parallel/mesh.py:99-142): a decoder that
``parallel.mesh.shard_modules`` cut over the vocab holds the rows
[m V1/tp, (m+1) V1/tp) of embed and logit and a ``TPShard`` (``dec.tp``).
Its embedding lookups are vocab-parallel (``parallel.tensor.embed_lookup``),
the fused teacher-forced NLL and a replay's logps take the max, the sum of
exponentials and the target's logit over the tp group without gathering
the logits, a sampled decode draws from the logits gathered over the group
(so every rank draws what one process draws), and the greedy head runs
kernel 2 on the rank's vocab block and combines the blocks' (token, max,
lse) (``parallel.tensor.combine_heads``).

Multinomial decode (``decoder_sample_batched(greedy=False)``: SCST's
rollout and eval's sample_max=0) draws its tokens from a second generator,
so that the dropout generator gives the same masks however many draws a
decode makes; with ``forced`` it replays a rollout's tokens under
autograd with those masks (the self-critical update).  Beam search is
models/beam.py.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from echr_tpu_torch.config import Config
from echr_tpu_torch.models.contexts import Contexts
from echr_tpu_torch.ops.attention import (
    AdditiveAttention,
    additive_attention_precompute,
    additive_attention_step,
)
from echr_tpu_torch.ops.core import Dense, dense, dropout, matmul, parameter, round_to, uniform_
from echr_tpu_torch.ops.kernel_head import greedy_head, prepare_head
from echr_tpu_torch.ops.masked import window_mean_padded
from echr_tpu_torch.ops.recurrent import LSTMCell, lstm_cell, lstm_cell_pre, lstm_input_proj
from echr_tpu_torch.parallel.tensor import (
    combine_heads,
    copy_to_tp,
    embed_lookup,
    gather_from_tp,
    shard_of,
    vocab_logp,
    vocab_nll,
)
from echr_tpu_torch.utils.profiling import span


class DecoderState(NamedTuple):
    h: torch.Tensor  # [L, B, N, H]
    c: torch.Tensor  # [L, B, N, H]


class Precomputed(NamedTuple):
    """Decode-loop invariants (echr_tpu's precompute_attention dict)."""

    att: Optional[torch.Tensor]  # ctx2att(clip_feats) [B, T, Hatt]
    ts: Optional[Dict[str, torch.Tensor]] = None  # fused three_stream inputs
    allimg_pooled: Optional[torch.Tensor] = None  # all_img's clip input [B, N, Dc]


def _use_kernel(cfg: Config, train: bool) -> bool:
    """The score kernels: runtime.use_pallas for no-grad decode,
    runtime.use_pallas_train for training (echr_tpu's _use_pallas)."""
    return bool(cfg.runtime.use_pallas_train if train else cfg.runtime.use_pallas)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _logit_input_size(cfg: Config) -> int:
    """Width of the core output that feeds the logit head; the substring
    tests run in echr_tpu's order."""
    m = cfg.decoder.caption_model
    H = cfg.decoder.CG_rnn_size
    if m == "h3_dense_add":  # one residual hidden
        return H
    if "two_stream" in m or "three_stream_2stream" in m:
        return 2 * H
    if "three_stream" in m:
        return 3 * H
    if "h3_dense" in m or "H3_dense" in m:
        return 3 * H
    return H


def _feats_dim(cfg: Config, t: str) -> int:
    return (("V" in t) * cfg.video_context_dim + ("E" in t) * cfg.event_context_dim
            + ("C" in t) * cfg.clip_context_dim)


def _input_feats_dim(cfg: Config) -> int:
    return _feats_dim(cfg, cfg.context.CG_input_feats_type)


def _init_feats_dim(cfg: Config) -> int:
    return _feats_dim(cfg, cfg.context.CG_init_feats_type)


def _video_rows(ctxs: Contexts, N: int) -> torch.Tensor:
    B, Dv = ctxs.video.shape
    return ctxs.video[:, None, :].expand(B, N, Dv)


def _gather_input_feats(cfg: Config, ctxs: Contexts, att_or_pooled_clip: Optional[torch.Tensor],
                        N: int) -> Optional[torch.Tensor]:
    """The concat of the CG_input_feats_type contexts, V, E, C in that
    order: [B, N, D], or None when it selects none."""
    t = cfg.context.CG_input_feats_type
    parts = []
    if "V" in t:
        parts.append(_video_rows(ctxs, N))
    if "E" in t:
        parts.append(ctxs.event)
    if "C" in t:
        parts.append(att_or_pooled_clip)
    return torch.cat(parts, dim=-1) if parts else None


def attention_live(cfg: Config) -> bool:
    """Whether a decode step uses the core's attention: every core that
    has one, but show_attend_tell only with "C" in CG_input_feats_type."""
    m = cfg.decoder.caption_model
    if m == "all_img":
        return False
    return m != "show_attend_tell" or "C" in cfg.context.CG_input_feats_type


# ---------------------------------------------------------------------------
# cores: an nn.Module each, and a step function
#   step(core, cfg, xt [B, N, E], ctxs, pre, state, dtype, use_kernel, train, gen)
#     -> (output [B, N, _logit_input_size], state)
# ---------------------------------------------------------------------------


class _Core(nn.Module):
    def init_uniform(self, gen: torch.Generator):
        """Each cell U(-1/sqrt(H), +) and the attention's Linears torch's
        default, in the order the core holds them (lstm_cell_init,
        additive_attention_init)."""
        for m in self.children():
            for cell in (m if isinstance(m, nn.ModuleList) else (m,)):
                cell.init_uniform(gen)
        return self


def _attention(cfg: Config) -> AdditiveAttention:
    d = cfg.decoder
    return AdditiveAttention(cfg.clip_context_dim, d.CG_rnn_size, d.CG_att_hid_size)


def _attend(core: nn.Module, h: torch.Tensor, ctxs: Contexts, pre: Precomputed,
            dtype: torch.dtype, use_kernel: bool, train: bool) -> torch.Tensor:
    """The core's attention over the clip frames, queried by h [B, N, H]."""
    att, _ = additive_attention_step(core.attention, h, ctxs.clip_feats, pre.att,
                                     ctxs.clip_mask, dtype, use_kernel=use_kernel, remat=train)
    return att


class ThreeStreamCore(_Core):
    """Three LSTMCells over [word | event], [word | attended clip] and
    [word | video]; the reference's unused fusion_layer is omitted."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        E, H = d.CG_input_encoding_size, d.CG_rnn_size
        self.layer0 = LSTMCell(cfg.event_context_dim + E, H)
        self.layer1 = LSTMCell(cfg.clip_context_dim + E, H)
        self.layer2 = LSTMCell(cfg.video_context_dim + E, H)
        self.attention = _attention(cfg)


def _precompute_three_stream(core: ThreeStreamCore, cfg: Config, ctxs: Contexts,
                             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The event and video streams' context gate inputs are constant over
    the steps, and the three word projections fuse into one
    [E] x [12H] product (_precompute_three_stream)."""
    E = cfg.decoder.CG_input_encoding_size
    N = ctxs.event.shape[1]
    l0, l1, l2 = core.layer0, core.layer1, core.layer2
    return {
        "wx": torch.cat([l0.weight_ih[:, :E], l1.weight_ih[:, :E], l2.weight_ih[:, :E]], 0),
        "const0": lstm_input_proj(l0, ctxs.event, col_start=E, dtype=dtype, with_bias=True),
        "const2": lstm_input_proj(l2, _video_rows(ctxs, N), col_start=E, dtype=dtype,
                                  with_bias=True),
    }


def _step_three_stream(core: ThreeStreamCore, cfg: Config, xt: torch.Tensor, ctxs: Contexts,
                       pre: Precomputed, state: DecoderState, dtype: torch.dtype,
                       use_kernel: bool, train: bool = False,
                       gen: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, DecoderState]:
    """The reference ThreeStream_Core.forward; xt [B, N, E].  The
    dropped-out hidden states are what the state carries.  With the fused
    inputs (pre.ts) the step uses the hoisted projections: the same math up
    to the order of f32 sums."""
    N = xt.shape[1]
    pre_h1 = state.h[1]
    E = cfg.decoder.CG_input_encoding_size
    ts = pre.ts
    if ts is not None:
        xproj = matmul(round_to(xt, dtype), ts["wx"].t(), dtype)  # [B, N, 12H]
        x0, x1, x2 = xproj.chunk(3, dim=-1)
        h0, c0 = lstm_cell_pre(core.layer0, x0 + ts["const0"], state.h[0], state.c[0], dtype)
    else:
        h0, c0 = lstm_cell(core.layer0, torch.cat([xt, ctxs.event], -1), state.h[0],
                           state.c[0], dtype)
    h0 = dropout(h0, 0.5, gen, train)
    att = _attend(core, pre_h1, ctxs, pre, dtype, use_kernel, train)
    if ts is not None:
        att_proj = lstm_input_proj(core.layer1, att, col_start=E, dtype=dtype, with_bias=True)
        h1, c1 = lstm_cell_pre(core.layer1, x1 + att_proj, state.h[1], state.c[1], dtype)
    else:
        h1, c1 = lstm_cell(core.layer1, torch.cat([xt, att], -1), state.h[1], state.c[1],
                           dtype)
    h1 = dropout(h1, 0.5, gen, train)
    if ts is not None:
        h2, c2 = lstm_cell_pre(core.layer2, x2 + ts["const2"], state.h[2], state.c[2], dtype)
    else:
        h2, c2 = lstm_cell(core.layer2, torch.cat([xt, _video_rows(ctxs, N)], -1),
                           state.h[2], state.c[2], dtype)
    h2 = dropout(h2, 0.5, gen, train)
    new_state = DecoderState(torch.stack([h0, h1, h2]), torch.stack([c0, c1, c2]))
    return torch.cat([h0, h1, h2], dim=-1), new_state


class AllImgCore(_Core):
    """CG_num_layers bias-free LSTMCells (the reference's nn.LSTM(...,
    bias=False)), the first over [word | input feats]."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        E, H = d.CG_input_encoding_size, d.CG_rnn_size
        in_dim = E + _input_feats_dim(cfg)
        self.layers = nn.ModuleList(LSTMCell(in_dim if l == 0 else H, H, bias=False)
                                    for l in range(d.CG_num_layers))


class ShowAttendTellCore(AllImgCore):
    """all_img's stack and the attention."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.attention = _attention(cfg)


def _step_stack(layers: nn.ModuleList, cfg: Config, x: torch.Tensor, state: DecoderState,
                dtype: torch.dtype, train: bool, gen: Optional[torch.Generator]
                ) -> Tuple[torch.Tensor, DecoderState]:
    """One step of a stacked LSTM with dropout CG_drop_prob between layers
    (train only); the state keeps the raw hiddens, the output is the top's."""
    hs, cs = [], []
    for l, cell in enumerate(layers):
        h, c = lstm_cell(cell, x, state.h[l], state.c[l], dtype)
        hs.append(h)
        cs.append(c)
        x = h
        if l < len(layers) - 1:
            x = dropout(x, cfg.decoder.CG_drop_prob, gen, train)
    return hs[-1], DecoderState(torch.stack(hs), torch.stack(cs))


def _with_input_feats(cfg: Config, xt: torch.Tensor, ctxs: Contexts,
                      clip: Optional[torch.Tensor]) -> torch.Tensor:
    feats = _gather_input_feats(cfg, ctxs, clip, xt.shape[1])
    return xt if feats is None else torch.cat([xt, feats], dim=-1)


def _step_show_attend_tell(core: ShowAttendTellCore, cfg: Config, xt: torch.Tensor,
                           ctxs: Contexts, pre: Precomputed, state: DecoderState,
                           dtype: torch.dtype, use_kernel: bool, train: bool = False,
                           gen: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, DecoderState]:
    """The reference ShowAttendTellCore.forward: the attention queried by
    the top layer's hidden before the update, then the stack.  Without "C"
    in CG_input_feats_type the attention's result is unused and is not
    computed."""
    att = None
    if attention_live(cfg):
        att = _attend(core, state.h[-1], ctxs, pre, dtype, use_kernel, train)
    return _step_stack(core.layers, cfg, _with_input_feats(cfg, xt, ctxs, att), state, dtype,
                       train, gen)


def _step_all_img(core: AllImgCore, cfg: Config, xt: torch.Tensor, ctxs: Contexts,
                  pre: Precomputed, state: DecoderState, dtype: torch.dtype,
                  use_kernel: bool, train: bool = False,
                  gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, DecoderState]:
    """The reference AllImgCore.forward: the clip enters as its
    padded-window mean (pre.allimg_pooled, hoisted by precompute_attention)."""
    return _step_stack(core.layers, cfg, _with_input_feats(cfg, xt, ctxs, pre.allimg_pooled),
                       state, dtype, train, gen)


class H3Core(_Core):
    """Three stacked LSTMCells: [word | video | previous top hidden],
    [event | h0] and [attended clip | h1]; h3, h3_dense and h3_dense_add."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        E, H = d.CG_input_encoding_size, d.CG_rnn_size
        self.layer0 = LSTMCell(cfg.video_context_dim + H + E, H)
        self.layer1 = LSTMCell(cfg.event_context_dim + H, H)
        self.layer2 = LSTMCell(cfg.clip_context_dim + H, H)
        self.attention = _attention(cfg)


def _make_h3_step(variant: str):
    def step(core: H3Core, cfg: Config, xt: torch.Tensor, ctxs: Contexts, pre: Precomputed,
             state: DecoderState, dtype: torch.dtype, use_kernel: bool, train: bool = False,
             gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, DecoderState]:
        """The reference H3_Core / H3_dense_Core / H3_dense_add_Core: the
        attention queried by the updated, dropped-out h1; the concat order,
        the residual adds and which hiddens (raw or dropped) the state keeps
        are the variant's."""
        N = xt.shape[1]
        x0 = torch.cat([xt, _video_rows(ctxs, N), state.h[-1]], -1)
        h0_raw, c0 = lstm_cell(core.layer0, x0, state.h[0], state.c[0], dtype)
        h0 = dropout(h0_raw, 0.5, gen, train)
        h1_raw, c1 = lstm_cell(core.layer1, torch.cat([ctxs.event, h0], -1), state.h[1],
                               state.c[1], dtype)
        h1 = dropout(h1_raw + h0 if variant == "h3_dense_add" else h1_raw, 0.5, gen, train)
        att = _attend(core, h1, ctxs, pre, dtype, use_kernel, train)
        h2_raw, c2 = lstm_cell(core.layer2, torch.cat([att, h1], -1), state.h[2], state.c[2],
                               dtype)
        c = torch.stack([c0, c1, c2])
        if variant == "h3":
            return h2_raw, DecoderState(torch.stack([h0, h1, h2_raw]), c)
        if variant == "h3_dense":
            return (torch.cat([h0_raw, h1_raw, h2_raw], -1),
                    DecoderState(torch.stack([h0, h1, h2_raw]), c))
        # h3_dense_add: the raw hiddens in the state, a residual output
        return h2_raw + h1, DecoderState(torch.stack([h0_raw, h1_raw, h2_raw]), c)

    return step


class TwoStreamCore(_Core):
    """[word | event] and [word | attended clip]: two_stream and
    three_stream_2stream."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        E, H = d.CG_input_encoding_size, d.CG_rnn_size
        self.layer0 = LSTMCell(cfg.event_context_dim + E, H)
        self.layer1 = LSTMCell(cfg.clip_context_dim + E, H)
        self.attention = _attention(cfg)


def _two_streams(core: nn.Module, x0: torch.Tensor, x1: torch.Tensor, state: DecoderState,
                 dtype: torch.dtype, train: bool, gen: Optional[torch.Generator]
                 ) -> Tuple[torch.Tensor, DecoderState]:
    """Two parallel LSTMCells with dropout 0.5 each; output [h0 | h1]."""
    h0, c0 = lstm_cell(core.layer0, x0, state.h[0], state.c[0], dtype)
    h0 = dropout(h0, 0.5, gen, train)
    h1, c1 = lstm_cell(core.layer1, x1, state.h[1], state.c[1], dtype)
    h1 = dropout(h1, 0.5, gen, train)
    return torch.cat([h0, h1], -1), DecoderState(torch.stack([h0, h1]), torch.stack([c0, c1]))


def _step_two_stream(core: TwoStreamCore, cfg: Config, xt: torch.Tensor, ctxs: Contexts,
                     pre: Precomputed, state: DecoderState, dtype: torch.dtype,
                     use_kernel: bool, train: bool = False,
                     gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, DecoderState]:
    """The reference TwoStream_Core.forward: the event stream and the clip
    stream, whose attention is queried by its previous hidden."""
    att = _attend(core, state.h[1], ctxs, pre, dtype, use_kernel, train)
    return _two_streams(core, torch.cat([xt, ctxs.event], -1), torch.cat([xt, att], -1), state,
                        dtype, train, gen)


class TwoStreamJumpCore(_Core):
    """two_stream whose streams also take the other's previous hidden."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        E, H = d.CG_input_encoding_size, d.CG_rnn_size
        self.layer0 = LSTMCell(cfg.event_context_dim + E + H, H)
        self.layer1 = LSTMCell(cfg.clip_context_dim + E + H, H)
        self.attention = _attention(cfg)


def _step_two_stream_jump(core: TwoStreamJumpCore, cfg: Config, xt: torch.Tensor,
                          ctxs: Contexts, pre: Precomputed, state: DecoderState,
                          dtype: torch.dtype, use_kernel: bool, train: bool = False,
                          gen: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, DecoderState]:
    """The reference TwoStream_jump_Core.forward."""
    pre_h0, pre_h1 = state.h[0], state.h[1]
    att = _attend(core, pre_h1, ctxs, pre, dtype, use_kernel, train)
    return _two_streams(core, torch.cat([xt, ctxs.event, pre_h1], -1),
                        torch.cat([xt, att, pre_h0], -1), state, dtype, train, gen)


class TwoStream3LSTMCore(_Core):
    """A word + video LSTMCell (layer2) that feeds an event stream (layer0)
    and a clip stream (layer1)."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        E, H = d.CG_input_encoding_size, d.CG_rnn_size
        self.layer0 = LSTMCell(cfg.event_context_dim + H, H)
        self.layer1 = LSTMCell(cfg.clip_context_dim + H, H)
        self.layer2 = LSTMCell(cfg.video_context_dim + E, H)
        self.attention = _attention(cfg)


def _step_two_stream_3lstm(core: TwoStream3LSTMCore, cfg: Config, xt: torch.Tensor,
                           ctxs: Contexts, pre: Precomputed, state: DecoderState,
                           dtype: torch.dtype, use_kernel: bool, train: bool = False,
                           gen: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, DecoderState]:
    """The reference TwoStream3LSTM_Core.forward: layer2 runs first; the
    output is the two streams' hiddens, the state [h0, h1, h2]."""
    N = xt.shape[1]
    att = _attend(core, state.h[1], ctxs, pre, dtype, use_kernel, train)
    h2, c2 = lstm_cell(core.layer2, torch.cat([xt, _video_rows(ctxs, N)], -1), state.h[2],
                       state.c[2], dtype)
    h2 = dropout(h2, 0.5, gen, train)
    out, st = _two_streams(core, torch.cat([h2, ctxs.event], -1), torch.cat([h2, att], -1),
                           state, dtype, train, gen)
    return out, DecoderState(torch.cat([st.h, h2[None]]), torch.cat([st.c, c2[None]]))


class TS2LDACore(_Core):
    """three_stream_2stream_LDA: a video stream and the clip stream."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        E, H = d.CG_input_encoding_size, d.CG_rnn_size
        self.layer0 = LSTMCell(cfg.video_context_dim + E, H)
        self.layer1 = LSTMCell(cfg.clip_context_dim + E, H)
        self.attention = _attention(cfg)


def _step_ts2_lda(core: TS2LDACore, cfg: Config, xt: torch.Tensor, ctxs: Contexts,
                  pre: Precomputed, state: DecoderState, dtype: torch.dtype,
                  use_kernel: bool, train: bool = False,
                  gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, DecoderState]:
    """The reference ThreeStream_Core_2stream_CLDA."""
    N = xt.shape[1]
    att = _attend(core, state.h[1], ctxs, pre, dtype, use_kernel, train)
    return _two_streams(core, torch.cat([xt, _video_rows(ctxs, N)], -1),
                        torch.cat([xt, att], -1), state, dtype, train, gen)


class TS2CCCore(_Core):
    """three_stream_2stream_CC: two streams over the same attended clip."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        E, H = d.CG_input_encoding_size, d.CG_rnn_size
        self.layer0 = LSTMCell(cfg.clip_context_dim + E, H)
        self.layer1 = LSTMCell(cfg.clip_context_dim + E, H)
        self.attention = _attention(cfg)


def _step_ts2_cc(core: TS2CCCore, cfg: Config, xt: torch.Tensor, ctxs: Contexts,
                 pre: Precomputed, state: DecoderState, dtype: torch.dtype,
                 use_kernel: bool, train: bool = False,
                 gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, DecoderState]:
    """The reference ThreeStream_Core_2stream_CC."""
    att = _attend(core, state.h[1], ctxs, pre, dtype, use_kernel, train)
    x = torch.cat([xt, att], -1)
    return _two_streams(core, x, x, state, dtype, train, gen)


# name -> (module class, step function, layers in the state)
CORE_REGISTRY = {
    "three_stream": (ThreeStreamCore, _step_three_stream, lambda cfg: 3),
    "show_attend_tell": (ShowAttendTellCore, _step_show_attend_tell,
                         lambda cfg: cfg.decoder.CG_num_layers),
    "all_img": (AllImgCore, _step_all_img, lambda cfg: cfg.decoder.CG_num_layers),
    "h3": (H3Core, _make_h3_step("h3"), lambda cfg: 3),
    "h3_dense": (H3Core, _make_h3_step("h3_dense"), lambda cfg: 3),
    "h3_dense_add": (H3Core, _make_h3_step("h3_dense_add"), lambda cfg: 3),
    "two_stream": (TwoStreamCore, _step_two_stream, lambda cfg: 2),
    "two_stream_jump": (TwoStreamJumpCore, _step_two_stream_jump, lambda cfg: 2),
    "two_stream_3lstm": (TwoStream3LSTMCore, _step_two_stream_3lstm, lambda cfg: 3),
    "three_stream_2stream": (TwoStreamCore, _step_two_stream, lambda cfg: 2),
    "three_stream_2stream_LDA": (TS2LDACore, _step_ts2_lda, lambda cfg: 2),
    "three_stream_2stream_CC": (TS2CCCore, _step_ts2_cc, lambda cfg: 2),
}


def core_num_layers(cfg: Config) -> int:
    return CORE_REGISTRY[cfg.decoder.caption_model][2](cfg)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


class Decoder(nn.Module):
    """embed [V+1, E], logit Dense(C, V+1) for the core's output width C,
    the core, and init_linear when the config initialises the state from
    contexts."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.decoder
        if d.caption_model not in CORE_REGISTRY:
            raise ValueError(f"caption_model {d.caption_model!r} not supported; "
                             f"available: {sorted(CORE_REGISTRY)}")
        V, E = d.CG_vocab_size, d.CG_input_encoding_size
        self.embed = parameter(V + 1, E)
        self.logit = Dense(_logit_input_size(cfg), V + 1)
        self.core = CORE_REGISTRY[d.caption_model][0](cfg)
        n_init = _init_feats_dim(cfg)
        self.init_linear = (Dense(n_init, core_num_layers(cfg) * d.CG_rnn_size)
                            if n_init else None)

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
    """[L, B, N, H] zeros, or init_linear of the CG_init_feats_type
    contexts split over the L layers (the reference init_hidden)."""
    B = ctxs.prop_mask.shape[0]
    L, H = core_num_layers(cfg), cfg.decoder.CG_rnn_size
    if dec.init_linear is None:
        z = torch.zeros(L, B, N, H, device=ctxs.prop_mask.device)
        return DecoderState(z, z)
    t = cfg.context.CG_init_feats_type
    parts = []
    if "V" in t:
        parts.append(_video_rows(ctxs, N))
    if "E" in t:
        parts.append(ctxs.event)
    if "C" in t:
        parts.append(window_mean_padded(ctxs.clip_feats, ctxs_soi(ctxs), ctxs.prop_mask))
    m = dense(dec.init_linear, torch.cat(parts, dim=-1), dtype).reshape(B, N, L, H)
    m = m.permute(2, 0, 1, 3)
    return DecoderState(m, m)


def precompute_attention(dec: Decoder, cfg: Config, ctxs: Contexts,
                         dtype: torch.dtype = torch.float32,
                         fuse_inputs: bool = False) -> Precomputed:
    """Hoist decode-loop invariants: ctx2att(clip_feats) where the core's
    attention is live, all_img's padded-window clip mean with "C" in
    CG_input_feats_type, and with ``fuse_inputs`` (teacher forcing) the
    fused three_stream input projections; greedy decode keeps them
    un-fused (fuse_inputs=False).  A caller that sorts or expands the
    proposal rows does so first."""
    att = pooled = ts = None
    if ctxs.clip_feats is not None and attention_live(cfg):
        att = additive_attention_precompute(dec.core.attention, ctxs.clip_feats, dtype)
    if fuse_inputs and isinstance(dec.core, ThreeStreamCore):
        ts = _precompute_three_stream(dec.core, cfg, ctxs, dtype)
    if (cfg.decoder.caption_model == "all_img" and ctxs.clip_feats is not None
            and "C" in cfg.context.CG_input_feats_type):
        pooled = window_mean_padded(ctxs.clip_feats, ctxs_soi(ctxs), ctxs.prop_mask)
    return Precomputed(att, ts, pooled)


def step_core_out(dec: Decoder, cfg: Config, it: torch.Tensor, ctxs: Contexts,
                  pre: Precomputed, state: DecoderState,
                  dtype: torch.dtype = torch.float32, train: bool = False,
                  gen: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, DecoderState]:
    """One decode step without the logit head: token ids [B, N] -> core
    output [B, N, C] (with the output dropout at train time)."""
    tp = shard_of(dec)
    xt = dec.embed[it.long()] if tp is None else embed_lookup(dec.embed, it, tp)
    step = CORE_REGISTRY[cfg.decoder.caption_model][1]
    out, state = step(dec.core, cfg, xt, ctxs, pre, state, dtype, _use_kernel(cfg, train), train,
                      gen)
    return dropout(out, cfg.decoder.CG_drop_prob, gen, train), state


def local_logits(dec: Decoder, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The logits of the decoder's own vocab columns: all V+1 of them, or on
    a vocab-sharded decoder the rank's block, whose input ``out`` (the same
    on every rank) takes its gradient summed over the tp group."""
    tp = shard_of(dec)
    return dense(dec.logit, out if tp is None else copy_to_tp(out, tp), dtype)


def whole_logits(dec: Decoder, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The logits [..., V+1] of the core output: on a vocab-sharded decoder
    the ranks' blocks gathered over the tp group."""
    logits = local_logits(dec, out, dtype)
    tp = shard_of(dec)
    return logits if tp is None else gather_from_tp(logits, tp, -1)


def step_logits(dec: Decoder, cfg: Config, it: torch.Tensor, ctxs: Contexts,
                pre: Precomputed, state: DecoderState,
                dtype: torch.dtype = torch.float32, train: bool = False,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, DecoderState]:
    """One decode step: token ids -> logits [B, N, V+1]."""
    out, state = step_core_out(dec, cfg, it, ctxs, pre, state, dtype, train, gen)
    return whole_logits(dec, out, dtype), state


def step_logprobs(dec: Decoder, cfg: Config, it: torch.Tensor, ctxs: Contexts,
                  pre: Precomputed, state: DecoderState,
                  dtype: torch.dtype = torch.float32, train: bool = False,
                  gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, DecoderState]:
    """One decode step: token ids -> log p(next token) [B, N, V+1]."""
    logits, state = step_logits(dec, cfg, it, ctxs, pre, state, dtype, train, gen)
    return torch.log_softmax(logits, dim=-1), state


def decoder_forward(dec: Decoder, cfg: Config, ctxs: Contexts, seq: torch.Tensor,
                    dtype: torch.dtype = torch.float32, train: bool = False,
                    gen: Optional[torch.Generator] = None, ss_prob: float = 0.0
                    ) -> torch.Tensor:
    """Teacher-forced logprobs [B, N, L, V+1] for predicting seq[..., 1:]
    from seq [B, N, L+1] (column 0 = BOS).  Scheduled sampling (train time,
    with a generator, ss_prob > 0): from step 1 on, each row's input token
    is replaced w.p. ss_prob by a sample of the previous step's
    distribution, drawn from ``gen``."""
    B, N, Lp1 = seq.shape
    pre = precompute_attention(dec, cfg, ctxs, dtype, fuse_inputs=True)
    state = init_state(dec, cfg, ctxs, N, dtype)
    use_ss = train and ss_prob > 0.0 and gen is not None
    outs = []
    for i in range(Lp1 - 1):
        it = seq[:, :, i].long()
        if use_ss and i >= 1:
            take = torch.rand(B, N, generator=gen, device=seq.device) < ss_prob
            probs = outs[-1].detach().exp().reshape(B * N, -1)
            sampled = torch.multinomial(probs, 1, generator=gen).reshape(B, N)
            it = torch.where(take, sampled, it)
        logprobs, state = step_logprobs(dec, cfg, it, ctxs, pre, state, dtype, train, gen)
        outs.append(logprobs)
    return torch.stack(outs, dim=2)


def decoder_forward_core_outputs(dec: Decoder, cfg: Config, ctxs: Contexts,
                                 seq: torch.Tensor, dtype: torch.dtype = torch.float32,
                                 train: bool = False, gen: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """Teacher-forced core outputs [B, N, L, C]: the decode loop without
    the logit head (decoder_forward with ss_prob = 0 before its head)."""
    N = seq.shape[1]
    pre = precompute_attention(dec, cfg, ctxs, dtype, fuse_inputs=True)
    state = init_state(dec, cfg, ctxs, N, dtype)
    outs = []
    for i in range(seq.shape[2] - 1):
        out, state = step_core_out(dec, cfg, seq[:, :, i], ctxs, pre, state, dtype, train, gen)
        outs.append(out)
    return torch.stack(outs, dim=2)


def _nll_head(w: torch.Tensor, b: torch.Tensor, outs: torch.Tensor, targets: torch.Tensor,
              m: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    logits = matmul(round_to(outs, dtype), w.t(), dtype) + b  # [B, N, L, V+1]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return -((tgt - lse) * m).sum(dim=(1, 2)) / (m.sum(dim=(1, 2)) + 1e-6)


def teacher_forced_nll(dec: Decoder, cfg: Config, ctxs: Contexts, seq: torch.Tensor,
                       masks: torch.Tensor, dtype: torch.dtype = torch.float32,
                       train: bool = False, gen: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Fused teacher-forced NLL per video [B]: equals
    language_model_loss(decoder_forward(...), seq[..., 1:], masks[..., 1:])
    without storing the [B, N, L, V+1] logits.  The logit head runs once
    after the loop under torch.utils.checkpoint, so the backward recomputes
    it and the saved residual is the [B, N, L, C] core outputs.  On a
    vocab-sharded decoder each rank computes the logits of its columns and
    the loss takes the max, the sum of exponentials and the targets'
    logits over the tp group (parallel.tensor.vocab_nll); the backward
    recomputes the rank's block only."""
    outs = decoder_forward_core_outputs(dec, cfg, ctxs, seq, dtype, train, gen)
    steps = outs.shape[2]
    targets = seq[:, :, 1:steps + 1].long()
    m = masks[:, :, 1:steps + 1].float()
    tp = shard_of(dec)
    if tp is not None:
        return checkpoint(_nll_head_tp, dec.logit.weight, dec.logit.bias, copy_to_tp(outs, tp),
                          targets, m, dtype, tp, use_reentrant=False)
    return checkpoint(_nll_head, dec.logit.weight, dec.logit.bias, outs, targets, m, dtype,
                      use_reentrant=False)


def _nll_head_tp(w: torch.Tensor, b: torch.Tensor, outs: torch.Tensor, targets: torch.Tensor,
                 m: torch.Tensor, dtype: torch.dtype, tp) -> torch.Tensor:
    logits = matmul(round_to(outs, dtype), w.t(), dtype) + b  # [B, N, L, V1/tp]
    return vocab_nll(logits, targets, m, tp)


def sort_gate(cfg: Config, ctxs: Contexts) -> bool:
    """The window sort runs with the score kernel (runtime.use_pallas)."""
    return bool(cfg.runtime.sort_decode_props and cfg.runtime.use_pallas
                and ctxs.clip_mask is not None)


def sort_ctxs_by_window(ctxs: Contexts) -> Tuple[Contexts, torch.Tensor]:
    """Permute each video's proposal rows by window start, so that the score
    kernel sees clustered windows: neighbouring rows share their live
    frames, and a block whose frames no row sees stages nothing.  The
    kernel is exact without the sort.  Every decoder op
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


def _categorical(logits: torch.Tensor, temperature: float, gen: torch.Generator
                 ) -> torch.Tensor:
    """One draw a row of [R, V1] logits from softmax(logits / temperature)."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def decoder_sample_batched(dec: Decoder, cfg: Config, ctxs: Contexts,
                           dtype: torch.dtype = torch.float32, greedy: bool = True,
                           temperature: float = 1.0,
                           sample_gen: Optional[torch.Generator] = None,
                           train: bool = False, gen: Optional[torch.Generator] = None,
                           forced: Optional[torch.Tensor] = None,
                           early_exit: Optional[bool] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy or multinomial decode of a [B]-video Contexts batch with one
    batch-wide early exit: the loop stops once no real proposal of any
    video is unfinished, which costs one host sync per step
    (``decoder_sample_batched.host_syncs``).  ``early_exit`` (default
    runtime.decode_early_exit_batched; the per-video callers pass
    runtime.decode_early_exit) False runs the fixed-L loop without the
    syncs; the outputs are the same, since the steps past the exit write
    zeros either way.

    Greedy eval-mode decode selects tokens with the streaming greedy head
    (kernel 2, unless runtime.use_pallas_head is False) and window-sorts
    the proposals when ``sort_gate`` holds.
    Otherwise the head is the plain logits path: the argmax, or with
    ``greedy=False`` a draw from softmax(logits / temperature) taken from
    ``sample_gen``; the recorded logp is the untempered logit[tok] -
    logsumexp(logits).  ``train`` turns dropout on (drawn from ``gen``) and
    takes the training attention route.  Sampled and train-mode decodes
    never sort: their draws are row-positional.  A finished proposal
    keeps drawing and feeding its draws back, as echr_tpu's does; its
    emitted tokens are zero.

    ``forced`` [B, N, L] (a rollout's seq) replays those tokens, as
    echr_tpu's decoder_sample(forced_tokens=...) does: all L steps run with
    no early exit, step t feeds forced[..., t] in place of a draw and
    records its logp, and unfinished / active follow from the forced
    tokens.  The steps are the rollout's own (the plain head, the same
    shapes, no sort), so with ``gen`` restored to its state before the
    rollout the replay draws the rollout's dropout masks in its order, and
    its logps equal the rollout's wherever the fed tokens agree: up to
    each proposal's end token.  The steps after the rollout's exit draw
    masks too; no emitted token depends on them.

    Returns (seq [B, N, L] int32, logps [B, N, L] f32, active [B, L] bool),
    equal to echr_tpu's decoder_sample_batched; unexecuted steps hold
    zeros."""
    if forced is None and not greedy and sample_gen is None:
        raise ValueError("decoder_sample_batched(greedy=False) needs sample_gen for the "
                         "categorical draws")
    with span("decode.loop", decoder_sample_batched):
        B, N = ctxs.prop_mask.shape
        L = cfg.decoder.CG_seq_length
        dev = ctxs.prop_mask.device
        if early_exit is None:
            early_exit = bool(cfg.runtime.decode_early_exit_batched)
        tp = shard_of(dec)

        greedy_eval = greedy and not train and forced is None
        stream_head = greedy_eval and bool(cfg.runtime.use_pallas_head)
        inv = None
        if greedy_eval and sort_gate(cfg, ctxs):
            ctxs, inv = sort_ctxs_by_window(ctxs)
        pre_att = precompute_attention(dec, cfg, ctxs, dtype)
        state = init_state(dec, cfg, ctxs, N, dtype)
        if stream_head:
            # once, outside the loop; on a vocab-sharded decoder the rank's block
            head_w, head_b = prepare_head(dec.logit, dtype)

        it = torch.zeros(B, N, dtype=torch.int32, device=dev)  # <bos> == 0
        out, state = step_core_out(dec, cfg, it, ctxs, pre_att, state, dtype, train, gen)
        real = ctxs.prop_mask > 0
        unfinished = torch.ones(B, N, dtype=torch.bool, device=dev)
        seq = torch.zeros(B, N, L, dtype=torch.int32, device=dev)
        logps = torch.zeros(B, N, L, dtype=torch.float32, device=dev)
        active_buf = torch.zeros(B, L, dtype=torch.bool, device=dev)
        for t in range(L):
            with span("decode.step"):
                if stream_head:
                    tok, mx, lse = greedy_head(out.reshape(B * N, -1), head_w, head_b)
                    if tp is not None:
                        tok, mx, lse = combine_heads(tok, mx, lse, tp, head_w.shape[0])
                    logp = mx - lse
                elif forced is not None and tp is not None:
                    # the replay's logps without gathering the logits
                    tok = forced[:, :, t].reshape(B * N).long()
                    logp = vocab_logp(local_logits(dec, out, dtype).reshape(B * N, -1), tok, tp)
                else:
                    logits = whole_logits(dec, out, dtype).reshape(B * N, -1)
                    lse = torch.logsumexp(logits, dim=-1)
                    if forced is not None:
                        tok = forced[:, :, t].reshape(B * N).long()
                    elif greedy:
                        tok = logits.argmax(dim=-1)
                    else:
                        tok = _categorical(logits, temperature, sample_gen)
                    logp = torch.gather(logits, 1, tok[:, None])[:, 0] - lse
                it = tok.reshape(B, N).int()
                unfinished = unfinished & (it > 0)
                active = (unfinished & real).any(dim=1)  # [B]
                # a finished video keeps writing zeros while others run
                seq[:, :, t] = it * unfinished * active[:, None]
                logps[:, :, t] = logp.reshape(B, N) * active[:, None]
                active_buf[:, t] = active
                decoder_sample_batched.steps += 1
                if t == L - 1:
                    break
                if forced is None and early_exit:
                    decoder_sample_batched.host_syncs += 1
                    with span("decode.sync", decoder_sample_batched, "sync_wait_ns"):
                        done = not bool(active.any())
                    if done:
                        break
                out, state = step_core_out(dec, cfg, it, ctxs, pre_att, state, dtype, train, gen)
        if inv is not None:
            idx = inv[:, :, None].expand(B, N, L)
            seq = torch.gather(seq, 1, idx)
            logps = torch.gather(logps, 1, idx)
        return seq, logps, active_buf


# token selections run, and early-exit host syncs taken, by all calls;
# the host's ns in the calls, and of them in the early exit's syncs
decoder_sample_batched.steps = 0
decoder_sample_batched.host_syncs = 0
decoder_sample_batched.host_ns = 0
decoder_sample_batched.sync_wait_ns = 0


def one_video_ctxs(ctxs: Contexts) -> Contexts:
    """One video's Contexts ([N, ...] rows, [T, ...] frames) as a batch of
    one."""
    return Contexts(*(None if x is None else x[None] for x in ctxs))


def decoder_sample(dec: Decoder, cfg: Config, ctxs: Contexts,
                   dtype: torch.dtype = torch.float32, greedy: bool = True,
                   temperature: float = 1.0, sample_gen: Optional[torch.Generator] = None,
                   train: bool = False, gen: Optional[torch.Generator] = None,
                   forced_tokens: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy or multinomial decode of one video's proposals (echr_tpu's
    decoder_sample): decoder_sample_batched on a batch of one, so the
    batch-wide early exit is the video's own (runtime.decode_early_exit
    False: the fixed-L loop), and greedy eval-mode decode sorts by window
    and takes kernel 2 at R = N rows.  ``forced_tokens``
    [N, L] replays a rollout over all L steps.  Bucket-padding rows decode
    from their [0, 1) windows and are not zeroed, as in echr_tpu; the
    callers cut them.

    Returns (seq [N, L], logps [N, L], active [L])."""
    forced = None if forced_tokens is None else forced_tokens[None]
    seq, logps, active = decoder_sample_batched(dec, cfg, one_video_ctxs(ctxs), dtype, greedy,
                                                temperature, sample_gen, train, gen, forced,
                                                bool(cfg.runtime.decode_early_exit))
    return seq[0], logps[0], active[0]
