"""Batched beam search (echr_tpu/models/beam.py), on the port's [B, N·k]
layout: B videos, N proposals each, k beams per proposal.

The k beams of a proposal live on adjacent rows of the flattened beam
axis, so every decode step is one batched core step over B x N·k rows.
Scoring is the sum of token logprobs; the final ranking divides it by the
GNMT length penalty ((5 + len) / 6)^alpha (alpha = 0 ranks by the raw
sum).  END is token 0.

Order on ties, as in the reference:

  * the per-step top-k keeps ``lax.top_k``'s order: values descending and,
    among equal values, the lower flat index (beam, then token) first.
    ``torch.topk`` promises no order on ties, so ``_top_k_first_index``
    takes k rounds of ``argmax``, which returns the first maximal index;
  * the final ranking is a stable argsort, as ``jnp.argsort`` is.

The loop has one batch-wide early exit, as the greedy decode has: after
each step it stops once every beam of every real proposal of every video
has finished, which costs one host sync per step
(``beam_search_batched.host_syncs``).  The steps it skips are no-ops (a
finished beam's only candidate is END at +0), so the fixed-L loop
(``early_exit=False``) returns identical tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from echr_tpu_torch.config import Config
from echr_tpu_torch.models.contexts import Contexts
from echr_tpu_torch.models.decoder import (
    Decoder,
    DecoderState,
    init_state,
    one_video_ctxs,
    precompute_attention,
    sort_ctxs_by_window,
    sort_gate,
    step_logprobs,
)
from echr_tpu_torch.utils.profiling import span

_NEG_INF = -1e30


class BeamResult(NamedTuple):
    seq: torch.Tensor  # [B, N, L] the best beam per proposal (0-terminated)
    logprob: torch.Tensor  # [B, N] its summed logprob
    all_seqs: torch.Tensor  # [B, N, k, L] every final beam, best first
    all_logprobs: torch.Tensor  # [B, N, k]


def _expand_ctxs(ctxs: Contexts, k: int) -> Contexts:
    """Repeat every proposal row k times, [B, N, ...] -> [B, N·k, ...], the
    k copies adjacent (jnp.repeat per video).  The video vector and the
    clip frames are shared by a video's proposals and stay as they are."""
    def rep(x):
        return None if x is None else x.repeat_interleave(k, dim=1)

    return Contexts(video=ctxs.video, event=rep(ctxs.event), clip_feats=ctxs.clip_feats,
                    clip_mask=rep(ctxs.clip_mask), prop_mask=rep(ctxs.prop_mask))


def _top_k_first_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis in
    ``lax.top_k``'s order: descending, the lower index first among equal
    values.  Overwrites x."""
    vals, idx = [], []
    for _ in range(k):
        i = x.argmax(dim=-1, keepdim=True)
        vals.append(torch.gather(x, -1, i))
        idx.append(i)
        x.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def _beam_step(finished: torch.Tensor, scores: torch.Tensor, tokens: torch.Tensor,
               logprobs: torch.Tensor, t: int):
    """Choose the k best continuations of every proposal's beams at step t.
    finished / scores [B, N, k], tokens [B, N, k, L], logprobs [B, N·k, V1].
    Returns (finished, scores, tokens, emitted tokens [B, N, k], the source
    row of each new beam on the flat beam axis [B, N·k])."""
    B, N, k = finished.shape
    V1 = logprobs.shape[-1]
    lp = logprobs.reshape(B, N, k, V1)
    # a finished beam may only "emit" END, at +0
    end_only = torch.full((V1,), _NEG_INF, device=lp.device, dtype=lp.dtype)
    end_only[0] = 0.0
    lp = torch.where(finished[..., None], end_only, lp)
    cand = (scores[..., None] + lp).reshape(B, N, k * V1)
    top_scores, top_idx = _top_k_first_index(cand, k)
    src = torch.div(top_idx, V1, rounding_mode="floor")
    tok = (top_idx % V1).to(torch.int32)

    tokens = torch.gather(tokens, 2, src[..., None].expand(tokens.shape))
    was_finished = torch.gather(finished, 2, src)
    emit = torch.where(was_finished, torch.zeros_like(tok), tok)
    tokens[..., t] = emit
    finished = was_finished | (tok == 0)
    flat_src = (torch.arange(N, device=src.device)[:, None] * k + src).reshape(B, N * k)
    return finished, top_scores, tokens, emit, flat_src


def _reorder(state: DecoderState, flat_src: torch.Tensor) -> DecoderState:
    idx = flat_src[None, :, :, None].expand(state.h.shape)
    return DecoderState(torch.gather(state.h, 2, idx), torch.gather(state.c, 2, idx))


def beam_search_batched(dec: Decoder, cfg: Config, ctxs: Contexts, beam_size: int,
                        length_alpha: float = 0.0, early_exit: bool = True,
                        dtype: torch.dtype = torch.float32) -> BeamResult:
    """Beam search of every proposal of a [B]-video Contexts batch.

    Under ``decoder.sort_gate`` the proposals are sorted by window start
    first (before the k-fold expansion, so a proposal's copies stay
    adjacent and share kernel 1's row pairs) and the results are
    un-permuted at the end: every op is per proposal, so this is exact.
    Bucket-padding proposals (prop_mask 0) come back as zeros.  Every
    decode step (the <bos> step included) adds one to
    ``beam_search_batched.steps``."""
    with span("decode.loop", beam_search_batched):
        B, N = ctxs.prop_mask.shape
        k = beam_size
        L = cfg.decoder.CG_seq_length
        dev = ctxs.prop_mask.device

        inv = None
        if sort_gate(cfg, ctxs):
            ctxs, inv = sort_ctxs_by_window(ctxs)
        bctx = _expand_ctxs(ctxs, k)
        pre = precompute_attention(dec, cfg, bctx, dtype)
        state = init_state(dec, cfg, bctx, N * k, dtype)
        it = torch.zeros(B, N * k, dtype=torch.int32, device=dev)  # <bos> == 0
        logprobs, state = step_logprobs(dec, cfg, it, bctx, pre, state, dtype)
        beam_search_batched.steps += 1

        # only beam 0 is live at first, so identical first-step beams do not
        # duplicate candidates
        scores = torch.full((B, N, k), _NEG_INF, device=dev)
        scores[..., 0] = 0.0
        finished = torch.zeros(B, N, k, dtype=torch.bool, device=dev)
        tokens = torch.zeros(B, N, k, L, dtype=torch.int32, device=dev)
        pad = ctxs.prop_mask <= 0  # [B, N], sorted order

        for t in range(L):
            with span("decode.step"):
                finished, scores, tokens, emit, flat_src = _beam_step(finished, scores, tokens,
                                                                      logprobs, t)
                if t == L - 1:
                    break
                if early_exit:
                    beam_search_batched.host_syncs += 1
                    with span("decode.sync", beam_search_batched, "sync_wait_ns"):
                        done = bool((finished | pad[..., None]).all())
                    if done:
                        break
                logprobs, state = step_logprobs(dec, cfg, emit.reshape(B, N * k), bctx, pre,
                                                _reorder(state, flat_src), dtype)
                beam_search_batched.steps += 1

        # padding proposals decode garbage from their [0, 1) window: zero them
        tokens = torch.where(pad[..., None, None], torch.zeros_like(tokens), tokens)
        scores = torch.where(pad[..., None], torch.zeros_like(scores), scores)
        ranked = scores
        if length_alpha > 0.0:
            lengths = (tokens != 0).sum(dim=3).float() + 1.0
            ranked = scores / torch.pow((5.0 + lengths) / 6.0, length_alpha)
        order = torch.argsort(-ranked, dim=2, stable=True)
        all_seqs = torch.gather(tokens, 2, order[..., None].expand(tokens.shape))
        all_scores = torch.gather(scores, 2, order)
        if inv is not None:  # undo the window sort
            all_seqs = torch.gather(all_seqs, 1, inv[:, :, None, None].expand(all_seqs.shape))
            all_scores = torch.gather(all_scores, 1, inv[:, :, None].expand(all_scores.shape))
        return BeamResult(all_seqs[:, :, 0], all_scores[:, :, 0], all_seqs, all_scores)


# decode steps run (the <bos> step included) and early-exit host syncs
# taken, by all calls; the host's ns in the calls, and of them in the
# early exit's syncs
beam_search_batched.steps = 0
beam_search_batched.host_syncs = 0
beam_search_batched.host_ns = 0
beam_search_batched.sync_wait_ns = 0


def beam_search(dec: Decoder, cfg: Config, ctxs: Contexts, beam_size: int,
                length_alpha: float = 0.0, early_exit: Optional[bool] = None,
                dtype: torch.dtype = torch.float32) -> BeamResult:
    """Beam search of one video's proposals (echr_tpu's beam_search):
    beam_search_batched on a batch of one, with the window sort and its
    un-permute and the video's own early exit (``early_exit`` None:
    runtime.decode_early_exit, whose False is the fixed-L loop).
    Bucket-padding rows come back as zeros.  Returns a BeamResult without the batch axis (seq
    [N, L], logprob [N], all_seqs [N, k, L], all_logprobs [N, k])."""
    if early_exit is None:
        early_exit = bool(cfg.runtime.decode_early_exit)
    res = beam_search_batched(dec, cfg, one_video_ctxs(ctxs), beam_size, length_alpha,
                              early_exit, dtype)
    return BeamResult(*(x[0] for x in res))
