"""The reference forward of one video: SST, the top-N anchors, the
contexts with TSRM, and the decoder teacher-forced, greedy or in beams.

Float32 with TF32 off.  ``Reference(..., precision="fp8")`` is the
control: every product's two operands rounded to float8 e4m3 with one
scale a tensor (its largest magnitude to 448), the step below the
configuration's bfloat16; the rest stays float32.

Semantics, as the JAX package states them:
  * SST: an LSTM stack over the video's frames, scores sigmoid(h W + b)
    [T, K]; anchor (t, k) is the window [t - k, t + 1), valid for k <
    min(K, t).
  * Selection: the topN-th largest valid score is the threshold; every
    valid anchor at or above it, in (t, k) order.
  * Contexts: video VL / VC / VH; event EC (window mean of C3D), EH (SST
    hidden at t), ER1-3 through TSRM over all events of the video; clip CC
    / CH frames, each proposal attending over its window.
  * TSRM (fST0): grouped QK affinities times a learned affinity of
    pairwise sinusoid position embeddings, a softmax over the events, no
    V projection, the grouped 1x1 output projection.
  * Decode: <bos> = END = 0; greedy emits argmax tokens until END (a
    finished proposal keeps decoding from its own draws; its tokens are
    0); beam search keeps k beams a proposal, a finished beam extends by
    END at +0, and ranks by sum / ((5 + len) / 6)^alpha with len = tokens
    before END + 1.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.cores import core_module
from benchmark.spec import Spec

FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax()
    if float(amax) == 0.0:
        return x
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Rows(NamedTuple):
    """A block of decoder rows of one video."""

    event: torch.Tensor  # [R, De]
    video: torch.Tensor  # [1, Dv]
    mask: torch.Tensor  # [R, T] bool, the row's window
    clip: torch.Tensor  # [T, Dc]
    pre: torch.Tensor  # [T, Hatt], ctx2att(clip)


class Contexts(NamedTuple):
    video: torch.Tensor  # [1, Dv]
    event: torch.Tensor  # [N, De]
    clip: torch.Tensor  # [T, Dc]
    pre: torch.Tensor  # [T, Hatt]
    mask: torch.Tensor  # [N, T] bool

    def rows(self, repeat: int = 1) -> Rows:
        return Rows(self.event.repeat_interleave(repeat, 0), self.video,
                    self.mask.repeat_interleave(repeat, 0), self.clip, self.pre)


class Reference:
    def __init__(self, spec: Spec, tap, cg, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.s, self.tap, self.cg, self.precision = spec, tap, cg, precision
        self.core = core_module(spec.caption_model)
        self.dev = tap["scores"]["w"].device

    # -- primitives ---------------------------------------------------------

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            a, b = _fp8(a), _fp8(b)
        return a @ b

    def dense(self, p, x):
        return self.mm(x, p["w"]) + p["b"]

    def cell(self, p, x, h, c):
        gates = self.mm(x, p["w_ih"]) + self.mm(h, p["w_hh"]) + p["b_ih"] + p["b_hh"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def attend(self, h: torch.Tensor, rows: Rows) -> torch.Tensor:
        """Additive attention of each row over its window's frames."""
        att = self.cg["decoder"]["core"]["attention"]
        q = self.dense(att["h2att"], h)  # [R, Hatt]
        y = torch.tanh(rows.pre[None] + q[:, None])  # [R, T, Hatt]
        s = self.dense(att["alpha_net"], y)[..., 0]  # [R, T]
        p = torch.softmax(s.masked_fill(~rows.mask, float("-inf")), dim=1)
        return self.mm(p, rows.clip)

    # -- proposals ----------------------------------------------------------

    def encode(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats [T, D] -> (hidden [T, H], scores [T, K])."""
        x = feats
        for p in self.tap["rnn"]:
            H = p["w_hh"].shape[0]
            xin = self.mm(x, p["w_ih"]) + p["b_ih"] + p["b_hh"]
            h = torch.zeros(H, device=self.dev)
            c = torch.zeros(H, device=self.dev)
            hs = []
            for t in range(len(x)):
                gates = xin[t] + self.mm(h[None], p["w_hh"])[0]
                i, f, g, o = gates.chunk(4)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                hs.append(h)
            x = torch.stack(hs)
        return x, torch.sigmoid(self.dense(self.tap["scores"], x))

    def valid(self, T: int) -> torch.Tensor:
        t = torch.arange(T, device=self.dev)[:, None]
        k = torch.arange(self.s.K, device=self.dev)[None, :]
        return k < torch.clamp(t, max=self.s.K)

    def threshold(self, scores: torch.Tensor, topN: int) -> float:
        """The topN-th largest valid anchor score (0 with fewer anchors)."""
        v = scores[self.valid(len(scores))]
        return float(torch.topk(v, topN).values[-1]) if len(v) >= topN else 0.0

    def select(self, scores: torch.Tensor, topN: int) -> List[Tuple[int, int]]:
        thr = self.threshold(scores, topN)
        sel = self.valid(len(scores)) & (scores >= thr)
        return [tuple(x) for x in sel.nonzero().tolist()]

    # -- contexts -----------------------------------------------------------

    def contexts(self, feats, hidden, lda, anchors: Sequence[Tuple[int, int]]) -> Contexts:
        s = self.s
        T = len(feats)
        ts = torch.tensor([a[0] for a in anchors], device=self.dev)
        ks = torch.tensor([a[1] for a in anchors], device=self.dev)
        start, end = ts - ks, ts + 1
        frame = torch.arange(T, device=self.dev)
        mask = (frame[None] >= start[:, None]) & (frame[None] < end[:, None])  # [N, T]

        vparts = []
        if "VL" in s.video_context_type:
            vparts.append(lda)
        if "VC" in s.video_context_type:
            vparts.append(feats.mean(0))
        if "VH" in s.video_context_type:
            vparts.append(hidden.mean(0))
        video = torch.cat(vparts)[None]

        w = mask.float() / mask.sum(1, keepdim=True)
        ec = w @ feats  # window means, f32 (the mean itself, not a product of the model)
        eh = hidden[ts]
        et = s.event_context_type
        if "ER1" in et:
            event = self.tsrm(ec, start, end)
        elif "ER2" in et:
            event = self.tsrm(eh, start, end)
        elif "ER3" in et:
            event = self.tsrm(torch.cat([ec, eh], 1), start, end)
        elif ("EC" in et) != ("EH" in et):
            event = ec if "EC" in et else eh
        else:
            raise ValueError(f"event_context_type {et!r} is not a served configuration")
        cparts = []
        if "CC" in s.clip_context_type:
            cparts.append(feats)
        if "CH" in s.clip_context_type:
            cparts.append(hidden)
        clip = torch.cat(cparts, 1)
        pre = self.dense(self.cg["decoder"]["core"]["attention"]["ctx2att"], clip)
        return Contexts(video, event, clip, pre, mask)

    def position_embedding(self, start, end) -> torch.Tensor:
        """[N, N, d] sinusoid embedding of (|d center| / length, log length
        ratio), in float64 and then float32."""
        d = self.s.d_feats
        s64, e64 = start.double(), end.double()
        center, length = 0.5 * (s64 + e64), (e64 - s64).clamp(min=1.0)
        dc = ((center[:, None] - center[None, :]) / length[:, None]).abs().clamp(min=1e-3)
        dl = torch.log(length[None, :] / length[:, None])
        pos = torch.stack([dc, dl], 2)  # [N, N, 2]
        nf = d // 4
        dim_mat = torch.pow(torch.tensor(10000.0, dtype=torch.float64, device=self.dev),
                            (4.0 / d) * torch.arange(nf, dtype=torch.float64, device=self.dev))
        div = (100.0 * pos)[..., None] / dim_mat
        emb = torch.cat([torch.sin(div), torch.cos(div)], 3)
        return emb.reshape(len(start), len(start), d).float()

    def tsrm(self, x, start, end) -> torch.Tensor:
        s, f = self.s, self.cg["fusion"]
        N, g, d = len(x), s.n_head, s.d_feats
        dg = d // g
        e = self.dense(f["event_emb"], x)  # [N, d]
        q = self.dense(f["query"], e).view(N, g, dg).transpose(0, 1)
        k = self.dense(f["key"], e).view(N, g, dg).transpose(0, 1)
        aff = self.mm(q, k.transpose(1, 2)).transpose(0, 1) / math.sqrt(dg)  # [N, g, N]
        if s.use_posit:
            emb = self.position_embedding(start, end)
            aw = self.dense(f["pair_pos_fc2"], torch.tanh(self.dense(f["pair_pos_fc1"], emb)))
            aw = aw.transpose(1, 2)  # [N, g, N]
            aff = {"fST0": lambda: aw * aff, "fST1": lambda: aw + aff,
                   "fST2": lambda: torch.log(aw.clamp(min=1e-6)) + aff,
                   "fST3": lambda: aw}[s.fST_type]()
        w = torch.softmax(aff, dim=2)
        heads = self.mm(w.reshape(N * g, N), e).view(N, g, d)  # no V projection
        out_w = f["out_w"]  # [g, d, d_o / g]
        out = torch.stack([self.mm(heads[:, i], out_w[i]) for i in range(g)], 1)
        return out.reshape(N, s.d_o) + f["out_b"]

    # -- decoder ------------------------------------------------------------

    def _zero_state(self, R: int):
        z = torch.zeros(self.core.LAYERS, R, self.s.H, device=self.dev)
        return z, z.clone()

    def _step(self, rows: Rows, tokens: torch.Tensor, state):
        xt = self.cg["decoder"]["embed"][tokens]
        out, state = self.core.step(self, rows, xt, state)
        return self.dense(self.cg["decoder"]["logit"], out), state

    def teacher_logits(self, ctx: Contexts, targets: torch.Tensor) -> torch.Tensor:
        """targets [N, S] (each row's tokens, END, then anything) -> logits
        [N, S, V1]: position t is fed <bos> then targets[:, t - 1]."""
        rows = ctx.rows()
        state = self._zero_state(len(targets))
        it = torch.zeros(len(targets), dtype=torch.long, device=self.dev)
        out = []
        for t in range(targets.shape[1]):
            logits, state = self._step(rows, it, state)
            out.append(logits)
            it = targets[:, t]
        return torch.stack(out, 1)

    def greedy(self, ctx: Contexts) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tokens [N, L], zeros from END on; confidence [N]: the summed
        logprob of each step's token while any proposal of the video is
        unfinished)."""
        N, L = len(ctx.event), self.s.seq_length
        rows = ctx.rows()
        state = self._zero_state(N)
        it = torch.zeros(N, dtype=torch.long, device=self.dev)
        unfinished = torch.ones(N, dtype=torch.bool, device=self.dev)
        seq = torch.zeros(N, L, dtype=torch.long, device=self.dev)
        conf = torch.zeros(N, device=self.dev)
        for t in range(L):
            logits, state = self._step(rows, it, state)
            lp = torch.log_softmax(logits, 1)
            it = lp.argmax(1)
            unfinished = unfinished & (it > 0)
            if not bool(unfinished.any()):
                break
            seq[:, t] = it * unfinished
            conf = conf + lp.gather(1, it[:, None])[:, 0]
        return seq, conf

    def beam(self, ctx: Contexts, k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(best tokens [N, L], its summed logprob [N], its ranked score [N])."""
        N, L, alpha = len(ctx.event), self.s.seq_length, self.s.beam_length_alpha
        rows = ctx.rows(k)
        state = self._zero_state(N * k)
        it = torch.zeros(N * k, dtype=torch.long, device=self.dev)
        scores = torch.full((N, k), -1e30, device=self.dev)
        scores[:, 0] = 0.0
        finished = torch.zeros(N, k, dtype=torch.bool, device=self.dev)
        tokens = torch.zeros(N, k, L, dtype=torch.long, device=self.dev)
        for t in range(L):
            logits, state = self._step(rows, it, state)
            lp = torch.log_softmax(logits, 1).view(N, k, -1)
            V1 = lp.shape[-1]
            end_only = torch.full((V1,), -1e30, device=self.dev)
            end_only[0] = 0.0
            lp = torch.where(finished[..., None], end_only, lp)
            top, idx = torch.topk((scores[..., None] + lp).view(N, k * V1), k, dim=1)
            src, tok = idx // V1, idx % V1
            tokens = tokens.gather(1, src[..., None].expand(tokens.shape)).clone()
            was = finished.gather(1, src)
            tokens[:, :, t] = torch.where(was, torch.zeros_like(tok), tok)
            finished = was | (tok == 0)
            scores = top
            if bool(finished.all()):
                break
            flat = (torch.arange(N, device=self.dev)[:, None] * k + src).reshape(-1)
            state = (state[0][:, flat], state[1][:, flat])
            it = tokens[:, :, t].reshape(-1)
        ranked = scores / ranked_penalty(tokens, alpha)
        best = ranked.argmax(1)
        pick = best[:, None]
        return (tokens.gather(1, pick[..., None].expand(N, 1, L))[:, 0],
                scores.gather(1, pick)[:, 0], ranked.gather(1, pick)[:, 0])


def ranked_penalty(tokens: torch.Tensor, alpha: float) -> torch.Tensor:
    """GNMT's ((5 + len) / 6)^alpha, len = tokens before END + 1."""
    if alpha <= 0.0:
        return torch.ones(tokens.shape[:-1], device=tokens.device)
    lengths = (tokens != 0).sum(-1).float() + 1.0
    return torch.pow((5.0 + lengths) / 6.0, alpha)


def anchors_to_times(anchors, n_frames: int, duration: float) -> np.ndarray:
    """The served timestamps of anchors (t, k): [t - k, t + 1) frames to
    seconds, clipped as the reference's featstamp_to_time."""
    tpf = duration / n_frames
    out = []
    for t, k in anchors:
        start = min(max(0.0, (t - k) * tpf), duration - tpf)
        out.append((start, max((t + 1) * tpf, start + tpf)))
    return np.asarray(out, np.float64)
