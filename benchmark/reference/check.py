"""What decides ``correct``: the captions a run served for a sample of
videos, held against the reference computed again from the same inputs.

Each served caption names its anchor by its timestamps; the reference
reads the served outputs only to judge them.  The numbers, each the
worst over the sample:

  malformed   served outputs that break the format: a video missing, a
              caption count other than topN (unless the extra captions
              tie the topN-th score), timestamps that are not an anchor
              of the video or repeat one, a word outside the vocab
  select_gap  how far a served anchor's reference score lies below the
              reference's topN-th score (0 when it is among the topN)
  score_err   |served proposal score - reference score| of an anchor
  token_gap   greedy: how far the reference's logit of a served token
              (END included) lies below the reference's best logit at
              that position, the served tokens fed back
  video_beam_gap_p90
              beam: how far the served caption's ranked score, by the
              reference, lies below the best ranked score of the
              reference's own beam search; the 90th percentile over one
              video's captions (linear, as torch.quantile), the worst
              video.  Not the widest gap, nor a mean: a bf16 rounding
              can flip a near-tie at the k-th beam, and where the
              candidate that drops out is an early END, the length
              penalty makes the two captions' ranked scores differ by
              ~34 (PERF.md).  Not compared, in "info": the widest gap,
              the mean over all sampled captions and the worst video's
              mean.
  logp_err    greedy: |served sentence confidence - the reference's
              summed logprob of the served tokens|, only of captions
              whose counted steps are all served tokens (a proposal that
              ended before the last one of its video keeps decoding its
              own draws, which the served output does not show)
  video_logp_err_mean
              beam: the same error of every caption, the mean over one
              video's captions, the worst video (the widest error of one
              caption, a sum of 30 bf16 roundings, reads within 3x of
              the fp8 control's; PERF.md).  Not compared, in "info":
              the widest.
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.model import Reference, anchors_to_times, ranked_penalty

_WORD = re.compile(r"w([0-9]+)\Z")


class Caption(NamedTuple):
    """A served caption, as serve.Caption carries it."""

    timestamp: Tuple[float, float]
    sentence: str
    proposal_score: float
    sentence_confidence: float


class Served(NamedTuple):
    """One video's inputs and what a run served for it."""

    feats: np.ndarray  # [T, D]
    lda: np.ndarray  # [lda_dim]
    duration: float
    captions: Sequence  # each with timestamp, sentence, proposal_score, sentence_confidence


def vocab(size: int) -> Dict[str, str]:
    """Token id -> word of the served vocab: id i renders as "w<i>"."""
    return {str(i): f"w{i}" for i in range(1, size + 1)}


def _anchor(ts, n_frames: int, duration: float, K: int):
    """The anchor (t, k) whose timestamps are ``ts``, or None."""
    tpf = duration / n_frames
    t = int(round(ts[1] / tpf)) - 1
    k = t - int(round(ts[0] / tpf))
    if not (0 <= k < min(K, t) and t < n_frames):
        return None
    want = anchors_to_times([(t, k)], n_frames, duration)[0]
    if np.abs(want - np.asarray(ts, np.float64)).max() > 1e-9 * max(1.0, duration):
        return None
    return t, k


def _tokens(sentence: str, size: int):
    ids = []
    for w in sentence.split():
        m = _WORD.match(w)
        if not m or not 1 <= int(m.group(1)) <= size:
            return None
        ids.append(int(m.group(1)))
    return ids


def parse(served: Served, n_frames: int, topN: int, s) -> Tuple[List, List, int]:
    """(anchors, token lists, malformed count) of one video's captions."""
    caps = list(served.captions)
    bad = 0
    scores = sorted((float(c.proposal_score) for c in caps), reverse=True)
    tied = len(caps) > topN and all(x == scores[topN - 1] for x in scores[topN:])
    if not (len(caps) == topN or tied):
        bad += 1
    anchors, tokens, seen = [], [], set()
    for c in caps:
        a = _anchor(c.timestamp, n_frames, served.duration, s.K)
        ids = _tokens(c.sentence, s.vocab)
        if a is None or a in seen or ids is None or len(ids) > s.seq_length:
            bad += 1
            continue
        seen.add(a)
        anchors.append(a)
        tokens.append((c, ids))
    return anchors, tokens, bad


def judge(ref: Reference, videos: Sequence[Served], topN: int, beam_size: int) -> Dict:
    """The numbers of the module docstring over ``videos``, and what they
    covered (videos, captions, tokens)."""
    s = ref.s
    L = s.seq_length
    out = {"malformed": 0, "select_gap": 0.0, "score_err": 0.0}
    out.update({"video_logp_err_mean": 0.0, "video_beam_gap_p90": 0.0} if beam_size > 1
               else {"logp_err": 0.0, "token_gap": 0.0})
    seen = {"videos": 0, "captions": 0, "tokens": 0}
    beam_gaps, logp_errs = [], []
    dev = ref.dev
    for v in videos:
        if v is None:  # a video the run did not serve
            out["malformed"] += 1
            continue
        seen["videos"] += 1
        feats = torch.as_tensor(v.feats, dtype=torch.float32, device=dev)
        n_frames = len(feats)
        hidden, scores = ref.encode(feats)
        anchors, tokens, bad = parse(v, n_frames, topN, s)
        out["malformed"] += bad
        if not anchors:
            continue
        thr = ref.threshold(scores, topN)
        ref_sc = scores[tuple(torch.tensor(anchors, device=dev).t())]
        served_sc = torch.tensor([float(c.proposal_score) for c, _ in tokens], device=dev)
        out["select_gap"] = max(out["select_gap"], float((thr - ref_sc).clamp(min=0).max()))
        out["score_err"] = max(out["score_err"], float((served_sc - ref_sc).abs().max()))

        ctx = ref.contexts(feats, hidden, torch.as_tensor(v.lda, dtype=torch.float32,
                                                          device=dev), anchors)
        lens = torch.tensor([len(ids) for _, ids in tokens], device=dev)
        target = torch.zeros(len(tokens), L, dtype=torch.long, device=dev)
        for r, (_, ids) in enumerate(tokens):
            target[r, :len(ids)] = torch.tensor(ids, dtype=torch.long, device=dev)
        steps = min(L, int(lens.max()) + 1)
        logits = ref.teacher_logits(ctx, target[:, :steps])  # [N, steps, V1]
        lp = torch.log_softmax(logits, -1).gather(2, target[:, :steps, None])[..., 0]
        pos = torch.arange(steps, device=dev)[None]
        upto = pos <= lens[:, None]  # the served tokens and END
        conf = torch.tensor([float(c.sentence_confidence) for c, _ in tokens], device=dev)
        seen["captions"] += len(tokens)
        seen["tokens"] += int(upto.sum())
        if beam_size > 1:
            ref_sum = (lp * upto).sum(1)
            errs = (conf - ref_sum).abs()
            logp_errs.append(errs)
            out["video_logp_err_mean"] = max(out["video_logp_err_mean"], float(errs.mean()))
            _, _, best = ref.beam(ctx, beam_size)
            ranked = ref_sum / ranked_penalty(target, s.beam_length_alpha)
            gaps = (best - ranked).clamp(min=0)
            beam_gaps.append(gaps)
            out["video_beam_gap_p90"] = max(out["video_beam_gap_p90"],
                                            float(torch.quantile(gaps, 0.9)))
        else:
            gap = logits.max(-1).values - logits.gather(2, target[:, :steps, None])[..., 0]
            out["token_gap"] = max(out["token_gap"], float(gap[upto].max()))
            active = int(lens.max())  # steps the video's confidence counts
            whole = lens + 1 >= active
            if bool(whole.any()):
                ref_sum = (lp * (pos < active)).sum(1)
                out["logp_err"] = max(out["logp_err"],
                                      float((conf - ref_sum)[whole].abs().max()))
    info = {}
    if beam_gaps:
        gaps = torch.cat(beam_gaps)
        info = {"beam_gap_widest": float(gaps.max()), "beam_gap_pooled": float(gaps.mean()),
                "video_beam_gap_mean": max(float(g.mean()) for g in beam_gaps),
                "logp_err_widest": float(torch.cat(logp_errs).max())}
    return {"numbers": out, "seen": seen, "info": info}


def compare(numbers: Dict, limits: Dict) -> Tuple[Dict, bool]:
    """Each number beside its limit (``limits`` as a cell's limits file
    holds them), and whether every number is within its limit."""
    checks = {k: {"value": v, "limit": limits["limits"][k]} for k, v in numbers.items()}
    return checks, all(x["value"] <= x["limit"] for x in checks.values())


def run_as_program(ref: Reference, video: Served, topN: int, beam_size: int) -> List:
    """The reference in the program's place: the captions it serves for
    one video, in the served form (the control runs it at fp8)."""
    feats = torch.as_tensor(video.feats, dtype=torch.float32, device=ref.dev)
    n_frames = len(feats)
    hidden, scores = ref.encode(feats)
    anchors = ref.select(scores, topN)
    ctx = ref.contexts(feats, hidden, torch.as_tensor(video.lda, dtype=torch.float32,
                                                      device=ref.dev), anchors)
    if beam_size > 1:
        seq, conf, _ = ref.beam(ctx, beam_size)
    else:
        seq, conf = ref.greedy(ctx)
    times = anchors_to_times(anchors, n_frames, video.duration)
    out = []
    for j, (t, k) in enumerate(anchors):
        row = seq[j].tolist()
        words = []
        for tok in row:
            if tok <= 0:
                break
            words.append(f"w{tok}")
        out.append(Caption(tuple(times[j]), " ".join(words), float(scores[t, k]),
                           float(conf[j])))
    return out
