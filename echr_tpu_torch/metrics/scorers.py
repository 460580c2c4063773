"""Pure-Python caption scorers: BLEU, ROUGE-L, CIDEr-D, METEOR
(echr_tpu/metrics/scorers.py, the port's copy, the same behaviour).

The reference delegates to the coco-caption submodule (Py2 + a Java METEOR
1.5 jar) which is declared but NOT vendored in the snapshot
(reference: .gitmodules:1-3, evaluate.py:14-18).  The project assumes no
JVM and no pycocoevalcap package, so these are independent Py3
implementations pinned to the official algorithms:

  BLEU   — pycocoevalcap BleuScorer semantics: corpus BLEU-1..4 with
           closest-reference-length brevity penalty (ties -> shorter ref),
           (correct + 1e-15) / (guess + 1e-9) precisions, per-image scores
           with per-image ratio BP.
  ROUGE  — pycocoevalcap Rouge semantics: per-key F_beta(beta=1.2) from
           max-precision and max-recall taken independently across refs.
  CIDEr  — pycocoevalcap CiderScorer semantics (the coco-caption scorer is
           CIDEr-D): tf-idf 4-gram cosine with hyp-count clipping and a
           length gaussian (sigma=6), x10; df over the call's reference
           corpus; idf = log(N_docs) - log(max(df, 1)).
  METEOR — METEOR 1.5 (Denkowski & Lavie 2014) "ranking"-task English
           parameters alpha=0.85, beta=0.2, gamma=0.6, delta=0.75 with the
           exact (w=1.0) and Porter-stem (w=0.6) matchers, one-to-one
           alignment chosen by beam search maximizing word coverage, then
           minimizing chunks, then total match distance (the jar's
           resolution order); content/function-word delta weighting;
           corpus score computed from SUMMED alignment statistics (the
           jar's aggregate), not a mean of segment scores.  The WordNet
           synonym (w=0.8) and paraphrase-table (w=0.6) matcher STAGES are
           implemented and pluggable — Meteor(synonyms=..., paraphrases=...)
           with metrics.matchers loaders for the jar-style data formats —
           but the jar's data assets are absent from the repo, so the DEFAULT
           configuration runs exact+stem only, and the function-word list
           is a standard closed-class list rather than the jar's
           frequency-derived one; absolute METEOR in the default config
           therefore differs from the Java jar by a system-consistent
           offset (see tests/test_metric_parity_official.py,
           tests/test_meteor_matchers.py's ready-to-run offset fixture, and
           BASELINE.md "metric parity" note).

Interface matches pycocoevalcap: scorer.compute_score(gts, res) ->
(score, per-key scores), where gts/res map key -> [sentence].
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

try:  # Porter stemmer for METEOR's stem module
    from nltk.stem.porter import PorterStemmer

    _STEM = PorterStemmer().stem
except Exception:  # pragma: no cover
    _STEM = lambda w: w  # noqa: E731


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU  (pycocoevalcap bleu_scorer semantics, option='closest')
# ---------------------------------------------------------------------------


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def method(self) -> str:
        return "Bleu"

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[List[float], List[List[float]]]:
        small, tiny = 1e-9, 1e-15
        n = self.n
        tot_guess = [0] * n
        tot_correct = [0] * n
        tot_testlen, tot_reflen = 0, 0
        per_image: List[List[float]] = [[] for _ in range(n)]
        for k in gts:
            hyp = res[k][0].split()
            refs = [r.split() for r in gts[k]]
            testlen = len(hyp)
            # closest reference length; ties broken toward the shorter ref
            reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]
            guess = [max(testlen - i, 0) for i in range(n)]
            correct = []
            for i in range(1, n + 1):
                hc = _ngrams(hyp, i)
                max_ref: Counter = Counter()
                for r in refs:
                    for ng, c in _ngrams(r, i).items():
                        if c > max_ref[ng]:
                            max_ref[ng] = c
                correct.append(sum(min(c, max_ref[ng]) for ng, c in hc.items()))
            tot_testlen += testlen
            tot_reflen += reflen
            for i in range(n):
                tot_guess[i] += guess[i]
                tot_correct[i] += correct[i]
            # per-image cumulative BLEU with per-image brevity penalty
            bleu = 1.0
            for i in range(n):
                bleu *= (correct[i] + tiny) / (guess[i] + small)
                per_image[i].append(bleu ** (1.0 / (i + 1)))
            ratio = (testlen + tiny) / (reflen + small)
            if ratio < 1:
                bp = math.exp(1 - 1.0 / ratio)
                for i in range(n):
                    per_image[i][-1] *= bp
        scores: List[float] = []
        bleu = 1.0
        ratio = (tot_testlen + tiny) / (tot_reflen + small)
        bp = math.exp(1 - 1.0 / ratio) if ratio < 1 else 1.0
        for i in range(n):
            bleu *= (tot_correct[i] + tiny) / (tot_guess[i] + small)
            scores.append(bp * bleu ** (1.0 / (i + 1)))
        return scores, per_image


# ---------------------------------------------------------------------------
# ROUGE-L  (pycocoevalcap rouge semantics)
# ---------------------------------------------------------------------------


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def method(self) -> str:
        return "Rouge"

    @staticmethod
    def _lcs(a: Sequence[str], b: Sequence[str]) -> int:
        if not a or not b:
            return 0
        prev = [0] * (len(b) + 1)
        for x in a:
            cur = [0]
            for j, y in enumerate(b, 1):
                cur.append(prev[j - 1] + 1 if x == y else max(cur[-1], prev[j]))
            prev = cur
        return prev[-1]

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        hyp = candidate[0].split()
        prec, rec = [], []
        for ref_s in refs:
            ref = ref_s.split()
            lcs = self._lcs(hyp, ref)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(ref) if ref else 0.0)
        # pycocoevalcap takes max precision and max recall INDEPENDENTLY
        # across refs (possibly from different refs), then one F score
        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            b2 = self.beta**2
            return (1 + b2) * prec_max * rec_max / (rec_max + b2 * prec_max)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        scores = [self.calc_score(res[k], gts[k]) for k in gts]
        return (sum(scores) / len(scores) if scores else 0.0), scores


# ---------------------------------------------------------------------------
# CIDEr-D  (pycocoevalcap cider_scorer semantics)
# ---------------------------------------------------------------------------


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def method(self) -> str:
        return "CIDEr"

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        keys = list(gts.keys())
        # document frequency over the reference set of this call
        df = [defaultdict(float) for _ in range(self.n)]
        ref_grams = {}
        for k in keys:
            per_ref = [
                [_ngrams(r.split(), n + 1) for n in range(self.n)] for r in gts[k]
            ]
            ref_grams[k] = per_ref
            for n in range(self.n):
                seen = set()
                for grams in per_ref:
                    seen |= set(grams[n].keys())
                for ng in seen:
                    df[n][ng] += 1.0
        ndoc = max(len(keys), 1)
        log_ndoc = math.log(max(ndoc, 1))

        def vec(grams_by_n):
            out, norms = [], []
            for n in range(self.n):
                v = {}
                for ng, c in grams_by_n[n].items():
                    idf = log_ndoc - math.log(max(df[n][ng], 1.0))
                    v[ng] = c * idf
                out.append(v)
                norms.append(math.sqrt(sum(x * x for x in v.values())))
            return out, norms

        scores = []
        for k in keys:
            hyp_tokens = res[k][0].split()
            hyp_grams = [_ngrams(hyp_tokens, n + 1) for n in range(self.n)]
            hv, hn = vec(hyp_grams)
            score = 0.0
            for ref_idx, ref_s in enumerate(gts[k]):
                rv, rn = vec(ref_grams[k][ref_idx])
                ref_len = len(gts[k][ref_idx].split())
                delta = len(hyp_tokens) - ref_len
                sim = 0.0
                for n in range(self.n):
                    # CIDEr-D: clip hyp tf-idf to ref tf-idf
                    num = sum(
                        min(hv[n].get(ng, 0.0), rv[n][ng]) * rv[n][ng] for ng in rv[n]
                    )
                    if hn[n] and rn[n]:
                        sim += (
                            num
                            / (hn[n] * rn[n])
                            * math.exp(-(delta**2) / (2 * self.sigma**2))
                        )
                score += sim / self.n
            scores.append(10.0 * score / max(len(gts[k]), 1))
        return (sum(scores) / len(scores) if scores else 0.0), scores


# ---------------------------------------------------------------------------
# METEOR 1.5 (exact + stem matchers; see module docstring for omissions)
# ---------------------------------------------------------------------------

# Standard English closed-class (function) words.  Approximates the jar's
# frequency-derived data/function/en.words list (words with relative corpus
# frequency above 1e-3 — overwhelmingly these closed-class items).
_FUNCTION_WORDS = frozenset(
    """a an the this that these those some any each every either neither
    no all both few many much more most other another such what which who
    whom whose i you he she it we they me him her us them my your his its
    our their mine yours hers ours theirs myself yourself himself herself
    itself ourselves yourselves themselves and or but nor so yet for if
    then than as because while although though since unless until when
    whenever where wherever whether once of in on at by with from to into
    onto upon about against between among through during before after
    above below under over up down out off near across behind beyond
    within without along around past toward towards is am are was were be
    been being do does did doing have has had having will would shall
    should may might must can could not n't there here also just only
    very too quite rather now ever never always often again let
    's 'd 'll 'm 're 've""".split()
)


class _AlignState:
    __slots__ = ("used_ref", "pairs", "last", "chunks", "dist", "count")

    def __init__(self, used_ref, pairs, last, chunks, dist, count):
        self.used_ref = used_ref  # frozenset of matched ref indices
        self.pairs = pairs        # tuple of (hyp_i, ref_j, weight)
        self.last = last          # (hyp_i, ref_j) of last match or None
        self.chunks = chunks
        self.dist = dist
        self.count = count

    def key(self):
        # partial-order comparator: max coverage, min chunks, min distance
        return (-self.count, self.chunks, self.dist)


class Meteor:
    ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
    W_EXACT, W_STEM = 1.0, 0.6
    W_SYN, W_PARA = 0.8, 0.6  # jar module weights (METEOR 1.5 en ranking)
    BEAM = 40  # the jar's default aligner beam size

    def __init__(self, synonyms=None, paraphrases=None):
        """Default (both None): exact+stem matchers via the oracle-pinned
        word-level aligner — byte-identical to the historical behavior.
        With matcher data (metrics.matchers.SynonymTable / ParaphraseTable,
        or paths for their from_file loaders), alignment routes through the
        span-capable aligner with the jar's full module stack
        (reference: external_tool/densevid_eval/evaluate.py:16,61)."""
        from echr_tpu_torch.metrics import matchers as M

        if isinstance(synonyms, str):
            synonyms = M.SynonymTable.from_file(synonyms)
        if isinstance(paraphrases, str):
            paraphrases = M.ParaphraseTable.from_file(paraphrases)
        self.synonyms = synonyms
        self.paraphrases = paraphrases

    def method(self) -> str:
        return "METEOR"

    # -- alignment ----------------------------------------------------------

    @classmethod
    def _candidates(cls, hyp: List[str], ref: List[str]) -> Dict[int, List[Tuple[int, float]]]:
        """Per hyp index: list of (ref index, matcher weight).  A pair
        matched by both matchers keeps the higher-priority (exact) one."""
        by_word: Dict[str, List[int]] = defaultdict(list)
        by_stem: Dict[str, List[int]] = defaultdict(list)
        for j, w in enumerate(ref):
            by_word[w].append(j)
            by_stem[_STEM(w)].append(j)
        out: Dict[int, List[Tuple[int, float]]] = {}
        for i, w in enumerate(hyp):
            exact = by_word.get(w, [])
            pairs = [(j, cls.W_EXACT) for j in exact]
            seen = set(exact)
            for j in by_stem.get(_STEM(w), []):
                if j not in seen:
                    pairs.append((j, cls.W_STEM))
            if pairs:
                out[i] = sorted(pairs)
        return out

    @classmethod
    def _align(cls, hyp: List[str], ref: List[str]) -> Tuple[Tuple[int, int, float], ...]:
        """One-to-one alignment via beam search over hyp positions,
        selecting by (1) max words covered, (2) min chunks, (3) min total
        |hyp_i - ref_j| — the jar's resolution priorities."""
        cands = cls._candidates(hyp, ref)
        beam = [_AlignState(frozenset(), (), None, 0, 0, 0)]
        for i in range(len(hyp)):
            opts = cands.get(i)
            if not opts:
                continue
            nxt = list(beam)  # option: leave hyp word i unmatched
            for st in beam:
                for j, w in opts:
                    if j in st.used_ref:
                        continue
                    contiguous = st.last is not None and st.last == (i - 1, j - 1)
                    nxt.append(
                        _AlignState(
                            st.used_ref | {j},
                            st.pairs + ((i, j, w),),
                            (i, j),
                            st.chunks + (0 if contiguous else 1),
                            st.dist + abs(i - j),
                            st.count + 1,
                        )
                    )
            nxt.sort(key=_AlignState.key)
            beam = nxt[: cls.BEAM]
        return min(beam, key=_AlignState.key).pairs

    # -- per-segment statistics ---------------------------------------------

    @classmethod
    def _word_weight(cls, w: str) -> float:
        return (1.0 - cls.DELTA) if w in _FUNCTION_WORDS else cls.DELTA

    def _stats(self, hyp: List[str], ref: List[str]):
        """(p_num, p_den, r_num, r_den, chunks, matches_avg) for one pair.
        Without matcher data this is the historical exact+stem word-level
        path, byte-identical; with synonyms/paraphrases it routes through
        the span-capable aligner (metrics.matchers)."""
        cls = type(self)
        if self.synonyms is not None or self.paraphrases is not None:
            return self._stats_spans(hyp, ref)
        p_den = sum(cls._word_weight(w) for w in hyp)
        r_den = sum(cls._word_weight(w) for w in ref)
        pairs = cls._align(hyp, ref) if hyp and ref else ()
        p_num = sum(w * cls._word_weight(hyp[i]) for i, _, w in pairs)
        r_num = sum(w * cls._word_weight(ref[j]) for _, j, w in pairs)
        chunks = 0
        last = None
        for i, j, _ in pairs:
            if last != (i - 1, j - 1):
                chunks += 1
            last = (i, j)
        m_avg = float(len(pairs))  # 1-1 word matches: |hyp side| == |ref side|
        return p_num, p_den, r_num, r_den, chunks, m_avg

    def _stats_spans(self, hyp: List[str], ref: List[str]):
        """Full-matcher-stack statistics: span matches contribute every
        covered word at the module weight; m = (hyp covered + ref covered)/2
        (the jar's average-matches fragmentation denominator, which equals
        len(pairs) in the 1-1 word case)."""
        from echr_tpu_torch.metrics import matchers as M

        cls = type(self)
        p_den = sum(cls._word_weight(w) for w in hyp)
        r_den = sum(cls._word_weight(w) for w in ref)
        pairs = ()
        if hyp and ref:
            cands = M.span_candidates(
                hyp, ref, _STEM, cls.W_EXACT, cls.W_STEM, cls.W_SYN,
                cls.W_PARA, self.synonyms, self.paraphrases)
            pairs = M.align_spans(hyp, ref, cands, cls.BEAM)
        p_num = r_num = 0.0
        hyp_cov = ref_cov = 0
        chunks = 0
        last_end = None
        for (i0, il, j0, jl, w, _prio) in pairs:
            p_num += w * sum(cls._word_weight(hyp[i]) for i in range(i0, i0 + il))
            r_num += w * sum(cls._word_weight(ref[j]) for j in range(j0, j0 + jl))
            hyp_cov += il
            ref_cov += jl
            if last_end != (i0, j0):
                chunks += 1
            last_end = (i0 + il, j0 + jl)
        m_avg = 0.5 * (hyp_cov + ref_cov)
        return p_num, p_den, r_num, r_den, chunks, m_avg

    @classmethod
    def _score_from_stats(cls, st) -> float:
        p_num, p_den, r_num, r_den, chunks, m = st
        if p_num == 0.0 or r_num == 0.0 or p_den == 0.0 or r_den == 0.0:
            return 0.0
        p = p_num / p_den
        r = r_num / r_den
        f_mean = p * r / (cls.ALPHA * p + (1 - cls.ALPHA) * r)
        frag = (chunks / m) if m > 0 else 0.0
        return f_mean * (1.0 - cls.GAMMA * frag**cls.BETA)

    def _pair_score(self, hyp: List[str], ref: List[str]) -> float:
        """Segment score of one hyp/ref pair (test hook)."""
        return self._score_from_stats(self._stats(hyp, ref))

    # -- corpus interface ----------------------------------------------------

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        """Per key: best ref by segment score; corpus score from SUMMED
        stats of the chosen alignments (the jar's aggregate score), as the
        pycocoevalcap Meteor wrapper reports it."""
        seg_scores: List[float] = []
        agg = [0.0] * 6
        for k in gts:
            hyp = res[k][0].split()
            best = None
            best_score = -1.0
            for r in gts[k]:
                st = self._stats(hyp, r.split())
                s = self._score_from_stats(st)
                if s > best_score:
                    best_score, best = s, st
            seg_scores.append(best_score)
            for i in range(6):
                agg[i] += best[i]
        return self._score_from_stats(tuple(agg)), seg_scores


def meteor_jar_bracket(gts: Dict, res: Dict) -> Tuple[float, float]:
    """[lo, hi] bracket on the Java METEOR 1.5 jar's corpus score given its
    data assets are absent from the repo (VERDICT r4 next-2; reference:
    external_tool/densevid_eval/evaluate.py:16,61).

    lo = exact+stem-only METEOR (the jar minus its synonym/paraphrase
    modules: every admitted match is one the jar also admits, at the same
    weight).  hi = METEOR with matchers.PromiscuousSynonymTable — every
    non-exact, non-stem pair admitted at the synonym weight 0.8, a superset
    of any WordNet synset table, weight-dominating the 0.6 paraphrase
    stage (caveat on the fragmentation term in the table's docstring).
    System RANKING decisions are sound when intervals don't overlap."""
    from echr_tpu_torch.metrics.matchers import PromiscuousSynonymTable

    lo, _ = Meteor().compute_score(gts, res)
    hi, _ = Meteor(synonyms=PromiscuousSynonymTable()).compute_score(gts, res)
    return float(lo), float(hi)
