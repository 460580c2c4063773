"""ActivityNet dense-captioning evaluation protocol, Py3
(echr_tpu/metrics/eval_score.py, the port's copy, the same behaviour).

Capability parity with the reference's vendored evaluator (reference:
external_tool/densevid_eval/evaluate.py, Krishna 2017 protocol):

  * predictions capped to top-N per video by proposal_score/re_score
    (:63-87),
  * per-tIoU captioning scores: every prediction is paired with every GT
    caption overlapping >= tIoU; unmatched predictions score against the
    garbage string 'abc123!@#' (:217-219); per-video scorer averages
    (:240-262),
  * detection precision/recall as GT/prediction set coverage (:139-170),
  * tIoUs fixed to [0.3, 0.5, 0.7, 0.9], refs val_1.json + val_2.json
    (:303-321).

GT can come from reference-format JSON files or be synthesised from a
Loader's dataset (synthetic runs have no val_*.json on disk).
"""
from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from echr_tpu_torch.metrics import scorers, tokenizer

log = logging.getLogger("echr_tpu_torch.metrics")

GARBAGE = "abc123!@#"


def _iou(a, b) -> float:
    # reference: evaluate.py:100-106
    s_i, e_i = a
    s, e = b
    inter = max(0, min(e, e_i) - max(s, s_i))
    union = min(max(e, e_i) - min(s, s_i), e - s + e_i - s_i)
    return float(inter) / (union + 1e-8)


class ANETCaptions:
    def __init__(
        self,
        ground_truths: List[Dict],
        prediction: Dict,
        tious: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
        max_proposals: int = 1000,
        max_proposals_type: str = "proposal_score",
        verbose: bool = False,
        only_recall: bool = False,
        meteor_synonyms: Optional[str] = None,
        meteor_paraphrases: Optional[str] = None,
    ):
        self.tious = list(tious)
        self.verbose = verbose
        self.only_recall = only_recall
        self.ground_truths = ground_truths
        self.prediction = self._cap_predictions(prediction, max_proposals, max_proposals_type)
        # matcher data assets route METEOR through the jar's full module
        # stack (exact>stem>synonym>paraphrase); None/"" = exact+stem only
        meteor = scorers.Meteor(synonyms=meteor_synonyms or None,
                                paraphrases=meteor_paraphrases or None)
        if verbose:
            self.scorers = [
                (scorers.Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
                (meteor, "METEOR"),
                (scorers.Rouge(), "ROUGE_L"),
                (scorers.Cider(), "CIDEr"),
            ]
        else:
            self.scorers = [(meteor, "METEOR")]
        self.scores: Dict[str, List[float]] = {}

    @staticmethod
    def _cap_predictions(submission: Dict, max_proposals: int, key: str) -> Dict:
        # reference: evaluate.py:63-87 — threshold at the top-N-th score
        results = {}
        for vid, props in submission["results"].items():
            if not props:
                results[vid] = props
                continue
            ps = np.sort(np.array([p[key] for p in props]))
            thr = ps[-min(len(ps), max_proposals)]
            results[vid] = [p for p in props if p[key] >= thr]
        return results

    def get_gt_vid_ids(self) -> List[str]:
        ids = set()
        for gt in self.ground_truths:
            ids |= set(gt.keys())
        return list(ids)

    def evaluate(self) -> Dict[str, List[float]]:
        if not self.only_recall:
            for tiou in self.tious:
                out = self.evaluate_tiou(tiou)
                for metric, s in out.items():
                    self.scores.setdefault(metric, []).append(s)
        self.scores["Recall"] = []
        self.scores["Precision"] = []
        for tiou in self.tious:
            precision, recall = self.evaluate_detection(tiou)
            self.scores["Recall"].append(recall)
            self.scores["Precision"].append(precision)
        return self.scores

    def evaluate_detection(self, tiou: float):
        # reference: evaluate.py:139-170
        gt_vid_ids = self.get_gt_vid_ids()
        recall = [0.0] * len(gt_vid_ids)
        precision = [0.0] * len(gt_vid_ids)
        for vi, vid in enumerate(gt_vid_ids):
            best_recall, best_precision = 0.0, 0.0
            for gt in self.ground_truths:
                if vid not in gt:
                    continue
                refs = gt[vid]
                ref_cov, pred_cov = set(), set()
                pred_i = -1
                if vid in self.prediction:
                    for pred_i, pred in enumerate(self.prediction[vid]):
                        for ref_i, ref_ts in enumerate(refs["timestamps"]):
                            if _iou(pred["timestamp"], ref_ts) > tiou:
                                ref_cov.add(ref_i)
                                pred_cov.add(pred_i)
                    if pred_i >= 0:
                        best_precision = max(best_precision, len(pred_cov) / (pred_i + 1))
                best_recall = max(best_recall, len(ref_cov) / len(refs["timestamps"]))
            recall[vi] = best_recall
            precision[vi] = best_precision
        return sum(precision) / len(precision), sum(recall) / len(recall)

    def evaluate_tiou(self, tiou: float) -> Dict[str, float]:
        # reference: evaluate.py:172-263
        gt_vid_ids = self.get_gt_vid_ids()
        vid2capid: Dict[str, List[int]] = {v: [] for v in gt_vid_ids}
        cur_res: Dict[int, List[Dict[str, str]]] = {}
        cur_gts: Dict[int, List[Dict[str, str]]] = {}
        uid = 0
        for vid in gt_vid_ids:
            if vid not in self.prediction:
                continue
            for pred in self.prediction[vid]:
                has_added = False
                for gt in self.ground_truths:
                    if vid not in gt:
                        continue
                    caps = gt[vid]
                    for ci, cts in enumerate(caps["timestamps"]):
                        if _iou(pred["timestamp"], cts) >= tiou:
                            cur_res[uid] = [{"caption": _ascii(pred["sentence"])}]
                            cur_gts[uid] = [{"caption": _ascii(caps["sentences"][ci])}]
                            vid2capid[vid].append(uid)
                            uid += 1
                            has_added = True
                if not has_added:
                    cur_res[uid] = [{"caption": _ascii(pred["sentence"])}]
                    cur_gts[uid] = [{"caption": GARBAGE}]
                    vid2capid[vid].append(uid)
                    uid += 1

        tok_res = tokenizer.tokenize(cur_res)
        tok_gts = tokenizer.tokenize(cur_gts)

        output: Dict[str, float] = {}
        for scorer, method in self.scorers:
            all_scores: Dict[str, object] = {}
            for vid in gt_vid_ids:
                res_v = {i: tok_res[i] for i in vid2capid[vid]}
                gts_v = {i: tok_gts[i] for i in vid2capid[vid]}
                if not res_v or not gts_v:
                    score = [0.0] * len(method) if isinstance(method, list) else 0.0
                else:
                    score, _ = scorer.compute_score(gts_v, res_v)
                all_scores[vid] = score
            if isinstance(method, list):
                means = np.mean(np.array(list(all_scores.values()), dtype=float), axis=0)
                for mi, m in enumerate(method):
                    output[m] = float(means[mi])
            else:
                output[method] = float(np.mean(list(all_scores.values())))
        return output


def _ascii(text: str) -> str:
    # reference: evaluate.py:24-25
    return "".join(c if ord(c) < 128 else " " for c in text)


def gt_from_dataset(loader, split: str = "val") -> Dict:
    """Synthesize a reference-format GT dict from a Loader's dataset."""
    gt = {}
    for ix in loader.dataset.split_ix[split]:
        ex = loader.dataset.get_example(ix)
        gt[ex.vid] = {
            "duration": ex.duration,
            "timestamps": [list(t) for t in ex.timestamps],
            "sentences": list(ex.sentences),
        }
    return gt


def eval_score(
    json_path: str,
    only_recall: bool = False,
    verbose: bool = False,
    topN: int = 1000,
    references: Optional[Sequence[str]] = None,
    gt_from_loader=None,
    tious: Sequence[float] = (0.3, 0.5, 0.7, 0.9),
    meteor_synonyms: Optional[str] = None,
    meteor_paraphrases: Optional[str] = None,
) -> Dict[str, List[float]]:
    """Entry point (reference: evaluate.py:303-321)."""
    with open(json_path) as f:
        submission = json.load(f)
    gts: List[Dict] = []
    for ref in references or []:
        with open(ref) as f:
            gts.append(json.load(f))
    if not gts:
        if gt_from_loader is None:
            raise ValueError("no GT references given and no loader to synthesise from")
        gts = [gt_from_dataset(gt_from_loader)]
    ev = ANETCaptions(
        ground_truths=gts,
        prediction=submission,
        tious=tious,
        max_proposals=topN,
        verbose=verbose,
        only_recall=only_recall,
        meteor_synonyms=meteor_synonyms,
        meteor_paraphrases=meteor_paraphrases,
    )
    scores = ev.evaluate()
    scores["tiou"] = list(tious)
    return scores
