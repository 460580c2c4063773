"""Standalone dense-captioning scorer CLI (echr_tpu/cli/score.py) on the
port's metrics/.

Parity with the reference's standalone evaluator entry
(reference: external_tool/densevid_eval/evaluate.py:338-366): score a
prediction JSON against GT reference files without rebuilding any model.

    python -m echr_tpu_torch.cli.score -s preds.json -r val_1.json val_2.json -v

Flags mirror the reference argparse surface (-s/--submission,
-r/--references, --tious, -ppv/--max-proposals-per-video, -v/--verbose,
-o/--onlyRecall, -ppv_type) plus per-tIoU and averaged score output like
the reference's logger lines.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

from echr_tpu_torch.metrics.eval_score import ANETCaptions

log = logging.getLogger("echr_tpu_torch.score")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "echr_tpu_torch.score",
        description="Evaluate the results stored in a submission file.",
    )
    p.add_argument("-s", "--submission", type=str, required=True)
    p.add_argument("-r", "--references", type=str, nargs="+", required=True,
                   help="GT caption JSONs (e.g. val_1.json val_2.json)")
    p.add_argument("--tious", type=float, nargs="+", default=[0.3, 0.5, 0.7, 0.9])
    p.add_argument("-ppv", "--max-proposals-per-video", type=int, default=1000)
    p.add_argument("-ppv_type", "--max_proposals_per_video_type", type=str,
                   default="proposal_score", choices=["proposal_score", "re_score"])
    p.add_argument("-v", "--verbose", action="store_true",
                   help="score all metrics (Bleu/METEOR/ROUGE/CIDEr), not METEOR-only")
    p.add_argument("-o", "--onlyRecall", type=int, default=0)
    p.add_argument("--meteor_synonyms", type=str, default="",
                   help="METEOR synonym data (jar-style; metrics/matchers.py)")
    p.add_argument("--meteor_paraphrases", type=str, default="",
                   help="METEOR paraphrase table (jar-style)")
    return p


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(message)s")
    ns = build_parser().parse_args(argv)
    with open(ns.submission) as f:
        submission = json.load(f)
    gts = []
    for ref in ns.references:
        with open(ref) as f:
            gts.append(json.load(f))
    ev = ANETCaptions(
        ground_truths=gts,
        prediction=submission,
        tious=ns.tious,
        max_proposals=ns.max_proposals_per_video,
        max_proposals_type=ns.max_proposals_per_video_type,
        verbose=ns.verbose,
        only_recall=bool(ns.onlyRecall),
        meteor_synonyms=ns.meteor_synonyms or None,
        meteor_paraphrases=ns.meteor_paraphrases or None,
    )
    scores = ev.evaluate()
    scores["tiou"] = list(ns.tious)
    for i, tiou in enumerate(ns.tious):
        for metric, vals in scores.items():
            if metric == "tiou":
                continue
            log.info("tIoU %.1f | %s: %2.4f", tiou, metric, 100 * vals[i])
    avg = {k: float(np.asarray(v, dtype=float).mean())
           for k, v in scores.items() if k != "tiou"}
    log.info("avg: %s", {k: round(v, 4) for k, v in avg.items()})
    return scores


if __name__ == "__main__":
    main(sys.argv[1:])
