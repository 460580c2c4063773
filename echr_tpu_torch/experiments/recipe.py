"""The published 3-stage recipe and its SCST stage, as echr_tpu's shell
scripts run them, through the port's train entry point.

    python -m echr_tpu_torch.experiments.recipe [TAG] [SCST_EPOCHS]

is experiments/soak_synthetic.sh's counterpart (on the card; TAG SOAK3,
SCST_EPOCHS 9 by default): on the synthetic-learnable corpus, which the
code generates,

  1. ``train_sst``   TAP pretraining, show_attend_tell captioner
                     (experiments/train_SST.sh:6-17);
  2. ``train_echr``  the three_stream captioner on GT proposals, the TAP
                     warm-started from stage 1 (train_ECHR.sh:8-20);
  3. ``finetune``    joint finetuning with model proposals, both models
                     warm-started from stage 2 (finetune.sh:8-20);
  4. ``scst``        self-critical training from stage 3
                     (soak_synthetic.sh:33-42),

each stage with soak_synthetic.sh's ``SYN`` flags (synthetic learnable
data, a gate every 100 iterations) and stages 2-3 with its
``--min_epoch_when_save 2``.  The argument lists are the scripts' own, flag
for flag; ``tests/test_torch_recipe.py`` reads them from the scripts.

``run_stage(argv, device)`` is what ``cli/train.py`` does with a command
line: ``config.parse_config``, then ``engine.train.train``.  ``soak``
chains the stages, each warm-started from the previous stage's
``model-best.ckpt`` through ``--pretrain`` / ``--pretrain_path``, as the
scripts do.  ``max_iterations`` (one cap a stage) is for short runs only,
as tests/test_pipeline_3stage.py caps ``train``: a capped stage may end
before its first gate, and then, and only then, the next stage starts
from its ``model-last.ckpt``.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Dict, List, Optional, Sequence

from echr_tpu_torch.config import parse_config
from echr_tpu_torch.engine.train import train

log = logging.getLogger("echr_tpu_torch.recipe")

# the flags every script shares (the flagship three_stream captioner's
# contexts, LDA features, the gate's settings, C3D width and anchors)
_CONTEXTS = ["--CG_input_feats_type", "", "--CG_init_feats_type", "",
             "--video_context_type", "VL", "--event_context_type", "ER3",
             "--clip_context_type", "CC"]

# soak_synthetic.sh:17-18: the scripts' cadence (a gate every 2000 or 10000
# iterations) never fires on the 64-video synthetic split
SYN = ["--synthetic", "1", "--synthetic_learnable", "1",
       "--save_checkpoint_every", "100", "--losses_log_every", "100"]


def train_sst(sst_name: str = "SST") -> List[str]:
    """experiments/train_SST.sh:6-17, stage 1: TAP pretraining."""
    return ["--training_mode", "pre_tap", "--tap_epoch", "5", "--cg_epoch", "0",
            "--tapcg_epoch", "0",
            "--caption_model", "show_attend_tell", "--CG_num_layers", "3",
            "--other_feature", "lda", "--lda_dim", "100",
            "--id", sst_name, *_CONTEXTS,
            "--learning_rate_decay_start", "10", "--learning_rate_decay_every", "5",
            "--learning_rate_decay_rate", "0.5", "--min_epoch_when_save", "0", "--save_all",
            "--fast_eval_cg", "1", "--video_dim", "500", "--K", "256",
            "--losses_log_every", "2000", "--save_checkpoint_every", "2000"]


def train_echr(sst_name: str = "SST", ec_name: str = "EC_C3D") -> List[str]:
    """experiments/train_ECHR.sh:8-20, stage 2: the captioner on GT
    proposals, the TAP from stage 1's best checkpoint."""
    return ["--training_mode", "pre_cg", "--tap_epoch", "0", "--cg_epoch", "30",
            "--tapcg_epoch", "0",
            "--caption_model", "three_stream", "--CG_num_layers", "3",
            "--other_feature", "lda", "--lda_dim", "100",
            "--id", ec_name, *_CONTEXTS,
            "--learning_rate_decay_start", "8", "--learning_rate_decay_every", "3",
            "--learning_rate_decay_rate", "0.5", "--min_epoch_when_save", "8", "--save_all",
            "--fast_eval_cg", "1", "--video_dim", "500", "--K", "256",
            "--pretrain", "tap", "--pretrain_path", f"save/{sst_name}/model-best.ckpt",
            "--losses_log_every", "2000", "--save_checkpoint_every", "10000"]


def finetune(ec_name: str = "EC_C3D", jt_name: str = "SST_EC_C3D") -> List[str]:
    """experiments/finetune.sh:8-20, stage 3: joint finetuning, both models
    from stage 2's best checkpoint."""
    return ["--training_mode", "cotrain", "--tap_epoch", "0", "--cg_epoch", "0",
            "--tapcg_epoch", "10",
            "--caption_model", "three_stream", "--CG_num_layers", "3",
            "--other_feature", "lda", "--lda_dim", "100",
            "--id", jt_name, *_CONTEXTS,
            "--lr", "1e-6", "--learning_rate_decay_start", "8", "--learning_rate_decay_every", "3",
            "--learning_rate_decay_rate", "0.5", "--min_epoch_when_save", "8", "--save_all",
            "--fast_eval_cg", "1", "--video_dim", "500", "--K", "256",
            "--pretrain", "tap_cg", "--pretrain_path", f"save/{ec_name}/model-best.ckpt",
            "--losses_log_every", "2000", "--save_checkpoint_every", "10000"]


def scst(tag: str = "SOAK3", scst_epochs: int = 9) -> List[str]:
    """experiments/soak_synthetic.sh:33-42, stage 4: SCST (self_critical_after
    0) from stage 3's best checkpoint, SYN included."""
    return ["--training_mode", "cotrain", "--tap_epoch", "0", "--cg_epoch", "0",
            "--tapcg_epoch", str(scst_epochs),
            "--caption_model", "three_stream", "--CG_num_layers", "3",
            "--other_feature", "lda", "--lda_dim", "100",
            "--id", f"{tag}_RL", *_CONTEXTS,
            "--lr", "5e-6", "--min_epoch_when_save", "0", "--save_all",
            "--fast_eval_cg", "1", "--video_dim", "500", "--K", "256",
            "--pretrain", "tap_cg", "--pretrain_path", f"save/{tag}_JT/model-best.ckpt",
            "--self_critical_after", "0",
            "--losses_log_every", "2000", "--save_checkpoint_every", "10000",
            *SYN]


def stage_argvs(tag: str = "SOAK3", scst_epochs: int = 9) -> List[List[str]]:
    """soak_synthetic.sh's four command lines, in order: each stage script
    with SYN passed through (stages 2-3 also ``--min_epoch_when_save 2``),
    then stage 4."""
    return [train_sst(f"{tag}_SST") + SYN,
            train_echr(f"{tag}_SST", f"{tag}_EC") + SYN + ["--min_epoch_when_save", "2"],
            finetune(f"{tag}_EC", f"{tag}_JT") + SYN + ["--min_epoch_when_save", "2"],
            scst(tag, scst_epochs)]


def run_stage(argv: Sequence[str], device="cuda", max_iterations: Optional[int] = None,
              timing_out: Optional[Dict] = None) -> Dict:
    """One stage as ``python -m echr_tpu_torch.cli.train <argv>`` runs it in
    one process: the command line parsed by ``config.parse_config``, then
    ``engine.train.train`` on ``device``.  Returns train()'s summary."""
    return train(parse_config(list(argv)), max_iterations=max_iterations, device=device,
                 timing_out=timing_out)


def warm_start_path(save_folder: str, capped: bool) -> str:
    """The checkpoint the next stage warm-starts from: the stage's
    model-best.ckpt, or, for a capped stage that ended before its first
    gate, its model-last.ckpt."""
    best = os.path.join(save_folder, "model-best.ckpt")
    if os.path.exists(best) or not capped:
        return best
    return os.path.join(save_folder, "model-last.ckpt")


def with_pretrain_path(argv: Sequence[str], path: str) -> List[str]:
    """``argv`` with the value of its --pretrain_path replaced by ``path``."""
    argv = list(argv)
    argv[argv.index("--pretrain_path") + 1] = path
    return argv


def soak(tag: str = "SOAK3", scst_epochs: int = 9, root: str = "save", device="cuda",
         extra: Sequence[str] = (), max_iterations: Optional[Sequence[int]] = None
         ) -> List[Dict]:
    """soak_synthetic.sh: the four stages in order under ``root`` (the
    scripts' ``save``), each from the previous stage's checkpoint.
    ``extra`` is appended to every stage's command line (the scripts'
    pass-through arguments); ``max_iterations`` caps each stage (four
    ints).  Returns each stage's train() summary."""
    outs: List[Dict] = []
    for i, argv in enumerate(stage_argvs(tag, scst_epochs)):
        argv = argv + ["--checkpoint_path", root, *extra]
        if outs:
            argv = with_pretrain_path(
                argv, warm_start_path(outs[-1]["save_folder"], max_iterations is not None))
        cap = None if max_iterations is None else max_iterations[i]
        log.info("stage %d: %s", i + 1, " ".join(argv))
        outs.append(run_stage(argv, device, cap))
    return outs


def main(argv: Sequence[str]) -> None:
    logging.basicConfig(format="[%(asctime)s] %(message)s", datefmt="%d %H:%M",
                        level=logging.INFO)
    tag = argv[0] if argv else "SOAK3"
    scst_epochs = int(argv[1]) if len(argv) > 1 else 9
    for i, out in enumerate(soak(tag, scst_epochs)):
        log.info("stage %d: %d iterations, best val score %s, %s", i + 1, out["iteration"],
                 out["best_val_score"], out["save_folder"])


if __name__ == "__main__":
    main(sys.argv[1:])
