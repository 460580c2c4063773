"""Command-line entry points: train, eval and score (echr_tpu/cli)."""
