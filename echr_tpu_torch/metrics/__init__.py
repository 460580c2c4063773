"""Dense-captioning metrics (echr_tpu/metrics/), the port's own copy."""
from echr_tpu_torch.metrics.eval_score import eval_score  # noqa: F401
