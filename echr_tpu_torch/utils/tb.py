"""TensorBoard logging (echr_tpu/utils/tb.py), the port's copy
(reference: tensorboardX SummaryWriter, train.py:121, 351-358, 417-436).
Uses torch.utils.tensorboard; only logs a warning if that is unavailable."""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

log = logging.getLogger("echr_tpu_torch.tb")


class TBWriter:
    def __init__(self, logdir: Optional[str]):
        """``logdir`` None writes nothing (a data-parallel run's ranks but
        rank 0)."""
        self._w = None
        if logdir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(logdir)
        except Exception as e:  # pragma: no cover
            log.warning("tensorboard unavailable (%s); scalars go to the log only", e)

    def scalar(self, tag: str, value, step: int) -> None:
        if self._w is not None:
            try:
                self._w.add_scalar(tag, float(value), step)
            except Exception:
                pass

    def histogram(self, tag: str, values, step: int) -> None:
        """``values``: an array or a tensor on any device, copied to the
        host only when there is a writer."""
        if self._w is not None:
            try:
                if hasattr(values, "detach"):
                    values = values.detach().float().cpu().numpy()
                self._w.add_histogram(tag, np.asarray(values).ravel(), step, bins=10)
            except Exception:
                pass

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
