"""Primitive ops and the CUDA kernels' wrappers.

Each kernel wrapper takes its plain PyTorch version for tensors that lie
on the CPU and launches its kernel for CUDA tensors.  The only other way
to the plain versions is ``force_plain()``, an explicit context for tests
and for chip_smoke.py's kernel-against-plain comparisons.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading

_FORCE_PLAIN = contextvars.ContextVar("echr_tpu_torch_force_plain", default=False)


@contextlib.contextmanager
def force_plain():
    """Run every kernel wrapper's plain PyTorch version, even on CUDA
    tensors.  For tests and kernel comparisons only."""
    token = _FORCE_PLAIN.set(True)
    try:
        yield
    finally:
        _FORCE_PLAIN.reset(token)


def use_plain(x) -> bool:
    """Whether a wrapper given tensor ``x`` runs its plain version: only on
    the CPU, or inside force_plain().  Any other device must be CUDA."""
    if x.device.type == "cpu" or _FORCE_PLAIN.get():
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """wrapper.launches += 1, under a lock: the eval loop launches kernel 1
    from two threads (the val losses on its prep thread, the decode on the
    caller's)."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1
