"""Tracing and timing (echr_tpu/utils/profiling.py): a device trace
context on torch.profiler, a timing harness with a device barrier, a
rolling time-a-batch logger, and the reading of a trace's device timeline.

    with device_trace("traces/steps") as prof:
        run_some_steps()
    shares = device_timeline("traces/steps/trace.json")

The reference's only profiling is ad-hoc time.time() prints
(reference: CaptionGenerator.py:22,28,42-43; train.py:343-349).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the block with torch.profiler, the CPU's activity and, where
    CUDA is available, the card's (kernels and copies, through CUPTI), and
    write it as a Chrome trace to ``logdir/trace.json`` (chrome://tracing,
    Perfetto or TensorBoard).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Total length of the intersection of two unions of intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, e - s)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_timeline(trace_path: str) -> Dict[str, float]:
    """The device's timeline in a Chrome trace of device_trace: over the
    traced window (from the first to the last event of any kind), the
    share in which any kernel or copy ran on the card ("busy_share"), the
    share of the host-to-device copy time that overlaps a kernel
    ("h2d_overlap_share"), the longest stretch with no kernel and no copy
    ("longest_idle_ms"), and the kernels', the copies' and the window's
    milliseconds and counts.  Shares are None where their denominator is
    0."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{trace_path}: no complete events")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)

    def spans(pred):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events if pred(e)]

    kernels = spans(lambda e: e.get("cat") == "kernel")
    copies = spans(lambda e: e.get("cat") == "gpu_memcpy")
    h2d = spans(lambda e: e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    k_union, busy = _union(kernels), _union(kernels + copies)
    window = t1 - t0
    busy_us = sum(e - s for s, e in busy)
    h2d_us = sum(e - s for s, e in _union(h2d))
    gaps = [b[0] - a[1] for a, b in zip(busy, busy[1:])]
    if busy:
        gaps += [busy[0][0] - t0, t1 - busy[-1][1]]
    return {
        "window_ms": window / 1e3,
        "busy_share": busy_us / window if window > 0 else None,
        "kernel_ms": sum(e - s for s, e in k_union) / 1e3,
        "kernels": len(kernels),
        "h2d_ms": h2d_us / 1e3,
        "h2d_copies": len(h2d),
        "h2d_overlap_share": (_overlap(_union(h2d), k_union) / h2d_us) if h2d_us > 0 else None,
        "longest_idle_ms": (max(gaps) if gaps else window) / 1e3,
    }


def _barrier(out) -> None:
    """Wait for the device work behind ``out``: a CUDA synchronise of the
    devices its tensors live on; nothing for CPU tensors."""
    devices = set()
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kw) -> Dict[str, float]:
    """Steady-state seconds a call of fn(*args, **kw), each call followed by
    a device barrier on its outputs: mean_s, p50_s, min_s and iters."""
    for _ in range(warmup):
        _barrier(fn(*args, **kw))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _barrier(fn(*args, **kw))
        samples.append(time.perf_counter() - t0)
    arr = np.array(samples)
    return {"mean_s": float(arr.mean()), "p50_s": float(np.percentile(arr, 50)),
            "min_s": float(arr.min()), "iters": iters}


class StepTimer:
    """Rolling time/batch logger (reference: train.py:343-349 logs the wall
    time per losses_log_every window)."""

    def __init__(self):
        self.t0 = time.time()
        self.n = 0

    def tick(self) -> None:
        self.n += 1

    def rate(self) -> float:
        return (time.time() - self.t0) / max(self.n, 1)

    def reset(self) -> None:
        self.t0 = time.time()
        self.n = 0
