"""The device timeline of a Chrome trace from torch.profiler: a frozen
copy of echr_tpu_torch/utils/profiling.py's ``device_timeline``
arithmetic, which also returns the idle gaps, the kernels' time by name
and the host's annotated spans."""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Tuple


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def read(trace_path: str) -> Dict:
    """Over the traced window (first to last event of any kind), in
    seconds: the window, the time in which any kernel or copy ran
    ("busy_s"), the idle gaps [(start, end)], each kernel name's summed
    time, and the host's user annotations [(name, start, end)]."""
    with open(trace_path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{trace_path}: no complete events")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)

    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = _union([span(e) for e in device])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if busy:
        gaps = [(t0, busy[0][0])] + gaps + [(busy[-1][1], t1)]
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e.get("name", "")] += float(e["dur"]) * 1e-6
    notes = [(e.get("name", ""), *span(e)) for e in events if e.get("cat") == "user_annotation"]
    us = 1e-6
    return {"window_s": (t1 - t0) * us, "busy_s": sum(e - s for s, e in busy) * us,
            "gaps": [((s - t0) * us, (e - t0) * us) for s, e in gaps if e > s],
            "kernels_s": dict(by_name),
            "notes": [(n, (s - t0) * us, (e - t0) * us) for n, s, e in notes]}


def label_gaps(timeline: Dict, top: int = 10) -> List[Tuple[str, float]]:
    """The ``top`` longest idle gaps, each named by the innermost host
    annotation that covers its middle ("outside" where none does)."""
    out = []
    for s, e in sorted(timeline["gaps"], key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        cover = [(ne - ns, n) for n, ns, ne in timeline["notes"] if ns <= mid <= ne]
        out.append((min(cover)[1] if cover else "outside", e - s))
    return out
