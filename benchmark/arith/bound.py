"""Roofline bounds on one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W): a frozen copy of chip_smoke.py's ``bound``."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "bf16": 989e12}


def bound(n_bytes: float, **ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate (each input read once, each output written once) and
    the operations over the peak rate of their type, summed over the types
    (``ops`` by type: f32=..., bf16=...)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": sum(ops.values())}
