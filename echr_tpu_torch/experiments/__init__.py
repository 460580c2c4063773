"""The port's counterparts of the Pallas probes under experiments/, each
named after the JAX probe it ports and driving its kernels at the probe's
shapes:

  probe_greedy_head      — kernel 7 against the dense product and its
                           reductions (X0), the product alone (XM) and
                           kernel 2
  probe_streaming_head2  — kernel 8's tile sweep against X0 and XM
  probe_mxu_vpu_overlap  — kernels 9 and 10: does tensor-core work hide
                           under the tanh work?
  probe_trained_e2e      — the batched eval of a trained checkpoint with the
                           batch-wide early exit on and off

and two probes of the port's own, with no JAX original:

  probe_tanh             — csrc/tanh.cuh's tanh against CUDA's tanhf in
                           kernels 1 and 4: SASS, accuracy, time (the card
                           only)
  probe_scst_replay      — SCST's replay against its rollout: the first
                           product that differs (ROADMAP.md C.2)

Each has ``run(device="cuda", ...)`` (probe_trained_e2e: ``load`` and
``compare``), which prints the probe's table and returns its record, and
runs as ``python -m echr_tpu_torch.experiments.<name>``.  Importing a
probe runs nothing.  The JAX probes under experiments/ stay the
reference.

``recipe`` is the counterpart of the shell scripts under experiments/:
the published 3-stage recipe and its SCST stage as command lines,
``run_stage`` and ``soak`` (``python -m echr_tpu_torch.experiments.recipe``).
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def probe_device(device) -> torch.device:
    """The device a probe runs on: the card unless the caller asks for the
    CPU; raises where CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"probe on {device!r}: CUDA is not available (pass device='cpu')")
    return dev


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def ms_per_step(loop: Callable[[], torch.Tensor], dev: torch.device, steps: int,
                repeats: int = 3) -> float:
    """The probes' timing: one warm-up run of ``loop`` (``steps`` steps that
    depend on each other), then the least of ``repeats`` timed runs, per
    step.  CUDA events on the card; the host clock on the CPU."""
    loop()
    best = float("inf")
    for _ in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loop()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            loop()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best / steps
