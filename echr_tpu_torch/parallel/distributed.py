"""Joining a torch.distributed group (echr_tpu/parallel/distributed.py).

One process (rank) drives one device: NCCL between ranks on CUDA devices,
gloo between ranks on the CPU.  Launch the same command once per rank:

  * ``ECHR_COORDINATOR=host:port`` with ``ECHR_NUM_PROCESSES`` and
    ``ECHR_PROCESS_ID``: echr_tpu's explicit cluster, a ``tcp://`` init;
  * ``ECHR_DISTRIBUTED=1``: the launcher's environment, torchrun's
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (the
    counterpart of jax.distributed.initialize()'s autodetection).

A CUDA rank takes the device ``cuda:LOCAL_RANK`` (torchrun sets
``LOCAL_RANK``; it is 0 where unset).  Every group has an explicit
timeout, so that a lost peer fails the run instead of hanging it.
echr_tpu's collective warm-ups (``_collective_warmup`` and the mesh's)
work around XLA:CPU's fixed 30 s Gloo rendezvous deadline; torch's
process groups take their timeout as an argument, so they have no
counterpart here.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

log = logging.getLogger("echr_tpu_torch.distributed")

# a collective's longest wait for its peers: a gating eval's ranks meet at
# its gather after evaluating shards of unequal cost
TIMEOUT_S = 1800.0


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The group's size; 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_world_size() -> int:
    """The ranks on this host: torchrun's ``LOCAL_WORLD_SIZE``, else the
    whole group's size (an upper bound, so that ranks sharing a host never
    oversubscribe its cores)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def initialize(coordinator_address: Optional[str], num_processes: int, process_id: int,
               backend: Optional[str] = None, device="cuda",
               timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the group of ``num_processes`` ranks as rank ``process_id``,
    at ``tcp://coordinator_address`` (``host:port``), or from the
    launcher's ``MASTER_ADDR`` / ``MASTER_PORT`` when it is None.  The
    backend defaults to NCCL for a CUDA ``device`` and gloo for the CPU.
    Returns the rank's device (``cuda:LOCAL_RANK`` for CUDA).  Raises when
    CUDA is asked for and absent, or when the group cannot be formed."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {process_id}: device {device!r} asked for, CUDA is not "
                               "available")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)  # before any CUDA work of the group
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    log.info("rank %d of %d joined (%s, %s, device %s)", rank(), world_size(), backend,
             init_method, dev)
    return dev


def maybe_initialize_from_env(device="cuda", timeout_s: float = TIMEOUT_S
                              ) -> Optional[torch.device]:
    """The CLIs' hook: join the group that the environment names (see the
    module docstring).  Returns the rank's device, or None when the
    environment names no group."""
    coord = os.environ.get("ECHR_COORDINATOR")
    if coord:
        return initialize(coord, int(os.environ["ECHR_NUM_PROCESSES"]),
                          int(os.environ["ECHR_PROCESS_ID"]), device=device,
                          timeout_s=timeout_s)
    if os.environ.get("ECHR_DISTRIBUTED", "").lower() in ("1", "true"):
        return initialize(None, int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                          device=device, timeout_s=timeout_s)
    return None


def destroy() -> None:
    """Leave the group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def allgather_object(obj) -> List:
    """[obj of rank 0, ..., obj of rank P-1] on every rank, for any
    picklable object; [obj] with a group of one or without a group."""
    if world_size() == 1:
        return [obj]
    out: List = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is true on any rank (an all-reduce MAX); the flag
    itself without a group."""
    if world_size() == 1:
        return bool(flag)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def gather_predictions(predictions: dict) -> dict:
    """The union of every rank's eval predictions (vid -> records), the
    same on every rank; a video that two ranks captioned keeps the lowest
    rank's records."""
    merged: dict = {}
    for part in allgather_object(predictions):
        for vid, recs in part.items():
            merged.setdefault(vid, recs)
    return merged
