"""Training CLI: ``python -m echr_tpu_torch.cli.train [reference flags]
[--device cuda]``.

echr_tpu's flag surface (reference: opts.py + train.py:510-513), so the
published experiment scripts translate 1:1 (experiments/*.sh), without
its compile cache; ``--device`` (default ``cuda``) picks the device.  A
flag for one of echr_tpu's runtime knobs that the port does not have is
refused (``config.parse_config``).

Data parallel: launch the same command once per rank with echr_tpu's
cluster variables (``ECHR_COORDINATOR=host:port``, ``ECHR_NUM_PROCESSES``,
``ECHR_PROCESS_ID``) or under torchrun with ``ECHR_DISTRIBUTED=1``; the
command joins the group after parsing (``parallel.distributed``) and a
CUDA rank trains on ``cuda:LOCAL_RANK``.
"""
from __future__ import annotations

import argparse
import logging
import sys

from echr_tpu_torch.config import parse_config
from echr_tpu_torch.engine.train import train
from echr_tpu_torch.parallel.distributed import destroy, maybe_initialize_from_env


def main(argv=None) -> dict:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", type=str, default="cuda")
    ns, rest = pre.parse_known_args(argv)
    # parse before joining: a --help or a typo exits before the rendezvous,
    # which would otherwise leave the other ranks waiting for this one
    cfg = parse_config(rest)
    # every rank logs to the console; rank 0 alone also to the run's train.log
    logging.basicConfig(format="[%(asctime)s] %(message)s", datefmt="%d %H:%M",
                        level=logging.INFO)
    device = maybe_initialize_from_env(ns.device)
    try:
        return train(cfg, device=device or ns.device)
    finally:
        if device is not None:
            destroy()


if __name__ == "__main__":
    main(sys.argv[1:])
