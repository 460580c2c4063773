"""Training CLI: ``python -m echr_tpu_torch.cli.train [reference flags]
[--device cuda]``.

echr_tpu's flag surface (reference: opts.py + train.py:510-513), so the
published experiment scripts translate 1:1 (experiments/*.sh), without
its cluster join or compile cache; ``--device`` (default ``cuda``) picks
the device.  A flag for one of echr_tpu's runtime knobs that the port
does not have is refused (``config.parse_config``).
"""
from __future__ import annotations

import argparse
import sys

from echr_tpu_torch.config import parse_config
from echr_tpu_torch.engine.train import train


def main(argv=None) -> dict:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", type=str, default="cuda")
    ns, rest = pre.parse_known_args(argv)
    return train(parse_config(rest), device=ns.device)


if __name__ == "__main__":
    main(sys.argv[1:])
