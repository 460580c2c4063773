"""Traffic: ``<mix>.json`` names a generator module of this folder
(``"generator"``) and its parameters; the generator builds the mix's
requests from the run's seed."""
from __future__ import annotations

import importlib
import json
from pathlib import Path


def load(path: Path, spec, seed: int, device):
    params = json.loads(Path(path).read_text())
    gen = importlib.import_module(f"benchmark.traffic.{params['generator']}")
    return gen.build(params, spec, seed, device)
