"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Needs as many CUDA cards as the cell asks
for, and exits non-zero without a result line where there are fewer.
The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and checks: each
number compared beside its limit); the checks are also the last lines of
standard error.
"""
import time

T_START = time.time()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from benchmark.harness import card_line, load_json, run_cell, workload

    manifest = load_json(BENCH.parent / "BENCHMARK.json")
    chips = int(workload(manifest, a.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {a.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(card_line(), flush=True)
    result = run_cell(BENCH, manifest, a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
                      T_START)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
