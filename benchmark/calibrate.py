"""The readings a cell's limits are set from, many seeds in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds <s1> <s2> ... [--requests 4]
        [--program-dtype float32] [--no-control]

For each seed: the cell's set-up, ``--requests`` requests through the
timed path (the run's own entry, sizes and load), the run's sample of
videos judged against the reference: the program's readings; and the
control's: the reference at float8 (e4m3, one scale a tensor) in the
program's place, serving the same sampled videos, judged the same way.
Each side's numbers are held against the cell's limits file by the
comparison a run makes, and its verdict printed ("program correct: true",
"control correct: false").  ``--program-dtype`` runs the program at
another compute dtype than its configuration's (a witness: at float32 the
program's readings should fall to float32 rounding).  Prints one JSON
line a seed, then the largest program reading and the smallest control
reading of each number.  The benchmark's runs do not run this.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))


def readings(bench, manifest, name, seed, n_requests, device, t_start, log=print,
             program_flags=None, control=True):
    """One seed's readings: {"program": numbers, "control": numbers or None,
    "program_correct", "control_correct", "info" and "control_info": each
    side's numbers not compared, "seen": what the check saw}."""
    import numpy as np
    import torch

    from benchmark.harness import reference, sample, serve, set_up
    from benchmark.reference.check import Served, compare, judge, run_as_program

    c = set_up(bench, manifest, name, seed, device, t_start, log, program_flags=program_flags)
    rng = np.random.default_rng(int(seed) % 2**63)
    w = serve(c, float("inf"), False, rng, max_requests=n_requests, log=log)
    c = c._replace(svc=None)
    gc.collect()
    if c.dev.type == "cuda":
        torch.cuda.empty_cache()
    videos = sample(c, w, rng)
    ref = reference(c)
    t = c.traffic
    prog = judge(ref, videos, t.topN, t.beam_size)
    prog["numbers"]["malformed"] += w.missing
    _, prog_ok = compare(prog["numbers"], c.limits)
    out = {"program": prog["numbers"], "program_correct": prog_ok and w.failed == 0,
           "control": None, "control_correct": None, "info": prog["info"], "control_info": None,
           "seen": prog["seen"]}
    if control:
        low = reference(c, "fp8")
        served = [Served(v.feats, v.lda, v.duration,
                         run_as_program(low, v, t.topN, t.beam_size))
                  for v in videos if v is not None]
        ctl = judge(ref, served, t.topN, t.beam_size)
        out["control"], out["control_info"] = ctl["numbers"], ctl["info"]
        out["control_correct"] = compare(ctl["numbers"], c.limits)[1]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--program-dtype", default=None)
    p.add_argument("--no-control", action="store_true")
    a = p.parse_args(argv)

    from benchmark.harness import card_line, load_json

    print(card_line(), flush=True)
    manifest = load_json(BENCH.parent / "BENCHMARK.json")
    flags = {"compute_dtype": a.program_dtype} if a.program_dtype else None
    prog_max, ctl_min = {}, {}
    t_start = T_START
    for seed in a.seeds:
        r = readings(BENCH, manifest, a.workload, seed, a.requests, "cuda", t_start,
                     program_flags=flags, control=not a.no_control)
        t_start = time.time()
        print(json.dumps({"seed": seed, **r}), flush=True)
        print(f"seed {seed}: program correct: {str(r['program_correct']).lower()}"
              + ("" if r["control"] is None
                 else f"; control correct: {str(r['control_correct']).lower()}"), flush=True)
        for k, v in r["program"].items():
            prog_max[k] = max(prog_max.get(k, v), v)
        for k, v in (r["control"] or {}).items():
            ctl_min[k] = min(ctl_min.get(k, v), v)
    print(json.dumps({"workload": a.workload, "seeds": len(a.seeds),
                      "program_dtype": a.program_dtype, "program_max": prog_max,
                      "control_min": ctl_min}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
