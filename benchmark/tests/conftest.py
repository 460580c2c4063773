"""CPU tests of the benchmark (``python -m pytest benchmark/tests -q`` from
the root of the repo).  A tiny copy of the benchmark's folder, with one
tiny cell of its own, lets the harness run end to end on the CPU, with
the port's plain kernels and no look for a card."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_FLAGS = dict(video_dim=24, hidden_dim=32, K=16, lda_dim=8, d_feats=32, n_head=4, d_o=32,
                  CG_rnn_size=32, CG_input_encoding_size=32, CG_att_hid_size=32,
                  CG_vocab_size=50, CG_seq_length=8, time_buckets=[48])
# at the tiny widths, several times the program's readings on seeds 1-3
# and below the fp8 control's (test_bench_control.py)
TINY_LIMITS = {"malformed": 0, "select_gap": 3e-4, "score_err": 5e-4, "logp_err": 0.012,
               "token_gap": 2e-3, "video_beam_gap_p90": 2e-4, "video_logp_err_mean": 4e-3}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_copy(dest: Path, model: str = "three_stream", beam: int = 1) -> dict:
    """A copy of benchmark/ under ``dest`` with the cell "tiny.cell" (the
    echr_three_stream flags at tiny widths, or ``model``'s, and ``beam``);
    returns the manifest that names it."""
    shutil.copytree(BENCH, dest, ignore=shutil.ignore_patterns("__pycache__", "out", "tests"))
    conf = json.loads((BENCH / "configs" / "echr_three_stream.json").read_text())
    conf["flags"].update(TINY_FLAGS, caption_model=model)
    (dest / "configs" / "tiny.json").write_text(json.dumps(conf))
    (dest / "traffic" / "tiny.json").write_text(json.dumps({
        "generator": "closed_loop", "videos_per_request": 4, "beam_size": beam,
        "topN": 10, "frames": [20, 40], "feature_seconds": 2.0, "distinct_requests": 2}))
    (dest / "limits" / "tiny.cell.json").write_text(json.dumps({"videos": 3,
                                                                "limits": TINY_LIMITS}))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "tiny.cell", "config": "tiny", "traffic": "tiny",
                             "chips": 1, "why": "a CPU test's cell"})
    for m in man["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.cell")
    return man


@pytest.fixture
def tiny(tmp_path):
    dest = tmp_path / "benchmark"
    return dest, tiny_copy(dest)
