"""A cell, a traffic mix and a per-layer metric added as new files and
entries are found by name, with no existing file of the benchmark
edited; the run's line carries what the contract asks."""
import hashlib
import json
import time

from conftest import BENCH

from benchmark.harness import run_cell

READER = '''
def read(rec):
    reqs = [r for r in rec["requests"] if r["captions"]]
    return sum(r["captions"] for r in reqs) / len(reqs) if reqs else None
'''
# a counter that no reader of the benchmark reads yet
SYNCS = '''
def read(rec):
    cs = rec["chunks"]
    return sum(c["counters"]["beam_search_batched.host_syncs"] for c in cs) if cs else None
'''


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_traffic_and_metric_are_found_by_name(tiny):
    dest, man = tiny
    before = _digests(dest)
    (dest / "traffic" / "tiny_beam2.json").write_text(json.dumps({
        "generator": "closed_loop", "videos_per_request": 3, "beam_size": 2,
        "topN": 10, "frames": [24, 40], "feature_seconds": 1.5, "distinct_requests": 2}))
    (dest / "limits" / "tiny.beam2.json").write_text((dest / "limits" / "tiny.cell.json")
                                                     .read_text())
    (dest / "metrics" / "captions_per_request.serve.py").write_text(READER)
    (dest / "metrics" / "beam_syncs.serve.py").write_text(SYNCS)
    man["workloads"].append({"name": "tiny.beam2", "config": "tiny", "traffic": "tiny_beam2",
                             "chips": 1, "why": "an added cell"})
    for metric, unit in (("captions_per_request.serve", "captions"),
                         ("beam_syncs.serve", "syncs")):
        man["per_layer"].append({"name": metric, "unit": unit, "better": "higher",
                                 "source": "program_counter", "layer": "serve",
                                 "moves": "captions_per_s", "workloads": ["tiny.beam2"]})
    traced = run_cell(dest, man, "tiny.beam2", 9, 0.3, True, "cpu", time.time(),
                      log=lambda *a, **k: None)
    assert traced["correct"] and traced["metrics"]["captions_per_request.serve"]["value"] == 30
    assert traced["metrics"]["beam_syncs.serve"]["value"] >= 0
    assert "k2_roofline.serve" not in traced["metrics"]  # not this cell's metric
    assert traced["metrics"]["decode_steps.serve"]["value"] == 8
    plain = run_cell(dest, man, "tiny.beam2", 9, 0.3, False, "cpu", time.time(),
                     log=lambda *a, **k: None)
    assert set(plain["metrics"]) == {"captions_per_s", "request_p90_ms", "setup_s"}
    assert list(plain)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(plain)[-1] == "checks" and plain["device"]["count"] == 1
    after = _digests(dest)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {"traffic/tiny_beam2.json", "limits/tiny.beam2.json",
                                        "metrics/captions_per_request.serve.py",
                                        "metrics/beam_syncs.serve.py"}


def test_the_tiny_copy_leaves_the_benchmark_alone(tiny):
    dest, _ = tiny
    mine = _digests(dest)
    theirs = _digests(BENCH)
    assert all(theirs[k] == v for k, v in mine.items() if k in theirs)


def test_counters_are_found_by_scanning_the_port():
    import echr_tpu_torch.models.beam  # noqa: F401
    import echr_tpu_torch.models.decoder  # noqa: F401
    import echr_tpu_torch.ops.kernel_attention  # noqa: F401
    import echr_tpu_torch.ops.kernel_head  # noqa: F401
    from benchmark.harness import port_counters

    found = port_counters()
    for key in ("attention_scores_masked.launches", "greedy_head.launches",
                "decoder_sample_batched.steps", "decoder_sample_batched.host_syncs",
                "beam_search_batched.steps", "beam_search_batched.host_syncs"):
        obj, attr = found[key]
        assert isinstance(getattr(obj, attr), int)
