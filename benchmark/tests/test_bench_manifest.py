"""BENCHMARK.json and the files it names: parse, name and unit rules, and
the data each cell and metric needs."""
import ast
import json
import re

import pytest
from conftest import BENCH, REPO

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
MAN = json.loads((REPO / "BENCHMARK.json").read_text())


def test_manifest_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"] and MAN["command"][1] == "benchmark/run.py"
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_sources():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_text(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in MAN["configs"]}
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        conf = json.loads((REPO / configs[w["config"]]["file"]).read_text())
        assert conf["name"] == w["config"] and conf["reduced"] == configs[w["config"]]["reduced"]
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "traffic" / f"{traffic['generator']}.py").exists()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert limits["limits"]["malformed"] == 0 and limits["videos"] >= 1
    assert {c["name"] for c in MAN["configs"]} == {w["config"] for w in MAN["workloads"]}


def test_every_per_layer_metric_has_a_reader():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    layers = {}
    for m in MAN["per_layer"]:
        path = BENCH / "metrics" / f"{m['name']}.py"
        tree = ast.parse(path.read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body)
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["name"])


def test_limits_lie_between_their_readings():
    for w in MAN["workloads"]:
        lim = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        for k, pair in lim.get("readings", {}).items():
            if isinstance(pair, list):
                lower, upper = pair
                assert lower < lim["limits"][k] < upper, (w["name"], k)
