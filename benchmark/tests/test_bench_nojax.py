"""No module of the benchmark imports jax, flax or the JAX package: the
top-level name of each import, compared whole (echr_tpu_torch is the
port and allowed; echr_tpu is not)."""
import ast

import pytest
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "echr_tpu"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py") if "out" not in p.parts))
def test_no_jax_import(path):
    assert not set(_imports(BENCH / path)) & FORBIDDEN


def test_the_reference_and_yardstick_import_nothing_of_the_port():
    for sub in ("reference", "arith", "traffic", "metrics"):
        for p in (BENCH / sub).rglob("*.py"):
            assert "echr_tpu_torch" not in set(_imports(p)), p


def test_harness_rejects_forbidden_modules(monkeypatch):
    import sys
    import types

    from benchmark.harness import forbidden_modules

    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "echr_tpu.models", types.ModuleType("echr_tpu.models"))
    assert forbidden_modules() == ["echr_tpu"]
