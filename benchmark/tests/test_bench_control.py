"""The control: the reference at float8 (e4m3, a scale a tensor) in the
program's place, at the tiny widths, on three seeds.  The program's
readings stay within the tiny cell's limits and the control's break at
least one of them, reading three times the program's or more there, as
the cells' own control does on the card at their sizes (PERF.md)."""
import pytest
from conftest import TINY_LIMITS, tiny_copy

from benchmark.calibrate import readings


@pytest.mark.parametrize("model,beam", [("three_stream", 1), ("h3", 4)])
def test_control_fails_where_the_program_passes(tmp_path, model, beam):
    import time

    dest = tmp_path / "benchmark"
    man = tiny_copy(dest, model, beam)
    for seed in (1, 2, 3):
        r = readings(dest, man, "tiny.cell", seed, 3, "cpu", time.time(),
                     log=lambda *a, **k: None)
        prog, ctl = r["program"], r["control"]
        assert r["seen"]["captions"] >= 30
        assert all(v <= TINY_LIMITS[k] for k, v in prog.items()), prog
        assert r["program_correct"] and r["control_correct"] is False
        failed = [k for k, v in ctl.items() if v > TINY_LIMITS[k]]
        assert any(ctl[k] >= 3 * prog[k] for k in failed), (prog, ctl)
