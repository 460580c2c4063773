"""The yardstick's counts against counts by hand."""
import math

import pytest
import torch
from conftest import BENCH

from benchmark.arith import bound, flops, kernels
from benchmark.arith.timeline import label_gaps
from benchmark.spec import spec_of


def _spec(model="three_stream"):
    import json

    f = json.loads((BENCH / "configs" / "echr_three_stream.json").read_text())["flags"]
    return spec_of(dict(f, caption_model=model))


def test_kernel1_counts_the_live_pairs_of_a_small_mask():
    B, R, T, H = 2, 3, 5, 4
    windows = [[(0, 2), (1, 5), (4, 5)], [(2, 3), (0, 5), (3, 4)]]
    mask = torch.zeros(B, R, T)
    for b, rows in enumerate(windows):
        for r, (s, e) in enumerate(rows):
            mask[b, r, s:e] = 1
    live = int(mask.sum())
    assert live == 2 + 4 + 1 + 1 + 5 + 1
    k = kernels.k1(B, R, T, H, live)
    assert k["ops"] == 4 * live * H
    assert k["bytes"] == 4 * (B * T * H + B * R * H + H + 1 + 2 * B * R * T)
    assert k["bound_ms"] == pytest.approx(max(k["bytes"] / 3.35e12, k["ops"] / 67e12) * 1e3)


def test_kernel2_counts():
    k = kernels.k2(4096, 1536, 6001)
    assert k["ops"] == 2 * 4096 * 1536 * 6001
    assert k["bytes"] == 2 * (4096 * 1536 + 6001 * 1536) + 4 * 6001 + 12 * 4096
    assert k["bound_by"] == "operations"
    assert k["bound_ms"] == pytest.approx(k["ops"] / 989e12 * 1e3)
    assert kernels.k2(10, 30, 70)["bytes"] == 2 * (10 * 32 + 70 * 32) + 4 * 70 + 12 * 10


def test_three_stream_decode_step_by_hand():
    s = _spec()
    H, E, w = 512, 512, 7
    cells = 2 * 4 * H * ((E + 512) + H) + 2 * 4 * H * ((E + 500) + H) + 2 * 4 * H * ((E + 100) + H)
    head = 2 * 1536 * 6001
    att = 2 * 512 * 512 + 2 * w * (512 + 500)
    assert flops.step_flops(s, w) == cells + head + att
    assert 35e6 < flops.step_flops(s, 60) < 37e6  # about 36 MFLOP a row-step


def test_h3_step_and_a_request():
    s = _spec("h3")
    H = 512
    cells = (2 * 4 * H * ((512 + 100 + H) + H) + 2 * 4 * H * ((512 + H) + H)
             + 2 * 4 * H * ((500 + H) + H))
    assert flops.step_flops(s, 1) == cells + 2 * H * 6001 + 2 * H * 512 + 2 * (512 + 500)
    one = flops.request_flops(s, [(200, [(3, 5)])], beam_size=4)
    assert one == flops.video_flops(s, 200, 1) + 4 * 6 * flops.step_flops(s, 3)
    capped = flops.request_flops(s, [(200, [(3, 30)])], beam_size=1)
    assert capped == flops.video_flops(s, 200, 1) + 30 * flops.step_flops(s, 3)


def test_video_flops_tsrm_terms():
    s = _spec()
    base = flops.video_flops(s, 10, 0)
    N, d = 4, 512
    tsrm = (2 * N * (1012 * d + 2 * d * d + d * 512) + 2 * N * N * (d + d * 16)
            + 2 * N * N * (d * d + d * 16))
    assert flops.video_flops(s, 10, N) - base == tsrm
    sst = 2 * 4 * 512 * (500 + 512) + 2 * 4 * 512 * (512 + 512)
    assert base == 10 * (sst + 2 * 512 * 256 + 2 * 500 * 512)


def test_bound_picks_the_larger():
    b = bound.bound(6.7e9, f32=67e9)  # 2 ms of bytes against 1 ms of f32 operations
    assert b["bound_ms"] == pytest.approx(2.0) and b["bound_by"] == "bytes"
    b = bound.bound(1.0, f32=67e9, bf16=989e9)
    assert b["bound_ms"] == pytest.approx(2.0) and math.isclose(b["ops"], 67e9 + 989e9)


def test_gap_labels_take_the_innermost_span():
    t = {"gaps": [(0.0, 1.0), (2.0, 2.5), (5.0, 5.1)],
         "notes": [("outer", 0.0, 3.0), ("inner", 1.9, 2.6)]}
    assert label_gaps(t) == [("outer", 1.0), ("inner", 0.5), ("outside", pytest.approx(0.1))]
