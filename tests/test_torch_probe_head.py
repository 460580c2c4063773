"""Kernels 7 and 8 at each of the tilings the CUDA source instantiates: the
port's head (pad_probe_head at the tiling's TV, then stream_head at
(TR, TV)) against probe_streaming_head2's Pallas kernel body run at the
same tiling in interpret mode on the CPU, ties included; the tilings the
wrapper offers against the ones the source instantiates; and the L2 bytes
a call reads by the plan.

How a tiling maps onto the Hopper block (stages, warpgroups, column
halves) and the limits it must keep (227 KB of shared memory, 128
accumulators a consumer thread, every vocab column once and in order) are
static_asserts of Plan<TR, TV> in csrc/probe_stream_head.cu: the compiler
checks them where the kernel is built.

Tolerances: tokens exact; max and logsumexp within 5e-4 (f32 sums in
another order; the bf16 operands are rounded the same way on both sides).
"""
import functools
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from experiments import probe_streaming_head2 as PS  # noqa: E402

from echr_tpu_torch.ops.kernel_probe_head import (  # noqa: E402
    TILINGS,
    l2_bytes,
    pad_probe_head,
    stream_head,
    stream_head_on,
)
from test_torch_probes import _assert_head_equal, _pallas_head  # noqa: E402

SOURCE = ROOT / "echr_tpu_torch" / "csrc" / "probe_stream_head.cu"


def _instantiated():
    """The (TR, TV) pairs of the source's ECHR_TILINGS list."""
    body = re.search(r"#define ECHR_TILINGS\(X\)((?:.*\\\n)*.*)", SOURCE.read_text()).group(1)
    return [(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", body)]


@pytest.mark.parametrize("tr,tv", TILINGS)
def test_stream_head_matches_streaming_head2_at_each_tiling(tr, tv):
    """At each tiling the card runs: a ragged vocab (V1=1201, padded to the
    tiling's TV) against the probe's body on the same (TR, TV) grid; then
    exact ties from integer-valued sums, the first index winning, where
    the kernel's order could break them: the last column of the first
    tile (its upper column half at TR <= 64) against the first columns of
    later tiles, and two columns within one tile."""
    r = np.random.RandomState(tr + tv)
    C, V1 = 64, 1201
    w = torch.from_numpy((r.randn(C, V1) * 0.05).astype(np.float32))
    b = torch.from_numpy((r.randn(V1) * 0.1).astype(np.float32))
    out = torch.from_numpy((r.randn(4 * tr, C) * 0.3).astype(np.float32))
    wp, bp = pad_probe_head(w, b, tv)
    body = functools.partial(PS._kernel, tile_v=tv)
    want = _pallas_head(body, out.numpy(), wp.float().numpy(), bp.numpy(), tr, tv)
    _assert_head_equal(stream_head(out, wp, bp, tr, tv), want)

    C, V1 = 16, 1100
    ones = torch.ones(tr, C)
    for cols in ([tv - 1, tv + 1, 2 * tv + 3], [5, 7, tv + 5]):
        wt = torch.zeros(C, V1)
        wt[:, cols] = 1.0
        wp, bp = pad_probe_head(wt, torch.zeros(V1), tv)
        tok, mx, _ = stream_head(ones, wp, bp, tr, tv)
        ptok, pmx, _ = _pallas_head(body, ones.numpy(), wp.float().numpy(), bp.numpy(), tr, tv)
        assert bool((tok == cols[0]).all()) and bool((mx == C).all())
        assert (ptok == cols[0]).all() and (pmx == C).all()


def test_tilings_are_the_instantiated_ones():
    """The wrapper offers exactly the tilings the source instantiates, in
    its order; a tiling it does not instantiate ((128, 512) would be 256
    accumulators a consumer thread) is refused before any launch."""
    assert _instantiated() == list(TILINGS)
    a = torch.randn(8, 16)
    wp, bp = pad_probe_head(torch.randn(16, 11), torch.zeros(11), 512)
    before = stream_head.launches
    with pytest.raises(ValueError, match="not one of"):
        stream_head_on(None, a, wp, bp, 128, 512)
    assert stream_head.launches == before


def test_l2_bytes_at_the_probe_shapes():
    """At R=4096, C=1536, VP=6144: A is read once a vocab tile, wp and bp
    once a row block; a ragged R rounds the row blocks up."""
    R, C, VP = 4096, 1536, 6144
    a_once, w_once = R * C * 2, C * VP * 2
    assert l2_bytes(R, C, VP, 64, 512) == {
        "a": 12 * a_once, "w": 64 * w_once, "bias": 64 * VP * 4,
        "total": 12 * a_once + 64 * w_once + 64 * VP * 4}
    for tr, tv in TILINGS:
        got = l2_bytes(R, C, VP, tr, tv)
        assert got["w"] == R // tr * w_once and got["a"] == VP // tv * a_once
    assert l2_bytes(1000, 200, 1024, 32, 128)["w"] == 32 * 200 * 1024 * 2  # 32 row blocks
