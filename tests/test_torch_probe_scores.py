"""Kernels 9 and 10's block plan (ops/kernel_probe_scores.py), a model of
the CUDA kernel's own indexing in csrc/probe_score_overlap.cu: every entry
of s and of dot written exactly once at the probe's shapes and at ragged
ones; the model's constants equal to the source's; the bytes of wd the
plan reads through L2; and the H and KD the wrapper refuses before any
launch, reachable on the CPU.

The kernels' arithmetic is held against the JAX probe's Pallas bodies in
tests/test_torch_probes.py (plain versions) and against the plain versions
on the card (chip_smoke.py phase 17).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from echr_tpu_torch.ops import kernel_probe_scores as kps

SOURCE = Path(__file__).resolve().parent.parent / "echr_tpu_torch" / "csrc" / \
    "probe_score_overlap.cu"

# (B, N, T, KD): the probe's shapes, chip_smoke phase 17's ragged shape and
# its shape off the 64 x 128 block at the narrowest product, an exact block,
# and a single proposal and frame
SHAPES = [(32, 128, 256, 2048), (3, 77, 200, 256), (2, 50, 130, 128), (1, 64, 128, 128),
          (2, 1, 1, 128)]


def _blocks(B, N, T):
    gx, gy, gz = kps.grid(B, N, T)
    return [(x, y, b) for b in range(gz) for y in range(gy) for x in range(gx)]


@pytest.mark.parametrize("B,N,T,KD", SHAPES)
def test_block_plan_writes_every_entry_once(B, N, T, KD):
    """Over the grid, the score warps write each s[b, n, t] once, and the
    consumer warpgroups each dot[b, j, n, k] once, each block only into its
    own video and its own copy j."""
    copies = -(-T // kps.TILE_T)
    s_count = np.zeros((B, N, T), np.int32)
    d_count = np.zeros((B, copies, N, KD), np.int32)
    for x, y, b in _blocks(B, N, T):
        nt = kps.score_writes(N, T, (x, y, b))
        assert nt.size and (nt[:, 0] // kps.TILE_N == y).all()
        assert (nt[:, 1] // kps.TILE_T == x).all()
        np.add.at(s_count[b], (nt[:, 0], nt[:, 1]), 1)
        jnk = kps.dot_writes(N, KD, (x, y, b))
        assert (jnk[:, 0] == x).all() and (jnk[:, 1] // kps.TILE_N == y).all()
        d_count[b].reshape(-1)[:] += np.bincount(
            np.ravel_multi_index(jnk.T, (copies, N, KD)), minlength=copies * N * KD)
    assert (s_count == 1).all()
    assert (d_count == 1).all()


def _constants():
    text = SOURCE.read_text()
    return {name: int(value) for name, value in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_plan_constants_are_the_sources():
    """The model's tile, score warps, staged chunk, product tile and ring
    are the constants the CUDA source compiles with, and its shared-memory
    count is the source's formula: it takes H up to 896 with the product."""
    c = _constants()
    assert (c["TN"], c["TT"], c["SCORE_WARPS"], c["HC"], c["BUFS"], c["KN"], c["STAGES"]) == (
        kps.TILE_N, kps.TILE_T, kps.SCORE_WARPS, kps.HC, kps.BUFS, kps.KD_TILE, kps.STAGES)
    assert c["SMEM_LIMIT"] == 232448
    text = SOURCE.read_text()
    assert "1024 + STAGES * STAGE_BYTES + A_ATOM * (padded_h(H) / SW) + SCORE_BYTES" in text
    assert "BUF_FLOATS = TT * PRE_LD + TN * HC + HC" in text and "PRE_LD = HC + 4" in text
    assert kps.smem_bytes(512, False) == 43200
    assert kps.smem_bytes(512, True) == 1024 + 4 * 16384 + 64 * 512 * 2 + 43200 + 64
    assert kps.smem_bytes(896, True) <= 232448 < kps.smem_bytes(900, True)


def test_source_has_no_accurate_tanh_or_warp_mma():
    """The score warps take tanh.cuh's tanh and the product runs on wgmma."""
    text = SOURCE.read_text()
    assert "echr_tanh(" in text and "wgmma<1>(" in text and "tma_load(" in text
    assert "tanhf" not in text and "nvcuda" not in text and "wmma::" not in text


def test_l2_bytes_of_wd_at_the_probe_shapes():
    """wd [512, 2048] bf16 is read once a block: 128 blocks at the probe's
    shapes, 256 MiB, against 512 MiB for the earlier 32-proposal blocks; a
    ragged N and T round the blocks up."""
    wd = 512 * 2048 * 2
    assert kps.l2_bytes(32, 128, 256, 512, 2048) == 128 * wd == 256 * 2 ** 20
    assert kps.l2_bytes(32, 128, 256, 512, 2048, tile_n=32) == 256 * wd == 512 * 2 ** 20
    assert kps.l2_bytes(3, 77, 200, 496, 256) == 3 * 2 * 2 * 496 * 256 * 2


@pytest.mark.parametrize("H,KD,match", [
    (30, None, "multiple of 4"), (0, None, "multiple of 4"), (30, 256, "multiple of 4"),
    (64, 192, "multiple of 128"), (64, 64, "multiple of 128"), (900, 256, "shared memory"),
    (1024, 128, "shared memory")])
def test_wrapper_refuses_dims_the_kernel_does_not_take(H, KD, match):
    """H and KD are checked before the tensors and the library: on the CPU
    too, and no launch is counted."""
    pre, q, w = torch.zeros(1, 3, H), torch.zeros(1, 2, H), torch.zeros(H)
    wd = None if KD is None else torch.zeros(H, KD, dtype=torch.bfloat16)
    before = (kps.probe_scores.launches, kps.probe_scores_plus_dot.launches)
    with pytest.raises(ValueError, match=match):
        kps.probe_scores_on(None, pre, q, w, wd)
    assert (kps.probe_scores.launches, kps.probe_scores_plus_dot.launches) == before


@pytest.mark.parametrize("H,KD", [(496, None), (496, 256), (896, 128), (100, 128)])
def test_wrapper_takes_the_dims_the_kernel_does(H, KD):
    """Dims the kernel takes pass check_dims; on the CPU the launch helper
    then raises on the tensors' device before it reaches the library."""
    kps.check_dims("probe", H, KD)
    pre, q, w = torch.zeros(1, 3, H), torch.zeros(1, 2, H), torch.zeros(H)
    wd = None if KD is None else torch.zeros(H, KD, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="is on cpu"):
        kps.probe_scores_on(None, pre, q, w, wd)


@pytest.mark.parametrize("kernel", ["probe_scores", "probe_scores_plus_dot"])
@pytest.mark.parametrize("B,N,T,launched", [(2, 3, 5, True), (0, 3, 5, False),
                                            (2, 0, 5, False), (2, 3, 0, False)])
def test_wrapper_counts_only_a_launch(monkeypatch, kernel, B, N, T, launched):
    """Each wrapper adds one to its count where its kernel launched, and not
    where B * N * T == 0 left the launch helper nothing to launch (the
    helper, stood in for here, returns the empty outputs)."""
    H, KD = 8, 128
    fn = getattr(kps, kernel)

    def helper(lib, pre, q, w, wd=None, scores=True):
        s = torch.zeros(B, N, T) if scores else None
        return s, None if wd is None else torch.zeros(B, -(-T // kps.TILE_T), N, KD)

    monkeypatch.setattr(kps, "use_plain", lambda x: False)
    monkeypatch.setattr(kps.native, "library", lambda: None)
    monkeypatch.setattr(kps, "probe_scores_on", helper)
    args = [torch.zeros(B, T, H), torch.zeros(B, N, H), torch.zeros(H)]
    if kernel == "probe_scores_plus_dot":
        args.append(torch.zeros(H, KD, dtype=torch.bfloat16))
    before = fn.launches
    fn(*args)
    assert fn.launches == before + launched
    fn.launches = before
