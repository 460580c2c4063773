"""The port's host library (echr_tpu/native's counterpart): the four C++
functions of ``echr_native.cc`` bound with ctypes, which the host code runs
in place of its numpy versions wherever the library is available:

  iou_grid         data/labels.iou_grid (the labelled batch, the labels-off
                   batch's count at thr <= 0.65)
  nms_temporal     engine/proposals.top_proposals_nms
  nms_external     engine/proposals.external_proposals_nms
  render_captions  utils/text.decode_sequence (serving, eval, SCST rewards)

g++ builds it at first use (``g++ -O3 -march=native -fPIC -shared
-std=c++17``) into ``echr_tpu_torch/_build/`` (listed in .gitignore),
under a name that carries a hash of the source, the compiler command and
the host CPU (``-march=native`` builds for it), holding an ``fcntl`` lock
on a file beside it and writing a temporary file that ``os.replace`` puts
in place, so that processes started together build it once.  The CUDA
kernels of csrc/ are built by ``ops/native.py``, not here.

The library is loaded with ``ctypes.CDLL``, so every call releases the GIL
(a loader thread's grid, an assembler thread's captions), and a smoke call
checks it once loaded.  A build or load that fails raises with the
compiler's stderr.  The numpy versions run only inside ``force_numpy()``,
under echr_tpu's ``ECHR_TPU_NO_NATIVE`` (any non-empty value), or where no
C++ compiler is on PATH (one logged warning, echr_tpu's contract for a host
without a toolchain).  Each function counts its calls in ``counts()``.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("echr_tpu_torch.native")

SOURCE = Path(__file__).resolve().with_name("echr_native.cc")
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I, _D = ctypes.c_int, ctypes.c_double
# entry point -> (argtypes, restype), the extern "C" functions of echr_native.cc
_SIGNATURES = {
    # gt, n_gt, T, K, iou, gts, mask
    "iou_grid": ([_i64p, _I, _I, _I, _f32p, _f32p, _f32p], None),
    # props, scores, n, overlap, topN, pad, pick
    "nms_temporal": ([_i64p, _f64p, _I, _D, _I, _D, _i32p], ctypes.c_int),
    # props, prop_scores, sent_scores, n, overlap, topN, pick
    "nms_external": ([_f64p, _f64p, _f64p, _I, _D, _I, _i32p], ctypes.c_int),
    # words, offsets, V, seq, N, L, out, cap, out_off
    "render_captions": ([ctypes.c_char_p, _i32p, _I, _i32p, _I, _I, ctypes.c_char_p,
                         ctypes.c_int64, _i64p], ctypes.c_int64),
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_warned_no_compiler = False
# process-wide, not per context: the loader's and the pipelined loop's
# threads make batches, and force_numpy() must reach them
_numpy_depth = 0
_state_lock = threading.Lock()


def _cpu_key() -> bytes:
    """The host CPU's model names and feature flags (``-march=native``
    builds for them): a library built on another CPU is never loaded."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return b"".join(sorted({ln for ln in f if ln.startswith((b"model name", b"flags"))}))
    except OSError:
        return f"{platform.machine()} {platform.processor()}".encode()


def library_path(build_dir: Optional[Path] = None) -> Path:
    """Where ``build`` puts the library for this source, compiler command
    and CPU (in BUILD_DIR unless ``build_dir`` is given)."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_key())
    return Path(build_dir or BUILD_DIR) / f"libechr_native_{h.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile echr_native.cc into ``build_dir`` (BUILD_DIR) unless the
    library of its hash is there.  Processes that build at once take turns
    on a file lock, and the library appears whole (os.replace).  Raises
    with the compiler's stderr if it fails."""
    so = library_path(build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # built by another process while this one waited
            return so
        fd, tmp = tempfile.mkstemp(dir=so.parent, prefix=so.stem, suffix=".tmp")
        os.close(fd)
        try:
            proc = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"{CXX} exited {proc.returncode} building {SOURCE}:\n"
                                   f"{proc.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def load(so: Path) -> ctypes.CDLL:
    """Load a library built by ``build``, declare its entry points and
    smoke-run a tiny grid, which a library that loads but is broken fails."""
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    iou, gts, mask = (np.full((2, 2), np.nan, np.float32) for _ in range(3))
    lib.iou_grid(np.array([[0, 1]], np.int64), 1, 2, 2, iou, gts, mask)
    if not (np.isfinite(iou).all() and mask.tolist() == [[0, 0], [1, 0]]):
        raise RuntimeError(f"{so}: the smoke call of iou_grid gave iou {iou.tolist()}, "
                           f"mask {mask.tolist()}")
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built and loaded on the first call."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = load(build())
    return _lib


def available() -> bool:
    """Whether the C++ functions can run: False under ECHR_TPU_NO_NATIVE or
    where no C++ compiler is on PATH (warned once); otherwise the library
    is built and loaded at the first call, and a failure raises."""
    global _warned_no_compiler
    if os.environ.get("ECHR_TPU_NO_NATIVE"):
        return False
    if _lib is None and shutil.which(CXX) is None:
        if not _warned_no_compiler:
            _warned_no_compiler = True
            log.warning("no C++ compiler (%s) on PATH: the host code runs its numpy versions",
                        CXX)
        return False
    library()
    return True


def active() -> bool:
    """Whether the dispatching call sites take the C++ path: available()
    and not inside force_numpy()."""
    return _numpy_depth == 0 and available()


@contextlib.contextmanager
def force_numpy():
    """Within the block every dispatching call site, in every thread of the
    process, runs its numpy version: for tests and on / off comparisons."""
    global _numpy_depth
    with _state_lock:
        _numpy_depth += 1
    try:
        yield
    finally:
        with _state_lock:
            _numpy_depth -= 1


def _count(fn) -> None:
    with _state_lock:
        fn.calls += 1


def iou_grid(featstamps, nfeats: int, K: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(iou [T, K] f32, gts_index [T, K] f32, mask [T, K] f32) of the
    featstamps [n_gt, 2] (ints) over T = nfeats frames."""
    lib = library()
    gt = np.ascontiguousarray(np.asarray(featstamps, dtype=np.int64).reshape(-1, 2))
    T, K = int(nfeats), int(K)
    if T < 0 or K < 0:
        raise ValueError(f"iou_grid: T={T}, K={K}")
    iou, gts, mask = (np.empty((T, K), np.float32) for _ in range(3))
    lib.iou_grid(gt, gt.shape[0], T, K, iou, gts, mask)
    _count(iou_grid)
    return iou, gts, mask


def nms_temporal(props: np.ndarray, scores: np.ndarray, overlap: float, topN: int,
                 pad: float = 1.0) -> np.ndarray:
    """Greedy NMS of props [n, 2] (int [start, end)) by scores [n]: the
    picks' indices, int32, at most topN."""
    lib = library()
    props = np.ascontiguousarray(props, dtype=np.int64).reshape(-1, 2)
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    if len(props) != len(scores):
        raise ValueError(f"nms_temporal: {len(props)} proposals, {len(scores)} scores")
    pick = np.empty((max(0, min(int(topN), len(scores))),), np.int32)
    n = lib.nms_temporal(props, scores, len(scores), float(overlap), len(pick), float(pad),
                         pick)
    _count(nms_temporal)
    return pick[:n]


def nms_external(props: np.ndarray, prop_scores: np.ndarray, sent_scores: np.ndarray,
                 overlap: float, topN: int) -> np.ndarray:
    """External-proposal NMS of props [n, 2] (seconds): the picks' indices,
    int32, at most topN, each the best sentence score of its cluster."""
    lib = library()
    props = np.ascontiguousarray(props, dtype=np.float64).reshape(-1, 2)
    prop_scores = np.ascontiguousarray(prop_scores, dtype=np.float64)
    sent_scores = np.ascontiguousarray(sent_scores, dtype=np.float64)
    if not len(props) == len(prop_scores) == len(sent_scores):
        raise ValueError(f"nms_external: {len(props)} proposals, {len(prop_scores)} scores, "
                         f"{len(sent_scores)} sentence scores")
    pick = np.empty((max(0, min(int(topN), len(prop_scores))),), np.int32)
    n = lib.nms_external(props, prop_scores, sent_scores, len(prop_scores), float(overlap),
                         len(pick), pick)
    _count(nms_external)
    return pick[:n]


def render_captions(words_packed: bytes, offsets: np.ndarray, seq: np.ndarray) -> List[str]:
    """Token ids seq [N, L] -> N sentences over the packed vocab
    (utils/text's table: word i is words_packed[offsets[i]:offsets[i + 1]]).
    A row stops at its first id <= 0; ids past the vocab render as
    nothing."""
    lib = library()
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    seq = np.ascontiguousarray(seq, dtype=np.int32)
    if seq.ndim != 2 or offsets.ndim != 1 or len(offsets) < 1 \
            or offsets[-1] != len(words_packed):
        raise ValueError(f"render_captions: seq {seq.shape}, offsets {offsets.shape} over "
                         f"{len(words_packed)} bytes")
    N, L = seq.shape
    V = len(offsets) - 1
    longest = int(np.diff(offsets).max()) if V else 0
    cap = N * L * (longest + 1) + 1  # every token the longest word and a separator
    out = ctypes.create_string_buffer(cap)
    out_off = np.empty((N + 1,), np.int64)
    written = lib.render_captions(words_packed, offsets, V, seq, N, L, out, cap, out_off)
    if written < 0:
        raise RuntimeError(f"render_captions: {cap} bytes did not hold the sentences")
    _count(render_captions)
    raw = out.raw
    return [raw[out_off[i]:out_off[i + 1]].decode("utf-8") for i in range(N)]


for _fn in (iou_grid, nms_temporal, nms_external, render_captions):
    _fn.calls = 0
del _fn


def counts() -> Dict[str, int]:
    """Each C++ function's calls since the last reset_counts()."""
    return {fn.__name__: fn.calls
            for fn in (iou_grid, nms_temporal, nms_external, render_captions)}


def reset_counts() -> None:
    with _state_lock:
        for fn in (iou_grid, nms_temporal, nms_external, render_captions):
            fn.calls = 0
