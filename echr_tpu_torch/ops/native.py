"""Build and load the CUDA kernels of echr_tpu_torch/csrc.

nvcc compiles every ``csrc/*.cu`` for sm_90a, one process per source, all
started together, and links the objects into one shared library with a
plain C interface, at first use, into ``echr_tpu_torch/_build/`` (listed
in .gitignore).  The library's name carries a hash of the sources and
flags, so a changed source rebuilds.  It is loaded with ctypes: every
pointer and the stream are ``c_void_p``, every size ``c_int``, and each
entry point returns ``cudaGetLastError()`` after its launches.

No fast-math flag: the kernels' tanhf, expf, exp2f and logf are the
accurate ones (an approximate tanh changes greedy tokens).  Kernels 1, 3
and 4 take their tanh from csrc/tanh.cuh, held within 2.4e-7 of float64
(2 ulp of 1.0), and so do kernels 9 and 10.  Kernel 2's bf16 path,
kernels 7-8 and kernel 10 take their TMA, mbarrier and wgmma pieces from
csrc/hopper.cuh and find the CUDA driver library's cuTensorMapEncodeTiled
through the runtime (cudaGetDriverEntryPoint), so the library needs no
-lcuda.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argtypes (see the extern "C" functions in csrc/*.cu)
_SIGNATURES = {
    # pre, q, w, b, mask, out, B, N, T, H, stream
    "echr_attention_scores": [_P] * 6 + [_I] * 4 + [_P],
    # pre, q, w, b, mask, out, B, N, T, H, stream
    "echr_attention_scores_dense": [_P] * 6 + [_I] * 4 + [_P],
    # pre, q, w, g, d_pre, d_q, d_w, dq_part, dw_part, B, N, T, H, stream
    "echr_attention_scores_bwd": [_P] * 9 + [_I] * 4 + [_P],
    # out, w, b, bf16, R, C, V1, tiles_per_split, splits, part_m, part_l, part_a, tok,
    # mx, lse, stream
    "echr_greedy_head": [_P, _P, _P] + [_I] * 6 + [_P] * 6 + [_P],
    # pre, q, w, b, mask, feats, out, B, N, T, H, D, stream
    "echr_attention_fused": [_P] * 7 + [_I] * 5 + [_P],
    # pre, feats, q, w, b, soi, out, B, N, T, H, D, stream
    "echr_windowed_attention": [_P] * 7 + [_I] * 5 + [_P],
    # out, w, b, R, C, VP, tr, tv, tok, mx, lse, stream
    "echr_probe_stream_head": [_P] * 3 + [_I] * 5 + [_P] * 3 + [_P],
    # pre, q, w, wd, s, dot, B, N, T, H, KD, scores, stream
    "echr_probe_scores": [_P] * 6 + [_I] * 6 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "echr_tpu_torch/csrc at first use and need the CUDA toolkit")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(cu: Optional[List[Path]] = None) -> Path:
    """Compile ``cu`` (default: csrc/*.cu; another list builds another
    version of the same entry points) unless a library of the same hash
    exists: one nvcc per source in parallel, then one link.  The hash
    covers the flags and the headers beside the sources."""
    global build_log
    cu = sorted(CSRC.glob("*.cu")) if cu is None else [Path(c) for c in cu]
    headers = sorted({h for c in cu for h in c.parent.glob("*.cuh")})
    so = BUILD_DIR / f"libechr_kernels_{_digest(cu + headers)}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [work / (src.stem + ".o") for src in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, o in zip(cu, objs)]
        logs, failed = [], []
        for src, proc in zip(cu, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        tmp = work / "lib.so"
        if not failed:
            link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append("link")
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def load(so: Path) -> ctypes.CDLL:
    """Load a library built by ``build`` and declare the entry points it has."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def check_arg(fn: str, name: str, x, shape, dtype, device) -> None:
    """Raise unless x is a contiguous ``dtype`` tensor of ``shape`` on the
    CUDA ``device``: what a kernel takes, and nothing else."""
    if x.device.type != "cuda" or x.device != device:
        raise ValueError(f"{fn}: {name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{fn}: {name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: {name} is not contiguous")
