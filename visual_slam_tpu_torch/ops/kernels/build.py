"""Build and load the hand-written CUDA kernels (`visual_slam_tpu_torch/csrc`).

All `.cu` sources are compiled by `nvcc` into ONE shared library with a
plain C interface, loaded with ctypes. Nothing includes PyTorch's headers,
so a cold build takes seconds. The library lands in
`visual_slam_tpu_torch/_build/` (git-ignored) under a name hashed from the
sources and flags: the first call after a source change rebuilds, later
calls and processes reuse it.

`--fmad=false` forbids the compiler from contracting `a*b + c` into one
FMA: with it, and with the plain PyTorch versions doing their float
operations in the same order, a kernel's output is bit-comparable with its
plain version's on the card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry point -> argtypes. Every entry returns cudaGetLastError().
_SIGNATURES = {
    # img, peaks, blur (NULL = no blur), B, H, W, border, g0..g4, stream, device
    "vslam_detect_blur": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P, _I],
    # count, first (the exhaustive check of B1's square root), stream, device
    "vslam_detect_sqrt_check": [_P, _P, _P, _I],
    # img, uv, patches, B, H, W, K, stream, device
    "vslam_patch": [_P, _P, _P, _I, _I, _I, _I, _P, _I],
    # data, order, run_start, tile_ptr, words, partial, out, C, N, K, tile,
    # max_runs, stream, device
    "vslam_cam_reduce": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P, _I],
    # x, cam, out, C, N, K, ck, grid_x, threads, vec4, evict_first, stream,
    # device (seg_kernel.ExpandGeometry)
    "vslam_cam_expand": [_P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P, _I],
}

build_seconds: float | None = None  # wall time of the last cold build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvslam_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # Build under a temporary name, then rename: a concurrent process never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (refused launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
