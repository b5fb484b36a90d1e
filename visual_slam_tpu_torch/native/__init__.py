"""ctypes bindings for the native (C++) PNG loader (port of
visual_slam_tpu/native/__init__.py:1-153).

`dataloader.cpp` decodes RGB-D PNGs with libpng on a thread pool, ahead of
the consumer. It is built at first use with g++ into the package's
git-ignored `_build/` directory, under a name hashed from the source and the
flags, so a source change rebuilds and later processes reuse the library;
it is written under a temporary name and renamed into place, so processes
that build at once never load a half-written file. Where it cannot be built
(no g++, no libpng headers), `available()` is False, `build_error` says why,
and the reader decodes with PIL instead: host IO either way.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("dataloader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
LIBS = ["-lpng", "-lz", "-lpthread"]
DEPTH_SCALE = 5000.0  # 16-bit depth PNG units per metre

build_error: str | None = None  # why the last build failed, if it did


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvslam_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the loader unless a library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): {res.stderr.strip()[-400:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def _load():
    """The loaded library, built at first use; None where it cannot be."""
    global build_error
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        build_error = str(e)
        return None
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,  # expected height, width: other sizes fail
    ]
    lib.dl_get.restype = ctypes.c_int
    lib.dl_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint16)]
    lib.dl_get_gray.restype = ctypes.c_int
    lib.dl_get_gray.argtypes = list(lib.dl_get.argtypes)
    lib.dl_close.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _load() is not None


class AsyncFrameLoader:
    """Prefetching RGB(-D) frame loader over the native thread pool.

        loader = AsyncFrameLoader(rgb_paths, depth_paths)
        rgb, depth = loader.get(i)    # blocks only if not yet decoded
        loader.close()
    """

    def __init__(self, rgb_paths: list[str], depth_paths: list[str] | None = None,
                 height: int = 480, width: int = 640, n_threads: int = 3, lookahead: int = 24):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native dataloader not available: {build_error}")
        self._lib = lib
        self.height, self.width = height, width
        self.n = len(rgb_paths)
        self._has_depth = depth_paths is not None
        rgb_arr = (ctypes.c_char_p * self.n)(*[p.encode() for p in rgb_paths])
        dep = depth_paths if depth_paths is not None else [""] * self.n
        dep_arr = (ctypes.c_char_p * self.n)(*[p.encode() for p in dep])
        self._handle = lib.dl_open(rgb_arr, dep_arr, self.n, n_threads, lookahead, height, width)
        if not self._handle:
            raise RuntimeError("dl_open failed")

    def _get(self, fn, idx: int, image: np.ndarray):
        depth_raw = np.empty((self.height, self.width), np.uint16)
        rc = fn(self._handle, idx, image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                depth_raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
        if rc != 0:
            raise IOError(f"native decode failed for frame {idx}")
        depth = depth_raw.astype(np.float32) / DEPTH_SCALE if self._has_depth else None
        return image, depth

    def get(self, idx: int):
        """(rgb uint8 (H,W,3), depth float32 metres (H,W) or None)."""
        return self._get(self._lib.dl_get, idx, np.empty((self.height, self.width, 3), np.uint8))

    def get_gray(self, idx: int):
        """(gray uint8 (H,W), depth float32 metres (H,W) or None): the gray
        conversion runs in native code, (299 R + 587 G + 114 B) / 1000."""
        return self._get(self._lib.dl_get_gray, idx, np.empty((self.height, self.width), np.uint8))

    def close(self):
        """Stop the workers and free the loader; a second call does nothing."""
        if self._handle:
            self._lib.dl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
