"""The native RGB-D batch loader: ``native/rgbd_loader.cpp`` through ctypes.

The disk datasets decode their PNGs with it when it builds: libpng decode,
bilinear colour and nearest depth resize, depth scaling and a thread pool,
written straight into numpy buffers. The source is the repository's shared
``native/rgbd_loader.cpp``, read and never changed; this module compiles it
with ``g++`` at first use into ``data/build/`` (listed in ``.gitignore``),
under a name that carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. It never loads
``native/librgbd_loader.so``, the JAX package's build. Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native", "rgbd_loader.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-Wall"]
LIBS = ["-lpng", "-lz", "-lpthread"]

_lib = None
_error: Optional[str] = None  # why the library is unavailable, once tried


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"librgbd_loader_{digest[:16]}.so")


def _build(out: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def _load_library():
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (``unavailable_reason`` says why)."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        _error = str(exc)
        return None
    lib.rgbd_load_batch.restype = ctypes.c_int
    lib.rgbd_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_library() is not None


def unavailable_reason() -> Optional[str]:
    """Why the native loader could not be built or loaded (None if it was,
    or has not been tried)."""
    return _error


def load_rgbd_batch(rgb_paths: Sequence[str], depth_paths: Sequence[str], height: int,
                    width: int, depth_scale: float = 5000.0,
                    num_threads: Optional[int] = None):
    """Decode and resize a window of frames natively.

    Returns (colors [n,H,W,3] float32 in 0..255, depths [n,H,W,1] float32
    meters), or None when the library is unavailable or a file fails to
    decode."""
    lib = _load_library()
    if lib is None:
        return None
    n = len(rgb_paths)
    assert len(depth_paths) == n
    colors = np.empty((n, height, width, 3), np.float32)
    depths = np.empty((n, height, width, 1), np.float32)
    rgb_arr = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
    dep_arr = (ctypes.c_char_p * n)(*[p.encode() for p in depth_paths])
    threads = num_threads or min(8, os.cpu_count() or 1)
    ok = lib.rgbd_load_batch(
        rgb_arr, dep_arr, n, height, width, ctypes.c_float(depth_scale),
        colors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        depths.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
    if ok != n:
        return None
    return colors, depths
