"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, into ``ops/build/`` (listed in ``.gitignore``);
the library's name carries a hash of its source, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {name: os.path.join(_HERE, "csrc", f"{name}.cu") for name in ("knn", "pointfusion")}
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def build(names=None) -> Dict[str, float]:
    """Compile the named sources (all by default), one ``nvcc`` each, all
    started together. Returns seconds per source (0.0 when already built);
    raises with the compiler's output if one fails. The compiler's
    resource report is kept beside each library as ``.log``."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(out + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
