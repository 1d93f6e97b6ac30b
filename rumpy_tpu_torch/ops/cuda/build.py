"""Build the package's CUDA sources with nvcc and load them over ctypes.

Each ``*.cu`` in ``rumpy_tpu_torch/csrc`` becomes a shared library with a
plain C interface (no PyTorch headers, which keeps the build short). The
library goes to ``rumpy_tpu_torch/build/``, beside ``csrc`` in the
package's own directory, named by the content hash of the source and of the
headers (``*.cuh``) beside it, so an edited source is rebuilt and concurrent
processes never see a half-written file. Nothing is built at import time:
the first launch on a CUDA tensor builds. ``load`` may be called from any
thread (a data loader's workers reach it): one lock per library serialises
its build, its load and the caller's binding of its entry points.
``build_all`` compiles several libraries ahead of their first use, one nvcc
process each, side by side.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_locks: Dict[str, threading.Lock] = {}
_guard = threading.Lock()
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if not CUDA_HOME:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME so that "
                           "$CUDA_HOME/bin/nvcc exists")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def _digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path. Raises with nvcc's output on failure."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}-{_digest(src)}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    build_seconds[name] = time.perf_counter() - t0
    return lib


def _lock_of(name: str) -> threading.Lock:
    with _guard:
        return _locks.setdefault(name, threading.Lock())


def load(name: str, bind: Optional[Callable[[ctypes.CDLL], None]] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use.
    ``bind`` (it sets the entry points' argument types) runs once, on the
    thread that loads, before any other thread is handed the library."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock_of(name):
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            if bind is not None:
                bind(lib)
            _libs[name] = lib
        return _libs[name]


def build_all(names: Iterable[str]) -> None:
    """Compile several libraries, their nvcc runs side by side."""
    def one(name):
        with _lock_of(name):
            build(name)

    names = list(names)
    with cf.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(one, names))
