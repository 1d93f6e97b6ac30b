"""Build the package's CUDA sources with nvcc and load them over ctypes.

Each source in ``rumpy_tpu_torch/csrc`` becomes a shared library with a
plain C interface (no PyTorch headers, which keeps the build short). The
library goes to ``rumpy_tpu_torch/build/``, beside ``csrc`` in the
package's own directory, named by the source's content hash, so an edited
source is rebuilt and concurrent processes never see a half-written file.
Nothing is built at import time: the first launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}
_lock = threading.Lock()
build_seconds: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if not CUDA_HOME:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME so that "
                           "$CUDA_HOME/bin/nvcc exists")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path. Raises with nvcc's output on failure."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    build_seconds[name] = time.perf_counter() - t0
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build(name)))
        return _libs[name]
