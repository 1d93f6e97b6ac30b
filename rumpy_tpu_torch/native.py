"""ctypes binding of the framework-free host library ``native/rumpy_native.cpp``.

Port of ``rumpy_tpu/native.py``, for what the port's ops call: the H.264
intra codec (``h264_intra``) that ``JMCompress`` runs without a JM binary.
The library is built from the repository's source at first use with
``g++`` into ``rumpy_tpu_torch/build/`` (compiled to a process-unique name
and renamed, so concurrent first calls never load a half-written file);
nothing is written under ``native/``. Where the build fails the call raises
:class:`NativeUnavailable`: the port has no stand-in codec.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(_PACKAGE_DIR), "native", "rumpy_native.cpp")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "build")
SO = os.path.join(BUILD_DIR, "librumpy_native.so")


class NativeUnavailable(RuntimeError):
    pass


_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.isfile(SRC):
        raise NativeUnavailable(f"missing {SRC}")
    if not os.path.isfile(SO) or os.path.getmtime(SRC) > os.path.getmtime(SO):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SRC],
                           check=True, capture_output=True)
            os.replace(tmp, SO)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", b"") or b""
            raise NativeUnavailable(
                f"building {SO} with g++ failed: {e} {detail.decode(errors='replace')[-400:]}")
    lib = ctypes.CDLL(SO)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.h264_intra_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
    lib.h264_intra_u8.restype = None
    _lib = lib
    return lib


def h264_intra(rgb: np.ndarray, qp: int) -> np.ndarray:
    """H.264 intra compression round trip of an (H, W, 3) uint8 image with
    even sides (the JM constraint) at quantiser ``qp``."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.shape[0] % 2 or rgb.shape[1] % 2:
        raise ValueError(f"h264_intra takes an (H, W, 3) image with even sides, got {rgb.shape}")
    lib = _load()
    h, w, _ = rgb.shape
    out = np.empty_like(rgb)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.h264_intra_u8(rgb.ctypes.data_as(u8p), h, w, int(qp), out.ctypes.data_as(u8p))
    return out
