"""PIL-compatible separable resampling as matrix products.

Port of ``rumpy_tpu/ops/resize.py``. Pillow's antialiased resampler is
re-derived as dense (out_size, in_size) coefficient matrices, one a pass:
support scaled by the downscale factor, rows normalized, and for uint8
images quantized to Pillow's 22-bit fixed point (round half away from
zero). ``pil_resize`` then runs the horizontal pass, rounds and clips to
uint8 (``clip8(floor(acc + 0.5))``), and the vertical pass.

The matrices are built in numpy, cached per (sizes, filter), and uploaded
once per device. The products run in float64: TF32 cannot touch them
whatever the process-wide flags say, and a sum of 22-bit coefficients
times 8-bit levels is exact in float64, so ``pil_resize`` gives Pillow's
integer arithmetic bit for bit (the JAX package's float32 products differ
from Pillow by one level at a few rounding boundaries).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed-point fraction bits for 8bpc


# Filter definitions (support, kernel fn): Pillow Resample.c equivalents.

def _bicubic(x: np.ndarray) -> np.ndarray:
    # Keys cubic with a = -0.5 (Pillow's BICUBIC).
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _sinc(x: np.ndarray) -> np.ndarray:
    return np.where(x == 0.0, 1.0, np.sinc(x))


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) < 3.0, _sinc(x) * _sinc(x / 3.0), 0.0)


def _box(x: np.ndarray) -> np.ndarray:
    return np.where((x > -0.5) | np.isclose(x, -0.5), np.where(x <= 0.5, 1.0, 0.0), 0.0)


def _hamming(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = np.where(x == 0.0, 1.0,
                   (0.54 + 0.46 * np.cos(np.pi * np.clip(x, 1e-12, None)))
                   * _sinc(np.clip(x, 1e-12, None)))
    return np.where(x >= 1.0, 0.0, out)


FILTERS = {
    "bicubic": (2.0, _bicubic),
    "bilinear": (1.0, _bilinear),
    "lanczos": (3.0, _lanczos),
    "box": (0.5, _box),
    "hamming": (1.0, _hamming),
}


def _precompute_coeffs(in_size: int, out_size: int, filter: str) -> np.ndarray:
    """Dense float64 (out_size, in_size) row-normalized coefficient matrix
    (Pillow's precompute_coeffs)."""
    support0, fn = FILTERS[filter]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ss = 1.0 / filterscale

    W = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        x = np.arange(xmin, xmax, dtype=np.float64)
        w = fn((x - center + 0.5) * ss)
        total = w.sum()
        if total != 0.0:
            w = w / total
        W[xx, xmin:xmax] = w
    return W


def _quantize_coeffs(W: np.ndarray) -> np.ndarray:
    """Pillow normalize_coeffs_8bpc: round-half-away-from-zero to 22-bit
    fixed point, returned as exact float32 multiples of 2**-22."""
    k = np.where(W < 0,
                 np.ceil(W * (1 << _PRECISION_BITS) - 0.5),
                 np.floor(W * (1 << _PRECISION_BITS) + 0.5))
    return (k / (1 << _PRECISION_BITS)).astype(np.float32)


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, filter: str = "bicubic",
                  quantized: bool = True) -> np.ndarray:
    W = _precompute_coeffs(in_size, out_size, filter)
    return _quantize_coeffs(W) if quantized else W.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _unscaled_matrix(in_size: int, out_size: int, filter: str) -> np.ndarray:
    """Unscaled-support kernels (the non-antialiased resize)."""
    support0, fn = FILTERS[filter]
    scale = in_size / out_size
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(math.floor(center - support0)), 0)
        xmax = min(int(math.ceil(center + support0)) + 1, in_size)
        x = np.arange(xmin, xmax, dtype=np.float64)
        w = fn(x - center + 0.5)
        total = w.sum()
        if total != 0.0:
            w = w / total
        W[xx, xmin:xmax] = w
    return W.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _device_matrix(in_size: int, out_size: int, filter: str, kind: str,
                   device: torch.device) -> torch.Tensor:
    """A pass's coefficients as a float64 tensor on ``device``, uploaded
    once. ``kind``: 'quantized' (uint8), 'antialias' or 'unscaled'."""
    if kind == "unscaled":
        W = _unscaled_matrix(in_size, out_size, filter)
    else:
        W = resize_matrix(in_size, out_size, filter, quantized=kind == "quantized")
    return torch.as_tensor(W.astype(np.float64), device=device)


def _passes(x: torch.Tensor, out_h: int, out_w: int, filter: str, kind: str,
            between=None) -> torch.Tensor:
    """Horizontal pass, ``between`` (if any), vertical pass, on a float64
    channel-last (..., H, W, C) tensor."""
    Wh = _device_matrix(x.shape[-2], out_w, filter, kind, x.device)
    Wv = _device_matrix(x.shape[-3], out_h, filter, kind, x.device)
    x = torch.einsum("...hwc,ow->...hoc", x, Wh)
    if between is not None:
        x = between(x)
    return torch.einsum("...hwc,oh->...owc", x, Wv)


def _clip8(acc: torch.Tensor) -> torch.Tensor:
    # clip8(floor(acc + 0.5)) on float accumulators.
    return torch.floor(acc + 0.5).clamp_(0.0, 255.0)


def pil_resize(img, size, filter: str = "bicubic") -> torch.Tensor:
    """``PIL.Image.resize`` for uint8 channel-last images, bit for bit.

    :param img: (H, W, C) or (N, H, W, C) uint8 tensor or numpy array.
    :param size: (out_h, out_w).
    :param filter: one of 'bicubic', 'bilinear', 'lanczos', 'box', 'hamming'.
    :returns: uint8 tensor on the input's device (the CPU for numpy).
    """
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.array(img))  # a writable copy
    if img.dtype != torch.uint8:
        raise TypeError("pil_resize expects uint8 input; use resize_float "
                        "for float images")
    out_h, out_w = size
    x = _passes(img.to(torch.float64), out_h, out_w, filter, "quantized", between=_clip8)
    return _clip8(x).to(torch.uint8)


def resize_float(img: torch.Tensor, size, filter: str = "bicubic",
                 antialias: bool = True) -> torch.Tensor:
    """Float resize with PIL kernel semantics and no uint8 quantization, on
    a channel-last (..., H, W, C) tensor; the result has the input's
    dtype. The degradation chain's downsample."""
    out_h, out_w = size
    kind = "antialias" if antialias else "unscaled"
    return _passes(img.to(torch.float64), out_h, out_w, filter, kind).to(img.dtype)
