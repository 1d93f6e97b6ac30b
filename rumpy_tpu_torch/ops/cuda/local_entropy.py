"""Local-histogram entropy: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``rumpy_tpu/ops/pallas/entropy_kernel.py::
local_entropy_pallas``: for every pixel of an (H, W) uint8 image, the
Shannon entropy (bits) of the histogram of its ``region`` x ``region``
window, values quantised to ``levels`` bins (``q = v * levels // 256``).
The window of output (y, x) spans rows ``y - region//2 .. y + region -
region//2 - 1`` and the same columns around x. The border rule is the TPU
kernel's, and it is mixed: rows outside the image are edge-replicated (and
counted again), columns outside the image are left out, so the window's
total shrinks at the left and right edge.

The kernel (``csrc/local_entropy.cu``) slides each column's histogram
down a strip of rows (two updates a row), adds a pixel's window from its
columns' histograms as packed bytes, and takes the entropy as ``log2(N) -
S / N`` with ``S = sum c log2 c`` summed as integers from
``plogp_table``. ``local_entropy_rgb`` runs the same kernel on a uint8
RGB image, whose grey levels the kernel computes in its load as
``grey_levels_reference`` does; a float32 image gets its grey levels from
``grey_levels_reference`` first.
The wrappers launch the kernel for CUDA tensors and raise if that fails;
they run the plain versions only for tensors that lie on the CPU. They may
be called from several threads (a data loader's workers): the library is
built under a lock and the launch goes to the calling thread's current
stream.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rumpy_tpu_torch.utils.color import weighted_sum_chain

# Launches of the CUDA kernel (one per ``local_entropy`` or
# ``local_entropy_rgb`` call on the card).
launches = 0

MAX_REGION = 15  # the kernel counts a window in bytes: region**2 <= 255
FRACTION_BITS = 20  # of the kernel's fixed-point S
# BT.601 full-range luma weights (utils/color.py's jpg variant), float32.
LUMA_WEIGHTS = tuple(float(np.float32(v)) for v in (0.299, 0.587, 0.114))
# Where the kernel reads its grey levels from, by the image's dims: uint8
# grey levels (H, W) or uint8 RGB (H, W, 3).
_SOURCES = {2: 0, 3: 1}

_count_lock = threading.Lock()  # the loader's workers count too
_tables: Dict[torch.device, torch.Tensor] = {}
_table_lock = threading.Lock()


def plogp_table(max_count: int = MAX_REGION ** 2) -> np.ndarray:
    """``c * log2(c)`` for c = 0..max_count in fixed point: int64, rounded
    to ``2**-FRACTION_BITS``. The kernel's table."""
    c = np.arange(max_count + 1, dtype=np.float64)
    v = c * np.log2(np.maximum(c, 1.0))
    return np.rint(v * 2.0 ** FRACTION_BITS).astype(np.int64)


def window_histogram(gray_u8: torch.Tensor, region: int, levels: int) -> torch.Tensor:
    """(H, W, levels) float32 counts of every pixel's window, by one-hot
    planes of the row-replicated image summed over the window's rows, then
    over its columns with zero planes outside the image."""
    h, w = gray_u8.shape
    half = region // 2
    q = (gray_u8.to(torch.int64) * levels) // 256
    rows = torch.arange(-half, h + region - half - 1, device=q.device).clamp(0, h - 1)
    onehot = F.one_hot(q[rows], levels).to(torch.float32)  # (H+region-1, W, L)
    col_hist = sum(onehot[r:r + h] for r in range(region))
    padded = F.pad(col_hist, (0, 0, half, region - 1 - half))
    return sum(padded[:, j:j + w] for j in range(region))


def local_entropy_reference(gray_u8: torch.Tensor, region: int = 10,
                            levels: int = 64) -> torch.Tensor:
    """The same function in plain PyTorch ops. (H, W) uint8-valued ->
    (H, W) float32."""
    hist = window_histogram(gray_u8, region, levels)
    total = hist.sum(dim=-1, keepdim=True)
    p = hist / total.clamp(min=1.0)
    plogp = torch.where(p > 0, p * torch.log2(p.clamp(min=1e-30)), torch.zeros_like(p))
    return -plogp.sum(dim=-1)


def grey_levels_reference(rgb: torch.Tensor) -> torch.Tensor:
    """The kernel's grey levels of an (H, W, 3) RGB image, in plain ops:
    uint8 input becomes float32 ``v / 255`` (the bits of numpy's
    conversion), float32 input is taken as it is; then ``round(255 * Y)``
    clamped to [0, 255], Y the jpg-variant luma evaluated as
    ``utils/color.py::weighted_sum_chain``. (H, W) uint8."""
    x = (rgb.double() / 255.0).float() if rgb.dtype == torch.uint8 else rgb
    y = weighted_sum_chain(x, LUMA_WEIGHTS)
    return (y * 255.0).round().clamp(0, 255).to(torch.uint8)


def _check(shape, region, levels, what):
    if not shape or 0 in shape:
        raise ValueError(f"{what}: need a non-empty image, got {tuple(shape)}")
    if not 1 <= region <= MAX_REGION:
        raise ValueError(f"{what}: region {region} is not in [1, {MAX_REGION}]")
    if not 1 <= levels <= 256:
        raise ValueError(f"{what}: levels {levels} is not in [1, 256]")


def local_entropy(gray_u8: torch.Tensor, region: int = 10,
                  levels: int = 64) -> torch.Tensor:
    """Per-pixel window entropy of an (H, W) uint8 tensor, float32.

    ``region`` in [1, 15], ``levels`` in [1, 256]."""
    if gray_u8.dim() != 2 or gray_u8.numel() == 0:
        raise ValueError(f"local_entropy: need a non-empty (H, W) image, got "
                         f"{tuple(gray_u8.shape)}")
    if gray_u8.dtype != torch.uint8:
        raise TypeError(f"local_entropy: dtype {gray_u8.dtype} is not uint8")
    _check(gray_u8.shape, region, levels, "local_entropy")
    if gray_u8.device.type == "cpu":
        return local_entropy_reference(gray_u8, region, levels)
    return _launch(gray_u8, region, levels, None, "local_entropy")


def local_entropy_rgb(rgb: torch.Tensor, region: int = 10, levels: int = 64,
                      clear: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pixel window entropy of the grey levels of an (H, W, 3) RGB
    image, uint8 or float32 in [0, 1]: ``local_entropy`` of
    ``grey_levels_reference(rgb)``, the grey levels of uint8 computed in
    the kernel's load. ``clear``: an int64 tensor of one element on the same
    device that the launch sets to 0, for a ``window_sum`` pick after it
    (ignored on the CPU)."""
    if rgb.dim() != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"local_entropy_rgb: need an (H, W, 3) image, got {tuple(rgb.shape)}")
    if rgb.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"local_entropy_rgb: dtype {rgb.dtype} is neither uint8 nor float32")
    _check(rgb.shape, region, levels, "local_entropy_rgb")
    if rgb.device.type == "cpu":
        return local_entropy_reference(grey_levels_reference(rgb), region, levels)
    if clear is not None and (clear.device != rgb.device or clear.dtype != torch.int64
                              or clear.numel() != 1):
        raise ValueError("local_entropy_rgb: clear must be one int64 on the image's device")
    if rgb.dtype == torch.float32:
        rgb = grey_levels_reference(rgb)
    return _launch(rgb, region, levels, clear, "local_entropy_rgb")


def grey_levels(rgb: torch.Tensor) -> torch.Tensor:
    """The grey levels that ``local_entropy_rgb``'s kernel computes in its
    load, by its front alone (a check of that front, not on the entropy
    path): (H, W) uint8 of an (H, W, 3) uint8 image."""
    if rgb.dim() != 3 or rgb.shape[-1] != 3 or rgb.dtype != torch.uint8:
        raise ValueError(f"grey_levels: need an (H, W, 3) uint8 image, got "
                         f"{tuple(rgb.shape)} {rgb.dtype}")
    if rgb.device.type == "cpu":
        return grey_levels_reference(rgb)
    if rgb.device.type != "cuda":
        raise RuntimeError(f"grey_levels: unsupported device {rgb.device}")
    rgb = rgb.contiguous()
    h, w = rgb.shape[:2]
    lib = _library()
    out = torch.empty((h, w), dtype=torch.uint8, device=rgb.device)
    with torch.cuda.device(rgb.device):
        err = lib.local_entropy_grey_levels(
            rgb.data_ptr(), out.data_ptr(), h, w,
            torch._C._cuda_getCurrentRawStream(rgb.device.index))
    if err != 0:
        name = lib.local_entropy_error_name(err).decode()
        raise RuntimeError(f"grey_levels: CUDA launch failed with error {err} ({name})")
    return out


def _launch(src, region, levels, clear, what):
    global launches
    if src.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {src.device}")
    src = src.contiguous()
    h, w = src.shape[:2]
    lib = _library()
    out = torch.empty((h, w), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        err = lib.local_entropy_forward(
            src.data_ptr(), _table(src.device).data_ptr(), out.data_ptr(),
            None if clear is None else clear.data_ptr(), h, w, region, levels,
            _SOURCES[src.dim()],
            torch._C._cuda_getCurrentRawStream(src.device.index))
    if err != 0:
        name = lib.local_entropy_error_name(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} ({name})")
    with _count_lock:
        launches += 1
    return out


def _table(device: torch.device) -> torch.Tensor:
    """``plogp_table`` as int32 on ``device``, uploaded once. The upload
    finishes before any stream can read it."""
    table = _tables.get(device)
    if table is None:
        with _table_lock:
            if device not in _tables:
                lib = _library()
                values = plogp_table()
                if len(values) != lib.local_entropy_table_size():
                    raise RuntimeError("local_entropy: the kernel's table size differs "
                                       "from plogp_table's")
                t = torch.from_numpy(values.astype(np.int32)).to(device)
                torch.cuda.synchronize(device)
                _tables[device] = t
            table = _tables[device]
    return table


def _bind(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.local_entropy_forward.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.local_entropy_forward.restype = i
    lib.local_entropy_grey_levels.argtypes = [vp, vp, i, i, vp]
    lib.local_entropy_grey_levels.restype = i
    lib.local_entropy_table_size.argtypes = []
    lib.local_entropy_table_size.restype = i
    lib.local_entropy_error_name.argtypes = [i]
    lib.local_entropy_error_name.restype = ctypes.c_char_p


def _library():
    """The kernel's C entry points, built and loaded at first use."""
    from rumpy_tpu_torch.ops.cuda import build
    return build.load("local_entropy", _bind)
