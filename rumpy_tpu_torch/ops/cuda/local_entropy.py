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

The function must move one byte in and four out a pixel, which is what
bounds it on an H100; the kernel (``csrc/local_entropy.cu``) does about
``region**2`` histogram updates a pixel, more than the function needs (its
source has the numbers). ``local_entropy`` launches it for CUDA tensors and
raises if that fails; it runs ``local_entropy_reference`` only for tensors
that lie on the CPU. It may be called from several threads (a
data loader's workers): the library is built under a lock and the launch
goes to the calling thread's current stream.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

# Launches of the CUDA kernel (one per ``local_entropy`` call on the card).
launches = 0

MAX_REGION = 15  # the kernel counts a window in bytes: region**2 <= 255

_count_lock = threading.Lock()  # the loader's workers count too


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


def local_entropy(gray_u8: torch.Tensor, region: int = 10,
                  levels: int = 64) -> torch.Tensor:
    """Per-pixel window entropy of an (H, W) uint8 tensor, float32.

    ``region`` in [1, 15], ``levels`` in [1, 256]."""
    global launches
    if gray_u8.dim() != 2 or gray_u8.numel() == 0:
        raise ValueError(f"local_entropy: need a non-empty (H, W) image, got "
                         f"{tuple(gray_u8.shape)}")
    if gray_u8.dtype != torch.uint8:
        raise TypeError(f"local_entropy: dtype {gray_u8.dtype} is not uint8")
    if not 1 <= region <= MAX_REGION:
        raise ValueError(f"local_entropy: region {region} is not in [1, {MAX_REGION}]")
    if not 1 <= levels <= 256:
        raise ValueError(f"local_entropy: levels {levels} is not in [1, 256]")
    if gray_u8.device.type == "cpu":
        return local_entropy_reference(gray_u8, region, levels)
    if gray_u8.device.type != "cuda":
        raise RuntimeError(f"local_entropy: unsupported device {gray_u8.device}")
    img = gray_u8.contiguous()
    h, w = img.shape
    lib = _library()
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        err = lib.local_entropy_forward(
            img.data_ptr(), out.data_ptr(), h, w, region, levels,
            torch._C._cuda_getCurrentRawStream(img.device.index))
    if err != 0:
        name = lib.local_entropy_error_name(err).decode()
        raise RuntimeError(f"local_entropy: CUDA launch failed with error {err} ({name})")
    with _count_lock:
        launches += 1
    return out


def _bind(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.local_entropy_forward.argtypes = [vp, vp, i, i, i, i, vp]
    lib.local_entropy_forward.restype = i
    lib.local_entropy_error_name.argtypes = [i]
    lib.local_entropy_error_name.restype = ctypes.c_char_p


def _library():
    """The kernel's C entry points, built and loaded at first use."""
    from rumpy_tpu_torch.ops.cuda import build
    return build.load("local_entropy", _bind)
