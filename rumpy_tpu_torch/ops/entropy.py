"""Local-entropy patch selection.

Port of ``rumpy_tpu/ops/entropy.py``: rank-entropy over a rectangular
window on the uint8 Y channel, summed at the crop size, argmax (or
iterative top-k with NaN masking of overlapping picks). On the card an
image's path is a handful of launches on the calling thread's own stream:
its upload, the entropy kernel with the grey levels computed in its load
(``ops/cuda/local_entropy.py``), the window-sum kernel
(``ops/cuda/window_sum.py``), and one copy back: the pick's 8-byte key for
a single patch, the pooled map for several. On the CPU the same functions
run as the kernels' plain versions. ``local_entropy`` here is the one-hot
formulation, whose border rule truncates the window on both axes.
"""

from __future__ import annotations

import threading
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rumpy_tpu_torch.device import resolve_device
from rumpy_tpu_torch.ops.cuda import local_entropy as entropy_ops
from rumpy_tpu_torch.ops.cuda import window_sum as window_ops
from rumpy_tpu_torch.ops.cuda.window_sum import box_filter_same as _box_filter_same

_streams = threading.local()  # each loader thread's own CUDA stream, per device


def local_entropy(gray_u8: torch.Tensor, region: int = 10,
                  levels: int = 256) -> torch.Tensor:
    """Per-pixel entropy (bits) of the ``region`` x ``region``
    neighbourhood of an (H, W) uint8-valued tensor, by one-hot planes and
    a box filter; windows are truncated at every border."""
    q = gray_u8.to(torch.int64)
    if levels != 256:
        q = (q * levels) // 256
    onehot = F.one_hot(q, levels).to(torch.float32)  # (H, W, L)
    counts = _box_filter_same(onehot, region)
    total = counts.sum(dim=-1, keepdim=True)
    p = counts / total.clamp(min=1.0)
    plogp = torch.where(p > 0, p * torch.log2(p.clamp(min=1e-30)), torch.zeros_like(p))
    return -plogp.sum(dim=-1)


def luma_u8(img: torch.Tensor) -> torch.Tensor:
    """uint8-valued luma of an (H, W, 3) float32 RGB image in [0, 1], as
    float32: ``round(255 * Y)`` clipped, Y the jpg-variant luma of
    ``utils/color.py`` evaluated as the JAX package's luma comes out on the
    CPU (the entropy kernel's grey levels, ``grey_levels_reference``)."""
    return entropy_ops.grey_levels_reference(img).to(torch.float32)


def _image(image_rgb, dev: torch.device) -> torch.Tensor:
    """An (H, W, 3) image as uint8 or float32 [0, 1] on ``dev``."""
    arr = np.ascontiguousarray(image_rgb)
    if not arr.flags.writeable:  # the decode cache's arrays are read-only
        arr = arr.copy()
    img = torch.as_tensor(arr)
    if img.dtype != torch.uint8:
        img = img.to(torch.float32)
    return img.to(dev, non_blocking=True)


def _stream(dev: torch.device) -> torch.cuda.Stream:
    """The calling thread's own stream on ``dev``: a sync on it waits for
    this thread's work only, not for a train step on the default stream."""
    streams = getattr(_streams, "by_device", None)
    if streams is None:
        streams = _streams.by_device = {}
    if dev not in streams:
        streams[dev] = torch.cuda.Stream(device=dev)
    return streams[dev]


def pooled_entropy(image_rgb, crop_size: int, region: int = 10, levels: int = 64,
                   device=None) -> torch.Tensor:
    """The entropy map of an (H, W, 3) image (uint8, or float in [0, 1]),
    summed over every crop-size window with stride 1: entry (y, x) scores
    the patch whose top-left corner is (y, x)."""
    img = _image(image_rgb, resolve_device(device))
    ent = entropy_ops.local_entropy_rgb(img, region=region, levels=levels)
    return window_ops.window_sum(ent, crop_size)


def entropy_patch_positions(image_rgb, crop_size: int, number_of_patches: int = 1,
                            selection: str = "highest", region: int = 10,
                            levels: int = 64, device=None) -> Tuple[list, list]:
    """Top-k entropy patch corners for an (H, W, 3) image (uint8, or float
    in [0, 1]), masking out overlaps between successive picks. Returns
    (ys, xs). The map is computed on ``device`` (default: the card); a
    single pick is taken there too, several on the host."""
    dev = resolve_device(device)
    lowest = selection != "highest"
    if dev.type == "cuda":
        with torch.cuda.stream(_stream(dev)):
            img = _image(image_rgb, dev)
            if number_of_patches == 1:
                pick = torch.empty(1, dtype=torch.int64, device=dev)
                ent = entropy_ops.local_entropy_rgb(img, region, levels, clear=pick)
                pooled = window_ops.window_sum(ent, crop_size, pick=pick, lowest=lowest)
                yy, xx = divmod(window_ops.pick_index(pick.item()), pooled.shape[1])
                return [yy], [xx]
            ent = entropy_ops.local_entropy_rgb(img, region, levels)
            arr = window_ops.window_sum(ent, crop_size).cpu().numpy().astype(np.float64)
    else:
        arr = pooled_entropy(image_rgb, crop_size, region, levels, dev).numpy()
        arr = arr.astype(np.float64)
    ys, xs = [], []
    for _ in range(number_of_patches):
        idx = np.nanargmin(arr) if lowest else np.nanargmax(arr)
        yy, xx = np.unravel_index(idx, arr.shape)
        arr[max(0, yy - crop_size):yy + crop_size,
            max(0, xx - crop_size):xx + crop_size] = np.nan
        ys.append(int(yy))
        xs.append(int(xx))
    return ys, xs
