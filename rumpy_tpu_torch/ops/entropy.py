"""Local-entropy patch selection.

Port of ``rumpy_tpu/ops/entropy.py``: rank-entropy over a rectangular
window on the uint8 Y channel, average-pooled at the crop size, argmax (or
iterative top-k with NaN masking of overlapping picks). On the card the
entropy map comes from the hand-written kernel
(``ops/cuda/local_entropy.py``); ``local_entropy`` here is the one-hot
formulation, whose border rule truncates the window on both axes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rumpy_tpu_torch.device import resolve_device
from rumpy_tpu_torch.ops.cuda import local_entropy as entropy_ops

# BT.601 full-range luma weights (utils/color.py's jpg variant), float32.
_LUMA = tuple(float(np.float32(v)) for v in (0.299, 0.587, 0.114))


def _box_filter_same(x: torch.Tensor, size: int) -> torch.Tensor:
    """Separable box sum over the first two axes with zero padding
    ('same'), the windows added in ascending order.

    Ceil-left anchor: output[i] sums window [i - size//2, i + (size-1)//2],
    which makes ``entropy_patch_positions``' trim an exact VALID window, so
    pooled[j] is the patch whose top-left corner is j."""
    pad_l = size // 2
    pad_r = size - 1 - pad_l

    def conv1d(v, axis):
        pads = [0, 0] * v.dim()
        k = 2 * (v.dim() - 1 - axis)  # F.pad lists the last axis first
        pads[k], pads[k + 1] = pad_l, pad_r
        vp = F.pad(v, pads)
        n = v.shape[axis]
        out = vp.narrow(axis, 0, n)
        for i in range(1, size):
            out = out + vp.narrow(axis, i, n)
        return out

    return conv1d(conv1d(x, 0), 1)


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


def local_entropy_best(gray_u8: torch.Tensor, region: int = 10,
                       levels: int = 64) -> torch.Tensor:
    """The entropy map through the hand-written kernel (its plain version
    for a tensor on the CPU). Takes uint8-valued input of any dtype:
    rounds and clips it first."""
    img = gray_u8.round().clamp(0, 255).to(torch.uint8)
    return entropy_ops.local_entropy(img, region=region, levels=levels)


def luma_u8(img: torch.Tensor) -> torch.Tensor:
    """uint8-valued luma of an (H, W, 3) float32 RGB image in [0, 1]:
    ``round(255 * Y)`` clipped, Y the jpg-variant luma of
    ``utils/color.py`` evaluated as a chain of fused multiply-adds in
    float32, ``fma(B, wb, fma(G, wg, R * wr))``. Images decoded from 8-bit
    files put many pixels exactly on a rounding boundary of ``255 * Y``,
    where the last bit of Y decides the grey level, and the fused chain is
    how the JAX package's luma comes out on the CPU; each step is computed
    in float64, where the product is exact, and rounded to float32 once."""
    r, g, b = (img[..., i].double() for i in range(3))
    y = (r * _LUMA[0]).float()
    y = (g * _LUMA[1] + y.double()).float()
    y = (b * _LUMA[2] + y.double()).float()
    return (y * 255.0).round().clamp(0, 255)


def pooled_entropy(image_rgb, crop_size: int, region: int = 10, levels: int = 64,
                   device=None) -> torch.Tensor:
    """The entropy map of an (H, W, 3) float [0,1] image, average-pooled
    (as a sum) at the crop size with stride 1: entry (y, x) scores the
    patch whose top-left corner is (y, x)."""
    dev = resolve_device(device)
    img = torch.as_tensor(np.asarray(image_rgb, np.float32), device=dev)
    ent = local_entropy_best(luma_u8(img), region=region, levels=levels)
    return _box_filter_same(ent, crop_size)[
        crop_size // 2: ent.shape[0] - (crop_size - 1) // 2,
        crop_size // 2: ent.shape[1] - (crop_size - 1) // 2]


def entropy_patch_positions(image_rgb, crop_size: int, number_of_patches: int = 1,
                            selection: str = "highest", region: int = 10,
                            levels: int = 64, device=None) -> Tuple[list, list]:
    """Top-k entropy patch corners for an (H, W, 3) float [0,1] image,
    masking out overlaps between successive picks. Returns (ys, xs). The
    map is computed on ``device`` (default: the card); the top-k runs on
    the host."""
    pooled = pooled_entropy(image_rgb, crop_size, region, levels, device)
    arr = pooled.cpu().numpy().astype(np.float64)
    ys, xs = [], []
    for _ in range(number_of_patches):
        idx = (np.nanargmax(arr) if selection == "highest"
               else np.nanargmin(arr))
        yy, xx = np.unravel_index(idx, arr.shape)
        arr[max(0, yy - crop_size):yy + crop_size,
            max(0, xx - crop_size):xx + crop_size] = np.nan
        ys.append(int(yy))
        xs.append(int(xx))
    return ys, xs
