"""Downsample / Upsample pipeline ops.

Port of ``rumpy_tpu/degradations/resize_ops.py``:

* device path: an antialiased PIL-kernel float resize
  (``ops/resize.py::resize_float``) at a fixed scale, with a normalized
  ``scale`` metadata column; a random scale changes the output's shape from
  batch to batch and raises, as in the JAX package;
* host path: the HR image centre-cropped to a multiple of the scale (to an
  even LR size with ``jm``, for the H.264 codec's 4:2:0 planes), then
  Pillow's bicubic, bit for bit (``ops/resize.py::pil_resize``), on the
  host device; a random scale is drawn from ``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from rumpy_tpu_torch.degradations.base import DegradationOp, normalize, to_float_array
from rumpy_tpu_torch.device import resolve_device
from rumpy_tpu_torch.ops import resize as resize_ops
from rumpy_tpu_torch.registry import register_tool


def center_crop_np(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - height) // 2
    left = (w - width) // 2
    return arr[top:top + height, left:left + width]


def _as_image(u8: np.ndarray, as_pil: bool):
    if as_pil:
        from PIL import Image
        return Image.fromarray(u8)
    return u8


def _pil_resize_np(u8: np.ndarray, size, device) -> np.ndarray:
    return resize_ops.pil_resize(torch.from_numpy(np.ascontiguousarray(u8)).to(device),
                                 size).cpu().numpy()


def downsample_pair(image, scale: int, jm: bool = False, device=None):
    """(HR centre-cropped to a multiple of ``scale``, its bicubic LR), each
    a PIL image for a PIL input, else uint8 arrays; the resize runs on
    ``device`` (default "cuda")."""
    arr, was_pil = to_float_array(image)
    h, w = arr.shape[:2]
    if jm:
        cw = (math.floor(w / scale) // 2) * 2
        ch = (math.floor(h / scale) // 2) * 2
    else:
        cw = math.floor(w / scale)
        ch = math.floor(h / scale)
    u8 = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    hr = center_crop_np(u8, ch * scale, cw * scale)
    lr = _pil_resize_np(hr, (ch, cw), resolve_device(device))
    return _as_image(hr, was_pil), _as_image(lr, was_pil)


class _Resize(DegradationOp):
    def __init__(self, scale=4, random_scale=False, scale_range=(2, 8),
                 normalize_metadata=True, seed=0):
        self.scale = scale
        self.random_scale = random_scale
        self.scale_range = tuple(scale_range)
        self.normalize_metadata = normalize_metadata
        self._rng = np.random.default_rng(seed)

    def get_hyperparams(self) -> Dict[str, Any]:
        return {"min_scale": self.scale_range[0],
                "max_scale": self.scale_range[1]}

    def _norm(self, s):
        return normalize(s, *self.scale_range) if self.normalize_metadata else s

    def _host_scale(self) -> int:
        if self.random_scale:
            return int(self._rng.integers(self.scale_range[0], self.scale_range[1] + 1))
        return self.scale

    def _resized(self, imgs, out_hw, views: int = 1):
        if self.random_scale:
            raise NotImplementedError(
                "random_scale produces dynamic shapes; use the host path")
        b = imgs.shape[0] // views
        scale = torch.full((b,), float(self._norm(self.scale)), device=imgs.device)
        return resize_ops.resize_float(imgs, out_hw), scale


@register_tool("downsample")
class Downsample(_Resize):
    def __init__(self, scale=4, jm=False, random_scale=False,
                 scale_range=(2, 8), normalize_metadata=True,
                 restrict_metadata=False, seed=0):
        super().__init__(scale, random_scale, scale_range, normalize_metadata, seed)
        self.jm = jm
        self.restrict_metadata = restrict_metadata

    def __call__(self, image):
        scale = self._host_scale()
        _, lr = downsample_pair(image, scale, jm=self.jm, device=self._host_device())
        return lr, ({} if self.restrict_metadata else {"scale": self._norm(scale)})

    def batch_apply(self, generator, imgs, views: int = 1):
        _, h, w, _ = imgs.shape
        out, scale = self._resized(imgs, (h // self.scale, w // self.scale), views)
        return out, ({} if self.restrict_metadata else {"scale": scale})


@register_tool("upsample")
class Upsample(_Resize):
    def __call__(self, image):
        scale = self._host_scale()
        arr, was_pil = to_float_array(image)
        u8 = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
        h, w = u8.shape[:2]
        up = _pil_resize_np(u8, (h * scale, w * scale), self._host_device())
        return _as_image(up, was_pil), {"scale": self._norm(scale)}

    def batch_apply(self, generator, imgs, views: int = 1):
        _, h, w, _ = imgs.shape
        out, scale = self._resized(imgs, (h * self.scale, w * self.scale), views)
        return out, {"scale": scale}
