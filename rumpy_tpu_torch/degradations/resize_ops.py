"""Downsample / Upsample pipeline ops.

Port of ``rumpy_tpu/degradations/resize_ops.py``, device path: an
antialiased PIL-kernel float resize (``ops/resize.py::resize_float``) at a
fixed scale, with a normalized ``scale`` metadata column. A random scale
changes the output's shape from batch to batch and raises, as in the JAX
package's device path.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from rumpy_tpu_torch.degradations.base import DegradationOp, normalize
from rumpy_tpu_torch.ops import resize as resize_ops
from rumpy_tpu_torch.registry import register_tool


class _Resize(DegradationOp):
    def __init__(self, scale=4, random_scale=False, scale_range=(2, 8),
                 normalize_metadata=True, seed=0):
        self.scale = scale
        self.random_scale = random_scale
        self.scale_range = tuple(scale_range)
        self.normalize_metadata = normalize_metadata

    def get_hyperparams(self) -> Dict[str, Any]:
        return {"min_scale": self.scale_range[0],
                "max_scale": self.scale_range[1]}

    def _norm(self, s):
        return normalize(s, *self.scale_range) if self.normalize_metadata else s

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
        # jm: the host path's even-size crop before JM compression
        super().__init__(scale, random_scale, scale_range, normalize_metadata, seed)
        self.restrict_metadata = restrict_metadata

    def batch_apply(self, generator, imgs, views: int = 1):
        _, h, w, _ = imgs.shape
        out, scale = self._resized(imgs, (h // self.scale, w // self.scale), views)
        return out, ({} if self.restrict_metadata else {"scale": scale})


@register_tool("upsample")
class Upsample(_Resize):
    def batch_apply(self, generator, imgs, views: int = 1):
        _, h, w, _ = imgs.shape
        out, scale = self._resized(imgs, (h * self.scale, w * self.scale), views)
        return out, {"scale": scale}
