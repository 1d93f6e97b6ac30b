"""Shared machinery for degradation-pipeline ops.

Port of ``rumpy_tpu/degradations/base.py``. Each op has two interfaces:

* device path: ``batch_apply(generator, imgs) -> (imgs, metadata)``
  transforms a (B, H, W, C) float batch on the generator's device, and the
  pipeline composes the ops inside the train step;
* host path: ``__call__(image) -> (image, metadata)`` on one PIL image or
  uint8 (H, W, C) array, for offline degradation (``image_manipulate``).
  Its numpy draws (JPEG quality, JM qpi, the compression coin) come from
  ``host_rng``: numpy's global generator, as in the JAX package, unless an
  ``ImagePipeline`` hands its ops its own ``RandomState``. Its tensor work
  runs on ``host_device`` (default ``"cuda"``), which the pipeline sets.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Tuple

import numpy as np
import torch

from rumpy_tpu_torch.device import resolve_device


def _is_pil(image) -> bool:
    # an image can only be a PIL image once PIL.Image has been imported
    pil = sys.modules.get("PIL.Image")
    return pil is not None and isinstance(image, pil.Image)


def to_float_array(image) -> Tuple[np.ndarray, bool]:
    """PIL image or uint8 array -> ((H, W, C) float32 in [0, 1], was_pil)."""
    was_pil = _is_pil(image)
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr, was_pil


def from_float_array(arr: np.ndarray, as_pil: bool):
    """[0, 1] float -> uint8, clipped and then truncated (torchvision's
    ``mul(255).byte()``, clamped rather than wrapped)."""
    u8 = np.clip(np.asarray(arr) * 255.0, 0, 255).astype(np.uint8)
    if as_pil:
        from PIL import Image
        return Image.fromarray(u8.squeeze(-1) if u8.shape[-1] == 1 else u8)
    return u8


def normalize(value, lo, hi):
    return (value - lo) / (hi - lo)


def per_view(t, views: int):
    """An image's draw repeated for each of its ``views`` consecutive rows
    of a view stack (image-major: rows i * views ... i * views + views - 1
    are image i's)."""
    return t if views == 1 else t.repeat_interleave(views, dim=0)


def host_metadata(meta: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A batch of one's metadata as Python values: a float, or a list of
    floats for a vector (the JAX host path's ``_host_call`` contract)."""
    out = {}
    for k, v in meta.items():
        v = v[0].cpu().numpy()
        out[k] = v.tolist() if v.ndim else float(v)
    return out


class DegradationOp:
    host_device = None  # the host path's torch device; None: "cuda"
    host_rng = np.random  # numpy draws of the host path

    def bind_host(self, device, rng=None) -> None:
        """Run the host path on ``device``, drawing from ``rng`` (a
        ``RandomState``; numpy's global generator when None)."""
        self.host_device = resolve_device(device)
        self.host_rng = np.random if rng is None else rng

    def _host_device(self) -> torch.device:
        if self.host_device is None:
            self.host_device = resolve_device(None)
        return self.host_device

    def _host_batch(self, image) -> Tuple[torch.Tensor, bool]:
        """One image as a float32 (1, H, W, C) batch on the host device."""
        arr, was_pil = to_float_array(image)
        return torch.from_numpy(np.ascontiguousarray(arr))[None].to(self._host_device()), was_pil

    def _host_generator(self) -> torch.Generator:
        """The op's generator on the host device, seeded with its ``seed``
        at first use."""
        gen = getattr(self, "_generator", None)
        dev = self._host_device()
        if gen is None or gen.device.type != dev.type:
            gen = self._generator = torch.Generator(dev).manual_seed(getattr(self, "seed", 0))
        return gen

    def get_hyperparams(self) -> Dict[str, Any]:
        raise NotImplementedError

    def __call__(self, image):
        raise NotImplementedError(f"{type(self).__name__} has no host path")

    def batch_apply(self, generator, imgs, views: int = 1, rows=None):
        """(B, H, W, C) float batch -> (batch, {attribute: (B / views,) or
        (B / views, M)}) on the generator's device. With ``views`` the batch
        is a stack of that many views of each image, image-major, and every
        draw is made once an image and shared by its views; the metadata
        has a row an image. With ``rows`` (``parallel.mesh.Rows``, counted in
        images) the batch is this rank's images of a global batch: every
        draw is made for the global batch, as one process draws it, and the
        op applies this rank's rows of them. Ops without a device path
        raise."""
        raise NotImplementedError(
            f"{type(self).__name__} has no on-device implementation")
