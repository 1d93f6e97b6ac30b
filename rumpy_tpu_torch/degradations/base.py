"""Shared machinery for degradation-pipeline ops.

Port of ``rumpy_tpu/degradations/base.py``, device path only: an op's
``batch_apply(generator, imgs) -> (imgs, metadata)`` transforms a
(B, H, W, C) float batch on the generator's device, and the pipeline
composes the ops inside the train step. The JAX package's host path
(``__call__`` on one PIL image or uint8 array, for the offline
``image_manipulate`` tool) is not ported: it raises.
"""

from __future__ import annotations

from typing import Any, Dict


def tools_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the tools slice "
        "(image_manipulate, offline pipelines and the codec binaries)")


def normalize(value, lo, hi):
    return (value - lo) / (hi - lo)


def per_view(t, views: int):
    """An image's draw repeated for each of its ``views`` consecutive rows
    of a view stack (image-major: rows i * views ... i * views + views - 1
    are image i's)."""
    return t if views == 1 else t.repeat_interleave(views, dim=0)


class DegradationOp:
    def get_hyperparams(self) -> Dict[str, Any]:
        raise NotImplementedError

    def __call__(self, image):
        raise tools_slice(f"the host path of {type(self).__name__} (one PIL "
                          "image or uint8 array at a time)")

    def batch_apply(self, generator, imgs, views: int = 1):
        """(B, H, W, C) float batch -> (batch, {attribute: (B / views,) or
        (B / views, M)}) on the generator's device. With ``views`` the batch
        is a stack of that many views of each image, image-major, and every
        draw is made once an image and shared by its views; the metadata
        has a row an image. Ops without a device path raise."""
        raise NotImplementedError(
            f"{type(self).__name__} has no on-device implementation")
