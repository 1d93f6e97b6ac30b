"""Image saving for evaluation outputs.

The part of ``rumpy_tpu/utils/visualization.py`` that ``EvalHub`` and the
trainer's validation sample need: ``to_uint8_rgb`` and ``safe_image_save``.
PIL is imported inside ``safe_image_save``, so the module imports where PIL
is not installed. Comparison collages (matplotlib) come with ROADMAP queue 1
item 10.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rumpy_tpu_torch.utils.color import ycbcr_to_rgb


def to_uint8_rgb(img, colorspace: str = "rgb") -> np.ndarray:
    """(H, W, C) float [0, 1] (numpy or tensor; the first image of a batch)
    as uint8 RGB: YCbCr converted, one channel repeated, then clipped and
    scaled with truncation, not rounding, as the JAX package saves."""
    img = img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    if img.ndim == 4:
        img = img[0]
    if colorspace == "ycbcr" and img.shape[-1] == 3:
        img = ycbcr_to_rgb(torch.from_numpy(np.asarray(img, np.float32)),
                           im_type="jpg").numpy()
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def safe_image_save(img, out_dir: str, name: str, colorspace: str = "rgb") -> str:
    """Write ``img`` as ``out_dir/name`` (``.png`` added where missing)
    through PIL; raises ImportError naming PIL where it is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("saving images needs PIL (Pillow), which is not "
                          "installed") from e
    os.makedirs(out_dir, exist_ok=True)
    u8 = to_uint8_rgb(img, colorspace)
    path = os.path.join(out_dir, name if name.lower().endswith(".png") else name + ".png")
    Image.fromarray(u8).save(path)
    return path
