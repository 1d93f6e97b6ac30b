"""BT.601 YCbCr <-> RGB conversion on channel-last tensors.

Port of ``rumpy_tpu/utils/color.py``: the ``jpg`` (full-range JFIF) and
``png`` (studio-swing) variants. The 3x3 products are written out as
float32 multiply-adds rather than a matmul, so they stay full float32 on
the card whatever the TF32 settings (the JAX version forces
``Precision.HIGHEST`` for the same reason).
"""

from __future__ import annotations

import numpy as np
import torch

# Forward matrices, rows = (Y, Cb, Cr), cols = (R, G, B).
_JPG_FWD = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312],
], dtype=np.float64)

_PNG_FWD = np.array([
    [65.481, 128.553, 24.966],
    [-37.797, -74.203, 112.0],
    [112.0, -93.786, -18.214],
], dtype=np.float64) / 255.0


def _biases(im_type: str, max_val: float) -> np.ndarray:
    s = max_val / 255.0
    if im_type == "jpg":
        return np.array([0.0, 128.0 * s, 128.0 * s])
    return np.array([16.0 * s, 128.0 * s, 128.0 * s])


def rgb_to_ycbcr(img: torch.Tensor, y_only: bool = False, max_val: float = 1.0,
                 im_type: str = "png") -> torch.Tensor:
    """RGB -> YCbCr on channel-last input (..., C=3)."""
    fwd = _JPG_FWD if im_type == "jpg" else _PNG_FWD
    bias = _biases(im_type, max_val)
    rows = fwd[:1] if y_only else fwd
    m = torch.as_tensor(rows.T, dtype=img.dtype, device=img.device)  # (3, out)
    b = torch.as_tensor(bias[:len(rows)], dtype=img.dtype, device=img.device)
    out = img[..., 0:1] * m[0] + img[..., 1:2] * m[1] + img[..., 2:3] * m[2]
    return out + b


def ycbcr_to_rgb(img: torch.Tensor, max_val: float = 1.0,
                 im_type: str = "png") -> torch.Tensor:
    """YCbCr -> RGB on channel-last input (..., C=3), with the reference's
    fixed inverse coefficients rather than a matrix inverse."""
    s = max_val / 255.0
    y, cb, cr = img[..., 0], img[..., 1], img[..., 2]
    if im_type == "jpg":
        bias = 128.0 * s
        r = y + 1.402 * cr - 1.402 * bias
        g = y - 0.344136 * cb - 0.714136 * cr + (0.714136 + 0.344136) * bias
        b = y + 1.772 * cb - 1.772 * bias
    else:
        r = 298.082 * y / 256.0 + 408.583 * cr / 256.0 - 222.921 * s
        g = (298.082 * y / 256.0 - 100.291 * cb / 256.0
             - 208.120 * cr / 256.0 + 135.576 * s)
        b = 298.082 * y / 256.0 + 516.412 * cb / 256.0 - 276.836 * s
    return torch.stack([r, g, b], dim=-1)
