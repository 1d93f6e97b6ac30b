"""BT.601 YCbCr <-> RGB conversion on channel-last tensors.

Port of ``rumpy_tpu/utils/color.py``: the ``jpg`` (full-range JFIF) and
``png`` (studio-swing) variants. Each output channel is the chain of fused
multiply-adds ``fma(B, wb, fma(G, wg, R * wr))`` that the JAX version's
full-precision contraction evaluates on the CPU, then the bias
(``weighted_sum_chain``), written out rather than a matmul, so it stays
full float32 on the card whatever the TF32 settings. On 8-bit images many
pixels sit exactly on a rounding boundary of ``255 * Y``, where the last
bit of Y decides the grey level; the chain gives JAX's bits there.
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


def weighted_sum_chain(img: torch.Tensor, weights) -> torch.Tensor:
    """``sum_c img[..., c] * weights[c]`` over the 3 channels of a
    channel-last float32 tensor, evaluated as ``fma(B, wb, fma(G, wg, R *
    wr))``: each step in float64, where the product of two float32 numbers
    is exact, and rounded to float32 once. ``weights`` are float32 values."""
    y = (img[..., 0].double() * weights[0]).to(img.dtype)
    for c in (1, 2):
        y = (img[..., c].double() * weights[c] + y.double()).to(img.dtype)
    return y


def rgb_to_ycbcr(img: torch.Tensor, y_only: bool = False, max_val: float = 1.0,
                 im_type: str = "png") -> torch.Tensor:
    """RGB -> YCbCr on channel-last input (..., C=3)."""
    fwd = _JPG_FWD if im_type == "jpg" else _PNG_FWD
    bias = _biases(im_type, max_val)
    rows = torch.as_tensor(fwd[:1] if y_only else fwd, dtype=img.dtype).double().tolist()
    # the biases as values of img's dtype, added as scalars: no upload to
    # the card, which would wait for the host
    b = torch.as_tensor(bias[:len(rows)], dtype=img.dtype).tolist()
    return torch.stack([weighted_sum_chain(img, row) + bias_c
                        for row, bias_c in zip(rows, b)], dim=-1)


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
