"""JPEG (and H.264-intra-style) compression simulated on the device.

Port of ``rumpy_tpu/ops/jpeg.py``: colour transform, 8x8 block DCT,
quality-scaled quantization, dequantization and inverse DCT as batched
products, with a per-example quality factor, inside the train step.

* Quantization tables and quality scaling follow ITU-T T.81 Annex K and
  libjpeg's ``jpeg_quality_scaling`` (5000/q below 50, 200-2q above).
* 4:4:4, the colour transform of ``utils/color.py`` (``im_type="jpg"``).
* A float DCT: close to libjpeg's integer DCT, not bit-exact.
* The H.264-intra approximation uses the same machinery with a flat
  quantization step Qstep(QP) = 0.625 * 2^(QP/6): the JM ``qpi`` metadata
  contract, not the JM binary's artefacts.

The DCT products run in float64, which TF32 cannot touch whatever the
process-wide flags say (the JAX package pins full float32 precision).
Rounding a coefficient over its quantization step flips where the ratio
lies within float noise of a .5 boundary, so two implementations agree
up to such near ties (:func:`tie_terms` gives the values that round).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from rumpy_tpu_torch.device import true_div
from rumpy_tpu_torch.utils.color import rgb_to_ycbcr, ycbcr_to_rgb

# ITU-T T.81 Annex K quantization tables.
LUMA_QTABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float32)

CHROMA_QTABLE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.float32)


def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II matrix, in float32 as the JAX
    package has it."""
    d = np.zeros((8, 8), dtype=np.float64)
    for i in range(8):
        c = np.sqrt(1 / 8) if i == 0 else np.sqrt(2 / 8)
        for j in range(8):
            d[i, j] = c * np.cos((2 * j + 1) * i * np.pi / 16)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    """(DCT matrix in float64, luma table, chroma table) on ``device``,
    uploaded once."""
    return (torch.as_tensor(_dct_matrix().astype(np.float64), device=device),
            torch.as_tensor(LUMA_QTABLE, device=device),
            torch.as_tensor(CHROMA_QTABLE, device=device))


def quality_to_scale(quality: torch.Tensor) -> torch.Tensor:
    """libjpeg jpeg_quality_scaling."""
    quality = quality.to(torch.float32)
    return torch.where(quality < 50, true_div(5000.0, quality), 200.0 - 2.0 * quality)


def scaled_qtable(base: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """Per-example (B, 8, 8) scaled quantization table."""
    scale = quality_to_scale(quality)[:, None, None]
    return torch.floor(true_div(base[None] * scale + 50.0, 100.0)).clamp(1.0, 255.0)


def _block_dct(ycc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, 3, H/8, W/8, 8, 8) float64 DCT coefficients."""
    b, h, w, c = ycc.shape
    d = _tables(ycc.device)[0]
    blocks = ycc.to(torch.float64).reshape(b, h // 8, 8, w // 8, 8, c).permute(0, 5, 1, 3, 2, 4)
    return torch.einsum("ij,bcnmjk,lk->bcnmil", d, blocks, d)


def _quantize(ycc: torch.Tensor, qtabs: torch.Tensor) -> torch.Tensor:
    """DCT -> quantize -> dequantize -> IDCT of (B, H, W, 3) levels centred
    at 0 (input - 128), with per-example (B, 3, 8, 8) steps."""
    b, h, w, c = ycc.shape
    d = _tables(ycc.device)[0]
    q = qtabs.to(torch.float64)[:, :, None, None]
    coeff = torch.round(_block_dct(ycc) / q) * q
    rec = torch.einsum("ji,bcnmjk,kl->bcnmil", d, coeff, d)
    return rec.permute(0, 2, 4, 3, 5, 1).reshape(b, h, w, c).to(ycc.dtype)


def _centred_ycc(img: torch.Tensor):
    """Edge-pad (B, H, W, 3) in [0, 1] to multiples of 8; its YCbCr in
    0..255 levels minus 128, and the original H, W."""
    b, h, w, _ = img.shape
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        img = F.pad(img.permute(0, 3, 1, 2), (0, pw, 0, ph),
                    mode="replicate").permute(0, 2, 3, 1)
    return rgb_to_ycbcr(img * 255.0, max_val=255.0, im_type="jpg") - 128.0, h, w


def _codec(img: torch.Tensor, qtabs: torch.Tensor, round_levels: bool = True) -> torch.Tensor:
    ycc, h, w = _centred_ycc(img)
    rgb = ycbcr_to_rgb(_quantize(ycc, qtabs) + 128.0, max_val=255.0, im_type="jpg")
    if round_levels:
        rgb = true_div(torch.round(rgb).clamp(0.0, 255.0), 255.0)
    return rgb[:, :h, :w, :]


def _qtables(levels: torch.Tensor, codec: str) -> torch.Tensor:
    """The (B, 3, 8, 8) steps of the YCbCr channels: JPEG's quality-scaled
    tables, or H.264's flat step of QP."""
    if codec == "h264":
        return h264_qstep(levels)[:, None, None, None].expand(levels.shape[0], 3, 8, 8)
    _, luma, chroma = _tables(levels.device)
    qc = scaled_qtable(chroma, levels)
    return torch.stack([scaled_qtable(luma, levels), qc, qc], dim=1)


def jpeg_compress(img: torch.Tensor, quality: torch.Tensor) -> torch.Tensor:
    """JPEG round trip. img (B, H, W, 3) in [0, 1]; quality (B,) in 1..100.
    Returns the same shape, clipped to [0, 1]."""
    return _codec(img, _qtables(quality, "jpeg"))


def h264_qstep(qpi: torch.Tensor) -> torch.Tensor:
    """H.264 quantization step: doubles every 6 QP."""
    return 0.625 * torch.exp2(true_div(qpi.to(torch.float32), 6.0))


def h264_intra_compress(img: torch.Tensor, qpi: torch.Tensor) -> torch.Tensor:
    """JM-style intra-frame compression approximation: the block-DCT
    pipeline with a flat quantization step derived from QP (20..51)."""
    return _codec(img, _qtables(qpi, "h264"))


def tie_terms(img: torch.Tensor, levels: torch.Tensor, codec: str = "jpeg"):
    """Where :func:`jpeg_compress` (``codec="jpeg"``, ``levels`` the
    qualities) or :func:`h264_intra_compress` (``"h264"``, the QPs) of
    ``img`` rounds: each DCT coefficient over its step, (B, 3, H/8, W/8, 8,
    8) float64, and the reconstructed RGB levels
    before the final rounding, (B, H, W, 3). A value within float noise of
    a .5 boundary is a near tie, where two implementations may round
    apart."""
    ycc, _, _ = _centred_ycc(img)
    qtabs = _qtables(levels, codec)
    ratios = _block_dct(ycc) / qtabs.to(torch.float64)[:, :, None, None]
    return ratios, _codec(img, qtabs, round_levels=False)
