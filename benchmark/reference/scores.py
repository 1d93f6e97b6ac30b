"""Y-channel PSNR and SSIM in plain PyTorch, float64.

Y = 0.299 R + 0.587 G + 0.114 B of the image clipped to [0, 1] (JFIF).
PSNR = 20 log10(1 / sqrt(MSE)). SSIM: an 11-tap Gaussian window (sigma
1.5), the population covariance, c1 = (0.01)^2, c2 = (0.03)^2, averaged
over the map less 5 pixels at each border, which is the map of a 'valid'
filtering (the padding never reaches it). ``precision="bf16"`` rounds the
inputs and every filtered map to bfloat16: the control's scores.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def y_channel(rgb: torch.Tensor) -> torch.Tensor:
    x = rgb.double().clamp(0.0, 1.0)
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _round(t, precision):
    return t.to(torch.bfloat16).double() if precision == "bf16" else t


def psnr(a: torch.Tensor, b: torch.Tensor, precision: str = "f32") -> float:
    a, b = _round(a, precision), _round(b, precision)
    mse = float(((a - b) ** 2).mean())
    return 100.0 if mse == 0 else 20.0 * math.log10(1.0 / math.sqrt(mse))


def ssim(a: torch.Tensor, b: torch.Tensor, precision: str = "f32") -> float:
    a, b = _round(a, precision), _round(b, precision)
    x = torch.arange(-5, 6, dtype=torch.float64, device=a.device)
    taps = torch.exp(-0.5 * (x / 1.5) ** 2)
    taps = taps / taps.sum()

    def filt(t):
        t = F.conv2d(t[None, None], taps.view(1, 1, 11, 1))
        return _round(F.conv2d(t, taps.view(1, 1, 1, 11))[0, 0], precision)

    ux, uy = filt(a), filt(b)
    vx, vy, vxy = filt(a * a) - ux * ux, filt(b * b) - uy * uy, filt(a * b) - ux * uy
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return float(s.mean())
