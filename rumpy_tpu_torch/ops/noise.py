"""Gaussian and Poisson noise on the device (Real-ESRGAN style).

Port of ``rumpy_tpu/ops/noise.py``:

* Gaussian: noise = N(0, 1) * sigma / 255 per example; gray noise is the
  first channel's field broadcast over RGB, blended in per example.
* Poisson: rate = img * vals with vals = 2^ceil(log2(#levels)), #levels
  the occupied bins of the 0..255-rounded image, counted by
  ``scatter_add_`` into a fixed (B, 256) tensor (no host sync).
* Output clipped to [0, 1] when ``clip``.

Each op draws from an explicit ``torch.Generator`` on its device and then
calls an ``apply_*`` function that takes the draws as arguments, so the
tests can give both packages the same draws.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rumpy_tpu_torch.degradations.base import per_view
from rumpy_tpu_torch.device import true_div


def _rand(generator, shape):
    return torch.rand(shape, generator=generator, device=generator.device)


def _luma(img):
    # ITU-R BT.601 luma as used by rgb_to_grayscale.
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def apply_gaussian_noise(img: torch.Tensor, sigma: torch.Tensor, gray: torch.Tensor,
                         noise: torch.Tensor, clip: bool = True):
    """``img`` (B, H, W, C) in [0, 1] plus ``sigma`` / 255 (B,) times the
    unit field ``noise`` (B, H, W, C), its first channel alone where
    ``gray`` (B,) is 1. Returns (out, metadata, the scaled field)."""
    g = gray.to(img.dtype)[:, None, None, None]
    scale = true_div(sigma, 255.0)[:, None, None, None]
    scaled = scale * (g * noise[..., :1] + (1.0 - g) * noise)
    out = img + scaled
    if clip:
        out = out.clamp(0.0, 1.0)
    meta = {"gaussian_noise_scale": sigma, "gray_noise": gray.to(img.dtype),
            "poisson_noise_scale": torch.zeros_like(sigma)}
    return out, meta, scaled


def _per_image(meta, views: int):
    return meta if views == 1 else {k: v[::views] for k, v in meta.items()}


def add_gaussian_noise(generator: torch.Generator, img: torch.Tensor,
                       sigma_range: Tuple[float, float] = (0.0, 10.0),
                       gray_prob: float = 0.0, clip: bool = True,
                       return_noise: bool = False, views: int = 1):
    """img: (B, H, W, C) in [0, 1]; sigma in 0..255 units, uniform in
    ``sigma_range``; gray noise with probability ``gray_prob``. With
    ``return_noise`` also returns the scaled noise field. With ``views``,
    ``img`` stacks that many views of each image (image-major) and each
    image's sigma, gray flag and unit field are drawn once and shared by
    its views; the metadata has a row an image."""
    b = img.shape[0] // views
    lo, hi = sigma_range
    sigma = lo + (hi - lo) * _rand(generator, b)
    gray = (_rand(generator, b) < gray_prob).to(img.dtype)
    noise = torch.randn((b,) + tuple(img.shape[1:]), generator=generator,
                        device=generator.device, dtype=img.dtype)
    out, meta, scaled = apply_gaussian_noise(img, per_view(sigma, views),
                                             per_view(gray, views),
                                             per_view(noise, views), clip)
    meta = _per_image(meta, views)
    return (out, meta, scaled) if return_noise else (out, meta)


def _poisson_vals(img: torch.Tensor) -> torch.Tensor:
    """vals = 2^ceil(log2(#unique levels)) per example, from a 256-bin
    occupancy count of the rounded 0..255 image."""
    b = img.shape[0]
    levels = torch.round(img * 255.0).clamp(0, 255).to(torch.int64).reshape(b, -1)
    occupancy = torch.zeros((b, 256), dtype=torch.int32, device=img.device)
    occupancy.scatter_add_(1, levels, torch.ones_like(levels, dtype=torch.int32))
    nuniq = (occupancy > 0).sum(dim=-1).to(torch.float32)
    return torch.exp2(torch.ceil(torch.log2(nuniq)))


def poisson_rates(img: torch.Tensor):
    """The Poisson path's inputs: the image rounded to 0..255 levels and
    its rounded luma, each over 255, and their vals (B, 1, 1, 1)."""
    rounded = true_div(torch.round(img * 255.0).clamp(0, 255), 255.0)
    gray_img = true_div(torch.round(_luma(img) * 255.0).clamp(0, 255), 255.0)
    vals_c = _poisson_vals(rounded)[:, None, None, None]
    vals_g = _poisson_vals(gray_img)[:, None, None, None]
    return rounded, gray_img, vals_c, vals_g


def apply_poisson_noise(img: torch.Tensor, scale: torch.Tensor, gray: torch.Tensor,
                        sample_c: torch.Tensor, sample_g: torch.Tensor,
                        rates, clip: bool = True):
    """``img`` plus ``scale`` (B,) times the Poisson noise whose samples
    are ``sample_c`` ~ Poisson(rounded * vals_c) (B, H, W, C) and
    ``sample_g`` ~ Poisson(gray_img * vals_g) (B, H, W, 1), ``rates`` =
    (rounded, gray_img, vals_c, vals_g) = :func:`poisson_rates` of ``img``.
    Returns (out, metadata, the scaled field)."""
    rounded, gray_img, vals_c, vals_g = rates
    noise_c = sample_c.to(img.dtype) / vals_c - rounded
    noise_g = sample_g.to(img.dtype) / vals_g - gray_img
    g = gray.to(img.dtype)[:, None, None, None]
    scaled = scale[:, None, None, None] * (g * noise_g + (1.0 - g) * noise_c)
    out = img + scaled
    if clip:
        out = out.clamp(0.0, 1.0)
    meta = {"poisson_noise_scale": scale, "gray_noise": gray.to(img.dtype),
            "gaussian_noise_scale": torch.zeros_like(scale)}
    return out, meta, scaled


def add_poisson_noise(generator: torch.Generator, img: torch.Tensor,
                      scale_range: Tuple[float, float] = (0.0, 1.0),
                      gray_prob: float = 0.0, clip: bool = True,
                      return_noise: bool = False, views: int = 1):
    """As :func:`add_gaussian_noise`; with ``views`` the scale and the
    gray flag are shared by an image's views, while the Poisson samples,
    whose rates are each view's own pixels, are drawn for every view."""
    b = img.shape[0] // views
    lo, hi = scale_range
    scale = lo + (hi - lo) * _rand(generator, b)
    gray = (_rand(generator, b) < gray_prob).to(img.dtype)
    rates = rounded, gray_img, vals_c, vals_g = poisson_rates(img)
    sample_c = torch.poisson(rounded * vals_c, generator=generator)
    sample_g = torch.poisson(gray_img * vals_g, generator=generator)
    out, meta, scaled = apply_poisson_noise(img, per_view(scale, views),
                                            per_view(gray, views), sample_c, sample_g,
                                            rates, clip)
    meta = _per_image(meta, views)
    return (out, meta, scaled) if return_noise else (out, meta)
