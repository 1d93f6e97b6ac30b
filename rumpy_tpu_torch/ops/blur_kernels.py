"""Batched blur-kernel generation on the device.

Port of ``rumpy_tpu/ops/blur_kernels.py``: a whole batch of per-example
kernels across the seven Real-ESRGAN families (iso / aniso /
generalized_{iso,aniso} / plateau_{iso,aniso} / sinc) from one
``torch.Generator``, in float32 on the generator's device. Every family in
range is evaluated for every example and the drawn one selected, so the
work is a fixed set of small launches and nothing waits for the host.

The random draws and the arithmetic are split: :func:`draw_kernel_params`
makes the draws, :func:`kernels_from_draws` builds the kernels and their
metadata from them. A torch generator cannot reproduce ``jax.random``
streams, so the tests hand both packages the same draws.

Sampling protocol, as in the JAX package: family choice by probability
(inverse CDF of one uniform draw, ``jax.random.choice``'s rule); iso
families pin sigma_y = sigma_x and rotation 0; betas are drawn half below
and half above 1; omega_c ~ U(omega_c_range); optional multiplicative
kernel noise that sinc kernels never get; a metadata field reads 0 unless
the drawn family uses it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from rumpy_tpu_torch.config.constants import blur_kernel_codes
from rumpy_tpu_torch.ops.special import j1

ALL_KERNEL_TYPES = ("iso", "aniso", "generalized_iso", "generalized_aniso",
                    "plateau_iso", "plateau_aniso", "sinc")
_ISO = {"iso", "generalized_iso", "plateau_iso"}
_ANISO = ("aniso", "generalized_aniso", "plateau_aniso")


@dataclasses.dataclass(frozen=True)
class BlurKernelConfig:
    kernel_size: int = 21
    kernel_range: Tuple[str, ...] = ("iso",)
    kernel_probabilities: Optional[Tuple[float, ...]] = None
    sigma_x_range: Tuple[float, float] = (0.6, 5.0)
    sigma_y_range: Tuple[float, float] = (0.6, 5.0)
    rotation_range: Tuple[float, float] = (-math.pi, math.pi)
    betag_range: Tuple[float, float] = (0.5, 8.0)
    betap_range: Tuple[float, float] = (0.5, 8.0)
    omega_c_range: Tuple[float, float] = (math.pi / 3, math.pi)
    noise_range: Optional[Tuple[float, float]] = None

    def __post_init__(self):
        if self.kernel_range == "all":
            object.__setattr__(self, "kernel_range", ALL_KERNEL_TYPES)
        for k in self.kernel_range:
            if k not in ALL_KERNEL_TYPES:
                raise ValueError(f"Unknown kernel type {k}")
        if self.kernel_size % 2 != 1:
            # the centred mesh grid and the padding assume odd sizes
            raise ValueError(f"kernel_size must be odd, got {self.kernel_size}")


@dataclasses.dataclass
class KernelDraws:
    """The random draws behind a batch of kernels, each (B,) on one device:
    ``family`` indexes ``cfg.kernel_range``; ``noise`` is (B, k, k) or None."""
    family: torch.Tensor
    sigma_x: torch.Tensor
    sigma_y: torch.Tensor
    rotation: torch.Tensor
    beta_g: torch.Tensor
    beta_p: torch.Tensor
    omega_c: torch.Tensor
    noise: Optional[torch.Tensor] = None


def _axis(kernel_size: int, device) -> torch.Tensor:
    # centred at 0: -(k // 2) .. k // 2
    return torch.arange(kernel_size, dtype=torch.float32, device=device) \
        - float(kernel_size // 2)


def _mesh_grid(kernel_size: int, device):
    ax = _axis(kernel_size, device)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    return xx, yy


def _quadratic_form(xx, yy, sig_x, sig_y, theta):
    """q = [x y] Sigma^-1 [x y]^T for Sigma = R diag(sx^2, sy^2) R^T,
    batched over the leading axis of sig_x / sig_y / theta."""
    c, s = torch.cos(theta), torch.sin(theta)
    inv_sx2 = 1.0 / (sig_x ** 2)
    inv_sy2 = 1.0 / (sig_y ** 2)
    a = c * c * inv_sx2 + s * s * inv_sy2
    b = c * s * (inv_sx2 - inv_sy2)
    d = s * s * inv_sx2 + c * c * inv_sy2
    a, b, d = a[:, None, None], b[:, None, None], d[:, None, None]
    return a * xx * xx + 2 * b * xx * yy + d * yy * yy


def _normalize(k):
    return k / k.sum(dim=(-2, -1), keepdim=True)


def gaussian_kernels(kernel_size, sig_x, sig_y, theta):
    xx, yy = _mesh_grid(kernel_size, sig_x.device)
    q = _quadratic_form(xx, yy, sig_x, sig_y, theta)
    return _normalize(torch.exp(-0.5 * q))


def generalized_gaussian_kernels(kernel_size, sig_x, sig_y, theta, beta):
    xx, yy = _mesh_grid(kernel_size, sig_x.device)
    q = _quadratic_form(xx, yy, sig_x, sig_y, theta)
    return _normalize(torch.exp(-0.5 * torch.pow(q, beta[:, None, None])))


def plateau_kernels(kernel_size, sig_x, sig_y, theta, beta):
    xx, yy = _mesh_grid(kernel_size, sig_x.device)
    q = _quadratic_form(xx, yy, sig_x, sig_y, theta)
    return _normalize(1.0 / (torch.pow(q, beta[:, None, None]) + 1.0))


def sinc_kernels(kernel_size, omega_c):
    """Circular lowpass: cutoff * J1(cutoff * r) / (2 pi r), the centre
    filled with cutoff^2 / (4 pi)."""
    xx, yy = _mesh_grid(kernel_size, omega_c.device)
    r = torch.sqrt(xx * xx + yy * yy)
    wc = omega_c[:, None, None]
    r_safe = torch.where(r == 0, torch.ones_like(r), r)
    k = wc * j1(wc * r_safe) / (2 * math.pi * r_safe)
    center = wc ** 2 / (4 * math.pi)
    k = torch.where(r[None] == 0, center, k)
    return _normalize(k)


def _uniform(generator, shape, rng_range):
    lo, hi = rng_range
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


@functools.lru_cache(maxsize=64)
def _family_tables(cfg: BlurKernelConfig, device: torch.device):
    """Cumulative family probabilities and metadata codes of ``cfg`` on
    ``device``, uploaded once (an upload in a step would wait for the host)."""
    names = cfg.kernel_range
    probs = np.asarray(cfg.kernel_probabilities if cfg.kernel_probabilities
                       is not None else [1.0 / len(names)] * len(names), np.float64)
    cum = np.cumsum(probs / probs.sum()).astype(np.float32)
    codes = np.asarray([blur_kernel_codes[n] for n in names], np.float32)
    return torch.as_tensor(cum, device=device), torch.as_tensor(codes, device=device)


def draw_kernel_params(generator: torch.Generator, batch: int,
                       cfg: BlurKernelConfig) -> KernelDraws:
    """The draws of :func:`sample_kernels`, on the generator's device."""
    cum, _ = _family_tables(cfg, generator.device)
    u = torch.rand(batch, generator=generator, device=generator.device)
    family = torch.searchsorted(cum, cum[-1] * (1.0 - u)).clamp_(max=len(cum) - 1)

    def beta(rng_range):
        lo = _uniform(generator, batch, (rng_range[0], 1.0))
        hi = _uniform(generator, batch, (1.0, rng_range[1]))
        below = torch.rand(batch, generator=generator, device=generator.device) < 0.5
        return torch.where(below, lo, hi)

    ks = cfg.kernel_size
    return KernelDraws(
        family=family,
        sigma_x=_uniform(generator, batch, cfg.sigma_x_range),
        sigma_y=_uniform(generator, batch, cfg.sigma_y_range),
        rotation=_uniform(generator, batch, cfg.rotation_range),
        beta_g=beta(cfg.betag_range),
        beta_p=beta(cfg.betap_range),
        omega_c=_uniform(generator, batch, cfg.omega_c_range),
        noise=(None if cfg.noise_range is None
               else _uniform(generator, (batch, ks, ks), cfg.noise_range)))


def kernels_from_draws(cfg: BlurKernelConfig, d: KernelDraws
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Kernels (B, k, k) and metadata {sigma_x, sigma_y, rotation, beta_g,
    beta_p, omega_c, kernel_type, kernel_size}, each (B,), from ``d``."""
    names = cfg.kernel_range
    ks = cfg.kernel_size
    batch = d.family.shape[0]
    zeros = torch.zeros_like(d.rotation)
    family_kernels = []
    for name in names:
        sy = d.sigma_x if name in _ISO else d.sigma_y
        th = zeros if name in _ISO else d.rotation
        if name in ("iso", "aniso"):
            k = gaussian_kernels(ks, d.sigma_x, sy, th)
        elif name in ("generalized_iso", "generalized_aniso"):
            k = generalized_gaussian_kernels(ks, d.sigma_x, sy, th, d.beta_g)
        elif name in ("plateau_iso", "plateau_aniso"):
            k = plateau_kernels(ks, d.sigma_x, sy, th, d.beta_p)
        else:  # sinc
            k = sinc_kernels(ks, d.omega_c)
        family_kernels.append(k)
    stacked = torch.stack(family_kernels)  # (F, B, k, k)
    kernels = torch.take_along_dim(stacked, d.family.view(1, -1, 1, 1), dim=0)[0]

    def fam_mask(wanted):
        m = torch.zeros(batch, dtype=torch.bool, device=d.family.device)
        for i, n in enumerate(names):
            if n in wanted:
                m = m | (d.family == i)
        return m

    if d.noise is not None:
        # multiplicative noise and renormalisation; sinc kernels never get it
        noisy = _normalize(kernels * d.noise)
        kernels = torch.where(fam_mask(("sinc",)).view(-1, 1, 1), kernels, noisy)

    gaussian_like = fam_mask([n for n in names if n != "sinc"])
    aniso_like = fam_mask(_ANISO)
    _, codes = _family_tables(cfg, d.family.device)
    metadata = {
        "sigma_x": torch.where(gaussian_like, d.sigma_x, zeros),
        "sigma_y": torch.where(gaussian_like,
                               torch.where(aniso_like, d.sigma_y, d.sigma_x), zeros),
        "rotation": torch.where(aniso_like, d.rotation, zeros),
        "beta_g": torch.where(fam_mask(("generalized_iso", "generalized_aniso")),
                              d.beta_g, zeros),
        "beta_p": torch.where(fam_mask(("plateau_iso", "plateau_aniso")), d.beta_p, zeros),
        "omega_c": torch.where(fam_mask(("sinc",)), d.omega_c, zeros),
        "kernel_type": codes[d.family],
        "kernel_size": torch.full_like(zeros, float(ks)),
    }
    return kernels, metadata


def sample_kernels(generator: torch.Generator, batch: int, cfg: BlurKernelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """A batch of blur kernels (B, k, k) and their metadata, drawn from
    ``generator`` on its device."""
    return kernels_from_draws(cfg, draw_kernel_params(generator, batch, cfg))


@dataclasses.dataclass
class SRMDDraws:
    """The draws behind a batch of SRMD/IKC Gaussian kernels, each (B,):
    ``is_iso`` (bool), the isotropic ``sigma``, and the anisotropic
    ``rotation``, ``sigma_x`` and ``u_y`` (U(0, 1), scaled into sigma_y)."""
    is_iso: torch.Tensor
    sigma: torch.Tensor
    rotation: torch.Tensor
    sigma_x: torch.Tensor
    u_y: torch.Tensor


def draw_srmd_params(generator: torch.Generator, batch: int, sig_min: float = 0.2,
                     sig_max: float = 4.0, rate_iso: float = 1.0) -> SRMDDraws:
    """The draws of :func:`sample_srmd_kernels` with ``random``."""
    dev = generator.device
    return SRMDDraws(
        is_iso=torch.rand(batch, generator=generator, device=dev) < rate_iso,
        sigma=_uniform(generator, batch, (sig_min, sig_max)),
        rotation=_uniform(generator, batch, (-math.pi, math.pi)),
        sigma_x=_uniform(generator, batch, (sig_min, sig_max)),
        u_y=torch.rand(batch, generator=generator, device=dev))


def srmd_kernels_from_draws(kernel_size: int, d: SRMDDraws, sig_min: float = 0.2,
                            sig_max: float = 4.0, scaling: float = 3.0
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Kernels (B, k, k) and metadata {isotropic_sigma, anisotropic_x,
    anisotropic_y, anisotropic_pi} from ``d``: isotropic sigma, or an
    anisotropic Gaussian with sigma_y = clip(u_y * scaling * sigma_x,
    sig_min, sig_max) at the drawn rotation; a field reads 0 unless the
    example's kind uses it."""
    sig_y = torch.clamp(d.u_y * scaling * d.sigma_x, sig_min, sig_max)
    zeros = torch.zeros_like(d.sigma)
    sx = torch.where(d.is_iso, d.sigma, d.sigma_x)
    sy = torch.where(d.is_iso, d.sigma, sig_y)
    th = torch.where(d.is_iso, zeros, d.rotation)
    kernels = gaussian_kernels(kernel_size, sx, sy, th)
    return kernels, {
        "isotropic_sigma": torch.where(d.is_iso, d.sigma, zeros),
        "anisotropic_x": torch.where(d.is_iso, zeros, d.sigma_x),
        "anisotropic_y": torch.where(d.is_iso, zeros, sig_y),
        "anisotropic_pi": torch.where(d.is_iso, zeros, d.rotation),
    }


def sample_srmd_kernels(generator: torch.Generator, batch: int, kernel_size: int = 21,
                        sig: float = 2.6, sig_min: float = 0.2, sig_max: float = 4.0,
                        rate_iso: float = 1.0, scaling: float = 3.0, random: bool = True
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SRMD/IKC Gaussian kernels on the generator's device: isotropic with
    probability ``rate_iso`` and sigma ~ U(sig_min, sig_max), else
    anisotropic (rotation ~ U(-pi, pi), sigma_x ~ U(sig_min, sig_max),
    sigma_y as :func:`srmd_kernels_from_draws` says). Without ``random``
    every kernel is isotropic at ``sig``."""
    if not random:
        sigma = torch.full((batch,), float(sig), device=generator.device)
        zeros = torch.zeros_like(sigma)
        return gaussian_kernels(kernel_size, sigma, sigma, zeros), {
            "isotropic_sigma": sigma, "anisotropic_x": zeros,
            "anisotropic_y": zeros, "anisotropic_pi": zeros}
    return srmd_kernels_from_draws(
        kernel_size, draw_srmd_params(generator, batch, sig_min, sig_max, rate_iso),
        sig_min, sig_max, scaling)
