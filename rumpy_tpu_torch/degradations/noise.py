"""Noise degradation op (Real-ESRGAN Gaussian / Poisson, gray / colour).

Port of ``rumpy_tpu/degradations/noise.py``, device path. Metadata
columns gaussian_noise_scale / poisson_noise_scale / gray_noise,
normalized by their configured ranges when requested.

``request_noise_image_pca`` builds ``pca_encoder`` at construction: a
given matrix, or a basis fit to ``pca_batch_len`` generated noise fields
(half Gaussian, half Poisson on a blank image, which is zero, as in the
JAX package), each ``pca_patch_size`` square. As in the JAX package the
device path gives no ``pca_noise`` column: the encoding is the host
path's.

The host path (``__call__`` on one image) runs the device path on a batch
of one on the host device, drawing from the op's own generator there
(seeded with ``seed``), or taking ``draws`` (:class:`NoiseDraws`) instead;
with a PCA encoder it adds ``pca_noise``, the scaled noise field
centre-cropped (zero-padded where smaller) to ``pca_patch_size`` and
encoded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from rumpy_tpu_torch.degradations import pca as pca_mod
from rumpy_tpu_torch.degradations.base import (DegradationOp, from_float_array,
                                               host_metadata, normalize, per_view)
from rumpy_tpu_torch.ops import noise as noise_ops
from rumpy_tpu_torch.registry import register_tool


@dataclasses.dataclass
class NoiseDraws:
    """The draws behind one noise call, each (B,) unless stated: the type
    (``use_gauss``, bool); the Gaussian path's ``sigma``, gray flag and unit
    field (B, H, W, C); the Poisson path's ``scale``, gray flag and samples
    (``sample_c`` (B, H, W, C) and ``sample_g`` (B, H, W, 1), at the rates
    of ``ops/noise.py::poisson_rates``)."""
    use_gauss: torch.Tensor
    sigma: torch.Tensor
    gaussian_gray: torch.Tensor
    field: torch.Tensor
    scale: torch.Tensor
    poisson_gray: torch.Tensor
    sample_c: torch.Tensor
    sample_g: torch.Tensor


@register_tool("realesrgannoise")
class RealESRGANNoise(DegradationOp):
    def __init__(self, normalize_metadata=True, gaussian_poisson_ratio=0.5,
                 poisson_noise_scale_range=(0, 1.0),
                 gaussian_noise_sigma_range=(0, 1.0),
                 gray_noise_probability=0.4,
                 random_noise_generation=True, seed=0,
                 request_noise_image_pca=False,
                 noise_image_pca_length=100,
                 pca_patch_size=64,
                 pca_batch_len=500,
                 load_pca_matrix=None,
                 **specific_noise_params):
        self.normalize_metadata = normalize_metadata
        self.gaussian_poisson_ratio = gaussian_poisson_ratio
        self.poisson_noise_scale_range = tuple(poisson_noise_scale_range)
        self.gaussian_noise_sigma_range = tuple(gaussian_noise_sigma_range)
        self.gray_noise_probability = gray_noise_probability
        self.random_noise = random_noise_generation
        self.seed = seed
        self.specific = specific_noise_params
        self.request_noise_image_pca = request_noise_image_pca
        self.pca_patch_size = pca_patch_size
        self.pca_encoder = None
        if request_noise_image_pca:
            if load_pca_matrix:
                self.pca_encoder = pca_mod.read_pca_matrix(load_pca_matrix)
            else:
                self.pca_encoder = pca_mod.pca_from_samples(
                    self.noise_samples(torch.Generator().manual_seed(seed), pca_batch_len),
                    k=noise_image_pca_length)

    def noise_samples(self, generator: torch.Generator, count: int) -> torch.Tensor:
        """2 * (count // 2) noise fields (pca_patch_size square, RGB) on the
        generator's device: Gaussian, then Poisson on a blank image."""
        s = self.pca_patch_size
        blank = torch.zeros((count // 2, s, s, 3), device=generator.device)
        _, _, n_gauss = noise_ops.add_gaussian_noise(
            generator, blank, self.gaussian_noise_sigma_range,
            self.gray_noise_probability, return_noise=True)
        _, _, n_poiss = noise_ops.add_poisson_noise(
            generator, blank, self.poisson_noise_scale_range,
            self.gray_noise_probability, return_noise=True)
        return torch.cat([n_gauss, n_poiss])

    def get_hyperparams(self) -> Dict[str, Any]:
        return {"gaussian_poisson_ratio": self.gaussian_poisson_ratio,
                "poisson_noise_scale_range": list(self.poisson_noise_scale_range),
                "gaussian_noise_sigma_range": list(self.gaussian_noise_sigma_range),
                "gray_noise_probability": self.gray_noise_probability}

    def batch_apply(self, generator, imgs, views: int = 1):
        out, meta, _ = self._batch_apply_noise(generator, imgs, views)
        return out, meta

    def _batch_apply_noise(self, generator, imgs, views: int = 1,
                           draws: Optional[NoiseDraws] = None):
        b = imgs.shape[0] // views
        dev = imgs.device
        gauss_range = self.gaussian_noise_sigma_range
        poisson_range = self.poisson_noise_scale_range
        gray_p = self.gray_noise_probability
        both = self.random_noise
        if not self.random_noise:
            # value-based selection: the type whose scale is > 0; when both
            # are positive the type is drawn from gaussian_poisson_ratio
            gs = float(self.specific.get("gaussian_noise_scale") or 0.0)
            ps = float(self.specific.get("poisson_noise_scale") or 0.0)
            both = gs > 0 and ps > 0
            gauss_range, poisson_range = (gs, gs), (ps, ps)
            gray = self.specific.get("gray_noise")
            if gray is None:
                # the reference's quirk, kept: gray noise with probability
                # 1 - p here (inverted against the random path)
                gray_p = 1.0 - self.gray_noise_probability
            else:
                if float(gray) not in (0.0, 1.0):
                    raise RuntimeError("gray noise must be 1 or 0, not in between.")
                gray_p = float(gray)
        if draws is not None:
            use_gauss = draws.use_gauss
        elif both:
            use_gauss = torch.rand(b, generator=generator, device=dev) \
                < self.gaussian_poisson_ratio
        else:
            use_gauss = torch.full((b,), gs > 0, dtype=torch.bool, device=dev)
        if draws is None:
            g_out, g_meta, g_noise = noise_ops.add_gaussian_noise(
                generator, imgs, gauss_range, gray_p, return_noise=True, views=views)
            p_out, p_meta, p_noise = noise_ops.add_poisson_noise(
                generator, imgs, poisson_range, gray_p, return_noise=True, views=views)
        else:
            g_out, g_meta, g_noise = noise_ops.apply_gaussian_noise(
                imgs, draws.sigma, draws.gaussian_gray, draws.field)
            p_out, p_meta, p_noise = noise_ops.apply_poisson_noise(
                imgs, draws.scale, draws.poisson_gray, draws.sample_c, draws.sample_g,
                noise_ops.poisson_rates(imgs))
        sel = per_view(use_gauss, views)[:, None, None, None]
        out = torch.where(sel, g_out, p_out)
        noise = torch.where(sel, g_noise, p_noise)
        zeros = torch.zeros(b, device=dev)
        g_scale, p_scale = g_meta["gaussian_noise_scale"], p_meta["poisson_noise_scale"]
        if self.normalize_metadata:
            lo_g, hi_g = self.gaussian_noise_sigma_range
            lo_p, hi_p = self.poisson_noise_scale_range
            if hi_g > lo_g:
                g_scale = normalize(g_scale, lo_g, hi_g)
            if hi_p > lo_p:
                p_scale = normalize(p_scale, lo_p, hi_p)
        meta = {
            "gaussian_noise_scale": torch.where(use_gauss, g_scale, zeros),
            "poisson_noise_scale": torch.where(use_gauss, zeros, p_scale),
            "gray_noise": torch.where(use_gauss, g_meta["gray_noise"], p_meta["gray_noise"]),
        }
        return out, meta, noise

    def _center_crop_noise(self, noise: torch.Tensor) -> torch.Tensor:
        """torchvision's CenterCrop(pca_patch_size) of a (B, H, W, C) field,
        zero-padded first where a side is smaller."""
        h, w = noise.shape[1:3]
        s = self.pca_patch_size
        if h < s or w < s:
            ph, pw = max(0, s - h), max(0, s - w)
            noise = F.pad(noise, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            h, w = noise.shape[1:3]
        top, left = (h - s) // 2, (w - s) // 2
        return noise[:, top:top + s, left:left + s, :]

    def __call__(self, image, draws: Optional[NoiseDraws] = None):
        imgs, was_pil = self._host_batch(image)
        gen = self._host_generator() if draws is None else None
        out, meta, noise = self._batch_apply_noise(gen, imgs, draws=draws)
        host_meta = host_metadata(meta)
        if self.pca_encoder is not None:
            enc = self.pca_encoder(self._center_crop_noise(noise).reshape(1, -1))
            host_meta["pca_noise"] = enc[0].cpu().numpy().tolist()
        return from_float_array(out[0].cpu().numpy(), was_pil), host_meta
