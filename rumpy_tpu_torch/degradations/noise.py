"""Noise degradation op (Real-ESRGAN Gaussian / Poisson, gray / colour).

Port of ``rumpy_tpu/degradations/noise.py``, device path. Metadata
columns gaussian_noise_scale / poisson_noise_scale / gray_noise,
normalized by their configured ranges when requested. The noise-image PCA
option comes with ``degradations/pca.py`` and raises until then.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from rumpy_tpu_torch.degradations.base import DegradationOp, normalize, per_view
from rumpy_tpu_torch.degradations.blur import pca_slice
from rumpy_tpu_torch.ops import noise as noise_ops
from rumpy_tpu_torch.registry import register_tool


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
        if request_noise_image_pca:
            raise pca_slice("request_noise_image_pca")
        self.normalize_metadata = normalize_metadata
        self.gaussian_poisson_ratio = gaussian_poisson_ratio
        self.poisson_noise_scale_range = tuple(poisson_noise_scale_range)
        self.gaussian_noise_sigma_range = tuple(gaussian_noise_sigma_range)
        self.gray_noise_probability = gray_noise_probability
        self.random_noise = random_noise_generation
        self.specific = specific_noise_params

    def get_hyperparams(self) -> Dict[str, Any]:
        return {"gaussian_poisson_ratio": self.gaussian_poisson_ratio,
                "poisson_noise_scale_range": list(self.poisson_noise_scale_range),
                "gaussian_noise_sigma_range": list(self.gaussian_noise_sigma_range),
                "gray_noise_probability": self.gray_noise_probability}

    def batch_apply(self, generator, imgs, views: int = 1):
        out, meta, _ = self._batch_apply_noise(generator, imgs, views)
        return out, meta

    def _batch_apply_noise(self, generator, imgs, views: int = 1):
        b = imgs.shape[0] // views
        dev = generator.device
        gauss_range = self.gaussian_noise_sigma_range
        poisson_range = self.poisson_noise_scale_range
        gray_p = self.gray_noise_probability
        if self.random_noise:
            use_gauss = torch.rand(b, generator=generator, device=dev) \
                < self.gaussian_poisson_ratio
        else:
            # value-based selection: the type whose scale is > 0; when both
            # are positive the type is drawn from gaussian_poisson_ratio
            gs = float(self.specific.get("gaussian_noise_scale") or 0.0)
            ps = float(self.specific.get("poisson_noise_scale") or 0.0)
            if gs > 0 and ps > 0:
                use_gauss = torch.rand(b, generator=generator, device=dev) \
                    < self.gaussian_poisson_ratio
            else:
                use_gauss = torch.full((b,), gs > 0, dtype=torch.bool, device=dev)
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
        g_out, g_meta, g_noise = noise_ops.add_gaussian_noise(
            generator, imgs, gauss_range, gray_p, return_noise=True, views=views)
        p_out, p_meta, p_noise = noise_ops.add_poisson_noise(
            generator, imgs, poisson_range, gray_p, return_noise=True, views=views)
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
