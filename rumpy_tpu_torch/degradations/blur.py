"""Blur degradation ops.

Port of ``rumpy_tpu/degradations/blur.py``: ``RealESRGANBlur``'s device
path, with random or fixed-parameter kernels, kernel metadata (sigmas
normalized by their ranges, sinc rows at 0) and full kernels on request.
Kernel math in ``ops/blur_kernels.py``, application in ``ops/blur.py``.
PCA-encoded kernels, ``SRMDGaussianBlur`` and ``BSRGANBlur`` come with
``degradations/pca.py`` and raise until then.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from rumpy_tpu_torch.config.constants import blur_kernel_codes
from rumpy_tpu_torch.degradations.base import DegradationOp, normalize, per_view
from rumpy_tpu_torch.ops import blur as blur_ops
from rumpy_tpu_torch.ops import blur_kernels as bk
from rumpy_tpu_torch.registry import register_tool


def pca_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with degradations/pca.py in the "
        "iterative blind-SR slice (SRMD, IKC, DAN)")


@register_tool("realesrganblur")
class RealESRGANBlur(DegradationOp):
    """Seven-family Real-ESRGAN blur."""

    def __init__(self, kernel_range=("iso",), kernel_probabilities=None,
                 semi_random_selection=False, sigma_x_range=(0.6, 5),
                 sigma_y_range=(0.6, 5),
                 rotation_range=(-math.pi, math.pi), betag_range=(0.5, 8),
                 betap_range=(0.5, 8), noise_range=None,
                 random_selection=True, selected_kernel=None,
                 use_kernel_code=True, seed=0, kernel_size=21,
                 request_full_kernels=False, normalize_metadata=True,
                 request_pca_kernels=False, request_kernel_metadata=False,
                 **kwargs):
        if random_selection and semi_random_selection:
            raise RuntimeError("Both random and semi random modes cannot be "
                               "on simultaneously.")
        if not random_selection and selected_kernel is None:
            raise RuntimeError("Need to specify requested kernel if not "
                               "using random selection.")
        if request_pca_kernels:
            raise pca_slice("request_pca_kernels")
        self.random_selection = random_selection
        self.selected_kernel = selected_kernel
        self.specific_params = {k: v for k, v in kwargs.items()
                                if k in ("sigma_x", "sigma_y", "rotation",
                                         "beta_g", "beta_p", "omega_c")}
        kr = tuple(kernel_range) if kernel_range != "all" else bk.ALL_KERNEL_TYPES
        if not random_selection:
            kr = (selected_kernel,)
        self.cfg = bk.BlurKernelConfig(
            kernel_size=kernel_size, kernel_range=kr,
            kernel_probabilities=tuple(kernel_probabilities)
            if kernel_probabilities else None,
            sigma_x_range=tuple(sigma_x_range),
            sigma_y_range=tuple(sigma_y_range),
            rotation_range=tuple(rotation_range),
            betag_range=tuple(betag_range), betap_range=tuple(betap_range),
            noise_range=tuple(noise_range) if noise_range else None)
        self.request_full_kernels = request_full_kernels
        self.normalize_metadata = normalize_metadata
        self.request_kernel_metadata = request_kernel_metadata

    def get_hyperparams(self) -> Dict[str, Any]:
        return {"blur_type": "real_esrgan",
                "kernel_size": self.cfg.kernel_size,
                "kernel_type_range": list(self.cfg.kernel_range),
                "kernel_probabilities": self.cfg.kernel_probabilities,
                "sigma_x_range": list(self.cfg.sigma_x_range),
                "sigma_y_range": list(self.cfg.sigma_y_range),
                "rotation_range": list(self.cfg.rotation_range),
                "beta_g_range": list(self.cfg.betag_range),
                "beta_p_range": list(self.cfg.betap_range),
                "noise_range": self.cfg.noise_range}

    def _fixed_kernels(self, b: int, device):
        """The selected family at the fixed parameters, for every example."""
        p = self.specific_params
        ks = self.cfg.kernel_size

        def full(v):
            return torch.full((b,), float(v), device=device)

        sx = full(p.get("sigma_x", 1.0))
        sy = full(p.get("sigma_y", p.get("sigma_x", 1.0)))
        th = full(p.get("rotation", 0.0))
        name = self.selected_kernel
        if name in ("iso", "aniso"):
            kernels = bk.gaussian_kernels(ks, sx, sy, th)
        elif name in ("generalized_iso", "generalized_aniso"):
            kernels = bk.generalized_gaussian_kernels(ks, sx, sy, th,
                                                      full(p.get("beta_g", 1.0)))
        elif name in ("plateau_iso", "plateau_aniso"):
            kernels = bk.plateau_kernels(ks, sx, sy, th, full(p.get("beta_p", 1.0)))
        elif name == "sinc":
            kernels = bk.sinc_kernels(ks, full(p.get("omega_c", math.pi / 2)))
        else:
            raise RuntimeError(f"Blur type {name} not recognized")
        meta = {"sigma_x": sx, "sigma_y": sy, "rotation": th,
                "beta_g": full(p.get("beta_g", 0.0)),
                "beta_p": full(p.get("beta_p", 0.0)),
                "omega_c": full(p.get("omega_c", 0.0)),
                "kernel_type": full(blur_kernel_codes[name]),
                "kernel_size": full(ks)}
        return kernels, meta

    def batch_apply(self, generator, imgs, views: int = 1):
        b = imgs.shape[0] // views
        if self.random_selection or not self.specific_params:
            kernels, meta = bk.sample_kernels(generator, b, self.cfg)
        else:
            kernels, meta = self._fixed_kernels(b, imgs.device)
        out = blur_ops.apply_kernels(imgs, per_view(kernels, views))
        meta_out: Dict[str, torch.Tensor] = {}
        if self.request_kernel_metadata:
            meta_out = dict(meta)
            if self.normalize_metadata:
                # sinc rows carry masked-zero sigmas: normalizing the
                # placeholder would turn 0 into (0 - lo) / (hi - lo) < 0
                applies = meta["kernel_type"] != float(blur_kernel_codes["sinc"])
                zeros = torch.zeros_like(meta["sigma_x"])
                meta_out["sigma_x"] = torch.where(
                    applies, normalize(meta["sigma_x"], *self.cfg.sigma_x_range), zeros)
                meta_out["sigma_y"] = torch.where(
                    applies, normalize(meta["sigma_y"], *self.cfg.sigma_y_range), zeros)
        if self.request_full_kernels:
            meta_out["unmodified_blur_kernel"] = kernels.reshape(b, -1)
        return out, meta_out


@register_tool("srmdgaussianblur")
class SRMDGaussianBlur(DegradationOp):
    """SRMD/IKC Gaussian blur: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise pca_slice(type(self).__name__)


@register_tool("bsrganblur")
class BSRGANBlur(SRMDGaussianBlur):
    """BSRGAN-style Gaussian blur: not ported yet."""
