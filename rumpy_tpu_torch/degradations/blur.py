"""Blur degradation ops.

Port of ``rumpy_tpu/degradations/blur.py``, device paths:
``RealESRGANBlur`` with random or fixed-parameter kernels, kernel
metadata (sigmas normalized by their ranges, sinc rows at 0);
``SRMDGaussianBlur`` (SRMD/IKC iso/aniso Gaussians) and ``BSRGANBlur``
(the same family with BSRGAN's wider defaults). Each gives full kernels
(``unmodified_blur_kernel``) and PCA-encoded ones (``blur_kernel``,
``degradations/pca.py``: a packaged or given matrix, or one fit at
construction to ``pca_batch_len`` kernels of the op's own family) on
request. Kernel math in ``ops/blur_kernels.py``, application in
``ops/blur.py``.

The host path (``__call__`` on one image) runs the device path on a batch
of one on the host device, drawing from the op's own generator there
(seeded with ``seed``); ``draws`` (``KernelDraws`` / ``SRMDDraws``) gives
it the draws instead. It returns the image as uint8 (or PIL) and the
metadata as floats and lists, and ``save_pca_matrix`` writes the PCA basis
beside the outputs.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

import torch

from rumpy_tpu_torch.config.constants import blur_kernel_codes
from rumpy_tpu_torch.degradations import pca as pca_mod
from rumpy_tpu_torch.degradations.base import (DegradationOp, from_float_array,
                                               host_metadata, normalize, per_view)
from rumpy_tpu_torch.ops import blur as blur_ops
from rumpy_tpu_torch.ops import blur_kernels as bk
from rumpy_tpu_torch.parallel.mesh import take_rows
from rumpy_tpu_torch.registry import register_tool


class _BlurBase(DegradationOp):
    """Full-kernel and PCA-kernel metadata shared by the blur ops."""

    def __init__(self, kernel_size=21, request_full_kernels=False,
                 normalize_metadata=True, request_pca_kernels=False,
                 load_pca_matrix=None, pca_batch_len=30000, pca_length=10,
                 request_kernel_metadata=False, pca_seed=0):
        self.kernel_size = kernel_size
        self.request_full_kernels = request_full_kernels
        self.normalize_metadata = normalize_metadata
        self.request_kernel_metadata = request_kernel_metadata
        self.pca_encoder: Optional[pca_mod.PCAEncoder] = None
        if request_pca_kernels:
            if load_pca_matrix:
                self.pca_encoder = pca_mod.read_pca_matrix(load_pca_matrix)
            else:
                self.pca_encoder = pca_mod.fit_kernel_pca(
                    self._pca_sample_fn(), batch_len=pca_batch_len, k=pca_length,
                    seed=pca_seed)

    def _pca_sample_fn(self):
        """``(generator, n) -> (n, k, k)`` kernels of this op's family."""
        raise NotImplementedError

    def save_pca_matrix(self, location: str) -> None:
        if self.pca_encoder is not None:
            self.pca_encoder.save(os.path.join(location,
                                               f"{type(self).__name__}_pca_matrix.npz"))

    def _draw(self, generator, b: int):
        """The draws of a batch of ``b`` kernels, or None where the kernels
        take none."""
        raise NotImplementedError

    def _kernels(self, draws, b: int, device):
        """(kernels (B, k, k), kernel metadata) from ``draws``."""
        raise NotImplementedError

    def _apply(self, imgs, kernels, meta, views: int = 1):
        raise NotImplementedError

    def batch_apply(self, generator, imgs, views: int = 1, rows=None):
        b = imgs.shape[0] // views
        draws = take_rows(self._draw(generator, b if rows is None else rows.total), rows)
        kernels, meta = self._kernels(draws, b, imgs.device)
        return self._apply(imgs, kernels, meta, views)

    def __call__(self, image, draws=None):
        imgs, was_pil = self._host_batch(image)
        if draws is None:
            draws = self._draw(self._host_generator(), 1)
        kernels, meta = self._kernels(draws, 1, imgs.device)
        out, meta_out = self._apply(imgs, kernels, meta)
        return from_float_array(out[0].cpu().numpy(), was_pil), host_metadata(meta_out)

    def _kernel_extras(self, kernels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full-kernel and PCA-kernel metadata of a (B, k, k) batch."""
        out: Dict[str, torch.Tensor] = {}
        flat = kernels.reshape(kernels.shape[0], -1)
        if self.request_full_kernels:
            out["unmodified_blur_kernel"] = flat
        if self.pca_encoder is not None:
            out["blur_kernel"] = self.pca_encoder(flat)
        return out


_BASE_OPTIONS = ("request_full_kernels", "normalize_metadata", "request_pca_kernels",
                 "load_pca_matrix", "pca_batch_len", "pca_length",
                 "request_kernel_metadata", "pca_seed")


@register_tool("realesrganblur")
class RealESRGANBlur(_BlurBase):
    """Seven-family Real-ESRGAN blur."""

    def __init__(self, kernel_range=("iso",), kernel_probabilities=None,
                 semi_random_selection=False, sigma_x_range=(0.6, 5),
                 sigma_y_range=(0.6, 5),
                 rotation_range=(-math.pi, math.pi), betag_range=(0.5, 8),
                 betap_range=(0.5, 8), noise_range=None,
                 random_selection=True, selected_kernel=None,
                 use_kernel_code=True, seed=0, kernel_size=21, **kwargs):
        if random_selection and semi_random_selection:
            raise RuntimeError("Both random and semi random modes cannot be "
                               "on simultaneously.")
        if not random_selection and selected_kernel is None:
            raise RuntimeError("Need to specify requested kernel if not "
                               "using random selection.")
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
        self.seed = seed
        super().__init__(kernel_size=kernel_size,
                         **{k: v for k, v in kwargs.items() if k in _BASE_OPTIONS})

    def _pca_sample_fn(self):
        return lambda gen, n: bk.sample_kernels(gen, n, self.cfg)[0]

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

    def _fixed(self) -> bool:
        return not self.random_selection and bool(self.specific_params)

    def _draw(self, generator, b: int):
        return None if self._fixed() else bk.draw_kernel_params(generator, b, self.cfg)

    def _kernels(self, draws, b: int, device):
        if self._fixed():
            return self._fixed_kernels(b, device)
        return bk.kernels_from_draws(self.cfg, draws)

    def _apply(self, imgs, kernels, meta, views: int = 1):
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
        meta_out.update(self._kernel_extras(kernels))
        return out, meta_out


@register_tool("srmdgaussianblur")
class SRMDGaussianBlur(_BlurBase):
    """SRMD/IKC iso/aniso Gaussian blur (``ops/blur_kernels.py``'s
    ``sample_srmd_kernels``). Its kernel metadata: ``isotropic_sigma``
    alone when every kernel is isotropic, else the anisotropic fields
    too; the sigmas are not normalized."""

    def __init__(self, random=False, sig=2.6, sig_min=0.2, sig_max=4.0,
                 rate_iso=1.0, scaling=3, seed=0, kernel_size=21, **kwargs):
        self.random = random
        self.sig = sig
        self.sig_min = sig_min
        self.sig_max = sig_max
        self.rate_iso = rate_iso
        self.scaling = scaling
        self.seed = seed
        super().__init__(kernel_size=kernel_size,
                         **{k: v for k, v in kwargs.items() if k in _BASE_OPTIONS})

    def _sample(self, generator, n: int, random: bool):
        return bk.sample_srmd_kernels(generator, n, self.kernel_size, self.sig,
                                      self.sig_min, self.sig_max, self.rate_iso,
                                      self.scaling, random=random)

    def _pca_sample_fn(self):
        return lambda gen, n: self._sample(gen, n, random=True)[0]

    def get_hyperparams(self) -> Dict[str, Any]:
        sig_params = ({"random": "True", "max_sigma": self.sig_max,
                       "min_sigma": self.sig_min} if self.random
                      else {"random": "False", "sigma": self.sig})
        return {**sig_params, "blur_type": "srmd", "kernel_size": self.kernel_size,
                "isotropic_probability": self.rate_iso,
                "anisotropic_scaling": self.scaling}

    def _draw(self, generator, b: int):
        if not self.random:
            return None
        return bk.draw_srmd_params(generator, b, self.sig_min, self.sig_max, self.rate_iso)

    def _kernels(self, draws, b: int, device):
        if draws is None:  # every kernel isotropic at sig: nothing drawn
            return self._sample(torch.Generator(device), b, random=False)
        return bk.srmd_kernels_from_draws(self.kernel_size, draws, self.sig_min,
                                          self.sig_max, self.scaling)

    def _apply(self, imgs, kernels, meta, views: int = 1):
        out = blur_ops.apply_kernels(imgs, per_view(kernels, views))
        meta_out: Dict[str, torch.Tensor] = {}
        if self.request_kernel_metadata:
            meta_out = ({"isotropic_sigma": meta["isotropic_sigma"]}
                        if self.rate_iso == 1.0 else dict(meta))
        meta_out.update(self._kernel_extras(kernels))
        return out, meta_out


@register_tool("bsrganblur")
class BSRGANBlur(SRMDGaussianBlur):
    """BSRGAN-style Gaussian blur: the iso/aniso Gaussian family with
    BSRGAN's wider defaults."""

    def __init__(self, random=True, sig_min=0.2, sig_max=4.0, rate_iso=0.5,
                 scaling=3, **kwargs):
        super().__init__(random=random, sig_min=sig_min, sig_max=sig_max,
                         rate_iso=rate_iso, scaling=scaling, **kwargs)

    def get_hyperparams(self) -> Dict[str, Any]:
        p = super().get_hyperparams()
        p["blur_type"] = "bsrgan"
        return p
