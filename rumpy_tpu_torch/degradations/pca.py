"""PCA encoding of blur kernels (and noise fields).

Port of ``rumpy_tpu/degradations/pca.py``. A basis is the first k rows of
V^T from the SVD of the *uncentred* (N, D) samples, the reference's
convention; encoding is one (B, D) x (D, k) product in full float32
whatever the TF32 flags. The packaged matrices (``standard``: 441 -> 10,
``extended``: 441 -> 100, converted from the reference's shipped ``.pth``
files) are the JAX package's ``rumpy_tpu/config/*_pca_matrix.npz``, read
as data; a reference-format ``.pth`` (D, k) matrix loads transposed.

:func:`fit_kernel_pca` draws its kernels with a ``torch.Generator``, which
cannot reproduce ``jax.random`` streams; :func:`pca_from_samples` takes the
samples, so the tests hand both packages the same kernels.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch

from rumpy_tpu_torch.utils.losses import full_f32_matmuls

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "rumpy_tpu", "config")

_PACKAGED = {
    "standard": "standard_blur_10_component_pca_matrix.npz",
    "extended": "extended_blur_100_component_pca_matrix.npz",
}


def fit_pca(samples: torch.Tensor, k: int = 10) -> torch.Tensor:
    """The (k, D) projection of (N, D) samples: V^T's first k rows from the
    SVD of the uncentred data, in float32."""
    x = torch.as_tensor(samples, dtype=torch.float32)
    _, _, vt = torch.linalg.svd(x, full_matrices=False)
    return vt[:k]


class PCAEncoder:
    """Project flattened (B, D) samples onto a fixed (k, D) basis."""

    def __init__(self, matrix):
        self.matrix = torch.as_tensor(np.asarray(matrix, np.float32))
        self._on: Dict[torch.device, torch.Tensor] = {}

    @property
    def components(self) -> int:
        return self.matrix.shape[0]

    def __call__(self, flat: torch.Tensor) -> torch.Tensor:
        m = self._on.get(flat.device)
        if m is None:  # uploaded once a device, not every step
            m = self._on[flat.device] = self.matrix.to(flat.device)
        with full_f32_matmuls():
            return flat.float() @ m.t()

    @staticmethod
    def load(path: str) -> "PCAEncoder":
        if path.endswith(".pth"):
            # the reference stores (D, k) and encodes flat @ matrix
            mat = torch.load(path, map_location="cpu").float().numpy()
            return PCAEncoder(mat.T)
        with np.load(path) as data:
            return PCAEncoder(data["matrix"])


def read_pca_matrix(name_or_path: str) -> PCAEncoder:
    """``standard`` / ``extended`` name the packaged matrices; anything else
    is a path."""
    if name_or_path in _PACKAGED:
        return PCAEncoder.load(os.path.join(CONFIG_DIR, _PACKAGED[name_or_path]))
    return PCAEncoder.load(name_or_path)


def pca_from_samples(samples: torch.Tensor, k: int = 10) -> PCAEncoder:
    """The encoder fit to (N, ...) samples, each flattened."""
    return PCAEncoder(fit_pca(samples.reshape(samples.shape[0], -1), k=k))


def fit_kernel_pca(sample_fn: Callable[[torch.Generator, int], torch.Tensor],
                   batch_len: int = 30000, k: int = 10, seed: int = 0,
                   chunk: int = 5000) -> PCAEncoder:
    """Fit a basis to ``batch_len`` kernels drawn in chunks on the CPU by
    ``sample_fn(generator, n) -> (n, ks, ks)`` from a generator seeded
    with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    chunks = []
    remaining = batch_len
    while remaining > 0:
        n = min(chunk, remaining)
        chunks.append(sample_fn(gen, n).reshape(n, -1))
        remaining -= n
    return pca_from_samples(torch.cat(chunks), k=k)
