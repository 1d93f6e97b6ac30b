"""Torch-semantics layers of the attribute-conditioned face GANs.

Port of two layers of ``rumpy_tpu/models/face_attribute_gans.py``, the ones
DIC and DSGAN import: ``PRelu`` (torch's ``nn.PReLU``) and
``TorchConvTranspose`` (torch's ``nn.ConvTranspose2d(k, s, p)``). The rest
of the module (FaceSR-Attributes-GAN, AGA-GAN, FMFNet with their STN,
``Conv2dSame`` and ``AttributeGANHandler``) is ROADMAP queue 1 item 9f.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class PRelu(nn.Module):
    """``where(x >= 0, x, a * x)`` with one shared slope (``num`` 1) or one a
    channel, ``init`` at init (torch's default 0.25; DIC's 0.2): the flax
    leaf ``prelu`` at the module's own path."""

    flax_leaves = {"weight": ("params", "prelu")}

    def __init__(self, num: int = 1, init: float = 0.25):
        super().__init__()
        self.init_value = init
        self.weight = nn.Parameter(torch.full((num,), init))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.fill_(self.init_value)

    def forward(self, x):
        a = self.weight.to(x.dtype)
        if a.shape[0] > 1:
            a = a[None, :, None, None]
        return torch.where(x >= 0, x, a * x)

    def flax_children(self):
        return []


class TorchConvTranspose(nn.Module):
    """torch's ``ConvTranspose2d(k, s, p)``: (H - 1) s - 2 p + k outputs. The
    JAX package stores the kernel as (k, k, out, in) and spells the
    transpose as an lhs-dilated conv with the kernel flipped; that is
    ``F.conv_transpose2d`` with the weight ``W[in, out, kh, kw] =
    kernel[kh, kw, out, in]``, unflipped (the weight bridge transposes it).
    Unlike ``common.ConvTranspose`` (flax's ``ConvTranspose``, whose kernel
    the bridge flips). Initialised as the JAX package's: U(+-1/sqrt(out k k))
    (flax's fan-in of a (k, k, out, in) kernel) and a zero bias."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(in_features, features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.copy_(torch.empty(self.weight.shape).uniform_(
            -bound, bound, generator=generator))
        self.bias.zero_()

    def forward(self, x):
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), stride=self.stride,
                                  padding=self.padding)
