"""Shared SR building blocks (PyTorch, channels_last).

Port of ``rumpy_tpu/models/common.py``. Modules take NCHW-shaped tensors in
``torch.channels_last`` memory, which is the JAX package's NHWC in memory,
so a block's input permuted to NHWC is a contiguous view the CUDA kernels
read directly. Parameters are float32; ``dtype`` is the activation type
(bf16 activations over fp32 params, as in the JAX package).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.ops.cuda import rcab_fused as rcab_ops

# DIV2K RGB channel means in [0,1] (as used by EDSR/RCAN MeanShift layers).
DIV2K_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Depth-to-space (N, C*s^2, H, W) -> (N, C, H*s, W*s). The channel
    ordering (C-contiguous blocks of s*s per output channel) is the JAX
    package's ``pixel_shuffle`` on NHWC, so weights carry over unchanged."""
    return F.pixel_shuffle(x, scale)


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Space-to-depth inverse of :func:`pixel_shuffle`."""
    return F.pixel_unshuffle(x, scale)


class Conv(nn.Module):
    """k x k conv with SAME padding: the zoo's default_conv.

    Initialised as torch's own default kernel init, U(+-1/sqrt(fan_in)),
    with a zero bias, as the JAX package's ``TConv`` does."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        w = torch.empty(self.weight.shape).uniform_(-bound, bound,
                                                    generator=generator)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        padding=self.padding)


class MeanShift(nn.Module):
    """Subtract/add a fixed RGB mean (EDSR/RCAN head/tail normalisation)."""

    def __init__(self, sign: int = -1, rgb_range: float = 1.0,
                 rgb_mean: Sequence[float] = DIV2K_RGB_MEAN):
        super().__init__()
        self.sign = sign
        self.shift = [m * rgb_range for m in rgb_mean]

    def forward(self, x):
        mean = torch.tensor(self.shift, dtype=x.dtype, device=x.device)
        return x + self.sign * mean[None, :, None, None]


class ResBlock(nn.Module):
    """EDSR-style residual block: conv-act-conv, residual scale."""

    def __init__(self, features: int, kernel_size: int = 3,
                 res_scale: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv(features, features, kernel_size, dtype=dtype)
        self.conv2 = Conv(features, features, kernel_size, dtype=dtype)

    def forward(self, x):
        h = self.conv2(torch.relu(self.conv1(x)))
        return x + h * self.res_scale


class Upsampler(nn.Module):
    """Sub-pixel upsampler: conv to C*s^2 then pixel shuffle, staged in
    factors of 2 (or a single x3 stage)."""

    def __init__(self, scale: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        stages = []
        s = scale
        while s % 2 == 0:
            stages.append(2)
            s //= 2
        if s == 3:
            stages.append(3)
        elif s != 1:
            raise ValueError(f"Unsupported scale {scale}")
        self.stages = stages
        self.convs = nn.ModuleList(
            Conv(features, features * st * st, 3, dtype=dtype) for st in stages)

    def forward(self, x):
        for st, conv in zip(self.stages, self.convs):
            x = pixel_shuffle(conv(x), st)
        return x


class CALayer(nn.Module):
    """Channel attention (RCAN): global average pool -> 1x1 reduce -> ReLU
    -> 1x1 expand -> sigmoid gate."""

    def __init__(self, features: int, reduction: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down = Conv(features, max(1, features // reduction), 1, dtype=dtype)
        self.up = Conv(max(1, features // reduction), features, 1, dtype=dtype)

    def forward(self, x):
        y = x.mean(dim=(2, 3), keepdim=True)
        y = torch.sigmoid(self.up(torch.relu(self.down(y))))
        return x * y


class RCAB(nn.Module):
    """Residual channel attention block (RCAN), run by the fused kernel
    ``ops/cuda/rcab_fused.py::rcab_fused`` on its (9, Cin, Cout) weight
    layout, which is rebuilt only when the parameters change."""

    def __init__(self, features: int, reduction: int = 16,
                 res_scale: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.res_scale = res_scale
        self.conv1 = Conv(features, features, 3, dtype=dtype)
        self.conv2 = Conv(features, features, 3, dtype=dtype)
        self.ca = CALayer(features, reduction, dtype=dtype)
        self._packed = (None, None)

    def _params(self):
        """The parameters in kernel order, read from the module dicts
        directly (nn.Module attribute lookups cost microseconds on every
        one of RCAN's 200 calls)."""
        m = self._modules
        convs = (m["conv1"], m["conv2"], m["ca"]._modules["down"],
                 m["ca"]._modules["up"])
        return tuple(c._parameters[k] for c in convs for k in ("weight", "bias"))

    def _kernel_weights(self):
        params = self._params()
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._packed[0] != key:
            w1, b1, w2, b2, wd, bd, wu, bu = (p.detach() for p in params)

            def taps(w):  # OIHW -> (9, I, O), tap-major as the kernel takes
                return (w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0])
                        .to(self.dtype).contiguous())

            packed = (taps(w1), b1.float(), taps(w2), b2.float(),
                      wd.flatten(1).t().float().contiguous(), bd.float(),
                      wu.flatten(1).t().float().contiguous(), bu.float())
            self._packed = (key, packed)
        return self._packed[1]

    def forward(self, x):
        y = rcab_ops.rcab_fused(x.to(self.dtype).permute(0, 2, 3, 1),
                                *self._kernel_weights(),
                                res_scale=self.res_scale)
        return y.permute(0, 3, 1, 2)
