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


def tile_maps(v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Per-image vectors (N, M) as (N, M, H, W) maps: a broadcast view, so a
    consumer's concat makes the only copy."""
    return v[:, :, None, None].expand(v.shape[0], v.shape[1], h, w)


class Conv(nn.Module):
    """k x k conv with SAME padding: the zoo's default_conv. With
    ``stride`` 2 it pads k // 2 on every side, as the JAX package's explicit
    ``padding=((1, 1), (1, 1))`` does for a 3x3 kernel (flax's 'SAME'
    would pad (0, 1) there).

    Initialised as torch's own default kernel init, U(+-1/sqrt(fan_in)),
    with a zero bias, as the JAX package's ``TConv`` does."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 stride: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
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
                        stride=self.stride, padding=self.padding)

    def as_linear(self, v):
        """A 1x1 conv applied to (N, in) vectors: (N, features), as the JAX
        package's 1x1 ``TConv`` on (N, 1, 1, in) maps."""
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(v.to(self.dtype), self.weight.flatten(1).to(self.dtype), b)


class Linear(nn.Module):
    """Dense layer: the JAX package's ``TDense`` (weight (out, in) here,
    its kernel (in, out)), torch's U(+-1/sqrt(fan_in)) kernel init and a
    zero bias; products in ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.copy_(torch.empty(self.weight.shape).uniform_(
            -bound, bound, generator=generator))
        self.bias.zero_()

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """BatchNorm over (N, C, H, W) with flax's ``nn.BatchNorm`` semantics,
    not ``torch.nn.BatchNorm2d``'s: statistics in float32 whatever the
    activation type, the variance biased and computed as E[x^2] - E[x]^2
    (clipped at 0), running statistics updated in training as
    ``momentum * running + (1 - momentum) * batch`` (flax's momentum 0.9;
    ``BatchNorm2d`` would store the unbiased variance), and the output
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, rounded
    to ``dtype``. Parameters ``scale``/``bias`` and buffers
    ``running_mean``/``running_var`` map onto flax's ``params`` and
    ``batch_stats`` leaves."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x, train: bool = False, update: bool = True):
        """``train``: normalise by the batch's statistics and, with
        ``update``, update the running ones (flax's
        ``use_running_average=False``; without ``update`` as flax's with the
        mutation discarded), whatever the module's ``training`` flag."""
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        if train and update:
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var)
        elif not train:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


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
    layout. Without a gradient the packed weights are cached and rebuilt
    only when the parameters change; with one, they are packed from the
    live parameters by differentiable layout ops, so the kernel's
    gradients reach ``conv1``, ``conv2`` and ``ca`` as ``.grad``."""

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

    @staticmethod
    def _pack(w1, b1, w2, b2, wd, bd, wu, bu):
        """OIHW parameters -> the kernel's layout, float32: (9, I, O)
        tap-major conv weights, (C, R) and (R, C) attention weights."""
        def taps(w):
            return w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0])

        return (taps(w1), b1, taps(w2), b2, wd.flatten(1).t(), bd,
                wu.flatten(1).t(), bu)

    def _kernel_weights(self):
        params = self._params()
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return self._pack(*params)
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._packed[0] != key:
            w1, b1, w2, b2, wd, bd, wu, bu = self._pack(*(p.detach() for p in params))
            packed = (w1.to(self.dtype).contiguous(), b1.float(),
                      w2.to(self.dtype).contiguous(), b2.float(),
                      wd.float().contiguous(), bd.float(),
                      wu.float().contiguous(), bu.float())
            self._packed = (key, packed)
        return self._packed[1]

    def forward(self, x):
        y = rcab_ops.rcab_fused(x.to(self.dtype).permute(0, 2, 3, 1),
                                *self._kernel_weights(),
                                res_scale=self.res_scale)
        return y.permute(0, 3, 1, 2)
