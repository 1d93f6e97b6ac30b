"""Shared SR building blocks (PyTorch, channels_last).

Port of ``rumpy_tpu/models/common.py``. Modules take NCHW-shaped tensors in
``torch.channels_last`` memory, which is the JAX package's NHWC in memory,
so a block's input permuted to NHWC is a contiguous view the CUDA kernels
read directly. Parameters are float32; ``dtype`` is the activation type
(bf16 activations over fp32 params, as in the JAX package).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling by an integer ``factor``: each pixel
    repeated ``factor`` x ``factor`` times, as the JAX package's
    ``_upsample_nearest`` (two ``jnp.repeat``s) does."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def tile_maps(v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Per-image vectors (N, M) as (N, M, H, W) maps: a broadcast view, so a
    consumer's concat makes the only copy."""
    return v[:, :, None, None].expand(v.shape[0], v.shape[1], h, w)


class Conv(nn.Module):
    """k x k conv with SAME padding: the zoo's default_conv. With
    ``stride`` 2 it pads k // 2 on every side, as the JAX package's explicit
    ``padding=((1, 1), (1, 1))`` does for a 3x3 kernel (flax's 'SAME'
    would pad (0, 1) there); ``flax_same`` pads as flax's 'SAME' does
    instead (ceil(size / stride) outputs, an odd pixel of padding at the
    end).

    Initialised as torch's own default kernel init, U(+-1/sqrt(fan_in)),
    with a zero bias, as the JAX package's ``TConv`` does; ``init="he_normal"``
    draws N(0, 2 / fan_in) (the JAX package's ``HE_NORMAL_INIT``),
    ``init="he_fanout"`` N(0, 2 / (k k features)) (its ``HE_FANOUT_INIT``) and
    ``init="rrdb"`` N(0, 0.02 / fan_in), kaiming-normal x 0.1 (its
    ``RRDB_KERNEL_INIT``). ``reflect`` pads k // 2 by reflection instead of
    zeros (an explicit reflect pad, then a 'VALID' conv). ``padding`` pads
    that many zeros on every side in place of k // 2 (0: flax's 'VALID').
    ``groups`` splits the channels as flax's ``feature_group_count`` does
    (weight (features, in_features // groups, k, k); flax's kernel is
    (k, k, in_features // groups, features)); ``dilation`` spaces the taps
    as flax's ``kernel_dilation`` does."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 stride: int = 1, flax_same: bool = False, init: str = "torch",
                 reflect: bool = False, padding: Optional[int] = None, groups: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.kernel_size = kernel_size
        self.groups = groups
        self.dilation = dilation
        self.flax_same = flax_same and stride > 1
        self.reflect = reflect
        self.padding = (0 if (self.flax_same or reflect) else
                        kernel_size // 2 if padding is None else padding)
        self.init_kind = init
        self.weight = nn.Parameter(torch.empty(features, in_features // groups,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        w = torch.empty(self.weight.shape)
        if self.init_kind == "he_fanout":
            fan_out = self.weight.shape[0] * self.weight[0, 0].numel()
            w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        elif self.init_kind in ("he_normal", "rrdb"):
            var = 2.0 if self.init_kind == "he_normal" else 0.02
            w.normal_(0.0, math.sqrt(var / fan_in), generator=generator)
        else:
            bound = 1.0 / math.sqrt(fan_in)
            w.uniform_(-bound, bound, generator=generator)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()

    def _same_pads(self, size):
        pads = []
        for d in reversed(size):  # F.pad's order: the last dimension first
            total = max((-(-d // self.stride) - 1) * self.stride + self.kernel_size - d, 0)
            pads += [total // 2, total - total // 2]
        return pads

    def forward(self, x, weight=None):
        """The conv of ``x``, by ``weight`` in place of the parameter where
        given (a spectral-normalised kernel)."""
        b = None if self.bias is None else self.bias.to(self.dtype)
        w = self.weight if weight is None else weight
        x = x.to(self.dtype)
        padding = self.padding
        if self.reflect and self.kernel_size > 1:
            x = F.pad(x, [self.kernel_size // 2] * 4, mode="reflect")
        stride = self.stride
        if self.kernel_size == 1 and stride > 1 and not padding:
            # the conv of every stride-th pixel at stride 1: the same sums (torch
            # 2.13's CPU backward of a strided 1 x 1 conv on a channels_last
            # input of even size corrupts the heap)
            x, stride = x[:, :, ::stride, ::stride], 1
        elif self.flax_same:
            pads = self._same_pads(x.shape[2:])
            if pads[0] == pads[1] and pads[2] == pads[3]:  # symmetric: the conv pads
                padding = (pads[2], pads[0])
            else:
                x = F.pad(x, pads)
        return F.conv2d(x, w.to(self.dtype), b, stride=stride, padding=padding,
                        dilation=self.dilation, groups=self.groups)

    def as_linear(self, v):
        """A 1x1 conv applied to (N, in) vectors: (N, features), as the JAX
        package's 1x1 ``TConv`` on (N, 1, 1, in) maps."""
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(v.to(self.dtype), self.weight.flatten(1).to(self.dtype), b)


class ConvTranspose(nn.Module):
    """Transposed conv with flax's ``nn.ConvTranspose`` semantics (without
    ``transpose_kernel``, padding 'SAME'): the input dilated by the stride,
    padded k + s - 2 in all (k - 1 at the start where the stride exceeds
    k - 1, else half of it rounded up), and correlated with the kernel as
    flax stores it; ``size * stride`` outputs. ``F.conv_transpose2d``
    correlates with the kernel flipped, so the weight here is flax's kernel
    flipped in both spatial axes, in torch's (in, out, kh, kw) layout (the
    weight bridge flips it). Torch's U(+-1/sqrt(in * k * k)) kernel init with
    a zero bias, as the JAX package's ``TConvTranspose`` (fan-in over the
    kernel's input axis)."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        total = kernel_size + stride - 2
        start = kernel_size - 1 if stride > kernel_size - 1 else -(-total // 2)
        # torch pads k - 1 - padding at both ends of the dilated input, and
        # output_padding more at the end; a shorter end pad is a crop
        self.padding = kernel_size - 1 - start
        self.output_padding = max(total - 2 * start, 0)
        self.crop = max(2 * start - total, 0)
        self.weight = nn.Parameter(torch.empty(in_features, features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[0] * self.weight[0, 0].numel())
        self.weight.copy_(torch.empty(self.weight.shape).uniform_(
            -bound, bound, generator=generator))
        self.bias.zero_()

    def forward(self, x):
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                               self.bias.to(self.dtype), stride=self.stride,
                               padding=self.padding, output_padding=self.output_padding)
        if self.crop:
            y = y[:, :, :y.shape[2] - self.crop, :y.shape[3] - self.crop]
        return y


class Conv3d(nn.Module):
    """k x k x k conv with SAME padding over (N, C, D, H, W) volumes: the
    JAX package's 3-D ``TConv`` (kernel (k, k, k, in, out) there, (out, in,
    k, k, k) here), torch's U(+-1/sqrt(fan_in)) kernel init, a zero bias."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel_size,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.copy_(torch.empty(self.weight.shape).uniform_(
            -bound, bound, generator=generator))
        self.bias.zero_()

    def forward(self, x):
        return F.conv3d(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype),
                        padding=self.weight.shape[-1] // 2)


class Gamma(nn.Module):
    """Base of a module with a scalar ``gamma`` of its own, initialised to
    zero (flax's ``self.param("gamma", zeros, (1,))``)."""

    flax_leaves = {"gamma": ("params", "gamma")}

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.gamma.zero_()


# flax's truncated_normal: a standard normal cut at +-2, scaled so that the
# cut distribution has the asked standard deviation
_TRUNC_STD = 0.87962566103423978


class Linear(nn.Module):
    """Dense layer: the JAX package's ``TDense`` (weight (out, in) here,
    its kernel (in, out)), torch's U(+-1/sqrt(fan_in)) kernel init and a
    zero bias; products in ``dtype``. ``init="trunc_normal"`` draws flax's
    ``truncated_normal(stddev=0.02)`` instead (the JAX package's
    ``TRUNC_NORMAL_INIT``, SwinIR's ``SDense``)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, use_bias: bool = True,
                 init: str = "torch"):
        super().__init__()
        self.dtype = dtype
        self.init_kind = init
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        w = torch.empty(self.weight.shape)
        if self.init_kind == "trunc_normal":
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.mul_(0.02 / _TRUNC_STD)
        else:
            bound = 1.0 / math.sqrt(self.weight.shape[1])
            w.uniform_(-bound, bound, generator=generator)
        self.weight.copy_(w)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


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


class LayerNorm(nn.Module):
    """LayerNorm over the last axis as flax's ``nn.LayerNorm``: epsilon 1e-6
    (``torch.nn.LayerNorm``'s is 1e-5), the statistics and the output in
    float32 whatever the activation type, rounded to ``dtype``. One
    ``F.layer_norm`` on the float32 input: its variance is a two-pass
    float32 sum where flax's is E[x^2] - E[x]^2, which differ by rounding
    only (a dozen elementwise kernels a call would follow flax's formula
    literally). ``weight`` and ``bias`` are flax's ``scale`` and ``bias``."""

    def __init__(self, features: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                            self.eps).to(self.dtype)


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
