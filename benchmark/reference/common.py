"""Plain PyTorch pieces of the references: convolutions, channel attention,
flax-style BatchNorm, Adam, and the precision of the control.

Parameters keep the port's names and layouts (OIHW conv weights, (out, in)
dense weights), so one seeded state dict loads into both. Every product
runs in float32 with TF32 off (:func:`exact_float32`), or, for the control,
on operands rounded to a lower precision (:func:`lower`). Nothing here
imports the port.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def exact_float32():
    """Float32 products on the card, not TF32, for the span of the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def scaled_round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` scaled so that its largest magnitude is ``dtype``'s largest,
    rounded to ``dtype`` and scaled back, in ``t``'s type."""
    s = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / s).to(dtype).to(t.dtype) * s


class _FP8(torch.autograd.Function):
    """An operand of an fp8 product as fp8 training rounds it: per-tensor
    scaled float8_e4m3fn forward, its gradient float8_e5m2 backward."""

    @staticmethod
    def forward(ctx, t):
        return scaled_round(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return scaled_round(g, torch.float8_e5m2)


def lower(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as an operand of a product in ``precision``: "f32" keeps it,
    "bf16" rounds it to bfloat16, "fp8" as :class:`_FP8` rounds it."""
    if precision == "f32":
        return t
    if precision == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    if precision == "fp8":
        return _FP8.apply(t)
    raise ValueError(f"unknown precision {precision}")


class Conv(nn.Module):
    """k x k conv, k // 2 zero padding on every side, OIHW weight."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout))
        self.precision = "f32"

    def forward(self, x):
        p = self.precision
        return F.conv2d(lower(x, p), lower(self.weight, p), self.bias, stride=self.stride,
                        padding=self.weight.shape[-1] // 2)

    def linear(self, v):
        """The 1 x 1 conv on (N, C) vectors."""
        p = self.precision
        return F.linear(lower(v, p), lower(self.weight.flatten(1), p), self.bias)


class Linear(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.precision = "f32"

    def forward(self, v):
        p = self.precision
        return F.linear(lower(v, p), lower(self.weight, p), self.bias)


class BatchNorm(nn.Module):
    """flax's BatchNorm: biased variance as E[x^2] - E[x]^2 clipped at 0,
    running statistics ``0.9 * running + 0.1 * batch`` in training."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x, train: bool):
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class Upsampler(nn.Module):
    """Sub-pixel x2 stages (x4: two)."""

    def __init__(self, scale: int, c: int):
        super().__init__()
        stages = int(round(math.log2(scale)))
        if 2 ** stages != scale:
            raise NotImplementedError(f"reference upsampler: scale {scale}")
        self.convs = nn.ModuleList(Conv(c, 4 * c, 3) for _ in range(stages))

    def forward(self, x):
        for conv in self.convs:
            x = F.pixel_shuffle(conv(x), 2)
        return x


def set_precision(module: nn.Module, precision: str) -> nn.Module:
    for m in module.modules():
        if hasattr(m, "precision"):
            m.precision = precision
    return module


class Adam:
    """torch.optim.Adam's update, written out: m, v, bias corrections, the
    step ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g * g)
            p.sub_(self.lr / c1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(c2) + self.eps))
