"""SwinIR: Swin-transformer SR.

Port of ``rumpy_tpu/models/swinir.py``: a shallow conv embed, residual Swin
transformer groups (``RSTB``: window self-attention with a learned
relative-position bias, shifted windows in every second block, LayerNorm
and a GELU MLP, then a conv), a conv after the body, and one of the four
reconstruction heads. Inputs are reflect-padded to a window multiple and
cropped back; the RGB mean shift applies at 3 input channels only.

Layout: the transformer body runs on NHWC tokens, which is the memory of
the channels_last tensors the convs take, so moving between them is a
view. A block's window partition and its roll are one gather of token
rows by a precomputed index, and the window reverse and the roll back one
gather by the inverse index: two copies a block, each a contiguous row of
C values a token. The indices and the shifted-window mask (-100 where the
rolled image's regions differ) are built on the device once for each
padded size; the relative-position bias is gathered once a block call.

Types follow the JAX package: the Dense layers and convs compute in
``dtype`` over float32 parameters; the attention logits are in ``dtype``,
and adding the float32 bias table (and mask) makes the softmax and the
product with the values float32, as XLA promotes them. q, k and v are made
contiguous in one copy, so that their products are plain batched GEMMs,
and the bias and mask are summed before one in-place add to the logits.
The products are ``torch.matmul`` and a softmax, as the JAX package's are
XLA einsums, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import true_div
from rumpy_tpu_torch.models.base import BaseHandler
from rumpy_tpu_torch.models.common import (Conv, LayerNorm, Linear, Upsampler, pixel_shuffle,
                                           upsample_nearest)
from rumpy_tpu_torch.registry import register_model

# SwinIR's RGB mean
_SWIN_RGB_MEAN = (0.4488, 0.4371, 0.4040)


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) indices into the (2 ws - 1)^2 relative-position table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def window_plan(h: int, w: int, ws: int, shift: int, device) -> Tuple:
    """(index, inverse, mask) of a (h, w) token grid: ``index`` lists, in
    window order (windows row-major, then each window's pixels row-major),
    the flat source pixel of each token of the image rolled by ``-shift``
    on both axes; ``inverse`` undoes it (the window reverse and the roll
    back); ``mask`` is (windows, ws^2, ws^2) float32, -100 where two
    tokens of a window lie in different regions of the rolled image, or
    None without a shift."""
    r = torch.arange(h, device=device)
    c = torch.arange(w, device=device)

    def windows(grid):
        return grid.reshape(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3).reshape(-1, ws * ws)

    index = windows(((r + shift) % h)[:, None] * w + ((c + shift) % w)[None, :]).reshape(-1)
    inverse = torch.empty_like(index)
    inverse[index] = torch.arange(h * w, device=device)
    if not shift:
        return index, inverse, None

    def region(n, pos):  # the slices [0, -ws), [-ws, -shift), [-shift, n) as 0, 1, 2
        return (pos >= n - ws).long() + (pos >= n - shift).long()

    labels = windows(3 * region(h, r)[:, None] + region(w, c)[None, :])
    mask = torch.where(labels[:, :, None] != labels[:, None, :], -100.0, 0.0)
    return index, inverse, mask.float()


class WindowAttention(nn.Module):
    """Multi-head self-attention inside (B_, ws^2, C) windows with a learned
    relative-position bias ((2 ws - 1)^2 x heads, flax's
    ``relative_position_bias``, drawn from normal(0.02)); q is scaled
    before its product with k."""

    flax_leaves = {"relative_position_bias": ("params", "relative_position_bias")}

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, dim * 3, dtype=dtype, init="trunc_normal")
        self.proj = Linear(dim, dim, dtype=dtype, init="trunc_normal")
        self.relative_position_bias = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(
            _rel_pos_index(window_size).reshape(-1)), persistent=False)

    def flax_children(self):
        return [("qkv", ("SDense_0",), self.qkv), ("proj", ("SDense_1",), self.proj)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.relative_position_bias.copy_(torch.empty(
            self.relative_position_bias.shape).normal_(0.0, 0.02, generator=generator))

    def forward(self, x, mask=None):
        b_, n, c = x.shape
        heads = self.num_heads
        q, k, v = self.qkv(x).reshape(b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4) \
            .contiguous()
        # the logits in the activation type, then (bias + mask) in float32
        # added in place, one pass over the logits (JAX adds the two in turn)
        bias = self.relative_position_bias[self.rel_index].reshape(n, n, heads).permute(2, 0, 1)
        bias = bias[None] if mask is None else bias[None] + mask[:, None]
        attn = torch.matmul(q * self.scale, k.transpose(-2, -1)).float()
        attn = attn.view(-1, bias.shape[0], heads, n, n).add_(bias).view(b_, heads, n, n)
        out = torch.matmul(torch.softmax(attn, dim=-1), v.float())
        return self.proj(out.to(self.proj.dtype).transpose(1, 2).reshape(b_, n, c))


class SwinBlock(nn.Module):
    """LayerNorm, (shifted) window attention, residual; LayerNorm, Dense,
    tanh GELU (flax's ``nn.gelu`` default), Dense, residual. Takes and
    returns NHWC tokens; ``plan`` is this block's ``window_plan``."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 8, shift: int = 0,
                 mlp_ratio: float = 2.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = WindowAttention(dim, window_size, num_heads, dtype=dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        hidden = int(dim * mlp_ratio)
        self.fc1 = Linear(dim, hidden, dtype=dtype, init="trunc_normal")
        self.fc2 = Linear(hidden, dim, dtype=dtype, init="trunc_normal")

    def flax_children(self):
        return [("norm1", ("LayerNorm_0",), self.norm1),
                ("attn", ("WindowAttention_0",), self.attn),
                ("norm2", ("LayerNorm_1",), self.norm2),
                ("fc1", ("SDense_0",), self.fc1), ("fc2", ("SDense_1",), self.fc2)]

    def forward(self, x, plan):
        b, h, w, c = x.shape
        index, inverse, mask = plan
        y = self.norm1(x).reshape(b, h * w, c).index_select(1, index)
        y = self.attn(y.reshape(-1, self.window_size ** 2, c), mask)
        x = x + y.reshape(b, h * w, c).index_select(1, inverse).reshape(b, h, w, c)
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))


class RSTB(nn.Module):
    """Residual Swin transformer group: ``depth`` SwinBlocks (shift
    ws // 2 in every second), a 3x3 conv, the input added back."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int = 8,
                 mlp_ratio: float = 2.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio, dtype=dtype) for i in range(depth))
        self.conv = Conv(dim, dim, 3, dtype=dtype)

    def flax_children(self):
        return ([(f"blocks.{i}", (f"SwinBlock_{i}",), b) for i, b in enumerate(self.blocks)]
                + [("conv", ("Conv_0", "TConv_0"), self.conv)])

    def forward(self, x, plans: Dict[int, Tuple]):
        res = x
        for block in self.blocks:
            res = block(res, plans[block.shift])
        return x + self.conv(res.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SwinIR(nn.Module):
    """The JAX package's layout: mean shift by ``img_range``, conv_first,
    the patch-embed LayerNorm, the RSTB stack, a LayerNorm, conv_after_body
    plus the embed, then the head: ``pixelshuffle`` (conv, LeakyReLU 0.01,
    Upsampler, conv), ``pixelshuffledirect`` (one conv, pixel shuffle),
    ``nearest+conv`` (conv, LeakyReLU 0.01, two nearest x2 with a conv and
    LeakyReLU 0.2 each, a conv, LeakyReLU 0.2, a conv) or ``""`` (the input
    plus a conv: denoising)."""

    def __init__(self, scale: int = 4, in_chans: int = 3, embed_dim: int = 60,
                 depths: Sequence[int] = (6, 6, 6, 6), num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 8, mlp_ratio: float = 2.0, img_range: float = 1.0,
                 upsampler: str = "pixelshuffle", num_feat: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.window_size = window_size
        self.img_range = img_range
        self.upsampler = upsampler
        self.register_buffer("rgb_mean", torch.tensor(
            _SWIN_RGB_MEAN if in_chans == 3 else (0.0,), dtype=torch.float32)[:, None, None],
            persistent=False)
        self.conv_first = Conv(in_chans, embed_dim, 3, dtype=dtype)
        self.patch_norm = LayerNorm(embed_dim, dtype=dtype)
        self.layers = nn.ModuleList(RSTB(embed_dim, d, n, window_size, mlp_ratio, dtype=dtype)
                                    for d, n in zip(depths, num_heads))
        self.norm = LayerNorm(embed_dim, dtype=dtype)
        self.conv_after_body = Conv(embed_dim, embed_dim, 3, dtype=dtype)
        if upsampler == "pixelshuffle":
            head = [Conv(embed_dim, num_feat, 3, dtype=dtype),
                    Conv(num_feat, in_chans, 3, dtype=dtype)]
            self.upsample = Upsampler(scale, num_feat, dtype=dtype)
        elif upsampler == "pixelshuffledirect":
            head = [Conv(embed_dim, in_chans * scale ** 2, 3, dtype=dtype)]
        elif upsampler == "nearest+conv":
            head = [Conv(embed_dim, num_feat, 3, dtype=dtype)] + [
                Conv(num_feat, num_feat, 3, dtype=dtype) for _ in range(3)] + [
                Conv(num_feat, in_chans, 3, dtype=dtype)]
        else:
            head = [Conv(embed_dim, in_chans, 3, dtype=dtype)]
        self.head = nn.ModuleList(head)
        self._plans: Dict[Tuple, Dict[int, Tuple]] = {}

    def flax_children(self):
        convs = [self.conv_first, self.conv_after_body] + list(self.head)
        names = ["conv_first", "conv_after_body"] + [f"head.{i}" for i in range(len(self.head))]
        out = [(n, (f"Conv_{i}", "TConv_0"), c) for i, (n, c) in enumerate(zip(names, convs))]
        out += [("patch_norm", ("LayerNorm_0",), self.patch_norm),
                ("norm", ("LayerNorm_1",), self.norm)]
        out += [(f"layers.{i}", (f"RSTB_{i}",), m) for i, m in enumerate(self.layers)]
        if self.upsampler == "pixelshuffle":
            out.append(("upsample", ("Upsampler_0",), self.upsample))
        return out

    def plans(self, h: int, w: int, device) -> Dict[int, Tuple]:
        """The window plans of a padded (h, w) grid by shift, built once."""
        key = (h, w, str(device))
        if key not in self._plans:
            ws = self.window_size
            self._plans[key] = {s: window_plan(h, w, ws, s, device) for s in (0, ws // 2)}
        return self._plans[key]

    def forward(self, x):
        h, w = x.shape[2:]
        ws = self.window_size
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        mean = self.rgb_mean.to(x.dtype)
        x = (x - mean) * self.img_range

        feat = self.conv_first(x)
        tokens = self.patch_norm(feat.permute(0, 2, 3, 1))
        plans = self.plans(x.shape[2], x.shape[3], x.device)
        for layer in self.layers:
            tokens = layer(tokens, plans)
        tokens = self.norm(tokens)
        feat = feat + self.conv_after_body(tokens.permute(0, 3, 1, 2))

        head = self.head
        if self.upsampler == "pixelshuffle":
            out = head[1](self.upsample(F.leaky_relu(head[0](feat), 0.01)))
        elif self.upsampler == "pixelshuffledirect":
            out = pixel_shuffle(head[0](feat), self.scale)
        elif self.upsampler == "nearest+conv":
            f = F.leaky_relu(head[0](feat), 0.01)
            f = F.leaky_relu(head[1](upsample_nearest(f)), 0.2)
            f = F.leaky_relu(head[2](upsample_nearest(f)), 0.2)
            out = head[4](F.leaky_relu(head[3](f), 0.2))
        else:
            out = x + head[0](feat)
        out = true_div(out, self.img_range) + mean
        return out[:, :, :h * self.scale, :w * self.scale]


@register_model("swinir")
class SwinIRHandler(BaseHandler):
    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"

    def __init__(self, embed_dim=60, depths=(6, 6, 6, 6), num_heads=(6, 6, 6, 6),
                 window_size=8, mlp_ratio=2.0, img_range=1.0, upsampler="pixelshuffle",
                 **kwargs):
        super().__init__(embed_dim=embed_dim, depths=tuple(depths), num_heads=tuple(num_heads),
                         window_size=window_size, mlp_ratio=mlp_ratio, img_range=img_range,
                         upsampler=upsampler, **kwargs)

    def build_module(self, **kw):
        return SwinIR(scale=self.scale, in_chans=self.in_features, dtype=self.dtype, **kw)
