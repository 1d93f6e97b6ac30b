"""Attribute-conditioned face GANs: FaceSR-Attributes-GAN, AGA-GAN, FMFNet.

Port of ``rumpy_tpu/models/face_attribute_gans.py``: 16 x 16 CelebA faces to
128 x 128 (x8), conditioned on their attribute vector (the 40 CelebA
attributes with ``metadata=["all"]``). The JAX package computes none of it
in a Pallas kernel: here it is cuDNN convs and PyTorch ops, and no RCAB
kernel runs. The LR side is fixed at 16 by the networks: AGA-GAN's 768 =
3 x 16 x 16 attribute map, FaceSR's 1 x 1 bottleneck, FMFNet's 2 x 2 latent.

Torch-semantics layers: ``PRelu`` (torch's ``nn.PReLU``),
``TorchConvTranspose`` (``nn.ConvTranspose2d(k, s, p)``), the JAX package's
``TConv`` (explicit symmetric padding and dilation) and ``Conv2dSame``
(Keras 'same' padding at stride 2: the odd pixel of padding at the end),
both ``common.Conv``; a flatten of NCHW in torch's channel-major order, so
dense weights map unchanged.

``affine_grid`` and ``grid_sample`` (the STN's) are written as the JAX
functions are, not as ``F.affine_grid`` / ``F.grid_sample``: the STN's
affine head starts at the identity, where every sample point lies on a
pixel and the gradient with respect to the grid depends on which side of
it ``floor`` lands. So the base grid is, bit for bit, the one the JAX
package's jitted ``jnp.linspace(-1, 1, n)`` gives (XLA turns its division
by n - 1 into a product by the reciprocal), and the sample is floor, four
taps, a validity mask and the same unnormalisation.

Flax names a compact module's children by class, numbered in the order
they are constructed (``_Compact``). A module the JAX network binds once
and calls many times is one set of parameters there and one port module
here: AGA-GAN's shallow block, RDDB, ``conv_only_*``, ``main_body_2`` and
up-blocks; FMFNet's residual dense ``body``, meta-attention convs, up-block,
latent dense and adapter.

``AttributeGANHandler`` trains as the JAX handler does, on the port's
``BaseGANHandler``: one generator optimizer (the pre-train one: the
handler's lr, scheduler and clipping) for both phases and the
discriminator's; L1 pre-training for ``pretrain_epochs``, then the LSGAN
step: the generator (train mode, so FaceSR's BatchNorm statistics move)
against the discriminator in eval mode, on the fake then the real images,
with the pixel, adversarial and (with VGG weights) perceptual terms; then
the discriminator in train mode on the real and the detached fake images,
each call with its own dropout draws. The metadata reaches both networks
but FMFNet's discriminator; ``apply`` raises without it. The online
degradation chain is not run, as in the JAX handler.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import true_div
from rumpy_tpu_torch.models.attention_manipulators import (compute_num_metadata,
                                                           select_metadata_columns)
from rumpy_tpu_torch.models.base import BaseHandler, TrainState
from rumpy_tpu_torch.models.common import (BatchNorm, Conv, Linear, pixel_shuffle,
                                           upsample_nearest)
from rumpy_tpu_torch.models.contrastive import device_batch
from rumpy_tpu_torch.models.gan_models import BaseGANHandler, GANPair, frozen
from rumpy_tpu_torch.registry import register_model


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


# ---------------------------------------------------------------------------
# Torch-semantics helpers
# ---------------------------------------------------------------------------

def _tconv(cin: int, cout: int, kernel: int = 3, stride: int = 1, pad: int = 0,
           dilation: int = 1, dtype: torch.dtype = torch.float32) -> Conv:
    """The JAX package's ``TConv``: torch's ``Conv2d(k, s, p, dilation)``."""
    return Conv(cin, cout, kernel, stride=stride, padding=pad, dilation=dilation, dtype=dtype)


def _conv_same(cin: int, cout: int, kernel: int, stride: int,
               dtype: torch.dtype = torch.float32) -> Conv:
    """``Conv2dSame``: ceil(size / stride) outputs, the padding split with
    the odd pixel at the end."""
    return Conv(cin, cout, kernel, stride=stride, flax_same=True, dtype=dtype)


def _flatten_nchw(x):
    """torch's ``nn.Flatten`` of an NCHW map: channel-major."""
    return x.flatten(1)


def _maxpool(x, k: int = 2, s: Optional[int] = None):
    return F.max_pool2d(x, k, s or k)


def _lrelu(v, slope: float = 0.25):
    return F.leaky_relu(v, slope)


def _linspace(n: int, like: torch.Tensor) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` as XLA computes it under jit, bit for bit,
    in ``like``'s dtype and on its device: ``-1 * (1 - step) + 1 * step``
    with ``step = i * (1 / (n - 1))``, the reciprocal rounded to the dtype,
    then the endpoint 1."""
    kw = dict(dtype=like.dtype, device=like.device)
    if n == 1:
        return torch.full((1,), -1.0, **kw)
    rcp = true_div(1.0, torch.full((), n - 1, **kw))
    step = torch.arange(n - 1, **kw) * rcp
    return torch.cat([step - (1.0 - step), torch.ones(1, **kw)])


def affine_grid(theta: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``F.affine_grid(theta, align_corners=True)`` as the JAX package
    computes it: the (N, H, W, 2) xy grid ``theta @ (x, y, 1)`` over the
    base grid of :func:`_linspace` rows."""
    ys, xs = _linspace(height, theta), _linspace(width, theta)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H, W, 3)
    return torch.einsum("nij,hwj->nhwi", theta, base)


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample(align_corners=True, padding_mode="zeros")``, bilinear,
    as the JAX package writes it: x (N, H, W, C), grid (N, Ho, Wo, 2) xy in
    [-1, 1]; the grid's unnormalised coordinates, their floor, four taps
    read with clipped indices and zeroed outside the image, the weights in
    x's dtype. Returns (N, Ho, Wo, C)."""
    n, h, w, c = x.shape
    gx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx = (gx - x0)[..., None].to(x.dtype)
    wy = (gy - y0)[..., None].to(x.dtype)
    flat = x.reshape(n, h * w, c)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long().reshape(n, -1, 1)
        vals = torch.gather(flat, 1, idx.expand(-1, -1, c)).reshape(*yi.shape, c)
        return vals * valid[..., None].to(x.dtype)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _bn(features: int, dtype: torch.dtype) -> BatchNorm:
    """flax's ``BatchNorm(momentum=0.9)``."""
    return BatchNorm(features, momentum=0.9, dtype=dtype)


# the flax path below a class's numbered name: a TConv and a Conv2dSame
# each wrap one common TConv
_INNER = {"TConv": ("TConv_0",), "Conv2dSame": ("TConv_0",)}


class _Compact(nn.Module):
    """A module whose children are named as flax's compact form names them:
    by class, each numbered from 0 in the order the JAX module constructs
    it (a TConv's or a Conv2dSame's conv one level further down).
    ``_add`` records a child in that order; a child the JAX module binds
    once and calls many times is recorded once, and one it constructs but
    never calls (so it has no parameters) is recorded as ``None``: it takes
    its number all the same."""

    def __init__(self):
        super().__init__()
        self._flax_order = []

    def _add(self, cls: str, module: Optional[nn.Module]) -> Optional[nn.Module]:
        self._flax_order.append((cls, module))
        return module

    def flax_children(self):
        names = {id(m): n for n, m in self.named_modules() if n}
        counts: Dict[str, int] = {}
        out = []
        for cls, m in self._flax_order:
            i = counts.get(cls, 0)
            counts[cls] = i + 1
            if m is not None:
                out.append((names[id(m)], (f"{cls}_{i}",) + _INNER.get(cls, ()), m))
        return out


def _dropout(h, keep: Optional[torch.Tensor], prob: float):
    """flax's ``Dropout`` with the caller's keep mask: (N, C) for a whole
    channel map of an NCHW ``h`` (``broadcast_dims=(1, 2)`` on NHWC), or
    ``h``'s own shape; kept values divided by the keep probability."""
    if keep.dim() < h.dim():
        keep = keep[:, :, None, None]
    return torch.where(keep, true_div(h, prob), 0.0)


# ---------------------------------------------------------------------------
# FaceSR-Attributes-GAN
# ---------------------------------------------------------------------------

class STN(_Compact):
    """STN_L1_UpG / STN_L2_UpG: a localisation net, a 6-dof affine head
    (``theta_w`` (20, 6) zeros and ``theta_b`` the identity at init, in
    float32), then :func:`affine_grid` and :func:`grid_sample` of the input
    on a 32 x 32 (variant 1) or 64 x 64 (variant 2) grid."""

    flax_leaves = {"theta_w": ("params", "theta_w"), "theta_b": ("params", "theta_b")}

    def __init__(self, in_features: int, variant: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        if variant == 1:
            spec, self.grid_hw, flat = [(128, 3, 1), (20, 3, 1), (20, 3, 0)], 32, 20 * 2 * 2
        else:
            spec, self.grid_hw, flat = [(64, 5, 0), (20, 5, 0), (20, 3, 0)], 64, 20 * 3 * 3
        cins = [in_features] + [o for o, _, _ in spec[:-1]]
        self.convs = nn.ModuleList(self._add("TConv", _tconv(i, o, k, 1, p, dtype=dtype))
                                   for i, (o, k, p) in zip(cins, spec))
        self.dense = self._add("TDense", Linear(flat, 20, dtype=dtype))
        self.theta_w = nn.Parameter(torch.zeros(20, 6))
        self.theta_b = nn.Parameter(torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.theta_w.zero_()
        self.theta_b.zero_()
        self.theta_b[0] = 1.0
        self.theta_b[4] = 1.0

    def forward(self, x):
        h = _maxpool(x)
        for i, conv in enumerate(self.convs):
            h = torch.relu(conv(h))
            if i < 2:
                h = _maxpool(h)
        h = torch.relu(self.dense(_flatten_nchw(h)))
        theta = (h.float() @ self.theta_w + self.theta_b).reshape(-1, 2, 3)
        grid = affine_grid(theta, self.grid_hw, self.grid_hw)
        return grid_sample(x.permute(0, 2, 3, 1), grid).permute(0, 3, 1, 2)


class FaceSRAttributesGenerator(_Compact):
    """A 4-step conv encoder to a 1 x 1 bottleneck (flax BatchNorm, leaky
    relu 0.2), the attributes concatenated there (through two 1 x 1 convs
    with ``use_attribute_encoder``), a skip-connected transposed-conv
    decoder to 16 x 16, then three nearest x2 upsamplings with convs, the
    first two after an STN: 16 x 16 in, 128 x 128 out."""

    def __init__(self, n_feats: int = 32, n_attributes: int = 18, remove_stn: bool = False,
                 use_attribute_encoder: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        nf, na = n_feats, n_attributes
        self.dtype = dtype
        enc = [(3, nf, 4, 2, 1), (nf, 4 * nf, 4, 2, 1), (4 * nf, 16 * nf, 4, 2, 1),
               (16 * nf, 64 * nf, 2, 1, 0)]
        self.enc_convs, self.enc_norms = nn.ModuleList(), nn.ModuleList()
        for cin, cout, k, s, p in enc:
            self.enc_convs.append(self._add("TConv", _tconv(cin, cout, k, s, p, dtype=dtype)))
            self.enc_norms.append(self._add("BatchNorm", _bn(cout, dtype)))
        self.meta_encoder = (nn.ModuleList(
            [self._add("TConv", _tconv(na, 2 * na, 1, dtype=dtype)),
             self._add("TConv", _tconv(2 * na, na, 1, dtype=dtype))])
            if use_attribute_encoder else None)
        dec = [(64 * nf + na, 32 * nf), (48 * nf, 24 * nf), (28 * nf, 16 * nf), (17 * nf, 8 * nf)]
        self.dec_convs, self.dec_norms = nn.ModuleList(), nn.ModuleList()
        for cin, cout in dec:
            self.dec_convs.append(self._add("TorchConvTranspose",
                                            TorchConvTranspose(cin, cout, 4, 2, 1, dtype=dtype)))
            self.dec_norms.append(self._add("BatchNorm", _bn(cout, dtype)))
        self.stns = nn.ModuleList()
        self.tail_convs, self.tail_norms = nn.ModuleList(), nn.ModuleList()
        for i, (cin, cout) in enumerate([(8 * nf, 4 * nf), (4 * nf, 2 * nf), (2 * nf, nf)]):
            if i < 2 and not remove_stn:
                self.stns.append(self._add("STN", STN(cin, i + 1, dtype=dtype)))
            self.tail_convs.append(self._add("TConv", _tconv(cin, cout, 3, 1, 1, dtype=dtype)))
            self.tail_norms.append(self._add("BatchNorm", _bn(cout, dtype)))
        self.out = self._add("TConv", _tconv(nf, 3, 5, 1, 2, dtype=dtype))

    def forward(self, x, metadata, train: bool = False):
        feats = []
        h = x
        for conv, norm in zip(self.enc_convs, self.enc_norms):
            h = _lrelu(norm(conv(h), train=train), 0.2)
            feats.append(h)
        meta = metadata.to(self.dtype)[:, :, None, None]
        if self.meta_encoder is not None:
            for conv in self.meta_encoder:
                meta = conv(meta)
        h = torch.cat([h, meta.expand(-1, -1, *h.shape[2:])], dim=1)
        skips = [None, feats[2], feats[1], feats[0]]
        for conv, norm, skip in zip(self.dec_convs, self.dec_norms, skips):
            if skip is not None:
                h = torch.cat([h, skip], dim=1)
            h = torch.relu(norm(conv(h), train=train))
        for i, (conv, norm) in enumerate(zip(self.tail_convs, self.tail_norms)):
            h = upsample_nearest(h)
            if i < len(self.stns):
                h = self.stns[i](h)
            h = torch.relu(norm(conv(h), train=train))
        return self.out(h)


class FaceSRAttributesDiscriminator(_Compact):
    """A conv head (5 x 5 convs, max-pool, relu) to 32 x 32, the attribute
    maps concatenated there (through two 1 x 1 convs with
    ``use_attribute_encoder``), a conv body with channel dropout 0.2 twice,
    a dense layer with dropout 0.5, a sigmoid. In train mode ``keep`` holds
    the three dropout masks (``mask_shapes``): a 128 x 128 input."""

    keep_probs = (0.8, 0.8, 0.5)

    def __init__(self, n_feats: int = 32, n_attributes: int = 18,
                 use_attribute_encoder: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        nf, na = n_feats, n_attributes
        self.dtype = dtype
        self.widths = (4 * nf, 8 * nf, 1024)
        self.head = nn.ModuleList([self._add("TConv", _tconv(3, nf, 5, 1, 2, dtype=dtype)),
                                   self._add("TConv", _tconv(nf, 2 * nf, 5, 1, 2, dtype=dtype))])
        self.meta_encoder = (nn.ModuleList(
            [self._add("TConv", _tconv(na, 2 * na, 1, dtype=dtype)),
             self._add("TConv", _tconv(2 * na, na, 1, dtype=dtype))])
            if use_attribute_encoder else None)
        self.body = nn.ModuleList([
            self._add("TConv", _tconv(2 * nf + na, 4 * nf, 5, 1, 2, dtype=dtype)),
            self._add("TConv", _tconv(4 * nf, 8 * nf, 3, 1, 1, dtype=dtype))])
        self.dense = nn.ModuleList([self._add("TDense", Linear(8 * nf * 64, 1024, dtype=dtype)),
                                    self._add("TDense", Linear(1024, 1, dtype=dtype))])

    def mask_shapes(self, n: int):
        return [(n, c) for c in self.widths]

    def forward(self, x, metadata, train: bool = False, keep=None):
        h = torch.relu(_maxpool(self.head[0](x)))
        h = torch.relu(_maxpool(self.head[1](h)))
        meta = metadata.to(self.dtype)[:, :, None, None].expand(-1, -1, *h.shape[2:])
        if self.meta_encoder is not None:
            for conv in self.meta_encoder:
                meta = conv(meta)
        h = torch.cat([h, meta], dim=1)
        if train and keep is None:
            raise ValueError("a train-mode call takes its dropout masks (keep)")
        for i, conv in enumerate(self.body):
            h = torch.relu(_maxpool(conv(h)))
            if train:
                h = _dropout(h, keep[i], self.keep_probs[i])
        h = torch.relu(self.dense[0](_flatten_nchw(h)))
        if train:
            h = _dropout(h, keep[2], self.keep_probs[2])
        return torch.sigmoid(self.dense[1](h))


# ---------------------------------------------------------------------------
# AGA-GAN
# ---------------------------------------------------------------------------

class ConvPixelShuffleReLU(_Compact):
    """A 3 x 3 conv to ``out * scale^2`` channels, a pixel shuffle, a relu."""

    def __init__(self, in_features: int, features: int, scale: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.conv = self._add("TConv", _tconv(in_features, features * scale ** 2, 3, 1, 1,
                                              dtype=dtype))

    def forward(self, x):
        return torch.relu(pixel_shuffle(self.conv(x), self.scale))


class RDDB(_Compact):
    """Five densely connected 3 x 3 convs with leaky relu 0.25, ``0.4 * out
    + x``."""

    def __init__(self, in_features: int, n_feats: int = 64, out_feats: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(
            self._add("TConv", _tconv(in_features + i * n_feats, n_feats if i < 4 else out_feats,
                                      3, 1, 1, dtype=dtype)) for i in range(5))

    def forward(self, x):
        feats = [x]
        for conv in self.convs[:4]:
            feats.append(_lrelu(conv(torch.cat(feats, dim=1))))
        return _lrelu(self.convs[4](torch.cat(feats, dim=1))) * 0.4 + x


class SEBlock(_Compact):
    """Squeeze-excitation in the squeezed form the JAX package gives it (the
    reference feeds the unsqueezed pooled map to its Linear and fails): the
    spatial mean, Dense(C // ratio), relu, Dense(C), a sigmoid gate."""

    def __init__(self, in_feats: int, ratio: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = max(1, in_feats // ratio)
        self.down = self._add("TDense", Linear(in_feats, mid, dtype=dtype))
        self.up = self._add("TDense", Linear(mid, in_feats, dtype=dtype))

    def forward(self, x):
        g = self.up(torch.relu(self.down(x.mean(dim=(2, 3)))))
        return torch.sigmoid(g)[:, :, None, None] * x


class DualAttentionBlock(_Compact):
    """A pixel-shuffle up-block, the skip concatenated, a 3 x 3 conv, then
    its SE gate times (spatial attention + 1)."""

    def __init__(self, in_features: int, skip_features: int, out_feats: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up = self._add("ConvPixelShuffleReLU",
                            ConvPixelShuffleReLU(in_features, out_feats, dtype=dtype))
        self.conv = self._add("TConv", _tconv(skip_features + out_feats, out_feats, 3, 1, 1,
                                              dtype=dtype))
        self.se = self._add("SEBlock", SEBlock(out_feats, dtype=dtype))
        self.sa1 = self._add("TConv", _tconv(out_feats, out_feats // 4, 1, dtype=dtype))
        self.sa2 = self._add("TConv", _tconv(out_feats // 4, 1, 1, dtype=dtype))

    def forward(self, x, skip):
        up = torch.relu(self.up(x))
        conv = torch.relu(self.conv(torch.cat([skip, up], dim=1)))
        sa = torch.sigmoid(self.sa2(torch.relu(self.sa1(conv))))
        return self.se(conv) * (sa + 1.0)


class AGAGANUNet(_Compact):
    """The attribute-stream U-Net (on the 6-channel concatenation of an
    image and the generator's output): four conv stages with SE gates, three
    dual-attention up stages, a tanh. Exposed; the generator does not use
    it."""

    def __init__(self, n_feats: int = 32, in_features: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nf = n_feats
        self.stages, self.ses = nn.ModuleList(), nn.ModuleList()
        cin = in_features
        for ch, n_convs in ((nf, 2), (2 * nf, 2), (4 * nf, 2), (8 * nf, 3)):
            self.stages.append(nn.ModuleList(
                self._add("TConv", _tconv(cin if j == 0 else ch, ch, 3, 1, 1, dtype=dtype))
                for j in range(n_convs)))
            self.ses.append(self._add("SEBlock", SEBlock(ch, dtype=dtype)))
            cin = ch
        self.dabs, self.convs = nn.ModuleList(), nn.ModuleList()
        for i, (cin, skip, out, n) in enumerate(((8 * nf, 4 * nf, 4 * nf, 3),
                                                 (4 * nf, 2 * nf, 2 * nf, 2),
                                                 (2 * nf, nf, nf, 2))):
            self.dabs.append(self._add("DualAttentionBlock",
                                       DualAttentionBlock(cin, skip, out, dtype=dtype)))
            self.convs.append(nn.ModuleList(self._add("TConv", _tconv(out, out, 3, 1, 1,
                                                                      dtype=dtype))
                                            for _ in range(n)))
        self.out = self._add("TConv", _tconv(nf, 3, 3, 1, 1, dtype=dtype))

    def forward(self, x):
        skips = []
        h = x
        for i, (stage, se) in enumerate(zip(self.stages, self.ses)):
            if i:
                h = _maxpool(h)
            for conv in stage:
                h = conv(h)
            h = se(_lrelu(h))
            skips.append(h)
        for dab, convs, skip in zip(self.dabs, self.convs, skips[2::-1]):
            h = dab(h, skip)
            h1 = convs[0](h)
            h = h1 + _lrelu(convs[1](h1))
            if len(convs) == 3:
                h = convs[2](h)
        return torch.tanh(self.out(h))


class _Shallow(_Compact):
    """AGA-GAN's shallow block (one module, called on the LR image and on
    the attribute map): three 3 x 3 convs, leaky relu between."""

    def __init__(self, in_features: int, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(self._add("TConv", _tconv(in_features if i == 0 else nf, nf,
                                                             3, 1, 1, dtype=dtype))
                                   for i in range(3))

    def forward(self, v):
        v = _lrelu(self.convs[0](v))
        return self.convs[2](_lrelu(self.convs[1](v)))


class AGAGANGenerator(_Compact):
    """The attribute stream (Dense to 768 = a 3 x 16 x 16 map in channel-major
    order, the shared shallow block, three convs and a pixel-shuffle up) and
    the RDDB main branch (one RDDB called three times) with three rounds of
    progressive attention at 32 x 32 and a pixel-shuffle reconstruction to
    x8, a tanh."""

    def __init__(self, n_feats: int = 32, n_attributes: int = 38, use_transpose: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nf, na = n_feats, n_attributes
        self.dtype = dtype
        add = self._add
        self.attributes_dense = add("TDense", Linear(na, 768, dtype=dtype))
        self.shallow = add("_Shallow", _Shallow(3, nf, dtype=dtype))
        self.rddb = add("RDDB", RDDB(4 * nf, 64, 4 * nf, dtype=dtype))
        self.conv_only_1 = add("TConv", _tconv(4 * nf, 4 * nf, 3, 1, 1, dtype=dtype))
        self.conv_only_2 = add("TConv", _tconv(8 * nf, 4 * nf, 3, 1, 1, dtype=dtype))
        self.bottleneck_sig = add("TConv", _tconv(4 * nf, 1, 3, 1, 1, dtype=dtype))
        self.main_body_2 = add("TConv", _tconv(8 * nf, 4 * nf, 3, 1, 1, dtype=dtype))
        self.up_wide = add("ConvPixelShuffleReLU", ConvPixelShuffleReLU(4 * nf, 4 * nf,
                                                                        dtype=dtype))
        self.up_narrow = add("ConvPixelShuffleReLU", ConvPixelShuffleReLU(2 * nf, 2 * nf,
                                                                          dtype=dtype))
        self.f1 = add("TConv", _tconv(2 * nf, 2 * nf, 3, 1, 1, dtype=dtype))
        self.f2 = add("TConv", _tconv(2 * nf, 4 * nf, 3, 1, 1, dtype=dtype))
        self.f3 = add("TConv", _tconv(4 * nf, 4 * nf, 3, 1, 1, dtype=dtype))
        self.f4 = add("ConvPixelShuffleReLU", ConvPixelShuffleReLU(4 * nf, 4 * nf, dtype=dtype))
        self.conv1 = add("TConv", _tconv(3, 2 * nf, 3, 1, 1, dtype=dtype))
        self.conv2 = add("TConv", _tconv(4 * nf, 4 * nf, 3, 1, 1, dtype=dtype))
        self.conv5 = add("TConv", _tconv(4 * nf, 4 * nf, 3, 1, 1, dtype=dtype))
        self.f5 = add("ConvPixelShuffleReLU", ConvPixelShuffleReLU(4 * nf, 2 * nf, dtype=dtype))
        self.up3 = add("ConvPixelShuffleReLU", ConvPixelShuffleReLU(8 * nf, 4 * nf, dtype=dtype))
        self.up2 = add("ConvPixelShuffleReLU", ConvPixelShuffleReLU(6 * nf, 2 * nf, dtype=dtype))
        self.up1 = (add("TorchConvTranspose", TorchConvTranspose(4 * nf, 64, 3, 1, 1, dtype=dtype))
                    if use_transpose else add("TConv", _tconv(4 * nf, 64, 3, 1, 1, dtype=dtype)))
        self.out = add("TConv", _tconv(64, 3, 3, 1, 1, dtype=dtype))

    def _prog_round(self, stream, guide):
        c1 = self.conv_only_1
        return c1(c1(stream)) * torch.sigmoid(self.bottleneck_sig(c1(guide)))

    def forward(self, x, metadata, train: bool = False):
        lr_f = self.shallow(x)
        att = _lrelu(self.attributes_dense(metadata.to(self.dtype)))
        att_f = self.shallow(att.reshape(-1, 3, 16, 16))  # (B, 768): channel-major
        f1 = _lrelu(self.f1(torch.cat([att_f, lr_f], dim=1)))
        f2 = _lrelu(self.f2(f1))
        f3 = _lrelu(self.f3(f2))
        f4 = _lrelu(self.f4(f3))
        conv2 = _lrelu(self.conv2(torch.cat([_lrelu(self.conv1(x)), f1], dim=1)))
        h = self.rddb(conv2)
        h = self.rddb(_lrelu(self.main_body_2(torch.cat([h, f2], dim=1))))
        h = self.rddb(_lrelu(self.main_body_2(torch.cat([h, f3], dim=1))))
        conv5 = _lrelu(self.conv5(h * 0.4 + conv2))
        up = _lrelu(self.up_wide(conv5))  # up_conv4_l, and up_conv4_without
        c1, c2 = self.conv_only_1, self.conv_only_2
        a1 = up + self._prog_round(up, f4)
        att1 = c1(c2(torch.cat([f4, a1], dim=1)))
        a2 = a1 + self._prog_round(a1, att1)
        att2 = c1(c2(torch.cat([att1, a2], dim=1)))
        a3 = a2 * self._prog_round(a2, att2) + up  # round 3 multiplies
        f4_a = a3 + att2
        f5 = _lrelu(self.f5(f4_a))
        f6 = self.up_narrow(f5)
        up3 = _lrelu(self.up3(torch.cat([a3, f4_a], dim=1)))
        up2 = _lrelu(self.up2(torch.cat([up3, f5], dim=1)))
        up1 = _lrelu(self.up1(torch.cat([up2, f6], dim=1)))
        return torch.tanh(self.out(up1))


class AGAGANDiscriminator(_Compact):
    """The attributes as a 3 x 16 x 16 map (Dense 768), two convs and a
    transposed conv to 32 x 32, concatenated with the image branch (3 x 3
    convs and 4 x 4 stride-2 'same' convs, leaky relu 0.25) at 32 x 32, more
    such convs to 8 x 8, Dense 1024 (leaky relu 0.2), Dense 1, a sigmoid."""

    def __init__(self, n_feats: int = 32, n_attributes: int = 38,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nf, na = n_feats, n_attributes
        self.dtype = dtype
        add = self._add
        self.attributes_dense = add("TDense", Linear(na, 768, dtype=dtype))
        self.att = nn.ModuleList([
            add("TConv", _tconv(3, nf, 3, 1, 1, dtype=dtype)),
            add("TConv", _tconv(nf, nf, 3, 1, 1, dtype=dtype)),
            add("TorchConvTranspose", TorchConvTranspose(nf, 2 * nf, 4, 2, 1, dtype=dtype))])
        self.image = nn.ModuleList([
            add("TConv", _tconv(3, nf, 3, 1, 1, dtype=dtype)),
            add("Conv2dSame", _conv_same(nf, nf, 4, 2, dtype=dtype)),
            add("TConv", _tconv(nf, nf, 3, 1, 1, dtype=dtype)),
            add("Conv2dSame", _conv_same(nf, 2 * nf, 4, 2, dtype=dtype))])
        self.body = nn.ModuleList([
            add("TConv", _tconv(4 * nf, 2 * nf, 3, 1, 1, dtype=dtype)),
            add("Conv2dSame", _conv_same(2 * nf, 4 * nf, 4, 2, dtype=dtype)),
            add("TConv", _tconv(4 * nf, 4 * nf, 3, 1, 1, dtype=dtype)),
            add("Conv2dSame", _conv_same(4 * nf, 3 * nf, 4, 2, dtype=dtype)),
            add("TConv", _tconv(3 * nf, 3 * nf, 3, 1, 1, dtype=dtype))])
        self.dense = nn.ModuleList([add("TDense", Linear(3 * nf * 64, 1024, dtype=dtype)),
                                    add("TDense", Linear(1024, 1, dtype=dtype))])

    def forward(self, x, metadata, train: bool = False, keep=None):
        a = _lrelu(self.attributes_dense(metadata.to(self.dtype))).reshape(-1, 3, 16, 16)
        for layer in self.att:
            a = _lrelu(layer(a))
        h = x
        for layer in self.image:
            h = _lrelu(layer(h))
        h = torch.cat([h, a], dim=1)
        for layer in self.body:
            h = _lrelu(layer(h))
        h = _lrelu(self.dense[0](_flatten_nchw(h)), 0.2)
        return torch.sigmoid(self.dense[1](h))


# ---------------------------------------------------------------------------
# FMFNet
# ---------------------------------------------------------------------------

class _ConvPReLU(_Compact):
    """A conv (k, padding, dilation) and a PReLU."""

    def __init__(self, in_features: int, ch: int, kernel: int = 3, pad: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = self._add("TConv", _tconv(in_features, ch, kernel, 1, pad, dilation,
                                              dtype=dtype))
        self.prelu = self._add("PRelu", PRelu())

    def forward(self, x):
        return self.prelu(self.conv(x))


class FMFBlock(_Compact):
    """Ten image encoders of a 16 x 16 face (conv-conv-pool or conv /
    stride-2 'same' conv stages at 3 x 3, 5 x 5, 7 x 7 and dilated 3 x 3),
    each to an attribute-sized vector; their outer products with the raw and
    two encoded attribute vectors, 30 (A, A) planes, and those planes
    re-weighted on the diagonal, ``(stack + eye) * (eye + 0.1)``; 1 x 1
    convs over the 60 planes give the global mean of a 4A expansion and a
    4A squeeze: a (B, 8A) vector."""

    def __init__(self, n_feats: int = 64, n_attributes: int = 40, in_features: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nf, na = n_feats, n_attributes
        self.dtype, self.n_attributes = dtype, na
        add = self._add
        self.encoders, self.heads, self._plans = nn.ModuleList(), nn.ModuleList(), []

        def encoder(kind, stages, kernel=3, pad=1, dil=1):
            layers, plan, cin, ch = nn.ModuleList(), [], in_features, nf
            for _ in range(stages):
                layers.append(add("_ConvPReLU", _ConvPReLU(cin, ch, kernel, pad, dil, dtype)))
                if kind == "pool":
                    layers.append(add("_ConvPReLU", _ConvPReLU(ch, ch, kernel, pad, dil, dtype)))
                    plan += ["layer", "layer", "pool"]
                    cin = ch
                else:
                    layers.append(add("Conv2dSame", _conv_same(ch, 2 * ch, 2, 2, dtype)))
                    layers.append(add("PRelu", PRelu()))
                    plan += ["layer", "layer", "layer"]
                    cin = 2 * ch
                ch *= 2
            side = 16 // 2 ** stages
            self.encoders.append(layers)
            self._plans.append(plan)
            self.heads.append(nn.ModuleList([
                add("TDense", Linear(cin * side * side, 4 * na, dtype=dtype)),
                add("PRelu", PRelu()), add("TDense", Linear(4 * na, na, dtype=dtype))]))

        encoder("pool", 3)
        encoder("stride", 3)
        for kernel, pad, dil in ((5, 2, 1), (7, 3, 1), (3, 2, 2), (3, 3, 3)):
            encoder("pool", 2, kernel, pad, dil)
            encoder("stride", 2, kernel, pad, dil)

        def attributes_encoder(widths):
            layers, cin = nn.ModuleList(), na
            for width in widths:
                layers.append(add("TDense", Linear(cin, width, dtype=dtype)))
                if width != na:
                    layers.append(add("PRelu", PRelu()))
                cin = width
            return layers

        self.m1 = attributes_encoder((4 * na, 8 * na, 4 * na, na))
        self.m2 = attributes_encoder((na // 2, na // 4, na // 2, na))
        self.expand = add("TConv", _tconv(60, 4 * na, 1, dtype=dtype))
        self.squeeze = nn.ModuleList([add("TConv", _tconv(4 * na, na, 1, dtype=dtype)),
                                      add("TConv", _tconv(na, na // 2, 1, dtype=dtype)),
                                      add("TConv", _tconv(na // 2, 1, 1, dtype=dtype))])
        self.squeeze_prelu = add("PRelu", PRelu())
        self.squeeze_dense = add("TDense", Linear(na * na, 4 * na, dtype=dtype))

    def forward(self, x, metadata):
        outs = []
        for plan, layers, head in zip(self._plans, self.encoders, self.heads):
            v, it = x, iter(layers)
            for op in plan:
                v = _maxpool(v) if op == "pool" else next(it)(v)
            outs.append(head[2](head[1](head[0](_flatten_nchw(v)))))
        m0 = metadata.to(self.dtype)
        m1, m2 = m0, m0
        for layer in self.m1:
            m1 = layer(m1)
        for layer in self.m2:
            m2 = layer(m2)
        stack = torch.stack([torch.einsum("bi,bj->bij", xv, mv)
                             for xv in outs for mv in (m0, m1, m2)], dim=1)  # (B, 30, A, A)
        eye = torch.eye(self.n_attributes, dtype=stack.dtype, device=stack.device)
        full = torch.cat([stack, (stack + eye) * (eye + 0.1)], dim=1)
        expanded = self.expand(full)
        sq = expanded
        for conv in self.squeeze:
            sq = conv(sq)
        sq = self.squeeze_dense(_flatten_nchw(self.squeeze_prelu(sq)))
        return torch.cat([expanded.mean(dim=(2, 3)), sq], dim=-1)


class ResidualDenseBlock4C(_Compact):
    """Four densely connected conv-PReLUs, ``skip_weight * last + x``."""

    def __init__(self, n_feats: int = 64, skip_weight: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip_weight = skip_weight
        self.convs = nn.ModuleList(self._add("_ConvPReLU", _ConvPReLU((i + 1) * n_feats, n_feats,
                                                                      dtype=dtype))
                                   for i in range(4))

    def forward(self, x):
        feats = [x]
        for conv in self.convs:
            feats.append(conv(torch.cat(feats, dim=1)))
        return feats[-1] * self.skip_weight + x


class _UpsampleBlock(_Compact):
    """FMFNet's up-block (one module, at every scale): 1 x 1 conv to 4 nf,
    PReLU, pixel shuffle x2, 1 x 1 to 2 nf, PReLU, a conv-PReLU, 1 x 1 to
    nf, PReLU."""

    def __init__(self, nf: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        add = self._add
        self.layers = nn.ModuleList([
            add("TConv", _tconv(nf, 4 * nf, 1, dtype=dtype)), add("PRelu", PRelu()),
            add("TConv", _tconv(nf, 2 * nf, 1, dtype=dtype)), add("PRelu", PRelu()),
            add("_ConvPReLU", _ConvPReLU(2 * nf, 2 * nf, dtype=dtype)),
            add("TConv", _tconv(2 * nf, nf, 1, dtype=dtype)), add("PRelu", PRelu())])

    def forward(self, v):
        v = pixel_shuffle(self.layers[1](self.layers[0](v)), 2)
        for layer in self.layers[2:]:
            v = layer(v)
        return v


class FMFResidualDenseNet(_Compact):
    """The FMF vector (``FMFBlock`` at 64 features, whatever ``n_feats``)
    drives a sigmoid meta-attention over the residual dense groups and the
    latent of three per-scale encoder-decoders (depth 3, 4, 5 at 16, 32 and
    64 pixels, to a 2 x 2 latent); the shared up-block takes 16 to 128."""

    def __init__(self, n_attributes: int = 40, n_feats: int = 64, skip_weight: float = 0.2,
                 use_meta_attention: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        nf, na = n_feats, n_attributes
        self.nf, self.use_meta_attention = nf, use_meta_attention
        add = self._add
        self.fmf = add("FMFBlock", FMFBlock(n_attributes=na, dtype=dtype))
        widths = (8 * na, 6 * na, 4 * na, 3 * na, 2 * na, nf)
        self.meta_att = nn.ModuleList(  # constructed by the JAX module either way
            add("TConv", _tconv(i, o, 1, dtype=dtype) if use_meta_attention else None)
            for i, o in zip(widths, widths[1:]))
        self.body = add("ResidualDenseBlock4C", ResidualDenseBlock4C(nf, skip_weight, dtype))
        self.head = add("_ConvPReLU", _ConvPReLU(3, nf, dtype=dtype))
        self.upsample_block = add("_UpsampleBlock", _UpsampleBlock(nf, dtype))
        self.latent_dense = add("TDense", Linear(16 * nf + 8 * na, 16 * nf, dtype=dtype))
        self.adapter = nn.ModuleList([add("TConv", _tconv(2 * nf, 2 * nf, 3, 1, 1, dtype=dtype)),
                                      add("TConv", _tconv(2 * nf, nf, 3, 1, 1, dtype=dtype)),
                                      add("TConv", _tconv(nf, nf, 3, 1, 1, dtype=dtype))])
        self.encoders, self.decoders = nn.ModuleList(), nn.ModuleList()
        for depth in (3, 4, 5):
            enc, cin = nn.ModuleList(), nf
            for d in range(depth):
                width = nf * min(2 ** d, 4)
                enc.append(add("_ConvPReLU", _ConvPReLU(cin, width, dtype=dtype)))
                enc.append(add("_ConvPReLU", _ConvPReLU(width, width, dtype=dtype)))
                cin = width
            dec, cin = nn.ModuleList(), 4 * nf
            for d in range(depth):
                ch = 4 * nf if d < depth - 2 else (2 * nf if d == depth - 2 else nf)
                dec.append(add("TorchConvTranspose", TorchConvTranspose(cin, ch, 2, 2, 0,
                                                                        dtype=dtype)))
                dec.append(add("_ConvPReLU", _ConvPReLU(ch, ch, dtype=dtype)))
                dec.append(add("_ConvPReLU", _ConvPReLU(ch, ch, dtype=dtype)))
                cin = ch
            self.encoders.append(enc)
            self.decoders.append(dec)
        self.tail = nn.ModuleList(add("_ConvPReLU", _ConvPReLU(nf, nf, dtype=dtype))
                                  for _ in range(2))
        self.out = add("TConv", _tconv(nf, 3, 1, dtype=dtype))

    def forward(self, x, metadata, train: bool = False):
        fmf = self.fmf(x, metadata)
        att = None
        if self.use_meta_attention:  # the same gate at each of its uses
            att = fmf[:, :, None, None]
            for i, conv in enumerate(self.meta_att):
                att = conv(att)
                att = torch.sigmoid(att) if i == len(self.meta_att) - 1 else torch.relu(att)

        def groups(v):
            for g in range(3):
                b = self.body(v)
                if att is not None and g < 2:
                    b = b * att
                b = self.body(b)
                if att is not None and g < 2:
                    b = b * att
                v = v + b * 0.2
            return v

        def enc_dec(v, enc, dec):
            h = v
            for i in range(0, len(enc), 2):
                h = _maxpool(enc[i + 1](enc[i](h)))
            h = self.latent_dense(torch.cat([_flatten_nchw(h), fmf], dim=-1))
            h = h.reshape(-1, 4 * self.nf, 2, 2)
            for layer in dec:
                h = layer(h)
            out = torch.cat([v, h], dim=1)
            for conv in self.adapter:
                out = conv(out)
            return self.body(out)

        h = self.head(x)
        for enc, dec in zip(self.encoders, self.decoders):
            h = self.upsample_block(enc_dec(groups(h), enc, dec))
        h = self.body(self.body(h))
        return self.out(self.tail[1](self.tail[0](h)))


class FMFDiscriminator(_Compact):
    """Six conv-PReLU-pool stages (nf, nf, 2nf, 2nf, 4nf, 4nf) from 128 to 2,
    Dense(8 nf), PReLU, Dense(1), a sigmoid. It takes no metadata."""

    def __init__(self, n_feats: int = 64, use_sigmoid: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nf = n_feats
        self.use_sigmoid = use_sigmoid
        widths = (nf, nf, 2 * nf, 2 * nf, 4 * nf, 4 * nf)
        self.convs = nn.ModuleList(self._add("_ConvPReLU", _ConvPReLU(i, o, dtype=dtype))
                                   for i, o in zip((3,) + widths, widths))
        self.dense = nn.ModuleList([self._add("TDense", Linear(4 * nf * 4, 8 * nf, dtype=dtype)),
                                    self._add("PRelu", PRelu()),
                                    self._add("TDense", Linear(8 * nf, 1, dtype=dtype))])

    def forward(self, x, metadata=None, train: bool = False, keep=None):
        h = x
        for conv in self.convs:
            h = _maxpool(conv(h))
        h = self.dense[2](self.dense[1](self.dense[0](_flatten_nchw(h))))
        return torch.sigmoid(h) if self.use_sigmoid else h


class FMFAttributeDiscriminator(_Compact):
    """Predicts the attribute vector from a 128 x 128 image: six stages of 2
    or 3 conv-PReLUs and a pool, Dense(8 nf), PReLU, Dense(A). Its sigmoid
    is never applied, as in the reference and the JAX package. Exposed; the
    handler does not use it."""

    def __init__(self, n_feats: int = 64, n_attributes: int = 40,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nf = n_feats
        self.stages = nn.ModuleList()
        cin = 3
        for width, n in ((nf, 2), (2 * nf, 2), (2 * nf, 2), (4 * nf, 3), (4 * nf, 3),
                         (8 * nf, 3)):
            self.stages.append(nn.ModuleList(
                self._add("_ConvPReLU", _ConvPReLU(cin if j == 0 else width, width, dtype=dtype))
                for j in range(n)))
            cin = width
        self.dense = nn.ModuleList([self._add("TDense", Linear(8 * nf * 4, 8 * nf, dtype=dtype)),
                                    self._add("PRelu", PRelu()),
                                    self._add("TDense", Linear(8 * nf, n_attributes,
                                                               dtype=dtype))])

    def forward(self, x, train: bool = False):
        h = x
        for stage in self.stages:
            for conv in stage:
                h = conv(h)
            h = _maxpool(h)
        return self.dense[2](self.dense[1](self.dense[0](_flatten_nchw(h))))


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

class AttributeGANHandler(BaseGANHandler):
    """The attribute-conditioned GAN handler (module docstring): a ``GANPair``
    of the architecture's generator and discriminator, ``metadata`` (default
    ``["all"]``: the 40 CelebA attributes) or ``metadata_bypass_len``
    values an image, ``n_feats`` (32 for FaceSR and AGA-GAN, 64 for FMFNet),
    x8 from 16 x 16."""

    uses_metadata = True
    colorspace = "rgb"
    im_input = "unmodified"
    gan_mode = "lsgan"
    arch = "facesrattributes"

    def __init__(self, metadata=None, metadata_bypass_len=None, n_feats=None, scale=8,
                 **kwargs):
        if metadata is None and metadata_bypass_len is None:
            metadata = ["all"]
        self.metadata_keys = list(metadata) if metadata else None
        self.num_metadata = compute_num_metadata(metadata, metadata_bypass_len)
        self._n_feats = n_feats
        super().__init__(scale=scale, **kwargs)

    # -- modules ---------------------------------------------------------------

    def build_module(self, nf, nb, gc):
        del nf, nb, gc  # the RRDB widths of the base GAN: unused
        return GANPair(self.build_generator(), self.build_discriminator())

    def build_generator(self) -> nn.Module:
        na, a = self.num_metadata, self.arch
        if a == "facesrattributes":
            return FaceSRAttributesGenerator(n_feats=self._n_feats or 32, n_attributes=na,
                                             dtype=self.dtype)
        if a == "agagan":
            return AGAGANGenerator(n_feats=self._n_feats or 32, n_attributes=na,
                                   dtype=self.dtype)
        if a == "fmf":
            return FMFResidualDenseNet(n_attributes=na, n_feats=self._n_feats or 64,
                                       dtype=self.dtype)
        raise KeyError(a)

    def build_discriminator(self) -> nn.Module:
        na, a = self.num_metadata, self.arch
        if a == "facesrattributes":
            return FaceSRAttributesDiscriminator(n_feats=self._n_feats or 32, n_attributes=na,
                                                 dtype=self.dtype)
        if a == "agagan":
            return AGAGANDiscriminator(n_feats=self._n_feats or 32, n_attributes=na,
                                       dtype=self.dtype)
        return FMFDiscriminator(n_feats=self._n_feats or 64, dtype=self.dtype)

    def handler_metadata(self):
        return {"metadata_keys_used_in_training": self.metadata_keys,
                "num_metadata": self.num_metadata}

    def select_metadata(self, metadata, keys=None):
        return select_metadata_columns(metadata, keys, self.metadata_keys)

    # -- state -----------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Fresh weights and optimizers. The base's train-mode pass of the
        discriminator on zeros is left out: these discriminators take the
        metadata and hold no statistics for it to advance."""
        state = BaseHandler.init_state(self, seed)
        self._optimizers = {}
        self._opt_counts = {k: 0 for k in self._opt_specs}
        return state

    def optax_targets(self):
        """The JAX handler's ``generator`` state is its ``tx``, which both
        phases update: the port's ``generator_pre``."""
        targets = super().optax_targets()
        return {"generator": targets["generator_pre"], "discriminator": targets["discriminator"]}

    def _jax_state_dict(self, loaded) -> Dict[str, torch.Tensor]:
        """A JAX checkpoint of this handler: ``params`` {generator,
        discriminator} and the BatchNorm statistics of each in
        ``extra.g_vars`` / ``extra.d_vars`` (FaceSR's generator has them)."""
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        extra = loaded.get("extra") or {}
        stats = {part: (extra.get(key) or {}).get("batch_stats")
                 for part, key in (("generator", "g_vars"), ("discriminator", "d_vars"))}
        stats = {k: v for k, v in stats.items() if v}
        return state_dict_from_jax(loaded["network"], self.module, batch_stats=stats or None)

    # -- forward ---------------------------------------------------------------

    def _generate(self, batch, train: bool):
        meta = batch.get("metadata")
        if meta is None:
            raise RuntimeError("Metadata needs to be specified for this network to run "
                               "properly.")
        lr = torch.as_tensor(batch["lr"], device=self.device)
        meta = torch.as_tensor(meta, device=self.device).float()
        sr = self.module.generator(lr.permute(0, 3, 1, 2), meta, train=train)
        return sr.permute(0, 2, 3, 1)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        """The generator in eval mode (whatever ``train``, as in the JAX
        handler)."""
        self._use_params(params)
        return self._generate(batch, train=False), {}, extra

    def _disc_call(self, img, meta, train: bool, keep=None):
        """The discriminator on an NHWC batch; FMFNet's without metadata."""
        meta = None if self.arch == "fmf" else meta
        return self.discriminator(img.permute(0, 3, 1, 2), meta, train=train, keep=keep)

    # -- train -----------------------------------------------------------------

    def draws(self, n: int) -> Dict[str, Tuple[torch.Tensor, ...]]:
        """A GAN step's draws from the handler's generator: the FaceSR
        discriminator's three dropout keep masks for its real and its fake
        call (none for the other two)."""
        d = self.discriminator
        if not isinstance(d, FaceSRAttributesDiscriminator):
            return {}
        g, dev = self.rng, self.device
        return {part: tuple(torch.rand(shape, generator=g, device=dev) < p
                            for shape, p in zip(d.mask_shapes(n), d.keep_probs))
                for part in ("keep_real", "keep_fake")}

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        self._use_params(state.params)
        batch = device_batch(batch, self.device)
        with torch.enable_grad():
            if self.curr_epoch < self.pretrain_epochs:
                losses = self._pretrain_step(batch)
            else:
                losses = self.step_from_draws(batch, self.draws(batch["hr"].shape[0]))
        return TrainState(step=int(state.step) + 1, params=state.params,
                          extra=state.extra), {k: v.detach() for k, v in losses.items()}

    def _pretrain_loss(self, batch):
        sr = self._generate(batch, train=True)
        return (sr.float() - batch["hr"].float()).abs().mean(), {}

    def step_from_draws(self, batch, draws) -> Dict[str, torch.Tensor]:
        """One adversarial step with the caller's dropout draws (``draws``):
        the generator's update against the discriminator in eval mode (fake,
        then real), then the discriminator's in train mode (real, then the
        detached fake). The generator's optimizer is the one of both
        phases."""
        hr = batch["hr"]
        meta = torch.as_tensor(batch["metadata"], device=self.device).float()
        with frozen(self.discriminator):
            sr = self._generate(batch, train=True)
            pixel = (sr.float() - hr.float()).abs().mean()
            pred_fake = self._disc_call(sr, meta, train=False)
            pred_real = self._disc_call(hr, meta, train=False)
            adv = self._adv_g_loss(pred_fake, pred_real.detach())
            if self.vgg_module is not None:
                gen_f = self.vgg_module(sr.permute(0, 3, 1, 2))
                with torch.no_grad():
                    real_f = self.vgg_module(hr.permute(0, 3, 1, 2))
                content = (gen_f.float() - real_f.float()).abs().mean()
            else:
                content = torch.zeros((), device=self.device)
            total = (self.lambda_vgg * content + self.lambda_adv * adv
                     + self.lambda_pixel * pixel)
            self._update("generator_pre", total)
        sr_detached = sr.detach()
        pred_real = self._disc_call(hr, meta, train=True, keep=draws.get("keep_real"))
        pred_fake = self._disc_call(sr_detached, meta, train=True, keep=draws.get("keep_fake"))
        loss_real, loss_fake = self._adv_d_loss(pred_fake, pred_real)
        self._update("discriminator", loss_real + loss_fake)
        train_loss = (self.lambda_vgg * content + self.lambda_pixel * pixel
                      + self.lambda_adv * adv)  # the JAX package's sum order
        losses = {"train-loss": train_loss, "l1-loss": pixel, "gan-loss": adv,
                  "vgg-loss": content, "d-loss-real": loss_real, "d-loss-fake": loss_fake}
        return {k: v.detach() for k, v in losses.items()}


@register_model("facesrattributesgan")
class FaceSRAttributesGANHandler(AttributeGANHandler):
    """FaceSR-Attributes-GAN: the STN generator and the dropout
    discriminator, both on the attributes."""
    arch = "facesrattributes"


@register_model("agagan")
class AGAGANHandler(AttributeGANHandler):
    """AGA-GAN: the RDDB generator with progressive attention and the
    attribute-map discriminator."""
    arch = "agagan"


@register_model("fmfnet")
class FMFNetHandler(AttributeGANHandler):
    """FMFNet: the FMF residual dense generator and an unconditional image
    discriminator (``FMFAttributeDiscriminator`` is exposed as a module)."""
    arch = "fmf"
