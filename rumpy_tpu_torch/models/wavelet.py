"""WaveletSRNet and WaveletSRGAN: wavelet-domain face SR.

Port of ``rumpy_tpu/models/wavelet.py``. The network predicts the HR
image's wavelet-packet coefficients from the LR image: a BatchNorm residual
trunk (64 to 1024 channels), then one head a level, grouped 1/3/12/48/192;
the image comes back through the fixed orthonormal Haar packet basis. The
transforms are reshapes and one product with the +-1/ks basis, in float32;
everything else is cuDNN convs and PyTorch ops: the JAX package computes
none of it in a Pallas kernel, so no RCAB kernel runs.

Channels of a coefficient stack are filter-major (filter f, colour c at
f * 3 + c), so the LR band is channels 0-2. BatchNorm is flax's
(``common.BatchNorm``), applied to ``h + identity`` in the residual blocks,
the ReLU after it.

WaveletSRNet trains with 0.99 x the SR bands' MSE + 0.01 x the LR band's +
0.1 x the image's (the sum / 2N variant) + the texture hinge. WaveletSRGAN
trains with the bands' MSE until ``training_switch`` epochs (``set_epoch``),
then adds 10 x the LSGAN term of the wavelet discriminator (its sums
normalised by 2 (H + W), as written) and 10 x a LightCNN identity term, and
updates the discriminator on the detached prediction and the target's
decomposition. The identity term needs LightCNN weights
(``identity_weights``, an npz) unless ``include_id_loss = false``.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import true_div
from rumpy_tpu_torch.models.base import BaseHandler, TrainState, optimizer_update
from rumpy_tpu_torch.models.common import BatchNorm, Conv
from rumpy_tpu_torch.models.contrastive import device_batch
from rumpy_tpu_torch.models.gan_models import GANPair, PairedGANHandler, frozen
from rumpy_tpu_torch.registry import register_model

# ---------------------------------------------------------------------------
# Fixed wavelet packet basis
# ---------------------------------------------------------------------------

_HAAR2 = np.asarray([
    [[1., 1.], [1., 1.]],      # LL
    [[1., -1.], [1., -1.]],    # horizontal detail
    [[1., 1.], [-1., -1.]],    # vertical detail
    [[1., -1.], [-1., 1.]],    # diagonal detail
], np.float32)


@functools.lru_cache(maxsize=None)
def wavelet_basis(ks: int) -> np.ndarray:
    """(ks * ks, ks, ks) orthonormal packet filters: filter i is the
    Kronecker product of the 2x2 Haar patterns of i's base-4 digits (the
    least significant the coarsest level), over ks."""
    levels = int(math.log2(ks))
    if 2 ** levels != ks:
        raise ValueError(f"kernel size {ks} not a power of two")
    filters = []
    for i in range(ks * ks):
        f = np.ones((1, 1), np.float32)
        rem = i
        for _ in range(levels):
            f = np.kron(f, _HAAR2[rem % 4])
            rem //= 4
        filters.append(f / ks)
    return np.stack(filters)


@functools.lru_cache(maxsize=None)
def _device_basis(ks: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The (ks^2, ks^2) basis on ``device``, uploaded once: an upload
    inside a step would wait for the card."""
    return torch.from_numpy(wavelet_basis(ks).reshape(ks * ks, ks * ks)).to(device, dtype)


def _basis(ks: int, like: torch.Tensor) -> torch.Tensor:
    return _device_basis(ks, like.device, like.dtype)


def wavelet_dec(x: torch.Tensor, scale: int) -> torch.Tensor:
    """NHWC (N, H, W, 3) -> (N, H/ks, W/ks, ks^2 * 3), filter-major, in
    float32."""
    ks = scale
    n, h, w, c = x.shape
    blocks = x.float().reshape(n, h // ks, ks, w // ks, ks, c).permute(0, 1, 3, 5, 2, 4)
    coeffs = blocks.reshape(n, h // ks, w // ks, c, ks * ks) @ _basis(ks, blocks).t()
    return coeffs.transpose(3, 4).reshape(n, h // ks, w // ks, ks * ks * c)


def wavelet_rec(coeffs: torch.Tensor, scale: int) -> torch.Tensor:
    """The inverse of :func:`wavelet_dec` (the basis' transpose): NHWC
    coefficients -> (N, H ks, W ks, C) images, in float32."""
    ks = scale
    n, h, w, fc = coeffs.shape
    c = fc // (ks * ks)
    coeffs = coeffs.float().reshape(n, h, w, ks * ks, c).transpose(3, 4)
    blocks = (coeffs @ _basis(ks, coeffs)).reshape(n, h, w, c, ks, ks)
    return blocks.permute(0, 1, 4, 2, 5, 3).reshape(n, h * ks, w * ks, c)


def loss_mse_ref(x, y, size_average: bool = False):
    """The mean squared difference, or its sum over 2N (``size_average``
    off)."""
    z2 = (x - y) ** 2
    if size_average:
        return z2.mean()
    return true_div(z2.sum(), x.shape[0] * 2)


def loss_textures(x, y, nc: int = 3, alpha: float = 1.2, margin: float = 0.0):
    """The per-band energy hinge ``mean(relu(alpha |y_b|^2 - |x_b|^2 +
    margin))``, each band's energy summed over its ``nc`` colours (NHWC
    filter-major channels)."""
    xi = x.reshape(*x.shape[:3], -1, nc)
    yi = y.reshape(*y.shape[:3], -1, nc)
    return torch.relu((yi * yi).sum(-1) * alpha - (xi * xi).sum(-1) + margin).mean()


# ---------------------------------------------------------------------------
# Architecture
# ---------------------------------------------------------------------------

def _wconv(in_features, features, kernel, groups=1, use_bias=False, dtype=torch.float32):
    """A generator conv: normal(0, sqrt(2 / (k k features))) init."""
    return Conv(in_features, features, kernel, use_bias=use_bias, groups=groups, init="he_fanout",
                dtype=dtype)


class _ResidualBlockW(nn.Module):
    """A 1x1 skip where the channels change, two BatchNorm'd 3x3 convs
    (grouped by ``groups``), the second BatchNorm over ``h + identity``, a
    ReLU after it. ``interim``: the skip always, the first conv ungrouped."""

    def __init__(self, in_ch: int, out_ch: int, groups: int = 1, interim: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c0_skip = (_wconv(in_ch, out_ch, 1, dtype=dtype)
                        if interim or in_ch != out_ch else None)
        self.c1_conv = _wconv(in_ch, out_ch, 3, 1 if interim else groups, dtype=dtype)
        self.c2_bn = BatchNorm(out_ch, dtype=dtype)
        self.c3_conv = _wconv(out_ch, out_ch, 3, groups, dtype=dtype)
        self.c4_bn = BatchNorm(out_ch, dtype=dtype)

    def forward(self, x, train: bool = False):
        identity = x if self.c0_skip is None else self.c0_skip(x)
        h = torch.relu(self.c2_bn(self.c1_conv(x), train=train))
        return torch.relu(self.c4_bn(self.c3_conv(h) + identity, train=train))

    def flax_children(self):
        names = (() if self.c0_skip is None else ("c0_skip",)) + (
            "c1_conv", "c2_bn", "c3_conv", "c4_bn")
        return [(n, (n,), getattr(self, n)) for n in names]


# per-level head group counts
HEAD_GROUPS = (1, 3, 12, 48, 192)
TRUNK = ((64, 64), (64, 128), (128, 256), (256, 512), (512, 1024))


class WaveletSRNet(nn.Module):
    """The trunk (a BatchNorm'd 3x3 conv to 64, then ``num_layers_res``
    residual blocks a width up to 1024) and log2(scale) + 1 heads, each an
    interim block, a grouped residual block and a grouped 3x3 prediction of
    3 g coefficients. ``forward`` returns the image (N, 3, H ks, W ks), or
    (coefficients (N, 3 ks^2, H, W), image) with ``return_wavelets``."""

    def __init__(self, scale: int = 4, num_layers_res: int = 2, wavelet_c: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.a00_conv = _wconv(3, 64, 3, dtype=dtype)
        self.a01_bn = BatchNorm(64, dtype=dtype)
        blocks = []
        for inc, outc in TRUNK:
            blocks.append(_ResidualBlockW(inc, outc, dtype=dtype))
            blocks += [_ResidualBlockW(outc, outc, dtype=dtype) for _ in range(num_layers_res - 1)]
        self.trunk = nn.ModuleList(blocks)
        heads = []
        for level in range(int(math.log2(scale)) + 1):
            g = HEAD_GROUPS[level]
            heads.append(nn.ModuleList([
                _ResidualBlockW(1024, wavelet_c * g, g, interim=True, dtype=dtype),
                _ResidualBlockW(wavelet_c * g, wavelet_c * 2 * g, g, dtype=dtype),
                _wconv(wavelet_c * 2 * g, 3 * g, 3, g, use_bias=True, dtype=dtype)]))
        self.heads = nn.ModuleList(heads)

    def forward(self, x, train: bool = False, return_wavelets: bool = False):
        f = torch.relu(self.a01_bn(self.a00_conv(x), train=train))
        for block in self.trunk:
            f = block(f, train)
        outs = [pred(res(interim(f, train), train)) for interim, res, pred in self.heads]
        wavelets = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        img = wavelet_rec(wavelets.permute(0, 2, 3, 1), self.scale).permute(0, 3, 1, 2)
        return (wavelets, img) if return_wavelets else img

    def flax_children(self):
        out = [("a00_conv", ("a00_conv",), self.a00_conv), ("a01_bn", ("a01_bn",), self.a01_bn)]
        out += [(f"trunk.{i}", (f"b{i:02d}",), b) for i, b in enumerate(self.trunk)]
        for level, parts in enumerate(self.heads):
            out += [(f"heads.{level}.{j}", (f"h{level}{tag}",), m) for j, (tag, m) in enumerate(
                zip(("a_interim", "b_res", "c_pred"), parts))]
        return out


class WaveletDiscriminator(nn.Module):
    """A grouped stride-2 3x3 embedding of the 4^L wavelet groups (32 each),
    a grouped 3x3 to 256 each, both BatchNorm'd with leaky relu 0.01, the
    groups' 256 channels summed, a 3x3 prediction map of one channel."""

    END_C = 256

    def __init__(self, scale: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        wc = 4 ** int(math.log2(scale))
        self.wc = wc
        self.d0_conv = Conv(3 * wc, 32 * wc, 3, stride=2, padding=1, groups=wc, dtype=dtype)
        self.d1_bn = BatchNorm(32 * wc, dtype=dtype)
        self.d2_conv = Conv(32 * wc, self.END_C * wc, 3, groups=wc, dtype=dtype)
        self.d3_bn = BatchNorm(self.END_C * wc, dtype=dtype)
        self.d4_pred = Conv(self.END_C, 1, 3, dtype=dtype)

    def forward(self, x, train: bool = False):
        h = F.leaky_relu(self.d1_bn(self.d0_conv(x), train=train), 0.01)
        h = F.leaky_relu(self.d3_bn(self.d2_conv(h), train=train), 0.01)
        n, _, hh, ww = h.shape
        return self.d4_pred(h.reshape(n, self.wc, self.END_C, hh, ww).sum(dim=1))

    def flax_children(self):
        names = ("d0_conv", "d1_bn", "d2_conv", "d3_bn", "d4_pred")
        return [(n, (n,), getattr(self, n)) for n in names]


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

def wavelet_losses(wavelets, out, y, scale: int):
    """(LR band MSE, SR bands MSE, texture hinge, image MSE (sum / 2N),
    target decomposition) of NHWC coefficients ``wavelets``, image ``out``
    and HR ``y``."""
    target = wavelet_dec(y, scale)
    loss_lr = loss_mse_ref(wavelets[..., :3], target[..., :3], size_average=True)
    loss_sr = loss_mse_ref(wavelets[..., 3:], target[..., 3:], size_average=True)
    loss_tex = loss_textures(wavelets[..., 3:], target[..., 3:])
    loss_img = loss_mse_ref(out, y)
    return loss_lr, loss_sr, loss_tex, loss_img, target


@register_model("waveletsrnet")
class WaveletSRNetHandler(BaseHandler):
    """Loss 0.99 x SR bands + 0.01 x LR band + 0.1 x image + 1.0 x texture;
    a train step's forward advances the BatchNorm statistics."""

    loss_type = "l1"
    colorspace = "rgb"

    def __init__(self, num_layers_res=2, wavelet_c=32, **kwargs):
        super().__init__(num_layers_res=num_layers_res, wavelet_c=wavelet_c, **kwargs)

    def build_module(self, **kw):
        return WaveletSRNet(scale=self.scale, dtype=self.dtype, **kw)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        x = torch.as_tensor(batch["lr"], device=self.device).permute(0, 3, 1, 2)
        if train:
            wavelets, out = self.module(x, train=True, return_wavelets=True)
            return out.permute(0, 2, 3, 1), {"_wavelets": wavelets.permute(0, 2, 3, 1)}, extra
        return self.module(x).permute(0, 2, 3, 1), {}, extra

    def compute_losses(self, out, batch, aux):
        loss_lr, loss_sr, loss_tex, loss_img, _ = wavelet_losses(
            aux.pop("_wavelets").float(), out, batch["hr"].float(), self.scale)
        full = loss_sr * 0.99 + loss_lr * 0.01 + loss_img * 0.1 + loss_tex * 1.0
        return {"train-loss": full, "full_loss": full, "wavelet_lr_loss": loss_lr,
                "wavelet_hr_loss": loss_sr, "img_loss": loss_img, "texture_loss": loss_tex}


@register_model("waveletnet")
class WaveletNetHandler(WaveletSRNetHandler):
    """``waveletsrnet`` under its older name: ``nf`` and ``nb`` are ignored
    with a warning (the trunk is fixed)."""

    def __init__(self, nf=None, nb=None, **kwargs):
        if nf is not None or nb is not None:
            warnings.warn(
                "waveletnet's old nf/nb kwargs are ignored — the reference-exact "
                "WaveletSRNet has a fixed trunk (architectures.py:186-197)", stacklevel=2)
        super().__init__(**kwargs)


def cubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float64 weights of ``jax.image.resize(..., "cubic")``
    along one axis: Keys' cubic (a = -0.5) at half-pixel centres, widened
    by in / out when downscaling (antialias), each row normalised to sum
    1."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=np.float64)[None, :]) / kernel_scale
    w = np.where(x >= 2.0, 0.0, np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                                         ((1.5 * x - 2.5) * x) * x + 1.0))
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0)


@functools.lru_cache(maxsize=None)
def _device_cubic_matrix(in_size: int, out_size: int, device: torch.device,
                         dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(cubic_resize_matrix(in_size, out_size)).to(device, dtype)


def identity_preprocess(img: torch.Tensor, size: int = 128) -> torch.Tensor:
    """LightCNN's input: NHWC images resized to ``size`` x ``size`` as
    ``jax.image.resize(..., "cubic")`` does (a side already ``size`` is
    left as it is; each matrix uploaded once), then BT.601 grey, (N, size,
    size, 1)."""
    n, h, w, _ = img.shape
    r = img
    if h != size:
        r = torch.einsum("nhwc,oh->nowc", r, _device_cubic_matrix(h, size, img.device,
                                                                   img.dtype))
    if w != size:
        r = torch.einsum("nhwc,ow->nhoc", r, _device_cubic_matrix(w, size, img.device,
                                                                  img.dtype))
    gray = 0.299 * r[..., 0] + 0.587 * r[..., 1] + 0.114 * r[..., 2]
    return gray[..., None]


@register_model("waveletsrgan")
class WaveletSRGANHandler(PairedGANHandler):
    """WaveletSRNet with the wavelet discriminator (module docstring). The
    module is a ``GANPair``; the generator's optimizer is the handler's, the
    discriminator's an Adam at ``discriminator_lr`` (1e-4). Before
    ``training_switch`` epochs a step is the bands' MSE alone and the
    discriminator neither runs nor moves."""

    loss_type = "l1"
    colorspace = "rgb"

    def __init__(self, discriminator_lr=1e-4, training_switch=10,
                 identity_weights: Optional[str] = None, include_id_loss: bool = True,
                 num_layers_res=2, wavelet_c=32, **kwargs):
        self.training_switch = training_switch
        self.curr_epoch = 0
        self.include_id_loss = include_id_loss
        if include_id_loss and not identity_weights:
            raise ValueError(
                "WaveletSRGAN's identity loss needs converted LightCNN weights "
                "(identity_weights=...); pass include_id_loss=False to train without it "
                "(reference: handlers.py:85-89,115-118)")
        super().__init__(discriminator_lr=discriminator_lr, num_layers_res=num_layers_res,
                         wavelet_c=wavelet_c, **kwargs)
        self.identity_module = None
        if include_id_loss:
            from rumpy_tpu_torch.models.feature_extractors import LightCNNFeatures
            self.identity_module = LightCNNFeatures.from_npz(
                identity_weights, device=self.device, in_nc=1, dtype=self.dtype)

    def set_epoch(self, epoch: int) -> None:
        self.curr_epoch = epoch

    def build_module(self, **kw):
        return GANPair(WaveletSRNet(scale=self.scale, dtype=self.dtype, **kw),
                       WaveletDiscriminator(scale=self.scale, dtype=self.dtype))

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        x = torch.as_tensor(batch["lr"], device=self.device).permute(0, 3, 1, 2)
        return self.module.generator(x).permute(0, 2, 3, 1), {}, extra

    def identity_loss(self, y, out):
        """The LightCNN features' L1 (a mean) divided again by the features
        an image, the HR side without gradient."""
        with torch.no_grad():
            fy = self.identity_module(identity_preprocess(y).permute(0, 3, 1, 2))
        fo = self.identity_module(identity_preprocess(out).permute(0, 3, 1, 2))
        return true_div((fy.float() - fo.float()).abs().mean(), fy[0].numel())

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        self._use_params(state.params)
        batch = device_batch(batch, self.device)
        with torch.enable_grad():
            losses = self._gan_step(state, batch, self.curr_epoch >= self.training_switch)
        return TrainState(step=int(state.step) + 1, params=state.params,
                          extra=state.extra), {k: v.detach() for k, v in losses.items()}

    def _gan_step(self, state, batch, adversarial: bool):
        """The generator's update (its BatchNorm statistics advancing; the
        discriminator in eval mode on the prediction, without gradient to
        its parameters), then, when adversarial, the discriminator's on the
        detached prediction and the target (train mode, statistics chained
        fake then real)."""
        g, d = self.module.generator, self.discriminator
        y = batch["hr"].float()
        x = torch.as_tensor(batch["lr"]).permute(0, 3, 1, 2)
        target = wavelet_dec(y, self.scale)
        zero = torch.zeros((), device=self.device)
        with frozen(d):
            wavelets, out = g(x, train=True, return_wavelets=True)
            wavelets = wavelets.permute(0, 2, 3, 1).float()
            out = out.permute(0, 2, 3, 1)
            loss_lr = loss_mse_ref(wavelets[..., :3], target[..., :3], size_average=True)
            loss_sr = loss_mse_ref(wavelets[..., 3:], target[..., 3:], size_average=True)
            loss = loss_sr * 0.99 + loss_lr * 0.01
            adv = id_loss = zero
            if adversarial:
                fake = d(wavelets.permute(0, 3, 1, 2), train=False).float()
                adv = true_div(((fake - 1.0) ** 2).sum(), 2 * (fake.shape[2] + fake.shape[3]))
                if self.identity_module is not None:
                    id_loss = self.identity_loss(y, out)
                loss = loss + id_loss * 10.0 + adv * 10.0
            optimizer_update(self.optimizer(), g.parameters(), loss, self.grad_clip,
                             self.schedule(int(state.step)))
        dis_loss = zero
        if adversarial:
            fake = d(wavelets.detach().permute(0, 3, 1, 2), train=True).float()
            real = d(target.permute(0, 3, 1, 2), train=True).float()
            rs = 2 * (real.shape[2] + real.shape[3])
            dis_loss = true_div(((real - 1.0) ** 2).sum(), rs) + true_div((fake ** 2).sum(), rs)
            optimizer_update(self.d_optimizer(), d.parameters(), dis_loss)
        full = loss_sr * 0.99 + loss_lr * 0.01 + id_loss * 10.0 + adv * 10.0
        return {"train-loss": full, "full_loss": full, "wavelet_lr_loss": loss_lr,
                "wavelet_hr_loss": loss_sr, "id_loss": id_loss, "adv_loss": adv,
                "discrim_loss": dis_loss}
