"""FSSR: frequency-separation SR (ESRGAN-FS and the DSGAN degradation
simulator).

Port of ``rumpy_tpu/models/fssr.py``. ESRGAN-FS is ESRGAN whose pixel loss
compares low-pass images and whose discriminator sees the high band only
(the ``_pixel_pair`` and ``_disc_input`` hooks of the GAN handler).
FSSR-DSGAN is a scale-1 GAN: an 8-block residual generator bounded by a
sigmoid and a high-pass discriminator with flax-style BatchNorm, trained
with w_col x the low-pass L1 and w_per x LPIPS against the generator's own
input, and w_tex x ``-log(D(fake) + 1e-8)``. The filters are average pools;
everything is cuDNN convs and PyTorch ops: the JAX package computes none of
it in a Pallas kernel, so no RCAB kernel runs.

As in the JAX package (whose note records that the torch original cannot
run its step), the discriminator is updated on detached fakes first, then
the generator through a fresh forward of the updated discriminator in eval
mode. Both updates are scaled by the epoch-linear factor ``_lr_factor``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.base import TrainState, optimizer_update
from rumpy_tpu_torch.models.common import BatchNorm, Conv
from rumpy_tpu_torch.models.contrastive import device_batch
from rumpy_tpu_torch.models.face_attribute_gans import PRelu
from rumpy_tpu_torch.models.gan_models import (ESRGANHandler, GANPair, PairedGANHandler,
                                               frozen)
from rumpy_tpu_torch.registry import register_model

# ---------------------------------------------------------------------------
# Frequency filters
# ---------------------------------------------------------------------------


def low_pass(x: torch.Tensor, kernel_size: int = 5, padding: bool = True,
             include_pad: bool = True) -> torch.Tensor:
    """:func:`filter_low` on (N, C, H, W)."""
    pad = (kernel_size - 1) // 2 if padding else 0
    return F.avg_pool2d(x, kernel_size, 1, pad, count_include_pad=include_pad)


def high_pass(x: torch.Tensor, kernel_size: int = 5, include_pad: bool = True,
              normalize: bool = True) -> torch.Tensor:
    """:func:`filter_high` on (N, C, H, W)."""
    hf = x - low_pass(x, kernel_size, include_pad=include_pad)
    return 0.5 + hf * 0.5 if normalize else hf


def filter_low(x: torch.Tensor, kernel_size: int = 5, padding: bool = True,
               include_pad: bool = True) -> torch.Tensor:
    """The k x k stride-1 average of NHWC images: zero padding of (k - 1) //
    2 counted in the mean, or not counted (``include_pad`` off), or none
    (``padding`` off: the map shrinks by k - 1)."""
    return low_pass(x.permute(0, 3, 1, 2), kernel_size, padding,
                    include_pad).permute(0, 2, 3, 1)


def filter_high(x: torch.Tensor, kernel_size: int = 5, include_pad: bool = True,
                normalize: bool = True) -> torch.Tensor:
    """NHWC images less their :func:`filter_low`, mapped to 0.5 + hf / 2
    (``normalize``)."""
    return high_pass(x.permute(0, 3, 1, 2), kernel_size, include_pad,
                     normalize).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# ESRGAN-FS
# ---------------------------------------------------------------------------

@register_model("esrganfs")
class ESRGANFSHandler(ESRGANHandler):
    """ESRGAN with frequency separation: the pixel L1 on the low band, the
    discriminator on the normalised high band (``use_filters``)."""

    def __init__(self, use_filters: bool = True, **kwargs):
        self.use_filters = use_filters
        super().__init__(**kwargs)

    def _pixel_pair(self, sr, hr):
        if self.use_filters:
            return filter_low(sr), filter_low(hr)
        return sr, hr

    def _disc_input(self, img):
        return filter_high(img) if self.use_filters else img


@register_model("fssr")
class FSSRHandler(ESRGANFSHandler):
    """``esrganfs`` under its older name."""


# ---------------------------------------------------------------------------
# DSGAN
# ---------------------------------------------------------------------------

class DSGANGenerator(nn.Module):
    """A 3x3 conv to 64 and a PReLU, ``n_res_blocks`` residual blocks
    (conv, PReLU, conv), a 3x3 conv to RGB, sigmoid in float32: the
    input's size."""

    def __init__(self, n_res_blocks: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head = Conv(3, 64, 3, dtype=dtype)
        self.head_act = PRelu()
        self.blocks = nn.ModuleList(
            nn.ModuleList([Conv(64, 64, 3, dtype=dtype), PRelu(), Conv(64, 64, 3, dtype=dtype)])
            for _ in range(n_res_blocks))
        self.tail = Conv(64, 3, 3, dtype=dtype)

    def forward(self, x):
        h = self.head_act(self.head(x))
        for c0, act, c1 in self.blocks:
            h = h + c1(act(c0(h)))
        return torch.sigmoid(self.tail(h).float())

    def flax_children(self):
        out = [("head", ("g00_conv",), self.head), ("head_act", ("g01_act",), self.head_act)]
        for i, block in enumerate(self.blocks):
            out += [(f"blocks.{i}.{j}", (f"r{i:02d}{tag}",), m)
                    for j, (tag, m) in enumerate(zip(("a_conv", "b_act", "c_conv"), block))]
        return out + [("tail", ("z_conv",), self.tail)]


class DSGANDiscriminator(nn.Module):
    """The high band (k 5, border windows averaged over their true count,
    normalised; ``highpass``), 5x5 convs to 64, 128 and 256 (BatchNorm after
    the last two), leaky relu 0.2, a 1x1 to one channel, sigmoid in
    float32."""

    def __init__(self, highpass: bool = True, kernel_size: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.highpass, self.kernel_size = highpass, kernel_size
        self.d0_conv = Conv(3, 64, 5, dtype=dtype)
        self.d1_conv = Conv(64, 128, 5, dtype=dtype)
        self.d2_bn = BatchNorm(128, dtype=dtype)
        self.d3_conv = Conv(128, 256, 5, dtype=dtype)
        self.d4_bn = BatchNorm(256, dtype=dtype)
        self.d5_conv = Conv(256, 1, 1, dtype=dtype)

    def forward(self, x, train: bool = False):
        if self.highpass:
            x = high_pass(x, self.kernel_size, include_pad=False)
        h = F.leaky_relu(self.d0_conv(x), 0.2)
        h = F.leaky_relu(self.d2_bn(self.d1_conv(h), train=train), 0.2)
        h = F.leaky_relu(self.d4_bn(self.d3_conv(h), train=train), 0.2)
        return torch.sigmoid(self.d5_conv(h).float())

    def flax_children(self):
        names = ("d0_conv", "d1_conv", "d2_bn", "d3_conv", "d4_bn", "d5_conv")
        return [(n, (n,), getattr(self, n)) for n in names]


@register_model("fssrdsgan")
class FSSRDSGANHandler(PairedGANHandler):
    """The DSGAN degradation simulator (module docstring): scale 1, the
    generator's input the batch's ``lr`` (or ``hr``). Its optimizer is an
    Adam at ``generator_lr`` with the handler's scheduler and clipping, the
    discriminator's an Adam at ``discriminator_lr``; ``set_epoch`` sets the
    factor both updates are scaled by. The LPIPS term needs an LPIPS npz
    (``lpips_weights``) unless ``use_perceptual_loss = false``."""

    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"
    eps = 1e-8

    def __init__(self, generator_lr=2e-4, discriminator_lr=2e-4, n_res_blocks=8, w_col=1.0,
                 w_tex=0.005, w_per=0.01, use_perceptual_loss: bool = True,
                 lpips_weights: Optional[str] = None,
                 global_scheduler: Optional[str] = "custom", ds_epochs: int = 300,
                 decay_epochs: int = 150, scale: int = 1, **kwargs):
        self.w_col, self.w_tex, self.w_per = w_col, w_tex, w_per
        self.use_perceptual_loss = use_perceptual_loss
        self.curr_epoch = 0
        self.global_scheduler = global_scheduler
        self.ds_epochs, self.decay_epochs = ds_epochs, decay_epochs
        if use_perceptual_loss and not lpips_weights:
            raise ValueError(
                "FSSR-DSGAN's perceptual loss needs converted LPIPS weights "
                "(lpips_weights=...); pass use_perceptual_loss=False to train without it "
                "(reference: loss_functions.py:96-160)")
        kwargs.pop("lr", None)
        super().__init__(scale=scale, lr=generator_lr, discriminator_lr=discriminator_lr,
                         n_res_blocks=n_res_blocks, **kwargs)
        self.lpips = None
        if use_perceptual_loss:
            from rumpy_tpu_torch.utils.lpips import LPIPS
            self.lpips = LPIPS(lpips_weights, device=self.device)

    def set_epoch(self, epoch: int) -> None:
        self.curr_epoch = epoch

    def _lr_factor(self) -> float:
        """1 until epoch ds_epochs - decay_epochs, then falling linearly to 0
        at ds_epochs (with the "custom" global scheduler)."""
        if self.global_scheduler != "custom":
            return 1.0
        start_decay = self.ds_epochs - self.decay_epochs
        e = self.curr_epoch
        if e < start_decay:
            return 1.0
        return 1.0 - max(0.0, float(e - start_decay) / self.decay_epochs)

    def build_module(self, n_res_blocks):
        return GANPair(DSGANGenerator(n_res_blocks, dtype=self.dtype),
                       DSGANDiscriminator(dtype=self.dtype))

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        x = torch.as_tensor(batch["lr"] if "lr" in batch else batch["hr"], device=self.device)
        return self.module.generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1), {}, extra

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        self._use_params(state.params)
        batch = device_batch(batch, self.device)
        with torch.enable_grad():
            losses = self._gan_step(state, batch, self._lr_factor())
        return TrainState(step=int(state.step) + 1, params=state.params,
                          extra=state.extra), {k: v.detach() for k, v in losses.items()}

    def _gan_step(self, state, batch, lr_factor: float):
        g, d, eps = self.module.generator, self.discriminator, self.eps
        x = batch["lr"].float().permute(0, 3, 1, 2)
        y = batch["hr"].float().permute(0, 3, 1, 2)
        with torch.no_grad():
            fakes = g(x)
        real = d(y, train=True)
        fake = d(fakes, train=True)
        d_loss = -torch.log(real + eps).mean() - torch.log(1 - fake + eps).mean()
        optimizer_update(self.d_optimizer(), d.parameters(), d_loss,
                         lr=(self._d_lr or self.lr) * lr_factor)
        with frozen(d):
            out = g(x)
            tex = -torch.log(d(out, train=False) + eps).mean()
            col = (low_pass(out, padding=False) - low_pass(x, padding=False)).abs().mean()
            loss = self.w_col * col + self.w_tex * tex
            per = torch.zeros((), device=self.device)
            if self.lpips is not None:
                per = self.lpips.distance(out.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1)).mean()
            if self.use_perceptual_loss:
                loss = loss + self.w_per * per
            optimizer_update(self.optimizer(), g.parameters(), loss, self.grad_clip,
                             self.schedule(int(state.step)) * lr_factor)
        return {"train-loss": loss, "generator-loss": loss, "discriminator-loss": d_loss,
                "color-loss": col, "texture-loss": tex, "perceptual-loss": per}
