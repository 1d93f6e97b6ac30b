"""GAN SR family: ESRGAN, BSRGAN, Real-ESRGAN and QRealESRGAN.

Port of ``rumpy_tpu/models/gan_models.py``. The generator is RRDBNet
(residual-in-residual dense blocks; QRRDBNet puts a ParaCALayer after every
RRDB), the discriminator a VGG-style net for 128 x 128 crops or the
spectral-norm U-Net of Real-ESRGAN. The JAX package computes none of them in
a Pallas kernel: here they are cuDNN convs and PyTorch ops.

``SNConv`` is flax's ``nn.SpectralNorm`` around a conv, not
``torch.nn.utils.spectral_norm``: the kernel is viewed as (kh*kw*cin, cout)
in the HWIO order, ``u`` (1, cout) and ``sigma`` are buffers (flax's
``batch_stats``), one power-iteration step ``v = l2n(u W^T)``,
``u = l2n(v W)`` with ``l2n(x) = x * rsqrt(sum(x^2) + 1e-12)`` runs on every
call, ``u`` and ``v`` carry no gradient and ``sigma = v W u^T`` does; the
kernel is divided by ``sigma`` where it is not 0, the bias is left alone,
and ``u``, ``sigma`` are written only when ``update_stats`` (train) is set.

The handler keeps three ``torch.optim`` optimizers, as the JAX handler
keeps three optax transforms: pre-train and main over the generator, and
the discriminator's, which shares the main scheduler. Each counts its own
updates for its schedule, as optax does. ``set_epoch`` picks the step: L1
pre-training (its own optimizer, the only one that clips) for the first
``pretrain_epochs``, then the adversarial step in the JAX order: the online
chain; the generator loss with the discriminator in train mode on HR, then
on SR (both calls advance its BatchNorm statistics and spectral-norm ``u``);
the generator update; the discriminator loss on HR, then on the detached
SR, from the state the generator pass left; the discriminator update. So
the discriminator's state advances four times a step. The discriminator's
parameters take no gradient in the generator pass: in PyTorch a backward of
the generator loss would otherwise write into their ``.grad``. A parameter
the loss does not reach gets a zero gradient, so Adam moves it as optax does.

The handler's module is a :class:`GANPair`: its state holds the generator,
the discriminator and its statistics, so checkpoints carry all of them, and
the three optimizers' states with their counts. Evaluation runs the
generator alone.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.attention_manipulators import (ParaCALayer, compute_num_metadata,
                                                           select_metadata_columns)
from rumpy_tpu_torch.models.base import (BaseHandler, OptaxTarget, TrainState,
                                         build_optimizer, build_schedule, optimizer_update)
from rumpy_tpu_torch.models.common import (BatchNorm, Conv, Linear, pixel_unshuffle,
                                           upsample_nearest)
from rumpy_tpu_torch.models.contrastive import device_batch
from rumpy_tpu_torch.registry import register_model


def _lrelu(v):
    return F.leaky_relu(v, 0.2)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

class ResidualDenseBlock(nn.Module):
    """Five densely connected 3x3 convs (RRDB's init), ``x + 0.2 * x5`` in
    the activation type."""

    def __init__(self, nf: int = 64, gc: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv(nf + i * gc, gc if i < 4 else nf, 3, dtype=dtype, init="rrdb")
            for i in range(5))

    def forward(self, x):
        feats = [x]
        for conv in self.convs[:4]:
            feats.append(_lrelu(conv(torch.cat(feats, dim=1))))
        return x + 0.2 * self.convs[4](torch.cat(feats, dim=1))

    def flax_children(self):
        return [(f"convs.{i}", (f"TConv_{i}",), c) for i, c in enumerate(self.convs)]


class RRDB(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(ResidualDenseBlock(nf, gc, dtype) for _ in range(3))

    def forward(self, x):
        h = x
        for block in self.blocks:
            h = block(h)
        return x + 0.2 * h

    def flax_children(self):
        return [(f"blocks.{i}", (f"ResidualDenseBlock_{i}",), b)
                for i, b in enumerate(self.blocks)]


class RRDBNet(nn.Module):
    """ESRGAN / Real-ESRGAN generator. Scales 2 and 1 pixel-unshuffle the
    input (by 2 and 4); scale 8 runs the first nearest upsample at x4. With
    ``num_metadata > 0`` (QRRDBNet) a ParaCALayer of the metadata gates the
    trunk after every RRDB."""

    def __init__(self, scale: int = 4, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 23, gc: int = 32, num_metadata: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.unshuffle = {2: 2, 1: 4}.get(scale)
        first_in = in_nc * (self.unshuffle ** 2 if self.unshuffle else 1)
        self.conv_first = Conv(first_in, nf, 3, dtype=dtype)
        self.trunk = nn.ModuleList(RRDB(nf, gc, dtype) for _ in range(nb))
        self.metas = (nn.ModuleList(ParaCALayer(nf, num_metadata, nonlinearity=True, dtype=dtype)
                                    for _ in range(nb)) if num_metadata > 0 else None)
        self.tail = nn.ModuleList(Conv(nf, nf, 3, dtype=dtype) for _ in range(4))
        self.conv_last = Conv(nf, out_nc, 3, dtype=dtype)

    def forward(self, x, metadata=None):
        if self.unshuffle:
            x = pixel_unshuffle(x, self.unshuffle)
        fea = self.conv_first(x)
        trunk = fea
        for i, block in enumerate(self.trunk):
            trunk = block(trunk)
            if self.metas is not None and metadata is not None:
                trunk = self.metas[i](trunk, metadata)
        fea = fea + self.tail[0](trunk)
        fea = _lrelu(self.tail[1](upsample_nearest(fea, 4 if self.scale == 8 else 2)))
        fea = _lrelu(self.tail[2](upsample_nearest(fea)))
        fea = _lrelu(self.tail[3](fea))
        return self.conv_last(fea)

    def flax_children(self):
        out = [("conv_first", ("TConv_0",), self.conv_first)]
        out += [(f"trunk.{i}", (f"RRDB_{i}",), b) for i, b in enumerate(self.trunk)]
        if self.metas is not None:
            out += [(f"metas.{i}", (f"ParaCALayer_{i}",), m) for i, m in enumerate(self.metas)]
        out += [(f"tail.{i}", (f"TConv_{i + 1}",), c) for i, c in enumerate(self.tail)]
        return out + [("conv_last", ("TConv_5",), self.conv_last)]


QRRDBNet = RRDBNet  # meta-injection engaged by num_metadata > 0


# ---------------------------------------------------------------------------
# Spectral norm and discriminators
# ---------------------------------------------------------------------------

def _l2_normalize(x, eps: float = 1e-12):
    return x * torch.rsqrt((x * x).sum() + eps)


class SNConv(nn.Module):
    """A conv under flax's ``nn.SpectralNorm`` (module docstring). Its
    kernel and bias are the flax ``TConv_<index>``'s params, ``u`` and
    ``sigma`` the ``batch_stats`` leaves ``SpectralNorm_<sn_index>/
    TConv_<index>/kernel/{u,sigma}``: the module sits at its
    discriminator's flax path."""

    def __init__(self, in_features: int, features: int, kernel_size: int, stride: int,
                 index: int, sn_index: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(in_features, features, kernel_size, stride=stride, flax_same=True,
                         dtype=dtype)
        self.register_buffer("u", torch.zeros(1, features))
        self.register_buffer("sigma", torch.ones(()))
        self.index = index
        leaf = f"TConv_{index}/kernel/"
        self.flax_leaves = {"u": ("batch_stats", (f"SpectralNorm_{sn_index}", leaf + "u")),
                            "sigma": ("batch_stats", (f"SpectralNorm_{sn_index}", leaf + "sigma"))}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.u.copy_(torch.randn(self.u.shape, generator=generator))
        self.sigma.fill_(1.0)

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        w = self.conv.weight
        m = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])  # flax's (kh*kw*cin, cout)
        with torch.no_grad():
            md = m.detach()
            v = _l2_normalize((md * self.u).sum(1))  # u W^T: (K,)
            u = _l2_normalize((md * v[:, None]).sum(0))  # v W: (cout,)
        sigma = ((m * v[:, None]).sum(0) * u).sum()  # v W u^T, with W's gradient
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u[None])
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x, update_stats: bool = False):
        return self.conv(x, weight=self.normalized_weight(update_stats))

    def flax_children(self):
        return [("conv", (f"TConv_{self.index}",), self.conv)]


class VGGStyleDiscriminator128(nn.Module):
    """Strided-conv VGG-style discriminator for 128 x 128 crops: ten convs
    (4x4 stride 2 with flax's 'SAME' padding at the odd ones), flax-style
    BatchNorm after all but the first, a flatten in torch's CHW order, then
    Dense(100) and Dense(1)."""

    size = 128

    def __init__(self, nf: int = 64, in_nc: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        feats = [nf, nf, nf * 2, nf * 2, nf * 4, nf * 4, nf * 8, nf * 8, nf * 8, nf * 8]
        ins = [in_nc] + feats[:-1]
        self.convs = nn.ModuleList(
            Conv(i, f, 4 if k % 2 else 3, stride=2 if k % 2 else 1, use_bias=(k == 0),
                 flax_same=True, dtype=dtype)
            for k, (i, f) in enumerate(zip(ins, feats)))
        self.norms = nn.ModuleList(BatchNorm(f, momentum=0.9, dtype=dtype) for f in feats[1:])
        self.dense = nn.ModuleList([Linear(nf * 8 * 4 * 4, 100, dtype=dtype),
                                    Linear(100, 1, dtype=dtype)])

    def forward(self, x, train: bool = False):
        for k, conv in enumerate(self.convs):
            x = conv(x)
            if k > 0:
                x = self.norms[k - 1](x, train=train)
            x = _lrelu(x)
        x = _lrelu(self.dense[0](x.flatten(1)))  # NCHW flattened: torch's order
        return self.dense[1](x)

    def flax_children(self):
        return ([(f"convs.{i}", (f"TConv_{i}",), c) for i, c in enumerate(self.convs)]
                + [(f"norms.{i}", (f"BatchNorm_{i}",), n) for i, n in enumerate(self.norms)]
                + [(f"dense.{i}", (f"TDense_{i}",), d) for i, d in enumerate(self.dense)])


class UNetDiscriminatorSN(nn.Module):
    """Real-ESRGAN's U-Net discriminator: a plain first and last conv, eight
    spectral-norm convs (three 4x4 stride-2 downs, three 3x3 ups after
    nearest x2 upsampling with skip adds, two more 3x3)."""

    size = 64

    def __init__(self, nf: int = 64, in_nc: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_first = Conv(in_nc, nf, 3, dtype=dtype)
        spec = [(nf, nf * 2, 4, 2), (nf * 2, nf * 4, 4, 2), (nf * 4, nf * 8, 4, 2),
                (nf * 8, nf * 4, 3, 1), (nf * 4, nf * 2, 3, 1), (nf * 2, nf, 3, 1),
                (nf, nf, 3, 1), (nf, nf, 3, 1)]
        self.sn = nn.ModuleList(SNConv(i, o, k, s, index=j + 1, sn_index=j, dtype=dtype)
                                for j, (i, o, k, s) in enumerate(spec))
        self.conv_last = Conv(nf, 1, 3, dtype=dtype)

    def forward(self, x, train: bool = True):
        sn = self.sn
        x0 = _lrelu(self.conv_first(x))
        x1 = _lrelu(sn[0](x0, train))
        x2 = _lrelu(sn[1](x1, train))
        x3 = _lrelu(sn[2](x2, train))
        u = _lrelu(sn[3](upsample_nearest(x3), train)) + x2
        u = _lrelu(sn[4](upsample_nearest(u), train)) + x1
        u = _lrelu(sn[5](upsample_nearest(u), train)) + x0
        out = _lrelu(sn[6](u, train))
        out = _lrelu(sn[7](out, train))
        return self.conv_last(out)

    def flax_children(self):
        return ([("conv_first", ("TConv_0",), self.conv_first)]
                + [(f"sn.{i}", (), s) for i, s in enumerate(self.sn)]
                + [("conv_last", ("TConv_9",), self.conv_last)])


class GANPair(nn.Module):
    """The generator and the discriminator as one module (the JAX state's
    ``params["generator"]`` / ``params["discriminator"]``), so that one
    state dict holds both."""

    def __init__(self, generator: nn.Module, discriminator: nn.Module):
        super().__init__()
        self.generator = generator
        self.discriminator = discriminator

    def flax_children(self):
        return [("generator", ("generator",), self.generator),
                ("discriminator", ("discriminator",), self.discriminator)]


@contextlib.contextmanager
def frozen(module: nn.Module):
    """``module``'s parameters without gradients inside the block (the
    inputs' gradients still flow through it)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

class PairedGANHandler(BaseHandler):
    """A handler whose module is a ``GANPair`` with two optimizers, as the
    JAX handlers' ``tx`` and ``d_tx``: the handler's own (its lr, scheduler
    and clipping) over the generator, and an Adam at ``discriminator_lr``
    (default the handler's lr) without a schedule over the discriminator.
    A JAX checkpoint's BatchNorm statistics are its ``extra["g_bstats"]``
    and ``extra["d_bstats"]``, where present."""

    def __init__(self, discriminator_lr=None, **kwargs):
        self._d_lr = discriminator_lr
        self._d_optimizer = None
        super().__init__(**kwargs)

    @property
    def discriminator(self) -> nn.Module:
        return self.module.discriminator

    def trainable_parameters(self):
        return self.module.generator.parameters()

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        self._d_optimizer = None
        return super().init_state(seed)

    def d_optimizer(self) -> torch.optim.Optimizer:
        if self._d_optimizer is None:
            self._d_optimizer = build_optimizer(self.discriminator.parameters(),
                                                self._d_lr or self.lr)
        return self._d_optimizer

    def optimizer_state(self):
        if self._optimizer is None and self._d_optimizer is None:
            return None
        return {"generator": None if self._optimizer is None else self._optimizer.state_dict(),
                "discriminator": (None if self._d_optimizer is None
                                  else self._d_optimizer.state_dict())}

    def load_optimizer_state(self, saved) -> None:
        self._optimizer = self._d_optimizer = None
        if saved is None:
            return
        if saved.get("generator") is not None:
            self.optimizer().load_state_dict(saved["generator"])
        if saved.get("discriminator") is not None:
            self.d_optimizer().load_state_dict(saved["discriminator"])

    def optax_targets(self):
        """The JAX handlers' ``tx`` (the handler's clipping) and ``d_tx``."""
        return {"generator": OptaxTarget(self.optimizer, "generator", self.grad_clip is not None),
                "discriminator": OptaxTarget(self.d_optimizer, "discriminator", False)}

    def _jax_state_dict(self, loaded):
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        extra = loaded.get("extra") or {}
        stats = {part: extra[key] for part, key in (("generator", "g_bstats"),
                                                    ("discriminator", "d_bstats"))
                 if extra.get(key)}
        return state_dict_from_jax(loaded["network"], self.module, batch_stats=stats or None)


def _bce(logits, target: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


class BaseGANHandler(BaseHandler):
    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"
    gan_mode = "lsgan"  # 'relativistic' or 'bce'
    discriminator_type = "vgg128"

    def __init__(self, pretrain_epochs=0, lambda_adv=5e-3, lambda_pixel=1e-2,
                 lambda_vgg=1.0, vgg_weights=None, vgg_layer="conv5_4",
                 discriminator=None, d_lr=None, nf=64, nb=23, gc=32,
                 d_nf=64, main_lr=None, main_scheduler=None,
                 main_scheduler_params=None, main_optimizer_params=None,
                 pretrain_lr=None, pre_train_optimizer_params=None,
                 pre_train_scheduler=None, pre_train_scheduler_params=None,
                 discriminator_lr=None, discriminator_optimizer_params=None,
                 **kwargs):
        self.pretrain_epochs = pretrain_epochs
        self.lambda_adv = lambda_adv
        self.lambda_pixel = lambda_pixel
        # the perceptual term needs pretrained VGG weights; zero without them
        self.lambda_vgg = lambda_vgg if vgg_weights else 0.0
        self.vgg_weights = vgg_weights
        self.discriminator_type = discriminator or self.discriminator_type
        self.curr_epoch = 0
        self.d_nf = d_nf
        d_lr = discriminator_lr if discriminator_lr is not None else d_lr
        super().__init__(nf=nf, nb=nb, gc=gc, **kwargs)
        # the pre-train optimizer: the handler's lr, scheduler and clipping,
        # unless the pre_train_* spelling rebuilds it (without clipping)
        pre = (self.lr, self.scheduler, self.scheduler_params, self.optimizer_params,
               self.grad_clip)
        if (pretrain_lr is not None or pre_train_optimizer_params
                or pre_train_scheduler):
            pre = (pretrain_lr if pretrain_lr is not None else self.lr, pre_train_scheduler,
                   pre_train_scheduler_params, pre_train_optimizer_params, None)
        main = (main_lr or self.lr, main_scheduler, main_scheduler_params,
                main_optimizer_params, None)
        # the discriminator shares the MAIN scheduler
        disc = (d_lr or self.lr, main_scheduler, main_scheduler_params,
                discriminator_optimizer_params, None)
        self._opt_specs = {"generator_pre": pre, "generator": main, "discriminator": disc}
        self._schedules = {k: build_schedule(lr, sched, sp)
                           for k, (lr, sched, sp, _, _) in self._opt_specs.items()}
        self._optimizers: Dict[str, torch.optim.Optimizer] = {}
        self._opt_counts = {k: 0 for k in self._opt_specs}
        self.vgg_module = None
        if vgg_weights:
            from rumpy_tpu_torch.models.feature_extractors import VGG19Features
            self.vgg_module = VGG19Features.from_npz(vgg_weights, tap=vgg_layer,
                                                     dtype=self.dtype, device=self.device)
        # RRDB heads pixel-unshuffle at scales below 4: eval inputs must divide this
        self.size_multiple = {1: 4, 2: 2}.get(self.scale, 1)

    @property
    def discriminator(self) -> nn.Module:
        return self.module.discriminator

    def build_module(self, nf, nb, gc, **kw):
        return GANPair(self.build_generator(nf=nf, nb=nb, gc=gc, **kw),
                       self.build_discriminator())

    def build_generator(self, nf, nb, gc):
        return RRDBNet(scale=self.scale, nf=nf, nb=nb, gc=gc, dtype=self.dtype)

    def build_discriminator(self) -> nn.Module:
        if self.discriminator_type in ("vgg128", "vgg"):
            return VGGStyleDiscriminator128(nf=self.d_nf, dtype=self.dtype)
        return UNetDiscriminatorSN(nf=self.d_nf, dtype=self.dtype)

    def set_epoch(self, epoch: int) -> None:
        self.curr_epoch = epoch

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Fresh weights and optimizers; then, as flax's ``init`` of the
        discriminator does, one train-mode pass of it on zeros (1, s, s, 3),
        s 128 for VGG-128 and 64 for the U-Net: a power-iteration step on
        every ``u`` and one BatchNorm statistics update."""
        state = super().init_state(seed)
        self._optimizers = {}
        self._opt_counts = {k: 0 for k in self._opt_specs}
        d = self.discriminator
        with torch.no_grad():
            d(torch.zeros(1, 3, d.size, d.size, device=self.device), train=True)
        return state

    def _opt(self, name: str) -> torch.optim.Optimizer:
        if name not in self._optimizers:
            lr, _, _, op, _ = self._opt_specs[name]
            part = self.discriminator if name == "discriminator" else self.module.generator
            self._optimizers[name] = build_optimizer(
                part.parameters(), lr, self.optimizer_type,
                scheduler_params=self._opt_specs[name][2], optimizer_params=op)
        return self._optimizers[name]

    def optimizer_state(self):
        if not self._optimizers:
            return None
        return {"optimizers": {k: o.state_dict() for k, o in self._optimizers.items()},
                "counts": dict(self._opt_counts)}

    def load_optimizer_state(self, saved) -> None:
        self._optimizers = {}
        self._opt_counts = {k: 0 for k in self._opt_specs}
        if saved is None:
            return
        for name, sd in saved["optimizers"].items():
            self._opt(name).load_state_dict(sd)
        self._opt_counts.update({k: int(v) for k, v in saved["counts"].items()})

    def optax_targets(self):
        """The JAX handler's ``generator`` (``main_tx``), ``discriminator``
        and, while a pre-train phase exists, ``generator_pre`` (``tx``)."""
        return {name: OptaxTarget(lambda name=name: self._opt(name),
                                  "discriminator" if name == "discriminator" else "generator",
                                  spec[4] is not None, name)
                for name, spec in self._opt_specs.items()}

    def set_optax_counts(self, counts) -> None:
        self._opt_counts.update(counts)

    def _jax_state_dict(self, loaded) -> Dict[str, torch.Tensor]:
        """A JAX GAN checkpoint: ``params`` {generator, discriminator} and
        the discriminator's ``extra.d_vars.batch_stats`` (BatchNorm
        statistics or spectral-norm ``u``/``sigma``)."""
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        stats = ((loaded.get("extra") or {}).get("d_vars") or {}).get("batch_stats")
        return state_dict_from_jax(loaded["network"], self.module,
                                   batch_stats={"discriminator": stats} if stats else None)

    # -- forward -------------------------------------------------------------

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        sr = self.module.generator(lr.permute(0, 3, 1, 2))
        return sr.permute(0, 2, 3, 1), {}, extra

    def _disc(self, img, train: bool = True):
        """The discriminator on an NHWC image batch."""
        return self.discriminator(self._disc_input(img).permute(0, 3, 1, 2), train=train)

    # -- hooks ---------------------------------------------------------------

    def _pixel_pair(self, sr, hr):
        """The images the pixel loss compares (identity by default)."""
        return sr, hr

    def _disc_input(self, img):
        """The image the discriminator sees (identity by default)."""
        return img

    def _adv_g_loss(self, pred_fake, pred_real):
        pred_fake, pred_real = pred_fake.float(), pred_real.float()
        if self.gan_mode == "bce":
            return _bce(pred_fake, 1.0)
        if self.gan_mode == "relativistic":
            real_rel = pred_real - pred_fake.mean()
            fake_rel = pred_fake - pred_real.mean()
            return 0.5 * (_bce(fake_rel, 1.0) + _bce(real_rel, 0.0))
        return ((pred_fake - 1.0) ** 2).mean()

    def _adv_d_loss(self, pred_fake, pred_real):
        pred_fake, pred_real = pred_fake.float(), pred_real.float()
        if self.gan_mode == "bce":
            return _bce(pred_real, 1.0), _bce(pred_fake, 0.0)
        if self.gan_mode == "relativistic":
            # the whole fake prediction is detached: D's gradient flows
            # through pred_real only
            pred_fake = pred_fake.detach()
            real_rel = pred_real - pred_fake.mean()
            fake_rel = pred_fake - pred_real.mean()
            return 0.5 * _bce(real_rel, 1.0), 0.5 * _bce(fake_rel, 0.0)
        return ((pred_real - 1.0) ** 2).mean(), (pred_fake ** 2).mean()

    def _generator_outputs(self, batch):
        """(sr, pixel term, extra losses) of the generator update; the DAN
        conjugation's pixel term is its image + kernel loss."""
        sr, _, _ = self.apply(self._state_params, batch, train=True)
        pp_sr, pp_hr = self._pixel_pair(sr, batch["hr"])
        return sr, (pp_sr.float() - pp_hr.float()).abs().mean(), {}

    def _pretrain_loss(self, batch):
        """(loss, extra losses) of the L1 pre-training phase."""
        sr, _, _ = self.apply(self._state_params, batch, train=True)
        return (sr.float() - batch["hr"].float()).abs().mean(), {}

    # -- train ---------------------------------------------------------------

    def _update(self, name: str, loss) -> None:
        """An update of optimizer ``name`` from ``loss`` (``optimizer_update``:
        the pre-train optimizer's clipping, the lr of this optimizer's own
        step count)."""
        opt = self._opt(name)
        optimizer_update(opt, (p for g in opt.param_groups for p in g["params"]), loss,
                         self._opt_specs[name][4], self._schedules[name](self._opt_counts[name]))
        self._opt_counts[name] += 1

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        self._use_params(state.params)
        batch = device_batch(batch, self.device)
        if self.input_fn is not None:  # the online degradation chain
            with torch.no_grad():
                batch = self.input_fn(self.rng, batch)
        with torch.enable_grad():
            if self.curr_epoch < self.pretrain_epochs:
                losses = self._pretrain_step(batch)
            else:
                losses = self._gan_step(batch)
        return TrainState(step=int(state.step) + 1, params=state.params,
                          extra=state.extra), {k: v.detach() for k, v in losses.items()}

    def _pretrain_step(self, batch):
        loss, extras = self._pretrain_loss(batch)
        self._update("generator_pre", loss)
        z = torch.zeros((), device=self.device)
        return {"train-loss": loss, "l1-loss": loss, "gan-loss": z, "vgg-loss": z,
                "d-loss-real": z, "d-loss-fake": z, **extras}

    def _gan_step(self, batch):
        hr = batch["hr"]
        # generator update: D in train mode (batch statistics, state
        # advancing: HR first, then SR), its parameters without gradients
        with frozen(self.discriminator):
            sr, pixel, g_extras = self._generator_outputs(batch)
            pred_real = self._disc(hr)
            pred_fake = self._disc(sr)
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
            self._update("generator", total)
        # discriminator update, from the state the generator pass left
        sr_detached = sr.detach()
        pred_real = self._disc(hr)
        pred_fake = self._disc(sr_detached)
        loss_real, loss_fake = self._adv_d_loss(pred_fake, pred_real)
        self._update("discriminator", loss_real + loss_fake)
        train_loss = (self.lambda_vgg * content + self.lambda_pixel * pixel
                      + self.lambda_adv * adv).detach()  # the JAX package's sum order
        return {"train-loss": train_loss, "l1-loss": pixel, "gan-loss": adv,
                "vgg-loss": content,
                "d-loss-real": loss_real, "d-loss-fake": loss_fake, **g_extras}


@register_model("esrgan")
class ESRGANHandler(BaseGANHandler):
    """ESRGAN: RRDB generator, VGG-128 discriminator, relativistic GAN after
    L1 pre-training."""
    gan_mode = "relativistic"
    discriminator_type = "vgg128"

    def __init__(self, pretrain_epochs=5, **kwargs):
        super().__init__(pretrain_epochs=pretrain_epochs, **kwargs)


@register_model("bsrgan")
class BSRGANHandler(BaseGANHandler):
    gan_mode = "lsgan"
    discriminator_type = "unet_sn"


@register_model("realesrgan")
class RealESRGANHandler(BaseGANHandler):
    """Real-ESRGAN: the U-Net SN discriminator; its degradations come from
    the online chain."""
    gan_mode = "lsgan"
    discriminator_type = "unet_sn"


@register_model("qrealesrgan")
class QRealESRGANHandler(BaseGANHandler):
    """Meta-attention Real-ESRGAN (QRRDBNet): degradation metadata gates the
    trunk through ParaCALayers."""
    gan_mode = "lsgan"
    discriminator_type = "unet_sn"
    uses_metadata = True

    def __init__(self, metadata=None, metadata_bypass_len=None, **kwargs):
        self.metadata_keys = list(metadata) if metadata else ["qpi"]
        self.num_metadata = compute_num_metadata(self.metadata_keys, metadata_bypass_len)
        super().__init__(**kwargs)

    def build_generator(self, nf, nb, gc):
        return RRDBNet(scale=self.scale, nf=nf, nb=nb, gc=gc, num_metadata=self.num_metadata,
                       dtype=self.dtype)

    def example_inputs(self, batch: int = 1, size: int = 16):
        return (torch.zeros((batch, size, size, self.in_features), device=self.device),
                torch.zeros((batch, self.num_metadata), device=self.device))

    def select_metadata(self, metadata, keys=None):
        return select_metadata_columns(metadata, keys, self.metadata_keys)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        meta = torch.as_tensor(batch["metadata"], device=self.device).float()
        sr = self.module.generator(lr.permute(0, 3, 1, 2), meta)
        return sr.permute(0, 2, 3, 1), {}, extra
