"""DAN (Deep Alternating Network) blind SR.

Port of ``rumpy_tpu/models/dan.py``. An Estimator predicts the
(PCA-encoded) blur kernel from (SR, LR); a Restorer conditions on the
kernel code to super-resolve; the two alternate for ``loop`` iterations,
the Estimator seeing the SR detached and the Restorer the code detached.

The loss keeps the JAX package's quirk: every iteration's image and kernel
L1 is logged, but the optimised loss is the LAST iteration's image L1 +
kernel L1. So a gradient reaches the Restorer only through the last SR and
the Estimator only through the last estimate, and a train step runs the
iterations before the last without autograd (the same gradients, none of
their activations kept).

``mode``: ``v1`` (the Restorer of conditional residual blocks), ``v2``
(DANv2: dual-path blocks, the Estimator emits the full softmaxed kernel,
PCA-projected by a fixed matrix to the code the Restorer takes) and
``v1QRCAN``, whose Restorer is QRCAN fed the code as its metadata vector
(its 200 blocks on the RCAB kernels; float32, as in the JAX package), and
``v1QHAN`` with QHAN in its place. ``v1QELAN`` is refused: the JAX
package's DAN keeps no BatchNorm statistics, so its QELAN fails at the
first forward there (ROADMAP.md section 3). DAN's ``init_ker_map`` and DANv2's ``pca_matrix`` are constants of the
model, not parameters: both packages fit them by default from random SRMD
kernels, which a torch generator cannot draw as jax.random does, so a
JAX-trained DAN scores the same here only when its constants are passed in
(``init_ker_map=`` / ``pca_matrix=``, or
``utils/weights.py::model_constants_from_jax``). ``danv1qrealesrgan`` is
DAN v1 on a QRRDBNet restorer under the GAN handler (``gan_models``): the
DAN loss is its pixel term, the U-Net SN discriminator its adversary (BCE).
Every layer but QRCAN's blocks is a cuDNN conv or a PyTorch op: the JAX
package computes none of them in a Pallas kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.base import PIXEL_LOSSES, BaseHandler
from rumpy_tpu_torch.models.common import Conv, pixel_shuffle, tile_maps
from rumpy_tpu_torch.models.gan_models import BaseGANHandler
from rumpy_tpu_torch.registry import register_model
from rumpy_tpu_torch.utils.losses import full_f32_matmuls


def _lrelu(v):
    return F.leaky_relu(v, 0.2)


def _cat(a, b, dtype):
    return torch.cat([a.to(dtype), b.to(dtype)], dim=1)


class DANCALayer(nn.Module):
    """Channel attention with a LeakyReLU(0.2) between its 1x1 convs."""

    def __init__(self, nf: int, reduction: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down = Conv(nf, max(1, nf // reduction), 1, dtype=dtype)
        self.up = Conv(max(1, nf // reduction), nf, 1, dtype=dtype)

    def forward(self, x):
        y = self.up(_lrelu(self.down(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(y)

    def flax_children(self):
        return [("down", ("TConv_0",), self.down), ("up", ("TConv_1",), self.up)]


class CRBLayer(nn.Module):
    """Conditional residual block: concat(f, cond) -> conv, LeakyReLU,
    conv, channel attention, plus f."""

    def __init__(self, nf1: int, nf2: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(nf1 + nf2, nf1 + nf2, 3, dtype=dtype)
        self.conv2 = Conv(nf1 + nf2, nf1, 3, dtype=dtype)
        self.ca = DANCALayer(nf1, dtype=dtype)

    def forward(self, f, cond):
        h = self.ca(self.conv2(_lrelu(self.conv1(_cat(f, cond, self.dtype)))))
        return f + h

    def flax_children(self):
        return [("conv1", ("Conv_0", "TConv_0"), self.conv1),
                ("conv2", ("Conv_1", "TConv_0"), self.conv2),
                ("ca", ("DANCALayer_0",), self.ca)]


class Estimator(nn.Module):
    """Kernel code (N, out_nc) from (SR guess, LR): a 1x1 LR head, a 9x9
    stride-``scale`` SR head (padding 4), conditional residual blocks, a
    conv and a global average pool."""

    def __init__(self, scale: int = 4, in_nc: int = 3, out_nc: int = 10, nf: int = 64,
                 num_blocks: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lr_head = Conv(in_nc, nf // 2, 1, dtype=dtype)
        self.hr_head = Conv(in_nc, nf // 2, 9, dtype=dtype, stride=scale)
        self.blocks = nn.ModuleList(CRBLayer(nf // 2, nf // 2, dtype=dtype)
                                    for _ in range(num_blocks))
        self.tail = Conv(nf // 2, out_nc, 3, dtype=dtype)

    def forward(self, sr, lr):
        hrf = self.hr_head(sr)
        f = self.lr_head(lr)
        for block in self.blocks:
            f = block(f, hrf)
        return self.tail(f).mean(dim=(2, 3))

    def flax_children(self):
        return ([("lr_head", ("TConv_0",), self.lr_head),
                 ("hr_head", ("TConv_1",), self.hr_head)]
                + [(f"blocks.{i}", (f"CRBLayer_{i}",), b) for i, b in enumerate(self.blocks)]
                + [("tail", ("Conv_0", "TConv_0"), self.tail)])


def _upsampling_convs(nf: int, scale: int, dtype, stage_at_x1: bool) -> Tuple[list, list]:
    """The tail convs after the body conv, and the pixel-shuffle factor
    after each (0: none): two x2 stages for x4, else one stage of
    ``scale`` (at x1 only with ``stage_at_x1``, as DAN v1 has it); the
    last conv makes RGB."""
    if scale == 4:
        stages = [2, 2]
    elif scale == 1 and not stage_at_x1:
        stages = []
    else:
        stages = [scale]
    convs = [Conv(nf, nf * s * s, 3, dtype=dtype) for s in stages]
    return convs + [Conv(nf, 3, 3, dtype=dtype)], stages + [0]


class Restorer(nn.Module):
    """Kernel-conditioned restorer: head conv, conditional residual blocks
    on the code tiled over the image, body conv, sub-pixel upsampling."""

    def __init__(self, scale: int = 4, nf: int = 64, nb: int = 8, input_para: int = 10,
                 in_nc: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head = Conv(in_nc, nf, 3, dtype=dtype)
        self.blocks = nn.ModuleList(CRBLayer(nf, input_para, dtype=dtype) for _ in range(nb))
        self.body = Conv(nf, nf, 3, dtype=dtype)
        convs, self.shuffles = _upsampling_convs(nf, scale, dtype, stage_at_x1=True)
        self.tail = nn.ModuleList(convs)

    def forward(self, lr, ker_code):
        cond = tile_maps(ker_code.to(lr.dtype), *lr.shape[2:])
        f = self.head(lr)
        for block in self.blocks:
            f = block(f, cond)
        f = self.body(f)
        for conv, s in zip(self.tail, self.shuffles):
            f = conv(f)
            if s:
                f = pixel_shuffle(f, s)
        return f

    def flax_children(self):
        convs = [self.head, self.body, *self.tail]
        names = ["head", "body"] + [f"tail.{i}" for i in range(len(self.tail))]
        return ([(n, (f"Conv_{i}", "TConv_0"), c) for i, (n, c) in enumerate(zip(names, convs))]
                + [(f"blocks.{i}", (f"CRBLayer_{i}",), b) for i, b in enumerate(self.blocks)])


class DAN(nn.Module):
    """DAN v1, or with ``generator`` (a meta-attention net taking (x,
    metadata)) in the Restorer's place. ``forward`` returns every
    iteration's SR (N, 3, sH, sW) and kernel code (N, input_para)."""

    def __init__(self, scale: int = 4, nf: int = 64, nb: int = 40, input_para: int = 10,
                 kernel_size: int = 21, loop: int = 4, init_ker_map: Sequence[float] = (),
                 generator: Optional[nn.Module] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.loop = loop
        self.input_para = input_para
        self.generator_named = generator is not None
        self.restorer = generator if generator is not None else Restorer(
            scale=scale, nf=nf, nb=nb, input_para=input_para, dtype=dtype)
        self.estimator = Estimator(scale=scale, out_nc=input_para, dtype=dtype)
        self.register_buffer("init_ker_map", torch.tensor(list(init_ker_map), dtype=torch.float32),
                             persistent=False)

    def forward(self, lr, all_grads: bool = True):
        """``all_grads=False`` runs the iterations before the last without
        autograd: only the last iteration's outputs then carry a graph."""
        ker_map = self.init_ker_map[None].expand(lr.shape[0], self.input_para)
        srs, ker_maps = [], []
        for i in range(self.loop):
            grad = torch.is_grad_enabled() and (all_grads or i == self.loop - 1)
            with torch.set_grad_enabled(grad):
                sr = self.restorer(lr, ker_map.detach())
                ker_map = self.estimator(sr.detach(), lr)
            srs.append(sr)
            ker_maps.append(ker_map)
        return srs, ker_maps

    def flax_children(self):
        return [("restorer", ("generator" if self.generator_named else "restorer",),
                 self.restorer), ("estimator", ("estimator",), self.estimator)]


class DPCB(nn.Module):
    """Dual-path conditional block: two residual conv streams, stream 0
    gated by stream 1 (which may be (N, C, 1, 1) and broadcasts)."""

    def __init__(self, nf1: int, nf2: int, ksize1: int = 3, ksize2: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList([Conv(nf1, nf1, ksize1, dtype=dtype),
                                    Conv(nf1, nf1, ksize1, dtype=dtype),
                                    Conv(nf2, nf1, ksize2, dtype=dtype),
                                    Conv(nf1, nf1, ksize2, dtype=dtype)])

    def forward(self, x0, x1):
        c = self.convs
        f1 = c[1](_lrelu(c[0](x0)))
        f2 = c[3](_lrelu(c[2](x1)))
        return x0 + f1 * f2, x1 + f2

    def flax_children(self):
        return [(f"convs.{i}", (f"Conv_{i}", "TConv_0"), c) for i, c in enumerate(self.convs)]


class DPCG(nn.Module):
    """Dual-path blocks with an outer dual residual."""

    def __init__(self, nf1: int, nf2: int, ksize1: int, ksize2: int, nb: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(DPCB(nf1, nf2, ksize1, ksize2, dtype=dtype)
                                    for _ in range(nb))

    def forward(self, x0, x1):
        y0, y1 = x0, x1
        for block in self.blocks:
            y0, y1 = block(y0, y1)
        return x0 + y0, x1 + y1

    def flax_children(self):
        return [(f"blocks.{i}", (f"DPCB_{i}",), b) for i, b in enumerate(self.blocks)]


class EstimatorV2(nn.Module):
    """DANv2's full-kernel estimator: a 5x5 LR head and a (4s+1)^2
    stride-s SR head (padding 2s) feed a dual-path group; a conv, a global
    pool and a 1x1 conv to k^2 values, softmaxed in float32 into a
    normalised kernel (plus the previous one in the residual form)."""

    def __init__(self, scale: int = 4, nf: int = 64, kernel_size: int = 21,
                 num_blocks: int = 5, residual_form: bool = False, in_nc: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.residual_form = residual_form
        self.lr_head = Conv(in_nc, nf // 2, 5, dtype=dtype)
        self.hr_head = Conv(in_nc, nf // 2, scale * 4 + 1, dtype=dtype, stride=scale)
        self.group = DPCG(nf // 2, nf // 2, 3, 3, num_blocks, dtype=dtype)
        self.body = Conv(nf // 2, nf, 3, dtype=dtype)
        self.tail = Conv(nf, kernel_size ** 2, 1, dtype=dtype)

    def forward(self, sr, lr, previous_kernel=None):
        f, _ = self.group(self.lr_head(lr), self.hr_head(sr))
        f = self.tail(self.body(f).mean(dim=(2, 3), keepdim=True))
        kernel = torch.softmax(f[:, :, 0, 0].float(), dim=-1)
        if self.residual_form and previous_kernel is not None:
            kernel = kernel + previous_kernel
        return kernel

    def flax_children(self):
        return [("lr_head", ("Conv_0", "TConv_0"), self.lr_head),
                ("hr_head", ("TConv_0",), self.hr_head), ("group", ("DPCG_0",), self.group),
                ("body", ("Conv_1", "TConv_0"), self.body), ("tail", ("TConv_1",), self.tail)]


class RestorerV2(nn.Module):
    """DANv2's restorer: the code becomes an (N, nf, 1, 1) stream gating the
    image stream through ``ng`` dual-path groups, then a conv and sub-pixel
    upsampling (plus the previous SR in the residual form)."""

    def __init__(self, scale: int = 4, nf: int = 64, nb: int = 10, ng: int = 5,
                 input_para: int = 10, residual_form: bool = False, in_nc: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.residual_form = residual_form
        self.head = Conv(in_nc, nf, 3, dtype=dtype)
        self.code = Conv(input_para, nf, 1, dtype=dtype)
        self.groups = nn.ModuleList(DPCG(nf, nf, 3, 1, nb, dtype=dtype) for _ in range(ng))
        self.body = Conv(nf, nf, 3, dtype=dtype)
        convs, self.shuffles = _upsampling_convs(nf, scale, dtype, stage_at_x1=False)
        self.tail = nn.ModuleList(convs)

    def forward(self, lr, ker_code, previous_sr=None):
        f1 = self.head(lr)
        f2 = self.code(ker_code[:, :, None, None].to(lr.dtype))
        for group in self.groups:
            f1, f2 = group(f1, f2)
        f = self.body(f1)
        for conv, s in zip(self.tail, self.shuffles):
            f = conv(f)
            if s:
                f = pixel_shuffle(f, s)
        if self.residual_form and previous_sr is not None:
            f = f + previous_sr
        return f

    def flax_children(self):
        convs = [self.head, self.body, *self.tail]
        names = ["head", "body"] + [f"tail.{i}" for i in range(len(self.tail))]
        return ([(n, (f"Conv_{i}", "TConv_0"), c) for i, (n, c) in enumerate(zip(names, convs))]
                + [("code", ("TConv_0",), self.code)]
                + [(f"groups.{i}", (f"DPCG_{i}",), g) for i, g in enumerate(self.groups)])


class DANv2(nn.Module):
    """DANv2: RestorerV2 and EstimatorV2 alternate from a delta kernel; the
    full kernel is projected by the fixed (input_para, k^2) ``pca_matrix``
    (a buffer) to the code, in full float32. ``forward`` returns every
    iteration's SR, code and kernel."""

    def __init__(self, scale: int = 4, nf: int = 64, nb: int = 10, ng: int = 5,
                 input_para: int = 10, kernel_size: int = 21, loop: int = 4,
                 residual_kernel: bool = False, residual_sr: bool = False,
                 pca_matrix: Sequence[Sequence[float]] = (), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.kernel_size = kernel_size
        self.loop = loop
        self.residual_kernel = residual_kernel
        self.residual_sr = residual_sr
        self.restorer = RestorerV2(scale=scale, nf=nf, nb=nb, ng=ng, input_para=input_para,
                                   residual_form=residual_sr, dtype=dtype)
        self.estimator = EstimatorV2(scale=scale, nf=nf, kernel_size=kernel_size,
                                     residual_form=residual_kernel, dtype=dtype)
        self.register_buffer("pca_matrix", torch.tensor([list(r) for r in pca_matrix],
                                                        dtype=torch.float32), persistent=False)

    def _encode(self, kernel):
        with full_f32_matmuls():
            return kernel @ self.pca_matrix.t()

    def forward(self, lr, all_grads: bool = True):
        n, c, h, w = lr.shape
        ks = self.kernel_size
        kernel = torch.zeros(n, ks * ks, device=lr.device)
        kernel[:, (ks // 2) * ks + ks // 2] = 1.0
        ker_map = self._encode(kernel)
        sr = torch.zeros(n, c, h * self.scale, w * self.scale, dtype=lr.dtype, device=lr.device)
        srs, ker_maps, kernels = [], [], []
        for i in range(self.loop):
            grad = torch.is_grad_enabled() and (all_grads or i == self.loop - 1)
            with torch.set_grad_enabled(grad):
                sr = self.restorer(lr, ker_map.detach(),
                                   previous_sr=sr.detach() if self.residual_sr else None)
                kernel = self.estimator(
                    sr.detach(), lr,
                    previous_kernel=kernel.detach() if self.residual_kernel else None)
                ker_map = self._encode(kernel)
            srs.append(sr)
            ker_maps.append(ker_map)
            kernels.append(kernel)
        return srs, ker_maps, kernels

    def flax_children(self):
        return [("restorer", ("restorer",), self.restorer),
                ("estimator", ("estimator",), self.estimator)]


@functools.lru_cache(maxsize=None)
def _default_basis(input_para: int, kernel_size: int, seed: int = 0):
    """The (input_para, k^2) PCA basis fit to 2000 SRMD kernels (isotropic
    with probability 0.5) from a torch generator seeded with ``seed``: the
    JAX package's stand-in for the reference's shipped pca_matrix.pth, with
    another generator's draws."""
    from rumpy_tpu_torch.degradations.pca import fit_kernel_pca
    from rumpy_tpu_torch.ops.blur_kernels import sample_srmd_kernels

    return fit_kernel_pca(
        lambda gen, n: sample_srmd_kernels(gen, n, kernel_size, rate_iso=0.5, random=True)[0],
        batch_len=2000, k=input_para, seed=seed)


def _default_pca_matrix(input_para: int, kernel_size: int,
                        seed: int = 0) -> Tuple[Tuple[float, ...], ...]:
    return tuple(tuple(r) for r in _default_basis(input_para, kernel_size, seed).matrix.tolist())


def _default_init_ker_map(input_para: int, kernel_size: int, seed: int = 0) -> Tuple[float, ...]:
    """The delta kernel encoded by the default basis."""
    delta = torch.zeros(1, kernel_size * kernel_size)
    delta[0, (kernel_size // 2) * kernel_size + kernel_size // 2] = 1.0
    return tuple(_default_basis(input_para, kernel_size, seed)(delta)[0].tolist())


@register_model("dan")
class DANHandler(BaseHandler):
    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"
    uses_metadata = True  # the kernel loss's target comes from the metadata

    def __init__(self, mode="v1", nf=64, nb=None, ng=5, input_para=10, kernel_size=21,
                 loop=4, selected_metadata=None, init_ker_map=None, generator=None,
                 pca_matrix=None, residual_kernel=False, residual_sr=False,
                 generator_params=None, **kwargs):
        if mode not in ("v1", "v2", "v1QRCAN", "v1QHAN", "v1QELAN"):
            raise NotImplementedError("Set mode to v1, v2 or a v1Q* variant")
        if mode == "v1QELAN":
            raise ValueError("DAN v1QELAN fails in the JAX package: its handler keeps no "
                             "batch_stats, and QELAN's BatchNorm finds no running statistics "
                             "at the first forward; the port refuses it")
        self.mode = mode
        self.selected_metadata = selected_metadata
        if selected_metadata:
            input_para = len(selected_metadata)
        if mode == "v2":
            mat = (tuple(tuple(r) for r in pca_matrix) if pca_matrix is not None
                   else _default_pca_matrix(input_para, kernel_size))
            super().__init__(nf=nf, nb=10 if nb is None else nb, ng=ng, input_para=input_para,
                             kernel_size=kernel_size, loop=loop, residual_kernel=residual_kernel,
                             residual_sr=residual_sr, pca_matrix=mat, **kwargs)
            return
        ikm = (tuple(init_ker_map) if init_ker_map is not None
               else _default_init_ker_map(input_para, kernel_size))
        self._generator_spec = None
        if mode != "v1":  # the generator is float32 whatever dtype says, as in JAX
            self._generator_spec = (mode.replace("v1", "").lower(), dict(generator_params or {}))
        super().__init__(nf=nf, nb=40 if nb is None else nb, input_para=input_para,
                         kernel_size=kernel_size, loop=loop, init_ker_map=ikm, **kwargs)

    def build_module(self, **kw):
        if self.mode == "v2":
            return DANv2(scale=self.scale, dtype=self.dtype, **kw)
        gen = None
        if self._generator_spec is not None:
            from rumpy_tpu_torch.models.blind_sr import _build_generator
            name, params = self._generator_spec
            gen = _build_generator(name, self.scale, kw["input_para"], torch.float32,
                                   dict(params), False, False)
        return DAN(scale=self.scale, dtype=self.dtype, generator=gen, **kw)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        """Train: every iteration's outputs, NHWC, a graph on the last only.
        Eval: the last iteration's SR."""
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device).permute(0, 3, 1, 2)
        out = self.module(lr, all_grads=not train)
        srs = [sr.permute(0, 2, 3, 1) for sr in out[0]]
        if train:
            return (srs, *out[1:]), {}, extra
        return srs[-1], {}, extra

    def compute_losses(self, out, batch, aux):
        if self.mode == "v2":
            srs, _, kernel_preds = out
            target = batch.get("blur_kernels", batch.get("metadata"))
            target = target.reshape(target.shape[0], -1)
        else:
            srs, kernel_preds = out
            target = batch["metadata"]
            if self.selected_metadata and target.shape[-1] != len(self.selected_metadata):
                raise ValueError(
                    f"DAN selected_metadata={self.selected_metadata} predicts "
                    f"{len(self.selected_metadata)} values but the batch metadata has "
                    f"{target.shape[-1]} columns — set data.metadata to the same key list "
                    "so the pipeline selects matching columns")
        target = torch.as_tensor(target, device=self.device).float()
        hr = torch.as_tensor(batch["hr"], device=self.device).float()
        crit = PIXEL_LOSSES[self.loss_type]
        losses = {}
        for i, (sr, kp) in enumerate(zip(srs, kernel_preds)):
            d_sr = crit(sr.float(), hr)
            d_kr = crit(kp.float(), target)
            losses[f"image-loss-iter-{i}"] = d_sr
            losses[f"kernel-loss-iter-{i}"] = d_kr
        losses["train-loss"] = d_sr + d_kr
        return losses


@register_model("danv1qrealesrgan")
class DANv1QRealESRGANHandler(BaseGANHandler):
    """DAN v1 with a QRRDBNet restorer under the GAN recipe: the estimator
    predicts the PCA kernel code the restorer conditions on; the generator
    loss is lambda_pixel * (the last iteration's image L1 + kernel L1) +
    lambda_vgg * VGG content + lambda_adv * BCE against the U-Net SN
    discriminator, after ``pretrain_epochs`` of the DAN loss alone. At
    evaluation the last iteration's SR."""

    gan_mode = "bce"
    discriminator_type = "unet_sn"
    uses_metadata = True
    colorspace = "rgb"
    im_input = "unmodified"

    def __init__(self, selected_metadata=None, input_para=10, kernel_size=21, loop=4,
                 use_pca_encoder=True, init_ker_map=None, pretrain_epochs=100,
                 lambda_adv=0.1, lambda_pixel=1.0, lambda_vgg=1.0, nf=64, nb=23, gc=32,
                 **kwargs):
        self.selected_metadata = selected_metadata
        if selected_metadata:
            input_para = len(selected_metadata)
        self.input_para = input_para
        self.kernel_size = kernel_size
        self.loop = loop
        if init_ker_map is not None:
            self._ikm = tuple(init_ker_map)
        elif use_pca_encoder:
            self._ikm = _default_init_ker_map(input_para, kernel_size)
        else:
            self._ikm = (0.5,) * input_para
        super().__init__(pretrain_epochs=pretrain_epochs, lambda_adv=lambda_adv,
                         lambda_pixel=lambda_pixel, lambda_vgg=lambda_vgg, nf=nf, nb=nb, gc=gc,
                         **kwargs)

    def build_generator(self, nf, nb, gc):
        from rumpy_tpu_torch.models.gan_models import RRDBNet
        restorer = RRDBNet(scale=self.scale, nf=nf, nb=nb, gc=gc, num_metadata=self.input_para,
                           dtype=self.dtype)
        return DAN(scale=self.scale, input_para=self.input_para, kernel_size=self.kernel_size,
                   loop=self.loop, init_ker_map=self._ikm, generator=restorer, dtype=self.dtype)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        """Train: every iteration's (SR, code), NHWC, a graph on the last
        only. Eval: the last iteration's SR."""
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device).permute(0, 3, 1, 2)
        srs, codes = self.module.generator(lr, all_grads=not train)
        srs = [sr.permute(0, 2, 3, 1) for sr in srs]
        if train:
            return (srs, codes), {}, extra
        return srs[-1], {}, extra

    def _dan_loss(self, batch):
        (srs, codes), _, _ = self.apply(self._state_params, batch, train=True)
        target = torch.as_tensor(batch["metadata"], device=self.device).float()
        if self.selected_metadata and target.shape[-1] != len(self.selected_metadata):
            raise ValueError(
                f"selected_metadata={self.selected_metadata} predicts "
                f"{len(self.selected_metadata)} values but the batch metadata has "
                f"{target.shape[-1]} columns — set data.metadata to the same key list")
        hr = batch["hr"].float()
        iter_losses = {}
        for i, (sr, code) in enumerate(zip(srs, codes)):
            d_sr = (sr.float() - hr).abs().mean()
            d_kr = (code.float() - target).abs().mean()
            iter_losses[f"image-loss-iter-{i}"] = d_sr
            iter_losses[f"kernel-loss-iter-{i}"] = d_kr
        return srs[-1], d_sr + d_kr, iter_losses

    def _generator_outputs(self, batch):
        return self._dan_loss(batch)

    def _pretrain_loss(self, batch):
        _, dan_loss, iter_losses = self._dan_loss(batch)
        return dan_loss, iter_losses
