"""Face SR families: SPARNet / QSPARNet, RCANSplitCeleb and FaceGAN.

Port of ``rumpy_tpu/models/face_models.py``.

* SPARNet / QSPARNet: spatial-attention residual face SR at a fixed size
  (the LR image upsampled by bicubic before the network). An encoder down
  to ``min_feat_size``, a residual trunk and a decoder, each block gated by
  a recursive hourglass's sigmoid map; QSPARNet multiplies each block's
  output by a ``ParaCALayer`` gate of the metadata (the 40 CelebA
  attributes with ``metadata=["all"]``). Convs pad by reflection; the
  BatchNorm is flax's (``common.BatchNorm``), its running statistics
  advancing in train steps only. cuDNN convs and PyTorch ops: the JAX
  package computes them without a Pallas kernel.
* RCANSplitCeleb: two full RCANs, one for each value of a binary CelebA
  attribute (the gate column ``metadata[:, split_index]``). Both experts run
  the whole batch on the RCAB kernels and the output takes expert a's image
  where the gate is above 0.5, expert b's elsewhere, so each expert's
  gradient comes from its own allocation only. The update hook zeroes the
  update of an expert with no example in the batch: its parameters stay bit
  for bit, while its Adam moments decay, as in the JAX package. The two
  "has examples" flags stay tensors, so a step reads nothing back.
* FaceGAN: an unconditional DCGAN. One train step updates the
  discriminator on a random half batch of real images rescaled to [-1, 1]
  and on detached fakes (BCE, two train-mode calls that chain its BatchNorm
  statistics, dropout 0.4), then the generator through the updated
  discriminator in eval mode. The step's draws (a permutation, two sets of
  uniform latents, two dropout masks) come from the handler's generator;
  ``FaceGANHandler.step_from_draws`` takes them from the caller, so that a
  test can feed it the JAX side's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import true_div
from rumpy_tpu_torch.models.advanced import RCAN
from rumpy_tpu_torch.models.attention_manipulators import ParaCALayer, QModelHandler
from rumpy_tpu_torch.models.base import BaseHandler, TrainState, optimizer_update
from rumpy_tpu_torch.models.common import BatchNorm, Conv, ConvTranspose, Linear
from rumpy_tpu_torch.models.contrastive import device_batch
from rumpy_tpu_torch.models.gan_models import GANPair, PairedGANHandler, frozen
from rumpy_tpu_torch.registry import register_model


def _lrelu(v):
    return F.leaky_relu(v, 0.2)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` of (N, C, H, W) to ``size``:
    output i reads input floor((i + 0.5) * m / n), computed in float32 as
    the JAX package computes it (half-pixel centres; torch's ``"nearest"``
    would read floor(i * m / n))."""
    for dim, n in ((2, size[0]), (3, size[1])):
        m = x.shape[dim]
        if m == n:
            continue
        idx = torch.floor(true_div((torch.arange(n, dtype=torch.float32) + 0.5) * m, n)).long()
        x = x.index_select(dim, idx.to(x.device))
    return x


class PReLU(nn.Module):
    """``where(x >= 0, x, alpha * x)`` with a per-channel ``alpha`` (0.25 at
    init): the flax leaf ``flax_name`` at its owner's path."""

    def __init__(self, channels: int, flax_name: str = "prelu"):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))
        self.flax_leaves = {"alpha": ("params", flax_name)}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.alpha.fill_(0.25)

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype)[None, :, None, None] * x)

    def flax_children(self):
        return []


def _activation(kind: str, channels: int, flax_name: str = "prelu"):
    if kind == "relu":
        return torch.relu
    if kind == "leakyrelu":
        return _lrelu
    if kind == "prelu":
        return PReLU(channels, flax_name)
    return None


class SPConv(nn.Module):
    """SPARNet's conv layer: nearest x2 up when ``scale`` is "up", a reflect
    pad of k // 2, the conv (stride 2 when "down"; a bias only for norm
    "none" or "pixel"), the norm ("bn", or "pixel": divided by the L2 norm
    over channels + 1e-12), then relu, leaky relu 0.2 or PReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, scale: str = "none",
                 norm: str = "none", relu: str = "none", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up = scale == "up"
        self.norm_kind = norm
        self.conv = Conv(in_ch, out_ch, kernel, use_bias=norm in ("none", "pixel"),
                         stride=2 if scale == "down" else 1, reflect=True, dtype=dtype)
        self.norm = BatchNorm(out_ch, momentum=0.9, dtype=dtype) if norm == "bn" else None
        self.act = _activation(relu, out_ch)

    def forward(self, x, train: bool = False):
        if self.up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")  # i reads i // 2
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x, train=train)
        elif self.norm_kind == "pixel":
            x = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)
        return x if self.act is None else self.act(x)

    def flax_children(self):
        out = [("conv", ("TConv_0",), self.conv)]
        if self.norm is not None:
            out.append(("norm", ("BatchNorm_0",), self.norm))
        if isinstance(self.act, PReLU):
            out.append(("act", (), self.act))
        return out


class HourGlassBlock(nn.Module):
    """SPARNet's attention: a recursive hourglass of ``depth`` levels (each
    ``up1(x) + up2(inner(low1(x)))``, up2 resized to up1 where an odd size
    makes them differ) and a conv to ``c_attn`` channels; returns x times
    the sigmoid of that map. Depth 0 is the identity. The convs are kept in
    flax's order of construction (``SPConv_<i>``)."""

    def __init__(self, c_in: int, depth: int, c_attn: int = 1, c_mid: int = 64,
                 norm: str = "bn", relu: str = "leakyrelu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = depth
        convs = []

        def conv(cin, **kw):
            convs.append(SPConv(cin, c_mid, 3, norm=norm, relu=relu, dtype=dtype, **kw))
            return len(convs) - 1

        def build(lv, cin):  # (up1, low1, inner level or low2, up2) as conv indices
            up1, low1 = conv(cin), conv(cin, scale="down")
            inner = build(lv - 1, c_mid) if lv > 1 else conv(c_mid)
            return up1, low1, inner, conv(c_mid, scale="up")

        self.plan = build(depth, c_in) if depth else None
        if depth:
            convs.append(SPConv(c_mid, c_attn, 3, dtype=dtype))
        self.convs = nn.ModuleList(convs)

    def _level(self, plan, x, train):
        up1_i, low1_i, inner, up2_i = plan
        up1 = self.convs[up1_i](x, train)
        low1 = self.convs[low1_i](x, train)
        low2 = (self._level(inner, low1, train) if isinstance(inner, tuple)
                else self.convs[inner](low1, train))
        up2 = self.convs[up2_i](low2, train)
        if up1.shape[2:] != up2.shape[2:]:
            up2 = resize_nearest(up2, up1.shape[2:])
        return up1 + up2

    def forward(self, x, train: bool = False):
        if not self.depth:
            return x
        att = torch.sigmoid(self.convs[-1](self._level(self.plan, x, train), train))
        return x * att

    def flax_children(self):
        return [(f"convs.{i}", (f"SPConv_{i}",), c) for i, c in enumerate(self.convs)]


class SPARResidualBlock(nn.Module):
    """Pre-activation (BatchNorm, then the activation; PReLU's leaf is
    ``preact_prelu``), two SPConvs (the first takes the scale), the
    hourglass on their output, added to the identity (an SPConv where the
    scale or the width changes), then, with metadata, a ParaCALayer gate."""

    def __init__(self, c_in: int, c_out: int, scale: str = "none", hg_depth: int = 2,
                 att_name: str = "spar", norm: str = "bn", relu: str = "leakyrelu",
                 num_metadata: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        nr = dict(norm=norm, relu=relu, dtype=dtype)
        self.identity = (None if scale == "none" and c_in == c_out
                         else SPConv(c_in, c_out, 3, scale=scale, dtype=dtype))
        self.preact_norm = BatchNorm(c_in, momentum=0.9, dtype=dtype) if norm == "bn" else None
        self.preact = _activation(relu, c_in, "preact_prelu")
        scales = {"down": ("none", "down"), "up": ("up", "none"),
                  "none": ("none", "none")}[scale]
        self.conv1 = SPConv(c_in, c_out, 3, scale=scales[0], **nr)
        self.conv2 = SPConv(c_out, c_out, 3, scale=scales[1], norm=norm, relu="none",
                            dtype=dtype)
        self.hourglass = HourGlassBlock(c_out, hg_depth, c_out if att_name == "spar3d" else 1,
                                        norm=norm, relu=relu, dtype=dtype)
        self.q = (ParaCALayer(c_out, num_metadata, nonlinearity=True, dtype=dtype)
                  if num_metadata > 0 else None)

    def forward(self, x, metadata=None, train: bool = False):
        identity = x if self.identity is None else self.identity(x, train)
        out = x if self.preact_norm is None else self.preact_norm(x, train=train)
        if self.preact is not None:
            out = self.preact(out)
        out = self.conv2(self.conv1(out, train), train)
        out = identity + self.hourglass(out, train)
        if self.q is not None and metadata is not None:
            out = self.q(out, metadata)
        return out

    def flax_children(self):
        convs = [c for c in (self.identity, self.conv1, self.conv2) if c is not None]
        names = ["identity", "conv1", "conv2"][3 - len(convs):]
        out = [(n, (f"SPConv_{i}",), c) for i, (n, c) in enumerate(zip(names, convs))]
        if self.preact_norm is not None:
            out.append(("preact_norm", ("BatchNorm_0",), self.preact_norm))
        if isinstance(self.preact, PReLU):
            out.append(("preact", (), self.preact))
        out.append(("hourglass", ("HourGlassBlock_0",), self.hourglass))
        if self.q is not None:
            out.append(("q", ("ParaCALayer_0",), self.q))
        return out


class SPARNet(nn.Module):
    """SPARNet / QSPARNet: a conv to the first width, ``log2(in_size /
    min_feat_size)`` down blocks, ``res_depth + 3 - down_steps`` trunk blocks,
    ``log2(out_size / min_feat_size)`` up blocks, a conv to RGB. Widths are
    clipped to [min_ch, max_ch]; the hourglass depth starts at
    ``log2(64 / bottleneck_size)``, falls by one a down block and rises by
    one an up block. ``num_metadata`` > 0 puts a ParaCALayer in every block
    (with ``metadata_encoder_only``, in the down blocks only)."""

    def __init__(self, min_ch: int = 32, max_ch: int = 128, in_size: int = 128,
                 out_size: int = 128, min_feat_size: int = 16, res_depth: int = 10,
                 bottleneck_size: int = 4, att_name: str = "spar", norm_type: str = "bn",
                 relu_type: str = "leakyrelu", num_metadata: int = 0,
                 metadata_encoder_only: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_size = in_size

        def clip(c):
            return max(min_ch, min(c, max_ch))

        down_steps = int(math.log2(in_size // min_feat_size))
        up_steps = int(math.log2(out_size // min_feat_size))
        n_ch = clip(max_ch // (down_steps + 1))
        nr = dict(att_name=att_name, norm=norm_type, relu=relu_type, dtype=dtype)
        trunk_meta = 0 if metadata_encoder_only else num_metadata
        self.first = SPConv(3, n_ch, 3, dtype=dtype)
        blocks, ch = [], n_ch
        hg_depth = int(math.log2(64 // bottleneck_size))
        for _ in range(down_steps):
            blocks.append(SPARResidualBlock(ch, clip(n_ch * 2), scale="down", hg_depth=hg_depth,
                                            num_metadata=num_metadata, **nr))
            ch = clip(n_ch * 2)
            n_ch *= 2
            hg_depth -= 1
        hg_depth += 1
        for _ in range(res_depth + 3 - down_steps):
            blocks.append(SPARResidualBlock(ch, clip(n_ch), hg_depth=hg_depth,
                                            num_metadata=trunk_meta, **nr))
            ch = clip(n_ch)
        for _ in range(up_steps):
            hg_depth += 1
            blocks.append(SPARResidualBlock(ch, clip(n_ch // 2), scale="up", hg_depth=hg_depth,
                                            num_metadata=trunk_meta, **nr))
            ch = clip(n_ch // 2)
            n_ch //= 2
        self.blocks = nn.ModuleList(blocks)
        self.last = SPConv(ch, 3, 3, dtype=dtype)

    def forward(self, x, metadata=None, train: bool = False):
        h = self.first(x, train)
        for block in self.blocks:
            h = block(h, metadata, train)
        return self.last(h, train)

    def flax_children(self):
        return ([("first", ("SPConv_0",), self.first)]
                + [(f"blocks.{i}", (f"SPARResidualBlock_{i}",), b)
                   for i, b in enumerate(self.blocks)]
                + [("last", ("SPConv_1",), self.last)])


class _BNHandlerMixin:
    """SPARNet's handlers: a train-mode forward normalises by the batch's
    statistics and advances the running ones (module buffers, so in the
    state); eval normalises by the running ones. A JAX checkpoint's
    statistics are its ``extra["vars"]["batch_stats"]``."""

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        x = torch.as_tensor(batch["lr"], device=self.device).permute(0, 3, 1, 2)
        meta = None
        if getattr(self, "uses_metadata", False):
            meta = self._metadata(batch)
        sr = self.module(x, meta, train=train)
        return sr.permute(0, 2, 3, 1), {}, extra


_SPARNET_DEFAULTS = dict(min_ch=32, max_ch=128, in_size=128, out_size=128, min_feat_size=16,
                         res_depth=10, bottleneck_size=4, att_name="spar", norm_type="bn",
                         relu_type="leakyrelu")


@register_model("sparnet")
class SPARNetHandler(_BNHandlerMixin, BaseHandler):
    """Face SR at a fixed size: the input is the bicubic-upsampled LR
    (``im_input="interp"``), the output the same size."""

    loss_type = "l1"
    colorspace = "rgb"
    im_input = "interp"

    def __init__(self, **kwargs):
        model = {k: kwargs.pop(k, v) for k, v in _SPARNET_DEFAULTS.items()}
        super().__init__(**model, **kwargs)

    def build_module(self, **kw):
        return SPARNet(dtype=self.dtype, **kw)


@register_model("qsparnet")
class QSPARNetHandler(_BNHandlerMixin, QModelHandler):
    """SPARNet with a ParaCALayer gate of the metadata in its blocks."""

    im_input = "interp"

    def __init__(self, metadata_encoder_only=False, **kwargs):
        model = {k: kwargs.pop(k, v) for k, v in _SPARNET_DEFAULTS.items()}
        super().__init__(metadata_encoder_only=metadata_encoder_only, **model, **kwargs)

    def build_module(self, **kw):
        return SPARNet(num_metadata=self.num_metadata, dtype=self.dtype, **kw)


# ---------------------------------------------------------------------------
# RCAN ensemble
# ---------------------------------------------------------------------------

class SplitRCAN(nn.Module):
    """Two RCANs on the same batch; each image takes expert a's output where
    its gate is above 0.5, expert b's elsewhere."""

    def __init__(self, **kw):
        super().__init__()
        self.expert_a = RCAN(**kw)
        self.expert_b = RCAN(**kw)

    def forward(self, x, gate):
        a = self.expert_a(x)
        b = self.expert_b(x)
        return torch.where(gate[:, None, None, None] > 0.5, a, b)

    def flax_children(self):
        return [("expert_a", ("expert_a",), self.expert_a),
                ("expert_b", ("expert_b",), self.expert_b)]


@register_model("rcansplitceleb")
class RCANSplitCelebHandler(BaseHandler):
    """Attribute-split two-RCAN ensemble. The gate column is
    ``metadata[:, split_index]`` (with ``data.metadata = ["gender"]`` the
    data layer's only column). Reports ``positive-loss`` and
    ``negative-loss`` (each NaN when its allocation is empty) and
    ``train-loss``, their NaN-safe sum."""

    loss_type = "l1"
    colorspace = "rgb"
    uses_metadata = True

    def __init__(self, n_feats=64, n_resgroups=10, n_resblocks=20, split_variable="gender",
                 split_index=0, **kwargs):
        self.split_variable = split_variable
        self.split_index = split_index
        super().__init__(n_feats=n_feats, n_resgroups=n_resgroups, n_resblocks=n_resblocks,
                         **kwargs)

    def build_module(self, **kw):
        return SplitRCAN(scale=self.scale, dtype=self.dtype, **kw)

    def _gate(self, batch) -> torch.Tensor:
        meta = torch.as_tensor(batch["metadata"], device=self.device)
        return meta[:, self.split_index].float()

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        gate = self._gate(batch)
        x = torch.as_tensor(batch["lr"], device=self.device).permute(0, 3, 1, 2)
        sr = self.module(x, gate)
        return sr.permute(0, 2, 3, 1), {"_gate": gate}, extra

    def compute_losses(self, sr, batch, aux):
        gate = aux.pop("_gate")
        per_ex = (sr.float() - batch["hr"].float()).abs().mean(dim=(1, 2, 3))
        pos = gate > 0.5
        n_pos, n_neg = pos.sum(), (~pos).sum()
        nan = torch.full((), math.nan, device=per_ex.device)
        pos_loss = torch.where(n_pos > 0, torch.where(pos, per_ex, 0.0).sum()
                               / n_pos.clamp(min=1), nan)
        neg_loss = torch.where(n_neg > 0, torch.where(pos, 0.0, per_ex).sum()
                               / n_neg.clamp(min=1), nan)
        return {"train-loss": torch.nan_to_num(pos_loss) + torch.nan_to_num(neg_loss),
                "positive-loss": pos_loss, "negative-loss": neg_loss}

    def transform_updates(self, updates, state, batch):
        """Zeroes the update of an expert with no example in the batch (its
        gradient is zero, but Adam's moments would still move it). The
        flags are tensors: nothing is read back."""
        pos = self._gate(batch) > 0.5
        has = {"expert_a.": pos.any().float(), "expert_b.": (~pos).any().float()}
        out = dict(updates)
        for prefix, flag in has.items():
            names = [k for k in updates if k.startswith(prefix)]
            for k, u in zip(names, torch._foreach_mul([updates[k] for k in names], flag)):
                out[k] = u
        return out


# ---------------------------------------------------------------------------
# Unconditional face GAN
# ---------------------------------------------------------------------------

class GANGenerator(nn.Module):
    """DCGAN face generator: latent -> Dense -> 5 x 5 x nf (flax's NHWC
    reshape) -> four 4 x 4 stride-2 transposed convs with leaky relu 0.2 ->
    a 5 x 5 conv to RGB -> tanh in float32: 80 x 80 images."""

    def __init__(self, latent_dim: int = 100, nf: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nf = nf
        self.dense = Linear(latent_dim, nf * 25, dtype=dtype)
        self.ups = nn.ModuleList(ConvTranspose(nf, nf, 4, 2, dtype=dtype) for _ in range(4))
        self.out = Conv(nf, 3, 5, dtype=dtype)

    def forward(self, z):
        x = _lrelu(self.dense(z))
        x = x.reshape(-1, 5, 5, self.nf).permute(0, 3, 1, 2)
        for up in self.ups:
            x = _lrelu(up(x))
        return torch.tanh(self.out(x).float())

    def flax_children(self):
        return ([("dense", ("TDense_0",), self.dense)]
                + [(f"ups.{i}", (f"TConvTranspose_{i}",), u) for i, u in enumerate(self.ups)]
                + [("out", ("TConv_0",), self.out)])


class GANFaceDiscriminator(nn.Module):
    """DCGAN discriminator: a 5 x 5 conv, four 5 x 5 stride-2 convs (flax's
    'SAME' padding) each with a float32 BatchNorm, leaky relu 0.2 after
    each, the features flattened in flax's NHWC order, dropout 0.4 in train
    mode, a Dense to one logit, sigmoid in float32. ``keep`` is the dropout
    mask (True: kept, scaled by 1 / 0.6)."""

    size = 80
    keep_prob = 0.6

    def __init__(self, nf: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(
            [Conv(3, nf, 5, dtype=dtype)]
            + [Conv(nf, nf, 5, stride=2, flax_same=True, dtype=dtype) for _ in range(4)])
        self.norms = nn.ModuleList(BatchNorm(nf, momentum=0.9, dtype=torch.float32)
                                   for _ in range(4))
        self.dense = Linear(nf * 25, 1, dtype=dtype)

    def features(self, x, train: bool = False):
        """The flattened features (N, 25 nf) the dropout takes."""
        x = _lrelu(self.convs[0](x))
        for conv, norm in zip(self.convs[1:], self.norms):
            x = _lrelu(norm(conv(x), train=train))
        return x.permute(0, 2, 3, 1).flatten(1)

    def forward(self, x, train: bool = False, keep: Optional[torch.Tensor] = None):
        f = self.features(x, train)
        if train:
            f = torch.where(keep, true_div(f, self.keep_prob), 0.0)
        return torch.sigmoid(self.dense(f).float())

    def flax_children(self):
        return ([(f"convs.{i}", (f"TConv_{i}",), c) for i, c in enumerate(self.convs)]
                + [(f"norms.{i}", (f"BatchNorm_{i}",), n) for i, n in enumerate(self.norms)]
                + [("dense", ("TDense_0",), self.dense)])


@register_model("facegan")
class FaceGANHandler(PairedGANHandler):
    """Unconditional face GAN: reports ``train-loss`` (the generator's),
    ``d-loss-real``, ``d-loss-fake`` and the discriminator's accuracies on
    real and fake images. The module is a ``GANPair``; the generator's
    optimizer is the handler's (its lr, scheduler and clipping), the
    discriminator's an Adam at ``discriminator_lr`` (default the handler's
    lr) without a schedule, as the JAX handler's two optax transforms.
    ``apply`` returns ``(generated + 1) / 2`` from ``batch["latent"]`` or,
    without it, from uniform latents of the handler's generator."""

    colorspace = "rgb"
    im_input = "unmodified"
    eps = 1e-7

    def __init__(self, latent_dim=100, nf=128, **kwargs):
        self.latent_dim = latent_dim
        self.nf = nf
        super().__init__(**kwargs)

    def build_module(self, **kw):
        return GANPair(GANGenerator(latent_dim=self.latent_dim, nf=self.nf, dtype=self.dtype,
                                    **kw),
                       GANFaceDiscriminator(nf=self.nf, dtype=self.dtype))

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        if "latent" in batch:
            z = torch.as_tensor(batch["latent"], device=self.device).float()
        else:
            n = batch["hr"].shape[0] if "hr" in batch else 1
            z = torch.rand((n, self.latent_dim), generator=self.rng, device=self.device)
        gen = self.module.generator(z)
        return ((gen + 1.0) / 2.0).permute(0, 2, 3, 1), {}, extra

    def draws(self, n: int) -> Dict[str, torch.Tensor]:
        """A step's draws from the handler's generator: the real images'
        permutation, the discriminator's and the generator's latents and
        the two dropout keep masks."""
        half = max(1, n // 2)
        g, dev = self.rng, self.device
        feats = self.nf * 25
        return {"perm": torch.randperm(n, generator=g, device=dev),
                "z_d": torch.rand((half, self.latent_dim), generator=g, device=dev),
                "z_g": torch.rand((n, self.latent_dim), generator=g, device=dev),
                "keep_real": torch.rand((half, feats), generator=g, device=dev)
                < GANFaceDiscriminator.keep_prob,
                "keep_fake": torch.rand((half, feats), generator=g, device=dev)
                < GANFaceDiscriminator.keep_prob}

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        self._use_params(state.params)
        batch = device_batch(batch, self.device)
        losses = self.step_from_draws(state, batch, self.draws(batch["hr"].shape[0]))
        return TrainState(step=int(state.step) + 1, params=state.params,
                          extra=state.extra), losses

    def step_from_draws(self, state: TrainState, batch, draws) -> Dict[str, torch.Tensor]:
        """One step with the caller's draws (see ``draws``): the
        discriminator's update on real (the first half of the permutation,
        rescaled to [-1, 1]) and fake images, then the generator's through
        the updated discriminator in eval mode."""
        eps = self.eps
        y = batch["hr"].float()
        half = max(1, y.shape[0] // 2)
        real = (y[draws["perm"][:half]] * 2.0 - 1.0).permute(0, 3, 1, 2)
        d, g = self.discriminator, self.module.generator
        with torch.no_grad():
            fakes = g(torch.as_tensor(draws["z_d"], device=self.device))
        with torch.enable_grad():
            pred_real = d(real, train=True, keep=torch.as_tensor(draws["keep_real"],
                                                                  device=self.device))
            pred_fake = d(fakes, train=True, keep=torch.as_tensor(draws["keep_fake"],
                                                                  device=self.device))
            loss_real = -torch.log(pred_real + eps).mean()
            loss_fake = -torch.log(1.0 - pred_fake + eps).mean()
            optimizer_update(self.d_optimizer(), d.parameters(), loss_real + loss_fake)
            with frozen(d):
                gen = g(torch.as_tensor(draws["z_g"], device=self.device))
                g_loss = -torch.log(d(gen, train=False) + eps).mean()
                optimizer_update(self.optimizer(), g.parameters(), g_loss,
                                 self.grad_clip, self.schedule(int(state.step)))
        return {"train-loss": g_loss.detach(), "d-loss-real": loss_real.detach(),
                "d-loss-fake": loss_fake.detach(),
                "d-acc-real": (pred_real > 0.5).float().mean(),
                "d-acc-fake": (pred_fake <= 0.5).float().mean()}
