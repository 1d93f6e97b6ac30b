"""Direct degradation regressors and MANet.

Port of ``rumpy_tpu/models/regressors.py``: BasicNet, ResNet-18/50,
DenseNet-169 and EfficientNet-B3 re-headed to regress a degradation vector,
and MANet, a U-shaped per-pixel blur-kernel estimator, on
``StandardRegressorHandler`` (target normalisation, the occupancy loss,
centre-crop or multi-patch evaluation).

The networks are cuDNN convs and PyTorch ops on channels_last tensors,
with flax's padding: 'SAME' at stride 2 pads (0, 1) on an even size
(``Conv(flax_same=True)``), the 7 x 7 stems pad 3, the stems' max pool
pads 1, DenseNet's transition pool and MANet's 2 x 2 stride-2 conv are
'VALID'. BatchNorm follows flax (``common.BatchNorm``: float32 statistics
and output, biased variance, momentum 0.9); its running statistics are
buffers of the module, so they travel in the handler's state and its
checkpoints, a train step normalises by the batch's statistics and updates
them, and evaluation reads them (a JAX-written checkpoint's
``extra.bstats`` load into them). EfficientNet's depthwise convs are
grouped convs; MANet's up-sampling is flax's transposed conv
(``common.ConvTranspose``), its softmax over the k^2 channels float32, and
its kernel map spread to the HR size by nearest-neighbour repeats.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.base import BaseHandler
from rumpy_tpu_torch.models.common import (BatchNorm, Conv, ConvTranspose, Linear,
                                           upsample_nearest)
from rumpy_tpu_torch.registry import register_model


def selective_softmax(x: torch.Tensor, softmax_range) -> torch.Tensor:
    """Softmax over the features ``softmax_range``, identity elsewhere."""
    a, b = softmax_range
    return torch.cat([x[:, :a], torch.softmax(x[:, a:b], dim=1), x[:, b:]], dim=1)


def indicator_occupancy_loss(pred: torch.Tensor, gt: torch.Tensor,
                             zero_thres: float = 1e-6) -> torch.Tensor:
    """The count of positions whose above-threshold occupancy disagrees;
    the indicators carry no gradient."""
    return ((gt > zero_thres).float() - (pred > zero_thres).float()).abs().sum()


def adaptive_avg_pool(x: torch.Tensor, out: int) -> torch.Tensor:
    """AdaptiveAvgPool2d of NCHW ``x`` to ``out`` x ``out``: the mean over
    the torch-style bins floor(i * H / out) .. ceil((i + 1) * H / out)."""
    return F.adaptive_avg_pool2d(x, out)


def _named(modules, flax_name: str, port_name: str):
    return [(f"{port_name}.{i}", (f"{flax_name}_{i}",), m) for i, m in enumerate(modules)]


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------

class BasicNet(nn.Module):
    """The CIFAR-tutorial classifier: conv5, pool, conv5, pool ('VALID'),
    an adaptive pool to 5 x 5, three Dense layers (the pooled map
    flattened in NHWC order, as the JAX package's)."""

    def __init__(self, in_channels: int = 3, output_size: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList([Conv(in_channels, 6, 5, padding=0, dtype=dtype),
                                    Conv(6, 16, 5, padding=0, dtype=dtype)])
        self.dense = nn.ModuleList([Linear(16 * 25, 120, dtype=dtype), Linear(120, 84, dtype=dtype),
                                    Linear(84, output_size, dtype=dtype)])

    def flax_children(self):
        return _named(self.convs, "TConv", "convs") + _named(self.dense, "TDense", "dense")

    def forward(self, x, train: bool = False):
        for conv in self.convs:
            x = F.max_pool2d(torch.relu(conv(x)), 2)
        x = adaptive_avg_pool(x, 5).permute(0, 2, 3, 1).flatten(1)
        x = torch.relu(self.dense[0](x))
        x = torch.relu(self.dense[1](x))
        return self.dense[2](x).float()


class _ResBlock(nn.Module):
    """ResNet's basic block (two 3 x 3 convs) or bottleneck (1 x 1, 3 x 3,
    1 x 1 to 4 x filters), BatchNorm after each, a 1 x 1 projection of the
    input where its width or stride changes."""

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 bottleneck: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_channels = filters * 4 if bottleneck else filters
        if bottleneck:
            specs = [(in_channels, filters, 1, 1), (filters, filters, 3, strides),
                     (filters, self.out_channels, 1, 1)]
        else:
            specs = [(in_channels, filters, 3, strides), (filters, filters, 3, 1)]
        if in_channels != self.out_channels or strides != 1:
            specs.append((in_channels, self.out_channels, 1, strides))
        self.convs = nn.ModuleList(Conv(i, o, k, use_bias=False, stride=s, flax_same=True,
                                        dtype=dtype) for i, o, k, s in specs)
        self.norms = nn.ModuleList(BatchNorm(o) for _, o, _, _ in specs)
        self.depth = 3 if bottleneck else 2

    def flax_children(self):
        return _named(self.convs, "TConv", "convs") + _named(self.norms, "BatchNorm", "norms")

    def forward(self, x, train: bool = False):
        y = x
        for i in range(self.depth):
            y = self.norms[i](self.convs[i](y), train=train)
            if i != self.depth - 1:
                y = torch.relu(y)
        residual = x
        if len(self.convs) > self.depth:
            residual = self.norms[-1](self.convs[-1](x), train=train)
        return torch.relu(y + residual)


def _stem(x, conv, norm, train):
    """A 7 x 7 stride-2 conv padded 3, BatchNorm, ReLU, a 3 x 3 stride-2
    max pool padded 1."""
    return F.max_pool2d(torch.relu(norm(conv(x), train=train)), 3, 2, padding=1)


class ResNet(nn.Module):
    """ResNet-18 (basic blocks, stages (2, 2, 2, 2)) or ResNet-50
    (bottlenecks, (3, 4, 6, 3)) regressing ``output_size`` values; with
    ``add_softmax`` the features ``softmax_range`` go through a softmax."""

    def __init__(self, in_channels: int = 3, output_size: int = 10,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2), bottleneck: bool = False,
                 width: int = 64, add_softmax: bool = False,
                 softmax_range: Tuple[int, int] = (0, 441), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.add_softmax = add_softmax
        self.softmax_range = tuple(softmax_range)
        self.stem = Conv(in_channels, width, 7, use_bias=False, stride=2, dtype=dtype)
        self.stem_norm = BatchNorm(width)
        blocks, c = [], width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                blocks.append(_ResBlock(c, width * 2 ** i, 2 if i > 0 and j == 0 else 1,
                                        bottleneck, dtype=dtype))
                c = blocks[-1].out_channels
        self.blocks = nn.ModuleList(blocks)
        self.fc = Linear(c, output_size, dtype=dtype)

    def flax_children(self):
        return ([("stem", ("TConv_0",), self.stem), ("stem_norm", ("BatchNorm_0",), self.stem_norm),
                 ("fc", ("TDense_0",), self.fc)] + _named(self.blocks, "_ResBlock", "blocks"))

    def forward(self, x, train: bool = False):
        x = _stem(x, self.stem, self.stem_norm, train)
        for block in self.blocks:
            x = block(x, train=train)
        x = self.fc(x.mean(dim=(2, 3))).float()
        return selective_softmax(x, self.softmax_range) if self.add_softmax else x


class DenseNet(nn.Module):
    """DenseNet-169-style regressor: dense blocks of BN-ReLU-1x1 conv to
    4 x growth, BN-ReLU-3x3 conv to growth, concatenated; BN-ReLU-1x1
    conv to half the width and a 2 x 2 average pool between blocks; a
    final BN-ReLU, the spatial mean, a Dense layer (and a softmax with
    ``add_softmax``). The convs and norms are kept in flax's order of
    construction."""

    def __init__(self, in_channels: int = 3, output_size: int = 10,
                 block_config: Sequence[int] = (6, 12, 32, 32), growth_rate: int = 32,
                 init_features: int = 64, add_softmax: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_config = tuple(block_config)
        self.add_softmax = add_softmax
        convs = [Conv(in_channels, init_features, 7, use_bias=False, stride=2, dtype=dtype)]
        norms = [BatchNorm(init_features)]
        c = init_features
        for bi, layers in enumerate(self.block_config):
            for _ in range(layers):
                norms += [BatchNorm(c), BatchNorm(4 * growth_rate)]
                convs += [Conv(c, 4 * growth_rate, 1, use_bias=False, dtype=dtype),
                          Conv(4 * growth_rate, growth_rate, 3, use_bias=False, dtype=dtype)]
                c += growth_rate
            if bi != len(self.block_config) - 1:
                norms.append(BatchNorm(c))
                convs.append(Conv(c, c // 2, 1, use_bias=False, dtype=dtype))
                c //= 2
        norms.append(BatchNorm(c))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(norms)
        self.fc = Linear(c, output_size, dtype=dtype)

    def flax_children(self):
        return (_named(self.convs, "TConv", "convs") + _named(self.norms, "BatchNorm", "norms")
                + [("fc", ("TDense_0",), self.fc)])

    def forward(self, x, train: bool = False):
        convs, norms = iter(self.convs), iter(self.norms)

        def bn_relu(v):
            return torch.relu(next(norms)(v, train=train))

        x = F.max_pool2d(bn_relu(next(convs)(x)), 3, 2, padding=1)
        for bi, layers in enumerate(self.block_config):
            for _ in range(layers):
                y = next(convs)(bn_relu(x))
                y = next(convs)(bn_relu(y))
                x = torch.cat([x, y.to(x.dtype)], dim=1)
            if bi != len(self.block_config) - 1:
                x = F.avg_pool2d(next(convs)(bn_relu(x)), 2)
        x = self.fc(bn_relu(x).mean(dim=(2, 3))).float()
        return torch.softmax(x, dim=1) if self.add_softmax else x


class _MBConv(nn.Module):
    """Mobile inverted bottleneck: a 1 x 1 expansion (unless ``expand`` is
    1), a depthwise k x k conv, squeeze-and-excitation by two 1 x 1 convs
    with bias on the pooled map, a 1 x 1 projection; BatchNorm after each
    conv but the SE's, SiLU after the first two; the input added back at
    stride 1 and equal width."""

    def __init__(self, in_channels: int, filters: int, expand: int, kernel: int, strides: int,
                 se_ratio: float = 0.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.residual = strides == 1 and in_channels == filters
        mid = in_channels * expand
        se = max(1, int(in_channels * se_ratio))
        convs = ([Conv(in_channels, mid, 1, use_bias=False, dtype=dtype)] if expand != 1 else [])
        convs += [Conv(mid, mid, kernel, use_bias=False, stride=strides, flax_same=True,
                       groups=mid, dtype=dtype),
                  Conv(mid, se, 1, dtype=dtype), Conv(se, mid, 1, dtype=dtype),
                  Conv(mid, filters, 1, use_bias=False, dtype=dtype)]
        self.expand = expand != 1
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(BatchNorm(c) for c in [mid] * (1 + self.expand) + [filters])

    def flax_children(self):
        return _named(self.convs, "TConv", "convs") + _named(self.norms, "BatchNorm", "norms")

    def forward(self, x, train: bool = False):
        convs, norms = iter(self.convs), iter(self.norms)
        y = x
        if self.expand:
            y = F.silu(next(norms)(next(convs)(y), train=train))
        y = F.silu(next(norms)(next(convs)(y), train=train))
        s = F.silu(next(convs)(y.mean(dim=(2, 3), keepdim=True)))
        y = y * torch.sigmoid(next(convs)(s))
        y = next(norms)(next(convs)(y), train=train)
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """EfficientNet regressor on the B0 plan scaled by ``width_mult`` and
    ``depth_mult`` (B3: 1.2 / 1.4): widths rounded to a multiple of 8
    (at least 8), repeats rounded up."""

    PLAN = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
            (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))  # expand, filters, repeats, strides, kernel

    def __init__(self, in_channels: int = 3, output_size: int = 10, width_mult: float = 1.2,
                 depth_mult: float = 1.4, dtype: torch.dtype = torch.float32):
        super().__init__()

        def w(ch):
            return max(8, int(ch * width_mult + 4) // 8 * 8)

        self.stem = Conv(in_channels, w(32), 3, use_bias=False, stride=2, flax_same=True,
                         dtype=dtype)
        self.stem_norm = BatchNorm(w(32))
        blocks, c = [], w(32)
        for expand, filters, repeats, strides, kernel in self.PLAN:
            for r in range(int(math.ceil(repeats * depth_mult))):
                blocks.append(_MBConv(c, w(filters), expand, kernel, strides if r == 0 else 1,
                                      dtype=dtype))
                c = w(filters)
        self.blocks = nn.ModuleList(blocks)
        self.head = Conv(c, w(1280), 1, use_bias=False, dtype=dtype)
        self.head_norm = BatchNorm(w(1280))
        self.fc = Linear(w(1280), output_size, dtype=dtype)

    def flax_children(self):
        return ([("stem", ("TConv_0",), self.stem), ("stem_norm", ("BatchNorm_0",), self.stem_norm),
                 ("head", ("TConv_1",), self.head), ("head_norm", ("BatchNorm_1",), self.head_norm),
                 ("fc", ("TDense_0",), self.fc)] + _named(self.blocks, "_MBConv", "blocks"))

    def forward(self, x, train: bool = False):
        x = F.silu(self.stem_norm(self.stem(x), train=train))
        for block in self.blocks:
            x = block(x, train=train)
        x = F.silu(self.head_norm(self.head(x), train=train))
        return self.fc(x.mean(dim=(2, 3))).float()


class MAConv(nn.Module):
    """Mutual affine convolution: each channel split is scaled and shifted
    by 1 x 1 convs of the other splits before its own k x k conv. The last
    output split is ``in_channels`` minus the others, as in the JAX package
    (in and out widths are equal in MANet)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 split: int = 2, reduction: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        in_split, out_split = [], []
        for i in range(split):
            last = i == split - 1
            in_split.append(in_channels - sum(in_split) if last else round(in_channels / split))
            out_split.append(in_channels - sum(out_split) if last else round(out_channels / split))
        self.bounds = [int(b) for b in np.cumsum([0] + in_split)]
        convs = []
        for i in range(split):
            rest = in_channels - in_split[i]
            hidden = max(1, rest // reduction)
            convs += [Conv(rest, hidden, 1, dtype=dtype), Conv(hidden, in_split[i] * 2, 1, dtype=dtype),
                      Conv(in_split[i], out_split[i], kernel_size, dtype=dtype)]
        self.convs = nn.ModuleList(convs)

    def flax_children(self):
        return _named(self.convs, "TConv", "convs")

    def forward(self, x):
        b = self.bounds
        parts = [x[:, b[i]:b[i + 1]] for i in range(len(b) - 1)]
        outputs = []
        for i, part in enumerate(parts):
            rest = torch.cat(parts[:i] + parts[i + 1:], dim=1)
            reduce, expand, conv = self.convs[3 * i:3 * i + 3]
            scale, translation = expand(torch.relu(reduce(rest))).chunk(2, dim=1)
            outputs.append(conv(part * torch.sigmoid(scale) + translation))
        return torch.cat(outputs, dim=1)


class MABlock(nn.Module):
    """Two MAConvs with a ReLU between, the input added back."""

    def __init__(self, channels: int = 64, split: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(MAConv(channels, channels, split=split, dtype=dtype)
                                   for _ in range(2))

    def flax_children(self):
        return _named(self.convs, "MAConv", "convs")

    def forward(self, x):
        return x + self.convs[1](torch.relu(self.convs[0](x)))


class MANet(nn.Module):
    """Per-pixel blur-kernel estimator: an edge pad to a multiple of 8, a
    head conv, MABlocks, a 2 x 2 stride-2 'VALID' conv down, MABlocks, a
    transposed conv up (plus the skip), MABlocks, a conv to k^2 channels
    (plus the head's skip), the crop back, a float32 softmax over the k^2
    channels and a nearest spread by ``scale``. Returns (N, k^2, H*s, W*s)."""

    def __init__(self, in_channels: int = 3, kernel_size: int = 21, nc: Sequence[int] = (128, 256),
                 nb: int = 1, split: int = 2, scale: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.head = Conv(in_channels, nc[0], 3, dtype=dtype)
        self.down = Conv(nc[0], nc[1], 2, stride=2, padding=0, dtype=dtype)
        self.up = ConvTranspose(nc[1], nc[0], 2, 2, dtype=dtype)
        self.tail = Conv(nc[0], kernel_size ** 2, 3, dtype=dtype)
        self.blocks = nn.ModuleList([MABlock(nc[0], split, dtype=dtype) for _ in range(nb)]
                                    + [MABlock(nc[1], split, dtype=dtype) for _ in range(nb)]
                                    + [MABlock(nc[0], split, dtype=dtype) for _ in range(nb)])
        self.nb = nb

    def flax_children(self):
        return ([("head", ("TConv_0",), self.head), ("down", ("TConv_1",), self.down),
                 ("tail", ("TConv_2",), self.tail), ("up", ("TConvTranspose_0",), self.up)]
                + _named(self.blocks, "MABlock", "blocks"))

    def forward(self, x, train: bool = False):
        h, w = x.shape[2:]
        x = F.pad(x, (0, (-w) % 8, 0, (-h) % 8), mode="replicate")
        blocks = iter(self.blocks)
        x1 = y = self.head(x)
        for _ in range(self.nb):
            y = next(blocks)(y)
        x2 = y = self.down(y)
        for _ in range(self.nb):
            y = next(blocks)(y)
        y = self.up(y + x2)
        for _ in range(self.nb):
            y = next(blocks)(y)
        y = self.tail(y + x1)[:, :, :h, :w]
        return upsample_nearest(torch.softmax(y.float(), dim=1), self.scale)


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

class StandardRegressorHandler(BaseHandler):
    """Direct degradation regression: targets normalised by
    ``normalization_scheme`` (``zero_mean``: mean/std; ``zero_to_one``:
    minim/maxim), an L1 loss (plus the occupancy loss, its threshold moved
    into the normalised space), evaluation on a centre crop of large
    inputs or on ``input_patch_num`` random patches stacked on channels
    (drawn by ``np.random.default_rng(0)`` on the host, as in the JAX
    package), the predictions un-normalised. The network takes
    ``in_features * input_patch_num`` channels."""

    colorspace = "rgb"
    task = "regression"
    loss_type = "l1"
    # trained by the regression route on one crop an item, not on
    # contrastive views (training/regression_trainer.py)
    direct_regressor = True

    def __init__(self, output_size=10, input_patch_num=1, centercrop_patch_eval=True,
                 crop_size=200, normalization_scheme=None, normalization_params=None,
                 occupancy_loss=False, occ_weight=1.0, l1_weight=1.0,
                 patch_selection_strategy="random", **kwargs):
        self.output_size = output_size
        self.input_patch_num = input_patch_num
        self.centercrop_patch_eval = centercrop_patch_eval
        self.crop_size = crop_size
        self.normalization_scheme = normalization_scheme
        params = dict(normalization_params or {})
        if normalization_scheme and not normalization_params:
            raise RuntimeError("Normalization parameters (mean, max etc.) "
                               "need to be specified if normalization is "
                               "required.")
        self.use_occ_loss = occupancy_loss
        if occupancy_loss and normalization_scheme:
            self.occ_thres = float((1e-6 - params.get("mean", 0.0)) / params.get("std", 1.0))
        else:
            self.occ_thres = 1e-6
        self.occ_weight = occ_weight
        self.l1_weight = l1_weight
        self.patch_selection_strategy = patch_selection_strategy
        super().__init__(**kwargs)
        self.norm_params = {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
                            for k, v in params.items()}

    @property
    def in_channels(self) -> int:
        return self.in_features * max(1, self.input_patch_num)

    def example_inputs(self, batch: int = 1, size: int = 32):
        return (torch.zeros((batch, size, size, self.in_channels), device=self.device),)

    def norm(self, y):
        p = self.norm_params
        if self.normalization_scheme == "zero_mean":
            return (y - p["mean"]) / p["std"]
        if self.normalization_scheme == "zero_to_one":
            return (y - p["minim"]) / (p["maxim"] - p["minim"])
        return y

    def unnorm(self, y):
        p = self.norm_params
        if self.normalization_scheme == "zero_mean":
            return y * p["std"] + p["mean"]
        if self.normalization_scheme == "zero_to_one":
            return y * (p["maxim"] - p["minim"]) + p["minim"]
        return y

    def apply(self, params, batch, train=False, rng=None, extra=None):
        """The network on NHWC ``lr``: a train call normalises its BatchNorms
        by the batch's statistics and updates the running ones. Returns
        (N, output_size) predictions, or an NHWC map (MANet)."""
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        out = self.module(lr.permute(0, 3, 1, 2), train=train)
        return (out.permute(0, 2, 3, 1) if out.dim() == 4 else out), {}, extra

    def compute_losses(self, pred, batch, aux):
        target = self.norm(batch["metadata"].float()).reshape(pred.shape[0], -1)
        l1 = (pred - target).abs().mean()
        if self.use_occ_loss:
            occ = indicator_occupancy_loss(pred, target, self.occ_thres)
            return {"train-loss": self.l1_weight * l1 + self.occ_weight * occ,
                    "l1-loss": l1, "occ-loss": occ}
        return {"train-loss": l1}

    def run_eval(self, state, batch):
        x = torch.as_tensor(batch["lr"], device=self.device)
        crop = self.crop_size
        if self.centercrop_patch_eval and x.shape[1] > crop and x.shape[2] > crop:
            top, left = (x.shape[1] - crop) // 2, (x.shape[2] - crop) // 2
            batch = dict(batch, lr=x[:, top:top + crop, left:left + crop, :])
        elif (not self.centercrop_patch_eval and self.input_patch_num > 1
              and x.shape[-1] == self.in_features):
            rng = np.random.default_rng(0)
            patches = []
            for _ in range(self.input_patch_num):
                top = int(rng.integers(0, max(1, x.shape[1] - crop + 1)))
                left = int(rng.integers(0, max(1, x.shape[2] - crop + 1)))
                patches.append(x[:, top:top + crop, left:left + crop, :])
            batch = dict(batch, lr=torch.cat(patches, dim=-1))
        return self.unnorm(super().run_eval(state, batch))

    def run_embedding(self, state, images):
        """ContrastiveEval's hook: a direct regressor's embedding is its
        predicted (un-normalised) degradation vector."""
        return self.run_eval(state, {"lr": images})

    def _jax_state_dict(self, loaded):
        """A JAX-written checkpoint keeps the BatchNorm statistics in
        ``extra.bstats``."""
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        stats = (loaded.get("extra") or {}).get("bstats") or None
        return state_dict_from_jax(loaded["network"], self.module, batch_stats=stats)


@register_model("basicnn")
class BasicNNHandler(StandardRegressorHandler):
    def build_module(self, **kw):
        return BasicNet(self.in_channels, self.output_size, dtype=self.dtype, **kw)


@register_model("resnet")
class ResnetHandler(StandardRegressorHandler):
    """``model_type`` resnet18 or resnet50."""

    def __init__(self, model_type="resnet18", add_softmax=False, **kwargs):
        self.model_type = model_type
        self.add_softmax = add_softmax
        super().__init__(**kwargs)

    def build_module(self, **kw):
        if self.model_type == "resnet18":
            sizes, bottleneck = (2, 2, 2, 2), False
        elif self.model_type == "resnet50":
            sizes, bottleneck = (3, 4, 6, 3), True
        else:
            raise RuntimeError("Model Undefined.")
        return ResNet(self.in_channels, self.output_size, sizes, bottleneck,
                      add_softmax=self.add_softmax, dtype=self.dtype, **kw)


@register_model("efficientnet")
class EfficientnetHandler(StandardRegressorHandler):
    def build_module(self, **kw):
        return EfficientNet(self.in_channels, self.output_size, dtype=self.dtype, **kw)


@register_model("densenet")
class DensenetHandler(StandardRegressorHandler):
    def __init__(self, add_softmax=False, **kwargs):
        self.add_softmax = add_softmax
        super().__init__(**kwargs)

    def build_module(self, **kw):
        return DenseNet(self.in_channels, self.output_size, add_softmax=self.add_softmax,
                        dtype=self.dtype, **kw)


@register_model("manet")
class ManetHandler(StandardRegressorHandler):
    """Per-pixel kernel predictor. With ``invariant_kernel`` an (N, k^2)
    kernel target is spread over the HR map before the L1 loss; its
    evaluation returns the map as it is (no crop, no un-normalisation)."""

    def __init__(self, kernel_size=21, sr_scale=4, invariant_kernel=False, **kwargs):
        self.kernel_size = kernel_size
        self.sr_scale = sr_scale
        self.invariant_kernel = invariant_kernel
        kwargs.setdefault("centercrop_patch_eval", False)
        super().__init__(**kwargs)

    def build_module(self, **kw):
        return MANet(self.in_channels, self.kernel_size, scale=self.sr_scale, dtype=self.dtype,
                     **kw)

    def compute_losses(self, pred, batch, aux):
        target = batch["metadata"].float()
        if self.invariant_kernel and target.dim() == 2:
            target = target[:, None, None, :].expand(pred.shape)
        return {"train-loss": (pred - target).abs().mean()}

    def run_eval(self, state, batch):
        return BaseHandler.run_eval(self, state, batch)
