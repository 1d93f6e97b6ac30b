"""Meta-attention family: the blocks that feed degradation metadata into an
SR network (the "Best of Both Worlds" injection mechanism).

Port of ``rumpy_tpu/models/attention_manipulators.py``: ``ParaCALayer``,
``PALayer``, ``SFTLayer``, ``QCALayer`` in its six styles, ``QRCAB``,
``QResidualGroup``, ``QRCAN``, ``ParamResBlock``, ``QEDSR``, Metabed's
metadata layers (``ResPipesCALayer``, ``ResPipesSplitCALayer``,
``DGFMBLayer``), the metadata-size rules and the ``qrcan`` and ``qedsr``
handlers. Metadata rides as an (N, M) tensor; SFT layers take it tiled to
(N, M, H, W) maps.

A QRCAB is an RCAB whose channel attention takes the metadata, and whose
branch a metadata gate may multiply. Its route is fixed when it is built,
from its options. The four foldable styles without pixel attention or SFT
turn into per-image inputs of the fused RCAB kernel
(``ops/cuda/rcab_fused.py``), forward and backward:

* ``standard``: the RCAB's gate; the q-layer gate q (N, C), if any, is the
  kernel's per-image scale;
* ``max_concat``: ``conv_down(concat(GAP(h2), m)) = GAP(h2) wd[:C] +
  (m wd[C:] + bd)``, a per-image down bias;
* ``mini_concat``: ``conv_up(relu(concat(z, m))) = relu(z) wu[:R] +
  (relu(m) wu[R:] + bu)``, a per-image up bias;
* ``modulate``: the gate times m, so m (times q) is the per-image scale.

These per-image inputs come from small PyTorch ops on the (N, M) metadata
before the kernel, in float32 (the kernel's type for them; the JAX package
rounds them to the activation type), and autograd carries their gradients
on to ``wd[C:]``, ``wu[R:]`` and the q-layer.

The kernel cannot take a softmax over the gate (``softmax``), a gate MLP
fed the metadata at every layer (``extended_attention``), or a per-pixel
PA or SFT after the gate. A block with any of these is the plain route:
cuDNN convs and PyTorch ops in the JAX block's order (conv, ReLU, conv,
channel attention, PA, q-layer, SFT, ``x + res``), in the activation type,
with the metadata rounded to it as flax rounds it. The JAX package's QRCAN
reaches no Pallas kernel at all; each route computes its block.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import true_div
from rumpy_tpu_torch.models.base import BaseHandler
from rumpy_tpu_torch.models.common import RCAB, Conv, Upsampler, tile_maps
from rumpy_tpu_torch.ops.cuda import rcab_fused as rcab_ops
from rumpy_tpu_torch.registry import register_model

KERNEL_STYLES = ("standard", "modulate", "max_concat", "mini_concat")
STYLES = KERNEL_STYLES + ("softmax", "extended_attention")


def para_ca_widths(network_channels: int, num_metadata: int,
                   num_layers: int = 2) -> Tuple[int, ...]:
    """The q-layer's output widths: past 15 metadata values the stack steps
    from M towards C (Python floor division, so (64 - 256) // 2 + 256 =
    160), else it takes C // multiplier."""
    widths, multiplier = [], num_layers
    for _ in range(num_layers):
        if num_metadata > 15:
            widths.append((network_channels - num_metadata) // multiplier + num_metadata)
        else:
            widths.append(network_channels // multiplier)
        multiplier -= 1
    return tuple(widths)


class ParaCALayer(nn.Module):
    """Meta-attention: metadata (N, M) -> staged 1x1 convs -> sigmoid ->
    channel gate (N, C)."""

    def __init__(self, network_channels: int, num_metadata: int,
                 nonlinearity: bool = True, num_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nonlinearity = nonlinearity
        widths = para_ca_widths(network_channels, num_metadata, num_layers)
        self.convs = nn.ModuleList(
            Conv(i, o, 1, dtype=dtype)
            for i, o in zip((num_metadata,) + widths[:-1], widths))

    def gate(self, attributes: torch.Tensor) -> torch.Tensor:
        """The gate (N, C) of metadata (N, M)."""
        y = attributes
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            y = conv.as_linear(y)
            if self.nonlinearity and i != last:
                y = torch.relu(y)
        return torch.sigmoid(y)

    def forward(self, x, attributes):
        return x * self.gate(attributes)[:, :, None, None].to(x.dtype)


class PALayer(nn.Module):
    """Pixel attention: a per-pixel sigmoid gate from two 1x1 convs."""

    def __init__(self, channel: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down = Conv(channel, channel // 8, 1, dtype=dtype)
        self.up = Conv(channel // 8, 1, 1, dtype=dtype)

    def forward(self, x):
        return x * torch.sigmoid(self.up(torch.relu(self.down(x))))


class SFTLayer(nn.Module):
    """Spatial feature transform: scale and shift from 1x1 convs of
    concat(x, metadata maps (N, M, H, W)); ``x * (scale + 1) + shift``.
    Children in flax's order of construction (an outer conv is built
    before its inner one): ``scale_out``, ``scale_in``, ``shift_out``,
    ``shift_in``."""

    def __init__(self, nf: int, para: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale_out = Conv(nf, nf, 1, dtype=dtype)
        self.scale_in = Conv(nf + para, nf, 1, dtype=dtype)
        self.shift_out = Conv(nf, nf, 1, dtype=dtype)
        self.shift_in = Conv(nf + para, nf, 1, dtype=dtype)

    def forward(self, x, meta_maps):
        cond = torch.cat([x, meta_maps.to(x.dtype)], dim=1)
        scale = self.scale_out(F.leaky_relu(self.scale_in(cond), 0.1))
        shift = self.shift_out(F.leaky_relu(self.shift_in(cond), 0.1))
        return x * (scale + 1.0) + shift


def _stack_gate(convs, y, relu: bool):
    """1x1 convs on (N, M) vectors, a ReLU after each where asked."""
    for conv in convs:
        y = conv.as_linear(y)
        if relu:
            y = torch.relu(y)
    return y


def _pipe_depth(num_layers, i: int) -> int:
    return num_layers[i] if isinstance(num_layers, (list, tuple)) else num_layers + i


def _pipe_widths(start: int, stop: int, n: int) -> Tuple[int, ...]:
    """``n`` layers from ``start`` to ``stop`` channels in equal steps,
    truncated by ``int`` (the JAX package's sizing)."""
    diff = (stop - start) / n
    return tuple(int(diff * j + start) for j in range(n + 1))


class _PipesGate(nn.Module):
    """Base of the pipe layers: ``pipes`` (lists of 1x1 convs) and ``out``,
    in flax's order of construction; ``gate`` (N, C) scales the features."""

    def forward(self, x, attributes):
        return x * self.gate(attributes)[:, :, None, None].to(x.dtype)

    def flax_children(self):
        convs = [(f"pipes.{i}.{j}", c) for i, p in enumerate(self.pipes) for j, c in enumerate(p)]
        convs.append(("out", self.out))
        return [(name, (f"TConv_{k}",), c) for k, (name, c) in enumerate(convs)]


class ResPipesCALayer(_PipesGate):
    """Multi-pipe meta-attention: ``num_pipes`` stacks of 1x1 convs of
    increasing depth (``num_layers + i``, or ``num_layers[i]``) take the
    metadata from M to C channels; their outputs, concatenated (or added),
    go through a last 1x1 conv and a sigmoid into a channel gate."""

    def __init__(self, network_channels: int, num_metadata: int, nonlinearity: bool = True,
                 num_layers=2, num_pipes: int = 3, combine_pipes: str = "concat",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nonlinearity = nonlinearity
        self.combine_pipes = combine_pipes
        self.pipes = nn.ModuleList()
        for i in range(num_pipes):
            w = _pipe_widths(num_metadata, network_channels, _pipe_depth(num_layers, i))
            self.pipes.append(nn.ModuleList(Conv(a, b, 1, dtype=dtype)
                                            for a, b in zip(w[:-1], w[1:])))
        width = network_channels * (1 if combine_pipes == "add" else num_pipes)
        self.out = Conv(width, network_channels, 1, dtype=dtype)

    def gate(self, attributes):
        outs = [_stack_gate(p, attributes, self.nonlinearity) for p in self.pipes]
        combined = sum(outs) if self.combine_pipes == "add" else torch.cat(outs, dim=1)
        return torch.sigmoid(self.out.as_linear(combined))


class ResPipesSplitCALayer(_PipesGate):
    """Split-pipe meta-attention: pipe 0 maps the metadata to C channels,
    keeps the first ``int(C * split_percent)`` and hands the rest to the
    next pipe; the last pipe ends at the kept width; the kept slices,
    concatenated, go through a last 1x1 conv and a sigmoid."""

    def __init__(self, network_channels: int, num_metadata: int, nonlinearity: bool = True,
                 num_layers=2, num_pipes: int = 3, split_percent: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nonlinearity = nonlinearity
        self.split_f = int(network_channels * split_percent)
        rem_f = network_channels - self.split_f
        self.pipes = nn.ModuleList()
        for i in range(num_pipes):
            start = num_metadata if i == 0 else rem_f
            stop = self.split_f if i == num_pipes - 1 else network_channels
            w = _pipe_widths(start, stop, _pipe_depth(num_layers, i))
            self.pipes.append(nn.ModuleList(Conv(a, b, 1, dtype=dtype)
                                            for a, b in zip(w[:-1], w[1:])))
        self.out = Conv(self.split_f * num_pipes, network_channels, 1, dtype=dtype)

    def gate(self, attributes):
        kept, carry, last = [], attributes, len(self.pipes) - 1
        for i, pipe in enumerate(self.pipes):
            h = _stack_gate(pipe, carry, self.nonlinearity)
            if i == last:
                kept.append(h)
            else:
                kept.append(h[:, :self.split_f])
                carry = h[:, self.split_f:]
        return torch.sigmoid(self.out.as_linear(torch.cat(kept, dim=1)))


class DGFMBLayer(nn.Module):
    """Degradation-guided feature modulation: the features' global average
    concatenated with the (1x1-reduced) degradation encoding, a stack of
    1x1 convs without activations, a sigmoid; ``x * att + x``."""

    def __init__(self, num_channels: int = 64, degradation_full_dim: int = 256,
                 degradation_reduced_dim: int = 64, num_layers=2, use_reduction: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        red_dim = degradation_reduced_dim if use_reduction else degradation_full_dim
        self.reduce = (Conv(degradation_full_dim, red_dim, 1, dtype=dtype)
                       if use_reduction else None)
        combined = num_channels + red_dim
        if isinstance(num_layers, (list, tuple)):
            sizes = list(num_layers) + [num_channels]
        else:
            sizes, multiplier = [], num_layers
            for _ in range(num_layers):
                sizes.append((num_channels - combined) // multiplier + combined
                             if combined > 15 else num_channels // multiplier)
                multiplier -= 1
        ins = [combined] + sizes[:-1]
        self.convs = nn.ModuleList(Conv(a, b, 1, dtype=dtype) for a, b in zip(ins, sizes))

    def forward(self, features, encoding):
        gap = features.mean(dim=(2, 3))
        enc = encoding.to(features.dtype)
        if self.reduce is not None:
            enc = self.reduce.as_linear(enc)
        y = _stack_gate(self.convs, torch.cat([gap, enc.to(gap.dtype)], dim=1), False)
        return features * torch.sigmoid(y)[:, :, None, None].to(features.dtype) + features

    def flax_children(self):
        convs = ([("reduce", self.reduce)] if self.reduce is not None else []) + [
            (f"convs.{i}", c) for i, c in enumerate(self.convs)]
        return [(name, (f"TConv_{k}",), c) for k, (name, c) in enumerate(convs)]


class QCALayer(nn.Module):
    """Channel attention fused with metadata, in six styles. It holds the
    squeeze (``down``) and excitation (``up``) 1x1 convs, and for
    ``extended_attention`` three convs fed ``concat(y, m)`` (widths C/2,
    C/4 and R) before ``up``. The four kernel styles give the fused
    kernel its gate inputs (:meth:`kernel_inputs`); every style computes
    its attention on the plain route (:meth:`attention`)."""

    def __init__(self, channel: int, style: str = "modulate", reduction: int = 16,
                 num_metadata: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        if style not in STYLES:
            raise NotImplementedError(style)
        self.style = style
        red = max(1, channel // reduction)
        if style == "extended_attention":
            widths = (channel // 2, channel // 4, red)
            self.concat = nn.ModuleList(
                Conv(i + num_metadata, o, 1, dtype=dtype)
                for i, o in zip((channel,) + widths[:-1], widths))
            self.up = Conv(red, channel, 1, dtype=dtype)
            return
        concat_down = style in ("max_concat", "softmax")
        self.down = Conv(channel + (num_metadata if concat_down else 0), red, 1, dtype=dtype)
        self.up = Conv(red + (num_metadata if style == "mini_concat" else 0),
                       channel, 1, dtype=dtype)

    def kernel_inputs(self, wd, bd, wu, bu, attributes):
        """The kernel's gate inputs from the packed (in, out) weights and
        metadata (N, M) float32: (wd (C, R), bd (R,) or (N, R), wu (R, C),
        bu (C,) or (N, C), scale (N, C) or None)."""
        c, r = wu.shape[-1], wd.shape[-1]
        if self.style == "max_concat":
            return wd[:c], bd + attributes @ wd[c:], wu, bu, None
        if self.style == "mini_concat":
            return wd, bd, wu[:r], bu + torch.relu(attributes) @ wu[r:], None
        if self.style == "modulate":
            return wd, bd, wu, bu, attributes.expand(-1, c)
        return wd, bd, wu, bu, None

    def attention(self, y, attributes):
        """The attention (N, C) of GAP(h2) ``y`` (N, C) and metadata
        (N, M), both in the activation type, as the JAX layer computes it."""
        style = self.style
        if style == "extended_attention":
            for conv in self.concat:
                y = torch.relu(conv.as_linear(torch.cat([y, attributes], dim=1)))
            return torch.sigmoid(self.up.as_linear(y))
        if style in ("max_concat", "softmax"):
            y = torch.relu(self.down.as_linear(torch.cat([y, attributes], dim=1)))
        elif style == "mini_concat":
            y = torch.relu(torch.cat([self.down.as_linear(y), attributes], dim=1))
        else:
            y = torch.relu(self.down.as_linear(y))
        y = torch.sigmoid(self.up.as_linear(y))
        if style == "softmax":
            return torch.softmax(y, dim=1)
        return y * attributes if style == "modulate" else y

    def forward(self, x, attributes):
        y = x.mean(dim=(2, 3))
        return x * self.attention(y, attributes.to(y.dtype))[:, :, None, None]


class QRCAB(RCAB):
    """RCAB with a metadata-fed channel attention (``ca``), and optional
    pixel attention (``pa``), q-layer (``q``) and SFT layer (``sft``). Like
    the JAX package's block it takes no res_scale. ``fused`` is fixed at
    construction: True runs the fused kernel with per-image gate inputs,
    False the plain route (see the module docstring)."""

    def __init__(self, features: int, reduction: int = 16, style: str = "modulate",
                 q_layer: bool = False, pa: bool = False, sft_layer: bool = False,
                 num_metadata: int = 1, num_layers_in_q_layer: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__(features, reduction, 1.0, dtype=dtype)
        self.fused = style in KERNEL_STYLES and not pa and not sft_layer
        self.ca = QCALayer(features, style, reduction, num_metadata, dtype=dtype)
        self.pa = PALayer(features, dtype=dtype) if pa else None
        # the kernel takes the q-layer's gate in float32
        self.q = (ParaCALayer(features, num_metadata, nonlinearity=True,
                              num_layers=num_layers_in_q_layer,
                              dtype=torch.float32 if self.fused else dtype)
                  if q_layer else None)
        self.sft = SFTLayer(features, num_metadata, dtype=dtype) if sft_layer else None

    def forward(self, x, metadata, meta_maps=None):
        if not self.fused:
            return self._plain(x, metadata, meta_maps)
        w1, b1, w2, b2, wd, bd, wu, bu = self._kernel_weights()
        a = metadata.float()
        wd, bd, wu, bu, scale = self.ca.kernel_inputs(wd, bd, wu, bu, a)
        if self.q is not None:
            q = self.q.gate(a)
            scale = q if scale is None else scale * q
        y = rcab_ops.rcab_fused(x.to(self.dtype).permute(0, 2, 3, 1), w1, b1, w2, b2,
                                wd, bd, wu, bu, res_scale=1.0 if scale is None else scale)
        return y.permute(0, 3, 1, 2)

    def _plain(self, x, metadata, meta_maps):
        x = x.to(self.dtype)
        res = self.conv2(torch.relu(self.conv1(x)))
        res = self.ca(res, metadata)
        if self.pa is not None:
            res = self.pa(res)
        if self.q is not None:
            res = self.q(res, metadata)
        if self.sft is not None and meta_maps is not None:
            res = self.sft(res, meta_maps)
        return x + res


class QResidualGroup(nn.Module):
    def __init__(self, features: int, n_resblocks: int = 20, reduction: int = 16,
                 style: str = "modulate", q_layer: bool = False, pa: bool = False,
                 sft_layer: bool = False, num_q_layers: Optional[int] = None,
                 num_metadata: int = 1, num_layers_in_q_layer: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(
            QRCAB(features, reduction, style,
                  q_layer=q_layer and (num_q_layers is None or i < num_q_layers),
                  pa=pa, sft_layer=sft_layer, num_metadata=num_metadata,
                  num_layers_in_q_layer=num_layers_in_q_layer, dtype=dtype)
            for i in range(n_resblocks))
        self.tail = Conv(features, features, 3, dtype=dtype)

    def forward(self, x, metadata, meta_maps=None):
        res = x
        for block in self.blocks:
            res = block(res, metadata, meta_maps)
        return x + self.tail(res)


class QRCAN(nn.Module):
    """RCAN whose blocks take metadata (N, M) (and, with SFT layers, its
    maps (N, M, H, W)); ``selective_meta_blocks`` (one flag a group)
    switches the q-layer and SFT off in a group, and
    ``num_q_layers_inner_residual`` keeps the q-layer in a group's first
    blocks only. The channel attention takes the metadata in every block."""

    def __init__(self, scale: int = 4, in_feats: int = 3, out_feats: int = 3,
                 n_feats: int = 64, n_resgroups: int = 10, n_resblocks: int = 20,
                 reduction: int = 16, style: str = "modulate", num_metadata: int = 1,
                 include_q_layer: bool = False, include_pixel_attention: bool = False,
                 include_sft_layer: bool = False,
                 selective_meta_blocks: Optional[Sequence[bool]] = None,
                 num_q_layers_inner_residual: Optional[int] = None,
                 num_layers_in_q_layer: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_feats = n_feats
        self.num_metadata = num_metadata
        self.include_sft_layer = include_sft_layer
        self.head = Conv(in_feats, n_feats, 3, dtype=dtype)
        self.groups = nn.ModuleList(
            QResidualGroup(
                n_feats, n_resblocks, reduction, style,
                q_layer=include_q_layer and (selective_meta_blocks is None
                                             or bool(selective_meta_blocks[g])),
                pa=include_pixel_attention,
                sft_layer=include_sft_layer and (selective_meta_blocks is None
                                                 or bool(selective_meta_blocks[g])),
                num_q_layers=num_q_layers_inner_residual, num_metadata=num_metadata,
                num_layers_in_q_layer=num_layers_in_q_layer, dtype=dtype)
            for g in range(n_resgroups))
        self.body_tail = Conv(n_feats, n_feats, 3, dtype=dtype)
        self.upsampler = Upsampler(scale, n_feats, dtype=dtype)
        self.tail = Conv(n_feats, out_feats, 3, dtype=dtype)

    def forward(self, x, metadata, meta_maps=None):
        metadata = metadata.float()  # once, not in each of the blocks
        x = self.head(x)
        res = x
        for group in self.groups:
            res = group(res, metadata, meta_maps)
        res = self.body_tail(res) + x
        return self.tail(self.upsampler(res))


class ParamResBlock(nn.Module):
    """EDSR ResBlock (conv, ReLU, conv, times ``res_scale``) with an
    optional q-layer on its branch."""

    def __init__(self, features: int, input_para: int, res_scale: float = 0.1,
                 add_q_layer: bool = True, q_layer_nonlinearity: bool = False,
                 num_layers: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv(features, features, 3, dtype=dtype)
        self.conv2 = Conv(features, features, 3, dtype=dtype)
        self.q = (ParaCALayer(features, input_para, nonlinearity=q_layer_nonlinearity,
                              num_layers=num_layers, dtype=dtype)
                  if add_q_layer else None)

    def forward(self, x, metadata):
        res = self.conv2(torch.relu(self.conv1(x))) * self.res_scale
        if self.q is not None:
            res = self.q(res, metadata)
        return x + res


class QEDSR(nn.Module):
    """EDSR of ParamResBlocks; ``selective_meta_blocks`` (one flag a block,
    or ``"front_only"`` for the first block alone) says which take a
    q-layer."""

    def __init__(self, scale: int = 4, in_features: int = 3, out_features: int = 3,
                 num_features: int = 64, num_blocks: int = 16, res_scale: float = 0.1,
                 input_para: int = 1, q_layer_nonlinearity: bool = False,
                 selective_meta_blocks: Union[None, str, Sequence[bool]] = None,
                 num_layers: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        smb = selective_meta_blocks
        if smb == "front_only":
            smb = (True,) + (False,) * (num_blocks - 1)
        self.head = Conv(in_features, num_features, 3, dtype=dtype)
        self.blocks = nn.ModuleList(
            ParamResBlock(num_features, input_para, res_scale,
                          add_q_layer=smb is None or bool(smb[i]),
                          q_layer_nonlinearity=q_layer_nonlinearity,
                          num_layers=num_layers, dtype=dtype)
            for i in range(num_blocks))
        self.body_tail = Conv(num_features, num_features, 3, dtype=dtype)
        self.upsampler = Upsampler(scale, num_features, dtype=dtype)
        self.tail = Conv(num_features, out_features, 3, dtype=dtype)

    def forward(self, x, metadata):
        metadata = metadata.float()
        x = self.head(x)
        res = x
        for block in self.blocks:
            res = block(res, metadata)
        res = self.body_tail(res) + x
        return self.tail(self.upsampler(res))


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

# Fixed metadata-size expansions of the JAX package's QModel handlers.
_EXPANSIONS = {
    "contrastive_encoding": 255,
    "contrastive_q": 255,
    "contrastive_encoding_tsne": 1,
    "contrastive_q_tsne": 1,
    "contrastive_encoding_pca": 10,
    "contrastive_q_pca": 7,
    "all": 39,  # all celeba attributes
}


def compute_num_metadata(metadata: Optional[Sequence[str]],
                         metadata_bypass_len: Optional[int] = None) -> int:
    if metadata_bypass_len:
        return metadata_bypass_len
    if metadata is None:
        return 1  # defaults to ['qpi']
    n = len(metadata)
    for key, extra in _EXPANSIONS.items():
        if key in metadata:
            n += extra
    if "blur_kernel" in metadata:
        n += 9  # 10-component PCA kernel occupies 10 slots (1 + 9)
    elif any("unmodified_blur_kernel" in m for m in metadata):
        n += 440  # full 21x21 kernel (441 slots)
    return n


def select_metadata_columns(metadata, keys, requested):
    """Mask a (B, K) metadata matrix down to the requested key list: 'all'
    in the requested list selects every column; otherwise a column is kept
    when its key matches a requested name exactly or as the suffix of a
    'step-op-name' column."""
    if keys is None or requested is None or "all" in requested:
        return metadata
    mask = [any(k == m or k.endswith(f"-{m}") for m in requested) for k in keys]
    return metadata[:, np.nonzero(mask)[0]]


class QModelHandler(BaseHandler):
    """Base of the metadata-injection handlers: the metadata vector's size
    and key selection; the network takes ``batch["metadata"]`` (N, M)."""

    uses_metadata = True
    colorspace = "rgb"
    im_input = "unmodified"

    def __init__(self, metadata=None, metadata_bypass_len=None,
                 ignore_degradation_location=False, **kwargs):
        if metadata is None and metadata_bypass_len is None:
            metadata = ["qpi"]
        if metadata is not None and ignore_degradation_location:
            metadata = [m[2:] if m[0].isdigit() else m for m in metadata]
        self.metadata_keys = list(metadata) if metadata else None
        self.num_metadata = compute_num_metadata(metadata, metadata_bypass_len)
        super().__init__(**kwargs)

    def select_metadata(self, metadata, keys=None):
        return select_metadata_columns(metadata, keys, self.metadata_keys)

    def _metadata(self, batch) -> torch.Tensor:
        meta = batch.get("metadata")
        if meta is None:
            raise RuntimeError("Metadata needs to be specified for this "
                               "network to run properly.")
        return torch.as_tensor(meta, device=self.device).float()

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        sr = self.module(lr.permute(0, 3, 1, 2), self._metadata(batch))
        return sr.permute(0, 2, 3, 1), {}, extra

    def handler_metadata(self):
        return {"metadata_keys_used_in_training": self.metadata_keys,
                "num_metadata": self.num_metadata}


@register_model("qrcan")
class QRCANHandler(QModelHandler):
    """QRCAN; ``style="modulate"`` with one metadata value expands it into
    an n_feats-long gaussian profile (``scale_qpi``)."""

    def __init__(self, style="modulate", include_q_layer=True,
                 selective_meta_blocks=None, num_q_layers_inner_residual=None,
                 n_feats=64, n_resgroups=10, n_resblocks=20, reduction=16,
                 include_pixel_attention=False, include_sft_layer=False,
                 clamp=False, min_mu=-0.2, max_mu=0.8, **kwargs):
        self.style = style
        self.clamp = clamp
        self.min_mu = min_mu
        self.max_mu = max_mu
        super().__init__(
            style=style, include_q_layer=include_q_layer,
            selective_meta_blocks=(tuple(selective_meta_blocks)
                                   if selective_meta_blocks else None),
            num_q_layers_inner_residual=num_q_layers_inner_residual,
            n_feats=n_feats, n_resgroups=n_resgroups, n_resblocks=n_resblocks,
            reduction=reduction, include_pixel_attention=include_pixel_attention,
            include_sft_layer=include_sft_layer, **kwargs)

    def build_module(self, **kw):
        eff_meta = (kw["n_feats"] if self.style == "modulate" and self.num_metadata == 1
                    else self.num_metadata)
        return QRCAN(scale=self.scale, in_feats=self.in_features,
                     num_metadata=eff_meta, dtype=self.dtype, **kw)

    def _metadata(self, batch) -> torch.Tensor:
        meta = super()._metadata(batch)
        if self.style == "modulate" and meta.shape[-1] == 1:
            meta = self.scale_qpi(meta)
        return meta

    def apply(self, params, batch, train=False, rng=None, extra=None):
        """With SFT layers the metadata also goes in tiled to (N, M, H, W)
        maps (a broadcast view; each SFT layer's concat copies it)."""
        self._use_params(params)
        x = torch.as_tensor(batch["lr"], device=self.device).permute(0, 3, 1, 2)
        meta = self._metadata(batch)
        maps = None
        if self.module.include_sft_layer:
            maps = tile_maps(meta, *x.shape[2:])
        return self.module(x, meta, maps).permute(0, 2, 3, 1), {}, extra

    def scale_qpi(self, qpi: torch.Tensor) -> torch.Tensor:
        """Gaussian channel profile centred by the (normalised) qpi (N, 1):
        (N, n_feats)."""
        n_feats = self.module.n_feats
        base = torch.linspace(0.0, 1.0, n_feats, device=qpi.device)
        mu = qpi * (self.max_mu - self.min_mu) + self.min_mu
        sig = 0.2
        g = (1 / (np.sqrt(2 * np.pi) * sig)) * torch.exp(
            true_div(-((base[None, :] - mu) ** 2), 2 * sig ** 2))
        return torch.clamp(g, 0.0, 1.0) if self.clamp else g


@register_model("qedsr")
class QEDSRHandler(QModelHandler):
    """QEDSR: EDSR whose blocks gate their branch by a q-layer of the
    metadata."""

    def __init__(self, num_features=64, num_blocks=16, res_scale=0.1,
                 selective_meta_blocks=None, q_layer_nonlinearity=False, **kwargs):
        super().__init__(
            num_features=num_features, num_blocks=num_blocks, res_scale=res_scale,
            selective_meta_blocks=(tuple(selective_meta_blocks)
                                   if isinstance(selective_meta_blocks, (list, tuple))
                                   else selective_meta_blocks),
            q_layer_nonlinearity=q_layer_nonlinearity, **kwargs)

    def build_module(self, **kw):
        return QEDSR(scale=self.scale, in_features=self.in_features,
                     input_para=self.num_metadata, dtype=self.dtype, **kw)
