"""SFTMD family: SR conditioned on per-pixel degradation maps through
spatial feature transform layers of a selectable type.

Port of ``rumpy_tpu/models/sftmd_variants.py``. SFT types: ``standard``
(a sigmoid scale and a shift from concat(features, maps)), ``concat`` (one
conv of the concat), ``weak`` (features times the maps), ``split``
(parallel feature and conditioned conv stacks, summed) and ``none``.
Every layer is a cuDNN conv or a PyTorch op: the JAX package computes none
of them in a Pallas kernel. Each SFT module keeps its convs in flax's order
of construction (``convs``) and its flax class name (``flax_name``) for the
weight bridge.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.attention_manipulators import ParaCALayer, QModelHandler
from rumpy_tpu_torch.models.common import Conv, pixel_shuffle, tile_maps
from rumpy_tpu_torch.registry import register_model


def _cat(fea, para):
    return torch.cat([fea, para.to(fea.dtype)], dim=1)


class SftConvs(nn.Module):
    """An SFT layer: ``forward(features, maps)`` with its convs in flax's
    order."""

    flax_name = ""

    def __init__(self, convs=()):
        super().__init__()
        self.convs = nn.ModuleList(convs)


class StandardSft(SftConvs):
    flax_name = "StandardSft"

    def __init__(self, nf: int, para: int, dtype: torch.dtype = torch.float32):
        cat = nf + para
        super().__init__([Conv(cat, 32, 3, dtype=dtype), Conv(32, nf, 3, dtype=dtype),
                          Conv(cat, 32, 3, dtype=dtype), Conv(32, nf, 3, dtype=dtype)])

    def forward(self, fea, para):
        cat = _cat(fea, para)
        mul_in, mul_out, add_in, add_out = self.convs
        mul = torch.sigmoid(mul_out(F.leaky_relu(mul_in(cat), 0.2)))
        add = add_out(F.leaky_relu(add_in(cat), 0.2))
        return fea * mul + add


class ConcatSft(SftConvs):
    flax_name = "ConcatSft"

    def __init__(self, nf: int, para: int, dtype: torch.dtype = torch.float32):
        super().__init__([Conv(nf + para, nf, 3, dtype=dtype)])

    def forward(self, fea, para):
        return self.convs[0](_cat(fea, para))


class WeakSft(SftConvs):
    flax_name = "WeakSft"

    def forward(self, fea, para):
        return fea * para.to(fea.dtype)


class SplitSft(SftConvs):
    """``split`` = "<feature convs><conditioned convs>", e.g. "22"."""

    flax_name = "SplitSft"

    def __init__(self, nf: int, para: int, split: str = "22",
                 dtype: torch.dtype = torch.float32):
        self.n_f, self.n_q = int(split[0]), int(split[1])
        super().__init__(
            [Conv(nf, nf, 3, dtype=dtype) for _ in range(self.n_f)]
            + [Conv(nf + para if j == 0 else nf, nf, 3, dtype=dtype)
               for j in range(self.n_q)])

    def forward(self, fea, para):
        f = fea
        for conv in self.convs[:self.n_f]:
            f = torch.relu(conv(f))
        q = _cat(fea, para)
        for conv in self.convs[self.n_f:]:
            q = torch.relu(conv(q))
        if self.n_q == 0:
            return f
        if self.n_f == 0:
            return q
        return f + q


def sft_layer(sft_type: str, nf: int, para: int, split: str = "22",
              dtype: torch.dtype = torch.float32) -> Optional[SftConvs]:
    if sft_type == "standard":
        return StandardSft(nf, para, dtype=dtype)
    if sft_type == "concat":
        return ConcatSft(nf, para, dtype=dtype)
    if sft_type == "weak":
        return WeakSft()
    if sft_type == "split":
        return SplitSft(nf, para, split, dtype=dtype)
    if sft_type == "none":
        return None
    raise ValueError(f"Unknown SFT type {sft_type}")


class SFTResidualBlock(nn.Module):
    """SFT, ReLU, (q-layer), conv, SFT, ReLU, (q-layer), conv, plus the
    input."""

    def __init__(self, nf: int = 64, para: int = 10, sft_type: str = "standard",
                 split: str = "22", q_injection: bool = False, q_layers: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sft1 = sft_layer(sft_type, nf, para, split, dtype)
        self.sft2 = sft_layer(sft_type, nf, para, split, dtype)
        self.conv1 = Conv(nf, nf, 3, dtype=dtype)
        self.conv2 = Conv(nf, nf, 3, dtype=dtype)
        q = (lambda: ParaCALayer(nf, para, nonlinearity=True, num_layers=q_layers,
                                 dtype=dtype))
        self.q1 = q() if q_injection else None
        self.q2 = q() if q_injection else None

    def forward(self, fea, para_maps, metadata=None):
        h = fea
        for sft, q, conv in ((self.sft1, self.q1, self.conv1), (self.sft2, self.q2, self.conv2)):
            h = torch.relu(h if sft is None else sft(h, para_maps))
            if q is not None and metadata is not None:
                h = q(h, metadata)
            h = conv(h)
        return fea + h


class SFTMD(nn.Module):
    """``convs`` in flax's order: three head convs, the trunk's output conv,
    then the upsampler's (two x2 stages for x4, else one); ``out`` is the
    final 9x9 conv, whose output is clipped to [0, 1]."""

    def __init__(self, scale: int = 4, in_nc: int = 3, out_nc: int = 3,
                 num_features: int = 64, num_blocks: int = 16, input_para: int = 10,
                 sft_type: str = "standard", split: str = "22", q_injection: bool = False,
                 q_layers: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        nf = num_features
        self.scale = scale
        stages = [2, 2] if scale == 4 else [scale]
        self.stages = stages
        self.convs = nn.ModuleList(
            [Conv(in_nc, nf, 3, dtype=dtype)] + [Conv(nf, nf, 3, dtype=dtype) for _ in range(3)]
            + [Conv(nf, nf * s * s, 3, dtype=dtype) for s in stages])
        self.blocks = nn.ModuleList(
            SFTResidualBlock(nf, input_para, sft_type, split, q_injection, q_layers, dtype)
            for _ in range(num_blocks))
        self.final_sft = sft_layer(sft_type, nf, input_para, split, dtype)
        self.final_q = (ParaCALayer(nf, input_para, nonlinearity=True, num_layers=q_layers,
                                    dtype=dtype) if q_injection else None)
        self.out = Conv(nf, out_nc, 9, dtype=dtype)

    def forward(self, x, metadata):
        """``metadata`` (N, P), tiled to maps here."""
        maps = tile_maps(metadata, *x.shape[2:])
        lrelu = lambda v: F.leaky_relu(v, 0.2)
        fea = lrelu(self.convs[1](lrelu(self.convs[0](x))))
        fea_bef = self.convs[2](fea)
        fea_in = fea_bef
        for block in self.blocks:
            fea_in = block(fea_in, maps, metadata)
        fea = fea_in + fea_bef
        if self.final_sft is not None:
            fea = self.final_sft(fea, maps)
        if self.final_q is not None:
            fea = self.final_q(fea, metadata)
        fea = self.convs[3](fea)
        for s, conv in zip(self.stages, self.convs[4:]):
            fea = lrelu(pixel_shuffle(conv(fea), s))
        return self.out(fea).clamp(0.0, 1.0)


@register_model("sftmd")
class SFTMDHandler(QModelHandler):
    """SFTMD; the metadata defaults to the 10-component PCA blur kernel."""

    def __init__(self, num_features=64, num_blocks=16, sft_type="standard",
                 split="22", q_injection=False, metadata=None, **kwargs):
        if metadata is None:
            metadata = ["blur_kernel"]
        super().__init__(metadata=metadata, num_features=num_features,
                         num_blocks=num_blocks, sft_type=sft_type, split=split,
                         q_injection=q_injection, **kwargs)

    def build_module(self, **kw):
        return SFTMD(scale=self.scale, in_nc=self.in_features,
                     input_para=self.num_metadata, dtype=self.dtype, **kw)
