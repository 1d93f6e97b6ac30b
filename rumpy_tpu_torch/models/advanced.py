"""Advanced SISR family: EDSR, RCAN, SRMD and EDSRMD.

Port of ``rumpy_tpu/models/advanced.py``. Defaults mirror the JAX package
(EDSR: 64 feats / 16 blocks / res_scale 0.1; RCAN: 10 groups x 20 RCAB,
reduction 16; no MeanShift in either; SRMD: 12 conv + ReLU layers at 128
features with a pixel-shuffle tail). Every RCAB runs the fused CUDA
kernel; the other convs are plain ``F.conv2d``. SRMD and EDSRMD take the
degradation metadata (N, M) tiled to per-pixel maps and concatenated to
the LR input (``_MetadataMapMixin``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rumpy_tpu_torch.models.attention_manipulators import (compute_num_metadata,
                                                           select_metadata_columns)
from rumpy_tpu_torch.models.base import BaseHandler
from rumpy_tpu_torch.models.common import (RCAB, Conv, ResBlock, Upsampler, pixel_shuffle,
                                           tile_maps)
from rumpy_tpu_torch.registry import register_model


class EDSR(nn.Module):
    def __init__(self, scale: int = 4, in_features: int = 3,
                 out_features: int = 3, net_features: int = 64,
                 num_blocks: int = 16, res_scale: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f = net_features
        self.head = Conv(in_features, f, 3, dtype=dtype)
        self.body = nn.ModuleList(ResBlock(f, 3, res_scale=res_scale, dtype=dtype)
                                  for _ in range(num_blocks))
        self.body_tail = Conv(f, f, 3, dtype=dtype)
        self.upsampler = Upsampler(scale, f, dtype=dtype)
        self.tail = Conv(f, out_features, 3, dtype=dtype)

    def forward(self, x):
        x = self.head(x)
        res = x
        for block in self.body:
            res = block(res)
        x = x + self.body_tail(res)
        return self.tail(self.upsampler(x))


class ResidualGroup(nn.Module):
    def __init__(self, features: int, n_resblocks: int = 20,
                 reduction: int = 16, res_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(RCAB(features, reduction, res_scale, dtype=dtype)
                                    for _ in range(n_resblocks))
        self.tail = Conv(features, features, 3, dtype=dtype)

    def forward(self, x):
        res = x
        for block in self.blocks:
            res = block(res)
        return x + self.tail(res)


class RCAN(nn.Module):
    def __init__(self, scale: int = 4, in_feats: int = 3, out_feats: int = 3,
                 n_feats: int = 64, n_resgroups: int = 10, n_resblocks: int = 20,
                 reduction: int = 16, res_scale: float = 1.0,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.head = Conv(in_feats, n_feats, 3, dtype=dtype)
        self.groups = nn.ModuleList(
            ResidualGroup(n_feats, n_resblocks, reduction, res_scale, dtype=dtype)
            for _ in range(n_resgroups))
        self.body_tail = Conv(n_feats, n_feats, 3, dtype=dtype)
        self.upsampler = Upsampler(scale, n_feats, dtype=dtype)
        self.tail = Conv(n_feats, out_feats, 3, dtype=dtype)

    def forward(self, x):
        x = self.head(x)
        res = x
        for group in self.groups:
            if self.remat and torch.is_grad_enabled():
                # keep only the group's input; its blocks run again in
                # the backward pass
                res = checkpoint(group, res, use_reentrant=False)
            else:
                res = group(res)
        res = self.body_tail(res) + x
        return self.tail(self.upsampler(res))


class SRMD(nn.Module):
    """SRMD: ``nb`` 3x3 convs at ``nc`` features, ReLU after all but the
    last, whose ``out_nc * scale**2`` channels are pixel-shuffled; the
    input is the LR image with its degradation maps (``in_nc`` = 3 + M)."""

    def __init__(self, scale: int = 4, in_nc: int = 18, out_nc: int = 3, nc: int = 128,
                 nb: int = 12, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.convs = nn.ModuleList(
            [Conv(in_nc, nc, 3, dtype=dtype)]
            + [Conv(nc, nc, 3, dtype=dtype) for _ in range(nb - 2)]
            + [Conv(nc, out_nc * scale ** 2, 3, dtype=dtype)])

    def forward(self, x):
        for conv in self.convs[:-1]:
            x = torch.relu(conv(x))
        return pixel_shuffle(self.convs[-1](x), self.scale)


@register_model("edsr")
class EDSRHandler(BaseHandler):
    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"

    def __init__(self, num_features=64, num_blocks=16, res_scale=0.1, **kwargs):
        super().__init__(num_features=num_features, num_blocks=num_blocks,
                         res_scale=res_scale, **kwargs)

    def build_module(self, num_features, num_blocks, res_scale):
        return EDSR(scale=self.scale, in_features=self.in_features,
                    net_features=num_features, num_blocks=num_blocks,
                    res_scale=res_scale, dtype=self.dtype)


@register_model("rcan")
class RCANHandler(BaseHandler):
    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"

    def __init__(self, n_resblocks=20, n_resgroups=10, n_feats=64,
                 reduction=16, res_scale=1.0, remat=False, **kwargs):
        super().__init__(n_resblocks=n_resblocks, n_resgroups=n_resgroups,
                         n_feats=n_feats, reduction=reduction,
                         res_scale=res_scale, remat=remat, **kwargs)

    def build_module(self, n_resblocks, n_resgroups, n_feats, reduction,
                     res_scale, remat=False):
        # remat recomputes each residual group in the backward pass
        # (torch.utils.checkpoint) instead of keeping its activations; it
        # has no effect on a forward without gradients.
        return RCAN(scale=self.scale, in_feats=self.in_features,
                    n_feats=n_feats, n_resgroups=n_resgroups,
                    n_resblocks=n_resblocks, reduction=reduction,
                    res_scale=res_scale, remat=remat, dtype=self.dtype)


class _MetadataMapMixin:
    """SRMD-style metadata: key-driven sizing and CSV-column selection as
    the QModel handlers do, and the (N, M) vector tiled to per-pixel maps
    concatenated to the LR input."""

    uses_metadata = True

    def _init_metadata(self, metadata, metadata_bypass_len, num_metadata):
        if metadata is not None:
            self.metadata_keys = list(metadata)
            self.num_metadata = compute_num_metadata(self.metadata_keys, metadata_bypass_len)
        else:
            self.metadata_keys = None
            self.num_metadata = metadata_bypass_len or num_metadata

    def select_metadata(self, metadata, keys=None):
        return select_metadata_columns(metadata, keys, self.metadata_keys)

    def handler_metadata(self):
        return {"metadata_keys_used_in_training": self.metadata_keys,
                "num_metadata": self.num_metadata}

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        meta = batch.get("metadata")
        if meta is None:
            raise RuntimeError("Metadata needs to be specified for this "
                               "network to run properly.")
        meta = torch.as_tensor(meta, device=self.device)
        maps = tile_maps(meta, *lr.shape[1:3]).permute(0, 2, 3, 1)
        x = torch.cat([lr, maps.to(lr.dtype)], dim=-1)
        sr = self.module(x.permute(0, 3, 1, 2))
        return sr.permute(0, 2, 3, 1), {}, extra


@register_model("edsrmd")
class EDSRMDHandler(_MetadataMapMixin, BaseHandler):
    """EDSR on the LR image concatenated with its degradation maps."""

    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"

    def __init__(self, metadata=None, metadata_bypass_len=None, num_metadata=15,
                 num_features=64, num_blocks=16, res_scale=0.1, **kwargs):
        self._init_metadata(metadata, metadata_bypass_len, num_metadata)
        super().__init__(num_features=num_features, num_blocks=num_blocks,
                         res_scale=res_scale, **kwargs)

    def build_module(self, num_features, num_blocks, res_scale):
        return EDSR(scale=self.scale, in_features=self.in_features + self.num_metadata,
                    net_features=num_features, num_blocks=num_blocks,
                    res_scale=res_scale, dtype=self.dtype)


@register_model("srmd")
class SRMDHandler(_MetadataMapMixin, BaseHandler):
    """SRMD on the LR image concatenated with its degradation maps."""

    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"

    def __init__(self, metadata=None, metadata_bypass_len=None, num_metadata=15,
                 nc=128, nb=12, **kwargs):
        self._init_metadata(metadata, metadata_bypass_len, num_metadata)
        super().__init__(nc=nc, nb=nb, **kwargs)

    def build_module(self, nc, nb):
        return SRMD(scale=self.scale, in_nc=self.in_features + self.num_metadata,
                    nc=nc, nb=nb, dtype=self.dtype)
