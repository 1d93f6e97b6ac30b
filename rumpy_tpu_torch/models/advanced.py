"""Advanced SISR family: EDSR and RCAN.

Port of ``rumpy_tpu/models/advanced.py``. Defaults mirror the JAX package
(EDSR: 64 feats / 16 blocks / res_scale 0.1; RCAN: 10 groups x 20 RCAB,
reduction 16; no MeanShift in either). Every RCAB runs the fused CUDA
kernel; the other convs are plain ``F.conv2d``. SRMD and EDSRMD wait for
the metadata (attention-manipulator) slice.
"""

from __future__ import annotations

import torch
from torch import nn

from rumpy_tpu_torch.models.base import BaseHandler
from rumpy_tpu_torch.models.common import RCAB, Conv, ResBlock, Upsampler
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
                 dtype: torch.dtype = torch.float32):
        super().__init__()
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
            res = group(res)
        res = self.body_tail(res) + x
        return self.tail(self.upsampler(res))


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
        # remat trades recompute for activation memory in the backward
        # pass; it has no effect on the eval forward.
        return RCAN(scale=self.scale, in_feats=self.in_features,
                    n_feats=n_feats, n_resgroups=n_resgroups,
                    n_resblocks=n_resblocks, reduction=reduction,
                    res_scale=res_scale, dtype=self.dtype)
