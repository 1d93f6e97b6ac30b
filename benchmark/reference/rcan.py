"""RCAN (Zhang et al., ECCV 2018) in plain PyTorch, float32.

    head conv -> n_resgroups x [n_resblocks x RCAB -> conv, + group input]
    -> conv, + head output -> sub-pixel x2 stages -> tail conv

with RCAB(x) = x + res_scale * h * CA(h), h = conv2(relu(conv1(x))), and
CA(h) = sigmoid(W_u relu(W_d mean_hw(h) + b_d) + b_u). No mean shift, as
the port has none. Module names follow the port's state dict.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.common import Conv, Upsampler


class CALayer(nn.Module):
    def __init__(self, c: int, r: int):
        super().__init__()
        self.down = Conv(c, r, 1)
        self.up = Conv(r, c, 1)


class RCAB(nn.Module):
    def __init__(self, c: int, reduction: int, res_scale: float):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv(c, c, 3)
        self.conv2 = Conv(c, c, 3)
        self.ca = CALayer(c, max(1, c // reduction))

    def forward(self, x):
        h = self.conv2(torch.relu(self.conv1(x)))
        u = torch.sigmoid(self.ca.up.linear(torch.relu(self.ca.down.linear(h.mean(dim=(2, 3))))))
        return x + h * u[:, :, None, None] * self.res_scale


class ResidualGroup(nn.Module):
    def __init__(self, c, n_resblocks, reduction, res_scale):
        super().__init__()
        self.blocks = nn.ModuleList(RCAB(c, reduction, res_scale) for _ in range(n_resblocks))
        self.tail = Conv(c, c, 3)

    def forward(self, x):
        res = x
        for block in self.blocks:
            res = block(res)
        return x + self.tail(res)


class RCAN(nn.Module):
    def __init__(self, scale=4, n_feats=64, n_resgroups=10, n_resblocks=20, reduction=16,
                 res_scale=1.0, in_feats=3, out_feats=3):
        super().__init__()
        self.head = Conv(in_feats, n_feats, 3)
        self.groups = nn.ModuleList(ResidualGroup(n_feats, n_resblocks, reduction, res_scale)
                                    for _ in range(n_resgroups))
        self.body_tail = Conv(n_feats, n_feats, 3)
        self.upsampler = Upsampler(scale, n_feats)
        self.tail = Conv(n_feats, out_feats, 3)

    def forward(self, lr_nchw, train: bool = False):
        x = self.head(lr_nchw)
        res = x
        for group in self.groups:
            res = group(res)
        return self.tail(self.upsampler(self.body_tail(res) + x))


def build(cfg: dict) -> RCAN:
    return RCAN(scale=cfg["scale"], n_feats=cfg["n_feats"], n_resgroups=cfg["n_resgroups"],
                n_resblocks=cfg["n_resblocks"], reduction=cfg["reduction"],
                res_scale=cfg.get("res_scale", 1.0))


def trained(name: str) -> bool:
    """Whether the optimizer trains the parameter ``name``: all of them."""
    return True


def embed(model, lr_nchw, train: bool):
    """No encoder: nothing to compute once for the whole batch."""
    return None


def generate(model, lr_nchw, emb):
    return model(lr_nchw)
