"""BoBW QRCAN (Aquilina et al., Sensors 2023) in plain PyTorch, float32:
a frozen DASR encoder (Wang et al., CVPR 2021) whose pooled features feed
every block of a QRCAN.

Encoder: six 3x3 convs (64, 64, 128/2, 128, 256/2, 256; stride-2 convs pad
one pixel each side), each followed by flax-style BatchNorm and
LeakyReLU(0.1); the embedding ``a`` (N, 256) is the spatial mean of the
last map (``pre-q``). The encoder takes no gradient, and in training its
BatchNorm normalises by the batch's statistics and updates its running
ones; in evaluation it uses the running ones.

QRCAB(x, a) = x + h * u * q, h = conv2(relu(conv1(x))),
u = sigmoid(W_u relu(W_d [mean_hw(h), a] + b_d) + b_u)  (``max_concat``),
q = sigmoid(W_2 relu(W_1 a + b_1) + b_2)  (the q-layer, widths 160 and 64).
The rest is RCAN's. Module names follow the port's state dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.common import BatchNorm, Conv, Linear, Upsampler

DASR_SPEC = ((64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1))


class DASREncoder(nn.Module):
    def __init__(self, out_dim: int = 256):
        super().__init__()
        ins = (3,) + tuple(f for f, _ in DASR_SPEC[:-1])
        self.convs = nn.ModuleList(Conv(i, f, 3, stride=s) for i, (f, s) in zip(ins, DASR_SPEC))
        self.norms = nn.ModuleList(BatchNorm(f) for f, _ in DASR_SPEC)
        self.mlp = nn.ModuleList([Linear(256, 256), Linear(256, out_dim)])

    def forward(self, x, train: bool):
        for conv, norm in zip(self.convs, self.norms):
            x = F.leaky_relu(norm(conv(x), train), 0.1)
        return x.mean(dim=(2, 3))


def q_widths(c: int, m: int, layers: int = 2):
    """The q-layer's widths: past 15 metadata values they step from M to C."""
    out, mult = [], layers
    for _ in range(layers):
        out.append((c - m) // mult + m if m > 15 else c // mult)
        mult -= 1
    return out


class QCALayer(nn.Module):
    def __init__(self, c: int, r: int, m: int):
        super().__init__()
        self.down = Conv(c + m, r, 1)
        self.up = Conv(r, c, 1)


class ParaCALayer(nn.Module):
    def __init__(self, c: int, m: int):
        super().__init__()
        widths = q_widths(c, m)
        self.convs = nn.ModuleList(Conv(i, o, 1) for i, o in zip([m] + widths[:-1], widths))

    def gate(self, a):
        return torch.sigmoid(self.convs[1].linear(torch.relu(self.convs[0].linear(a))))


class QRCAB(nn.Module):
    def __init__(self, c: int, reduction: int, m: int):
        super().__init__()
        self.conv1 = Conv(c, c, 3)
        self.conv2 = Conv(c, c, 3)
        self.ca = QCALayer(c, max(1, c // reduction), m)
        self.q = ParaCALayer(c, m)

    def forward(self, x, a):
        h = self.conv2(torch.relu(self.conv1(x)))
        y = torch.cat([h.mean(dim=(2, 3)), a], dim=1)
        u = torch.sigmoid(self.ca.up.linear(torch.relu(self.ca.down.linear(y))))
        return x + h * (u * self.q.gate(a))[:, :, None, None]


class QResidualGroup(nn.Module):
    def __init__(self, c, n_resblocks, reduction, m):
        super().__init__()
        self.blocks = nn.ModuleList(QRCAB(c, reduction, m) for _ in range(n_resblocks))
        self.tail = Conv(c, c, 3)

    def forward(self, x, a):
        res = x
        for block in self.blocks:
            res = block(res, a)
        return x + self.tail(res)


class QRCAN(nn.Module):
    def __init__(self, scale, n_feats, n_resgroups, n_resblocks, reduction, m):
        super().__init__()
        self.head = Conv(3, n_feats, 3)
        self.groups = nn.ModuleList(QResidualGroup(n_feats, n_resblocks, reduction, m)
                                    for _ in range(n_resgroups))
        self.body_tail = Conv(n_feats, n_feats, 3)
        self.upsampler = Upsampler(scale, n_feats)
        self.tail = Conv(n_feats, 3, 3)

    def forward(self, x, a):
        x = self.head(x)
        res = x
        for group in self.groups:
            res = group(res, a)
        return self.tail(self.upsampler(self.body_tail(res) + x))


class BoBW(nn.Module):
    def __init__(self, scale=4, n_feats=64, n_resgroups=10, n_resblocks=20, reduction=16,
                 encoder_dim=256):
        super().__init__()
        self.generator = QRCAN(scale, n_feats, n_resgroups, n_resblocks, reduction, 256)
        self.encoder = DASREncoder(encoder_dim)

    def forward(self, lr_nchw, train: bool = False):
        return generate(self, lr_nchw, embed(self, lr_nchw, train))


def build(cfg: dict) -> BoBW:
    return BoBW(scale=cfg["scale"], n_feats=cfg["n_feats"], n_resgroups=cfg["n_resgroups"],
                n_resblocks=cfg["n_resblocks"], reduction=cfg["reduction"],
                encoder_dim=cfg["encoder_dim"])


def trained(name: str) -> bool:
    """The optimizer trains the generator; the encoder is frozen."""
    return name.startswith("generator.")


def embed(model, lr_nchw, train: bool):
    """The encoder's embedding of the whole batch, without a gradient (its
    BatchNorm's batch statistics are the whole batch's)."""
    with torch.no_grad():
        return model.encoder(lr_nchw, train)


def generate(model, lr_nchw, emb):
    return model.generator(lr_nchw, emb)
