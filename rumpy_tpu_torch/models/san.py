"""SAN, the second-order attention network, and its meta-attention variant
QSAN, evaluated through ``forward_chop``.

Port of ``rumpy_tpu/models/san.py``. Second-order channel attention
(``SOCA``) pools the covariance of a group's features and takes its square
root by five Newton-Schulz iterations (:func:`cov_sqrt`), in float32; the
JAX package runs those products at ``Precision.HIGHEST``, so the port runs
them in full float32 whatever the process-wide TF32 flags say
(``utils/losses.py::full_f32_matmuls``), as it does the non-local block's
two products. The region-level non-local block (``NonlocalCA``) runs one
shared ``NonLocalBlock2D`` on the four quadrants, and SAN applies the same
``NonlocalCA`` before and after its groups: one set of parameters, whose
gradients autograd sums over the eight uses, as ``jax.grad`` does. Every
conv is cuDNN; no block runs a hand kernel.

Type promotion follows the JAX package: SAN's ``gamma`` is a float32
parameter, so in a bf16 model the trunk between groups is float32 and each
conv rounds its input to bf16.

The handlers' evaluation always tiles: ``ops/tiling.py::forward_chop`` with
``force_split=True`` and ``max_size=max_combined_im_size``, QSAN's
metadata passed to every tile.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import true_div
from rumpy_tpu_torch.models.attention_manipulators import ParaCALayer, QModelHandler
from rumpy_tpu_torch.models.base import BaseHandler
from rumpy_tpu_torch.models.common import Conv, Gamma, Upsampler
from rumpy_tpu_torch.ops.tiling import forward_chop
from rumpy_tpu_torch.registry import register_model
from rumpy_tpu_torch.utils.losses import full_f32_matmuls


def cov_sqrt(x: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """MPN-COV: the covariance of samples ``x`` (B, N, C), normalised by its
    trace, its square root by ``iters`` Newton-Schulz iterations, times the
    trace's root: (B, C, C)."""
    b, n, c = x.shape
    with full_f32_matmuls():
        xc = x - x.mean(dim=1, keepdim=True)
        cov = true_div(torch.bmm(xc.transpose(1, 2), xc), n)
        tr = torch.diagonal(cov, dim1=1, dim2=2).sum(-1)[:, None, None] + 1e-8
        a = cov / tr
        eye = torch.eye(c, dtype=x.dtype, device=x.device)[None]
        y, z = a, eye.expand_as(a)
        for _ in range(iters):
            t = 0.5 * (3.0 * eye - torch.bmm(z, y))
            y = torch.bmm(y, t)
            z = torch.bmm(t, z)
    return y * torch.sqrt(tr)


class SOCA(nn.Module):
    """Second-order channel attention: the mean over rows of the
    covariance's square root (float32), through a 1x1 squeeze, ReLU and a
    1x1 excite, as a sigmoid gate on ``x``."""

    def __init__(self, channel: int, reduction: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down = Conv(channel, max(1, channel // reduction), 1, dtype=dtype)
        self.up = Conv(max(1, channel // reduction), channel, 1, dtype=dtype)

    def flax_children(self):
        return [("down", ("TConv_0",), self.down), ("up", ("TConv_1",), self.up)]

    def forward(self, x):
        b, c, h, w = x.shape
        flat = x.permute(0, 2, 3, 1).reshape(b, h * w, c).float()
        stat = cov_sqrt(flat).mean(dim=1).to(x.dtype)
        y = self.up.as_linear(torch.relu(self.down.as_linear(stat)))
        return x * torch.sigmoid(y)[:, :, None, None]


class NonLocalBlock2D(nn.Module):
    """Embedded-gaussian non-local block: z = W(softmax(theta phi^T) g) + x,
    with g and phi max-pooled 2x2 at stride 2 always (the reference's flag
    is rebound to a class, so its ``sub_sample=False`` never takes; the JAX
    package reproduces that, and so does the port)."""

    def __init__(self, in_channels: int, inter_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.inter = inter_channels
        self.g = Conv(in_channels, inter_channels, 1, dtype=dtype)
        self.w = Conv(inter_channels, in_channels, 1, dtype=dtype)
        self.theta = Conv(in_channels, inter_channels, 1, dtype=dtype)
        self.phi = Conv(in_channels, inter_channels, 1, dtype=dtype)

    def flax_children(self):  # flax names them in the order they are built
        return [(name, (f"TConv_{i}",), getattr(self, name))
                for i, name in enumerate(("g", "w", "theta", "phi"))]

    def forward(self, x):
        b, _, h, w = x.shape

        def rows(t):  # (B, inter, H', W') -> (B, H' * W', inter)
            return t.reshape(b, self.inter, -1).transpose(1, 2)

        g = rows(F.max_pool2d(self.g(x), 2, 2))
        phi = rows(F.max_pool2d(self.phi(x), 2, 2))
        theta = rows(self.theta(x))
        with full_f32_matmuls():
            attn = torch.softmax(torch.bmm(theta, phi.transpose(1, 2)), dim=-1)
            y = torch.bmm(attn, g)
        return self.w(y.transpose(1, 2).reshape(b, self.inter, h, w)) + x


class NonlocalCA(nn.Module):
    """Region-level non-local attention: one NonLocalBlock2D on each of the
    four quadrants (one batched call when they have one shape)."""

    def __init__(self, in_feat: int = 64, inter_feat: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block = NonLocalBlock2D(in_feat, inter_feat, dtype=dtype)

    def flax_children(self):
        return [("block", ("NonLocalBlock2D_0",), self.block)]

    def forward(self, x):
        hh, ww = x.shape[2:]
        h1, w1 = hh // 2, ww // 2
        quads = [x[:, :, :h1, :w1], x[:, :, h1:, :w1], x[:, :, :h1, w1:], x[:, :, h1:, w1:]]
        if hh % 2 == 0 and ww % 2 == 0:
            lu, ld, ru, rd = self.block(torch.cat(quads)).chunk(4)
        else:
            lu, ld, ru, rd = (self.block(q) for q in quads)
        return torch.cat([torch.cat([lu, ru], dim=3), torch.cat([ld, rd], dim=3)], dim=2)


class RB(nn.Module):
    """conv, ReLU, conv, plus the input."""

    def __init__(self, n_feat: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(n_feat, n_feat, 3, dtype=dtype)
        self.conv2 = Conv(n_feat, n_feat, 3, dtype=dtype)

    def flax_children(self):
        return [("conv1", ("Conv_0", "TConv_0"), self.conv1),
                ("conv2", ("Conv_1", "TConv_0"), self.conv2)]

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(x)))


class LSRAG(nn.Module):
    """Local-source residual attention group: RBs, SOCA, a conv, for QSAN a
    ParaCALayer of the metadata, plus the group's input."""

    def __init__(self, n_feat: int, n_resblocks: int = 10, reduction: int = 8,
                 num_metadata: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(RB(n_feat, dtype=dtype) for _ in range(n_resblocks))
        self.soca = SOCA(n_feat, reduction, dtype=dtype)
        self.conv = Conv(n_feat, n_feat, 3, dtype=dtype)
        self.meta = (ParaCALayer(n_feat, num_metadata, nonlinearity=True, dtype=dtype)
                     if num_metadata > 0 else None)

    def flax_children(self):
        return ([(f"blocks.{i}", (f"RB_{i}",), b) for i, b in enumerate(self.blocks)]
                + [("soca", ("SOCA_0",), self.soca), ("conv", ("Conv_0", "TConv_0"), self.conv)]
                + ([("meta", ("ParaCALayer_0",), self.meta)] if self.meta is not None else []))

    def forward(self, x, metadata=None):
        residual = x
        for block in self.blocks:
            x = block(x)
        x = self.conv(self.soca(x))
        if self.meta is not None and metadata is not None:
            x = self.meta(x, metadata)
        return x + residual


class SAN(Gamma):
    """SAN x``scale``: a head conv, the shared NonlocalCA, ``n_resgroups``
    LSRAGs each plus gamma times the NonlocalCA's output, the same
    NonlocalCA again, plus the head's output, the upsampler and a tail
    conv. ``num_metadata > 0`` gives each group a ParaCALayer (QSAN)."""

    def __init__(self, scale: int = 4, in_feats: int = 3, n_colors: int = 3, n_feats: int = 64,
                 n_resgroups: int = 20, n_resblocks: int = 10, reduction: int = 16,
                 num_metadata: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head = Conv(in_feats, n_feats, 3, dtype=dtype)
        self.nl = NonlocalCA(n_feats, n_feats // 8, dtype=dtype)
        self.groups = nn.ModuleList(LSRAG(n_feats, n_resblocks, reduction, num_metadata,
                                          dtype=dtype) for _ in range(n_resgroups))
        self.upsampler = Upsampler(scale, n_feats, dtype=dtype)
        self.tail = Conv(n_feats, n_colors, 3, dtype=dtype)

    def flax_children(self):
        return ([("head", ("Conv_0", "TConv_0"), self.head), ("nl", ("NonlocalCA_0",), self.nl)]
                + [(f"groups.{i}", (f"LSRAG_{i}",), g) for i, g in enumerate(self.groups)]
                + [("upsampler", ("Upsampler_0",), self.upsampler),
                   ("tail", ("Conv_1", "TConv_0"), self.tail)])

    def forward(self, x, metadata=None):
        x = self.head(x)
        xx = self.nl(x)
        residual = xx
        for group in self.groups:
            xx = group(xx, metadata) + self.gamma * residual
        res = self.nl(xx) + x
        return self.tail(self.upsampler(res))


class _ChoppedEval:
    """``run_eval`` through ``forward_chop`` with a forced top-level split,
    as the JAX handlers' (SOCA and the non-local block are global, so a
    tiled output differs from a whole-image one and parity needs the same
    tiles)."""

    def run_eval(self, state, batch):
        lr = torch.as_tensor(batch["lr"], device=self.device)
        meta = {k: batch[k] for k in ("metadata",) if batch.get(k) is not None}
        with torch.inference_mode():
            return forward_chop(
                lambda t: self.apply(state.params, {"lr": t, **meta}, extra=state.extra)[0],
                lr, self.scale, max_size=self.max_combined_im_size, force_split=True)


@register_model("san")
class SANHandler(_ChoppedEval, BaseHandler):
    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"

    def __init__(self, n_feats=64, n_resgroups=20, n_resblocks=10,
                 max_combined_im_size=160000, **kwargs):
        self.max_combined_im_size = max_combined_im_size
        super().__init__(n_feats=n_feats, n_resgroups=n_resgroups, n_resblocks=n_resblocks,
                         **kwargs)

    def build_module(self, **kw):
        return SAN(scale=self.scale, in_feats=self.in_features, dtype=self.dtype, **kw)


@register_model("qsan")
class QSANHandler(_ChoppedEval, QModelHandler):
    def __init__(self, n_feats=64, n_resgroups=20, n_resblocks=10,
                 max_combined_im_size=160000, **kwargs):
        self.max_combined_im_size = max_combined_im_size
        super().__init__(n_feats=n_feats, n_resgroups=n_resgroups, n_resblocks=n_resblocks,
                         **kwargs)

    def build_module(self, **kw):
        return SAN(scale=self.scale, in_feats=self.in_features,
                   num_metadata=self.num_metadata, dtype=self.dtype, **kw)
