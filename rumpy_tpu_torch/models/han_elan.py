"""HAN and ELAN families, with their meta-attention variants QHAN and QELAN.

Port of ``rumpy_tpu/models/han_elan.py``.

HAN is RCAN's trunk (``models/advanced.py::ResidualGroup``, every block an
RCAB on the fused kernel ``ops/cuda/rcab_fused.py``) with layer attention
over the groups' outputs (``LAMModule``) and channel-spatial attention
(``CSAMModule``, a 3x3x3 conv over the (C, H, W) volume). QHAN takes
``models/attention_manipulators.py::QResidualGroup``: its four foldable
QCALayer styles run the fused kernel with per-image gate inputs. LAM's
products and softmax, and CSAM's conv3d, are plain PyTorch ops in the
activation type, as XLA computes them in the JAX package.

ELAN: shift convs (zero-fill shifts of four channel groups, a 1x1 conv),
group multi-scale window self-attention (``GMSA``: a 1x1 conv, flax-style
BatchNorm, three window sizes, shifted windows every other block) and a
reflect pad to the windows' lcm, cropped back after the pixel shuffle.
With ``num_metadata > 0`` a ParaCALayer follows every ``meta_every``-th
block: that is QELAN. The handlers keep GMSA's BatchNorm running
statistics as buffers, so they travel in the state and the checkpoints:
a train step normalises by the batch's statistics and updates them,
evaluation reads them.

Type promotion follows the JAX package: LAM's and CSAM's ``gamma`` is a
float32 parameter, so their outputs are float32 in a bf16 model until the
next conv rounds them; ELAN adds its float32 mean back after a bf16 tail.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.advanced import ResidualGroup
from rumpy_tpu_torch.models.attention_manipulators import (ParaCALayer, QModelHandler,
                                                           QResidualGroup)
from rumpy_tpu_torch.models.base import BaseHandler
from rumpy_tpu_torch.models.common import (DIV2K_RGB_MEAN, BatchNorm, Conv, Conv3d, Gamma,
                                           Upsampler, pixel_shuffle)
from rumpy_tpu_torch.registry import register_model


# ---------------------------------------------------------------------------
# HAN
# ---------------------------------------------------------------------------

class LAMModule(Gamma):
    """Layer attention over the stacked group outputs (B, N, C, H, W),
    newest first: energies of every layer pair, softmax of ``max -
    energy``, the attended layers times gamma plus the input, flattened
    onto channels as (B, N*C, H, W) (layer-major, as the JAX module's
    (B, H, W, N*C))."""

    def flax_children(self):
        return []

    def forward(self, x):
        b, n, c, h, w = x.shape
        flat = x.reshape(b, n, c * h * w)
        energy = torch.bmm(flat, flat.transpose(1, 2))
        attention = torch.softmax(energy.amax(-1, keepdim=True) - energy, dim=-1)
        out = torch.bmm(attention, flat).reshape(b, n, c, h, w)
        return (self.gamma * out + x).reshape(b, n * c, h, w)


class CSAMModule(Gamma):
    """Channel-spatial attention: the sigmoid of a 3x3x3 conv (one input
    and one output channel) over the (C, H, W) volume, padded on all three
    axes; ``x * (gamma * attention) + x``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3d(1, 1, 3, dtype=dtype)

    def flax_children(self):
        return [("conv", ("TConv_0",), self.conv)]

    def forward(self, x):
        attn = torch.sigmoid(self.conv(x.unsqueeze(1)))[:, 0]
        return x * (self.gamma * attn) + x


class HAN(nn.Module):
    """HAN: a head conv, residual groups of RCABs, a body conv, LAM over the
    11 stacked outputs (newest first) and CSAM on the last, fused by a conv,
    plus the head's output, then the upsampler and the tail."""

    group_name = "ResidualGroup"

    def __init__(self, scale: int = 4, in_feats: int = 3, n_colors: int = 3,
                 n_feats: int = 64, n_resgroups: int = 10, n_resblocks: int = 20,
                 reduction: int = 16, res_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32, groups: Optional[Sequence[nn.Module]] = None):
        super().__init__()
        self.head = Conv(in_feats, n_feats, 3, dtype=dtype)
        self.groups = nn.ModuleList(groups if groups is not None else (
            ResidualGroup(n_feats, n_resblocks, reduction, res_scale, dtype=dtype)
            for _ in range(n_resgroups)))
        self.body_tail = Conv(n_feats, n_feats, 3, dtype=dtype)
        self.lam = LAMModule()
        self.lam_conv = Conv(n_feats * (len(self.groups) + 1), n_feats, 3, dtype=dtype)
        self.csam = CSAMModule(dtype=dtype)
        self.fuse = Conv(2 * n_feats, n_feats, 3, dtype=dtype)
        self.upsampler = Upsampler(scale, n_feats, dtype=dtype)
        self.tail = Conv(n_feats, n_colors, 3, dtype=dtype)

    def flax_children(self):
        convs = [("head", 0), ("body_tail", 1), ("lam_conv", 2), ("fuse", 3), ("tail", 4)]
        return ([(name, (f"Conv_{i}", "TConv_0"), getattr(self, name)) for name, i in convs]
                + [(f"groups.{i}", (f"{self.group_name}_{i}",), g)
                   for i, g in enumerate(self.groups)]
                + [("lam", ("LAMModule_0",), self.lam), ("csam", ("CSAMModule_0",), self.csam),
                   ("upsampler", ("Upsampler_0",), self.upsampler)])

    def _forward(self, x, run_group):
        x = self.head(x)
        res, stack = x, []
        for group in self.groups:
            res = run_group(group, res)
            stack.append(res)
        res = self.body_tail(res)
        stack.append(res)
        out2 = self.lam_conv(self.lam(torch.stack(stack[::-1], dim=1)))
        out1 = self.csam(res)
        res = self.fuse(torch.cat([out1, out2], dim=1)) + x
        return self.tail(self.upsampler(res))

    def forward(self, x):
        return self._forward(x, lambda group, res: group(res))


class QHAN(HAN):
    """HAN whose groups are QResidualGroups fed the metadata (N, M) (and,
    with SFT layers, its maps); ``selective_meta_blocks`` (one flag a group)
    switches a group's q-layer and SFT off."""

    group_name = "QResidualGroup"

    def __init__(self, scale: int = 4, in_feats: int = 3, n_colors: int = 3,
                 n_feats: int = 64, n_resgroups: int = 10, n_resblocks: int = 20,
                 reduction: int = 16, res_scale: float = 1.0, num_metadata: int = 1,
                 style: str = "standard", include_q_layer: bool = True,
                 selective_meta_blocks: Optional[Sequence[bool]] = None,
                 num_q_layers_inner_residual: Optional[int] = None,
                 num_layers_in_q_layer: int = 2, include_sft_layer: bool = False,
                 dtype: torch.dtype = torch.float32):
        del res_scale  # a QRCAB takes none, as in the JAX package
        active = [selective_meta_blocks is None or bool(selective_meta_blocks[g])
                  for g in range(n_resgroups)]
        groups = [QResidualGroup(n_feats, n_resblocks, reduction, style,
                                 q_layer=include_q_layer and active[g],
                                 sft_layer=include_sft_layer and active[g],
                                 num_q_layers=num_q_layers_inner_residual,
                                 num_metadata=num_metadata,
                                 num_layers_in_q_layer=num_layers_in_q_layer, dtype=dtype)
                  for g in range(n_resgroups)]
        super().__init__(scale, in_feats, n_colors, n_feats, n_resgroups, n_resblocks,
                         reduction, dtype=dtype, groups=groups)

    def forward(self, x, metadata, meta_maps=None):
        metadata = metadata.float()
        return self._forward(x, lambda group, res: group(res, metadata, meta_maps))


# ---------------------------------------------------------------------------
# ELAN
# ---------------------------------------------------------------------------

def _shift(x, dy: int, dx: int):
    """Zero-fill spatial shift of NCHW ``x``: out[y, x] = in[y + dy, x + dx]."""
    h, w = x.shape[2:]
    pad = F.pad(x, (1, 1, 1, 1))
    return pad[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


class ShiftConv(nn.Module):
    """Five channel groups of c // 5 shifted left, right, up and down, the
    rest as they are, then a 1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, 1, dtype=dtype)

    def flax_children(self):
        return [("conv", ("TConv_0",), self.conv)]

    def forward(self, x):
        g = x.shape[1] // 5
        y = torch.cat([_shift(x[:, 0:g], 0, 1), _shift(x[:, g:2 * g], 0, -1),
                       _shift(x[:, 2 * g:3 * g], 1, 0), _shift(x[:, 3 * g:4 * g], -1, 0),
                       x[:, 4 * g:]], dim=1)
        return self.conv(y)


class LFE(nn.Module):
    """Local feature extraction: shift conv, ReLU, shift conv."""

    def __init__(self, in_channels: int, out_channels: int, exp_ratio: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = ShiftConv(in_channels, out_channels * exp_ratio, dtype=dtype)
        self.conv1 = ShiftConv(out_channels * exp_ratio, out_channels, dtype=dtype)

    def flax_children(self):
        return [("conv0", ("ShiftConv_0",), self.conv0), ("conv1", ("ShiftConv_1",), self.conv1)]

    def forward(self, x):
        return self.conv1(torch.relu(self.conv0(x)))


def _windows(x, ws: int):
    """(B, C, H, W) -> (B * nh * nw, ws * ws, C): windows in (B, nh, nw)
    order, pixels row-major in a window."""
    b, c, h, w = x.shape
    return (x.reshape(b, c, h // ws, ws, w // ws, ws).permute(0, 2, 4, 3, 5, 1)
            .reshape(-1, ws * ws, c))


def _unwindows(y, b: int, h: int, w: int, ws: int):
    """The inverse of :func:`_windows`."""
    c = y.shape[-1]
    return (y.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 5, 1, 3, 2, 4)
            .reshape(b, c, h, w))


class GMSA(nn.Module):
    """Group multi-scale self-attention: a 1x1 conv to ``channels * 2``
    (``* 1`` when it reuses the previous attention), BatchNorm, three
    channel splits attended in windows of the three sizes (rolled by -ws/2
    before and +ws/2 after when ``shifts``), concatenated, a 1x1 conv.
    Returns the output and the three attentions."""

    def __init__(self, channels: int, shifts: int = 0, window_sizes: Sequence[int] = (4, 8, 12),
                 calc_attn: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.shifts = shifts
        self.window_sizes = tuple(window_sizes)
        self.calc_attn = calc_attn
        mult = 2 if calc_attn else 1
        self.split = channels * mult // 3
        cc = self.split // 2 if calc_attn else self.split
        self.project_inp = Conv(channels, channels * mult, 1, dtype=dtype)
        self.bn = BatchNorm(channels * mult, momentum=0.9, dtype=dtype)
        self.project_out = Conv(3 * cc, channels, 1, dtype=dtype)

    def flax_children(self):
        return [("project_inp", ("TConv_0",), self.project_inp),
                ("bn", ("BatchNorm_0",), self.bn), ("project_out", ("TConv_1",), self.project_out)]

    def forward(self, x, prev_atns=None, train: bool = False):
        b, _, h, w = x.shape
        y = self.bn(self.project_inp(x), train=train)
        split = self.split
        ys, atns = [], []
        for idx, ws in enumerate(self.window_sizes[:3]):
            x_ = y[:, idx * split:(idx + 1) * split]
            if self.shifts > 0:
                x_ = torch.roll(x_, (-(ws // 2), -(ws // 2)), dims=(2, 3))
            win = _windows(x_, ws)
            if self.calc_attn:
                q, v = win[..., :split // 2], win[..., split // 2:]
                atn = torch.softmax(torch.bmm(q, q.transpose(1, 2)), dim=-1)
                y_ = torch.bmm(atn, v)
            else:
                atn = prev_atns[idx]
                y_ = torch.bmm(atn, win)
            y_ = _unwindows(y_, b, h, w, ws)
            if self.shifts > 0:
                y_ = torch.roll(y_, (ws // 2, ws // 2), dims=(2, 3))
            ys.append(y_)
            atns.append(atn)
        out = self.project_out(torch.cat(ys, dim=1))
        return out, (atns if self.calc_attn else prev_atns)


class ELAB(nn.Module):
    """``1 + shared_depth`` rounds of ``x = LFE(x) + x; x = GMSA(x) + x``,
    the rounds after the first reusing the first round's attention."""

    def __init__(self, channels: int, exp_ratio: int = 2, shifts: int = 0,
                 window_sizes: Sequence[int] = (4, 8, 12), shared_depth: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        depth = 1 + shared_depth
        self.lfes = nn.ModuleList(LFE(channels, channels, exp_ratio, dtype=dtype)
                                  for _ in range(depth))
        self.gmsas = nn.ModuleList(GMSA(channels, shifts, window_sizes, calc_attn=(i == 0),
                                        dtype=dtype) for i in range(depth))

    def flax_children(self):
        return ([(f"lfes.{i}", (f"LFE_{i}",), m) for i, m in enumerate(self.lfes)]
                + [(f"gmsas.{i}", (f"GMSA_{i}",), m) for i, m in enumerate(self.gmsas)])

    def forward(self, x, train: bool = False):
        atn = None
        for lfe, gmsa in zip(self.lfes, self.gmsas):
            x = lfe(x) + x
            y, atn = gmsa(x, atn, train=train)
            x = y + x
        return x


class ELAN(nn.Module):
    """ELAN x``scale``: the DIV2K mean shift, a reflect pad to the lcm of
    the window sizes, a 3x3 head, ``m_elan // (1 + n_share)`` ELABs
    (shifted windows in every second), a ParaCALayer after every
    ``meta_every``-th block when ``num_metadata > 0`` and metadata is
    given (QELAN), the head's output added back, a 3x3 tail to
    ``colors * scale**2`` channels, the pixel shuffle, the mean added back
    and the crop to ``scale`` times the input's size."""

    def __init__(self, scale: int = 4, colors: int = 3, window_sizes: Sequence[int] = (4, 8, 16),
                 m_elan: int = 36, c_elan: int = 180, n_share: int = 0, r_expand: int = 2,
                 apply_mean_shift: bool = True, rgb_range: float = 1.0,
                 num_metadata: int = 0, meta_every: int = 2, in_feats: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.window_sizes = tuple(window_sizes)
        self.apply_mean_shift = apply_mean_shift
        self.shift = [m * rgb_range for m in DIV2K_RGB_MEAN]
        self.meta_every = meta_every
        self.head = Conv(in_feats, c_elan, 3, dtype=dtype)
        n_blocks = m_elan // (1 + n_share)
        self.blocks = nn.ModuleList(
            ELAB(c_elan, r_expand, shifts=0 if (i + 1) % 2 == 1 else 1,
                 window_sizes=window_sizes, shared_depth=n_share, dtype=dtype)
            for i in range(n_blocks))
        self.metas = nn.ModuleList(
            ParaCALayer(c_elan, num_metadata, nonlinearity=True, dtype=dtype)
            for i in range(n_blocks) if num_metadata > 0 and (i + 1) % meta_every == 0)
        self.tail = Conv(c_elan, colors * scale ** 2, 3, dtype=dtype)

    def flax_children(self):
        return ([("head", ("TConv_0",), self.head), ("tail", ("TConv_1",), self.tail)]
                + [(f"blocks.{i}", (f"ELAB_{i}",), m) for i, m in enumerate(self.blocks)]
                + [(f"metas.{i}", (f"ParaCALayer_{i}",), m) for i, m in enumerate(self.metas)])

    def forward(self, x, metadata=None, train: bool = False):
        h, w = x.shape[2:]
        mean = torch.tensor(self.shift, dtype=x.dtype, device=x.device)[:, None, None]
        if self.apply_mean_shift:
            x = x - mean
        wsize = math.lcm(*self.window_sizes)
        ph, pw = (wsize - h % wsize) % wsize, (wsize - w % wsize) % wsize
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        x = self.head(x)
        res = x
        metas = iter(self.metas)
        for i, block in enumerate(self.blocks):
            res = block(res, train=train)
            if len(self.metas) and metadata is not None and (i + 1) % self.meta_every == 0:
                res = next(metas)(res, metadata)
        out = pixel_shuffle(self.tail(res + x), self.scale)
        if self.apply_mean_shift:
            out = out + mean
        return out[:, :, :h * self.scale, :w * self.scale]


QELAN = ELAN  # meta-attention engaged by num_metadata > 0


# ---------------------------------------------------------------------------
# Handlers
# ---------------------------------------------------------------------------

@register_model("han")
class HANHandler(BaseHandler):
    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"

    def __init__(self, n_feats=64, n_resgroups=10, n_resblocks=20, reduction=16, **kwargs):
        super().__init__(n_feats=n_feats, n_resgroups=n_resgroups, n_resblocks=n_resblocks,
                         reduction=reduction, **kwargs)

    def build_module(self, **kw):
        return HAN(scale=self.scale, in_feats=self.in_features, dtype=self.dtype, **kw)


@register_model("elan")
class ELANHandler(BaseHandler):
    """ELAN; a train step normalises GMSA's BatchNorm by the batch's
    statistics and updates the running ones, evaluation reads them."""

    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"

    def __init__(self, m_elan=36, c_elan=180, window_sizes=(4, 8, 16), n_share=0, r_expand=2,
                 **kwargs):
        super().__init__(m_elan=m_elan, c_elan=c_elan, window_sizes=tuple(window_sizes),
                         n_share=n_share, r_expand=r_expand, **kwargs)

    def build_module(self, **kw):
        return ELAN(scale=self.scale, in_feats=self.in_features, dtype=self.dtype, **kw)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        sr = self.module(lr.permute(0, 3, 1, 2), train=train)
        return sr.permute(0, 2, 3, 1), {}, extra


@register_model("qhan")
class QHANHandler(QModelHandler):
    def __init__(self, n_feats=64, n_resgroups=10, n_resblocks=20, reduction=16,
                 style="standard", include_q_layer=True, selective_meta_blocks=None,
                 num_q_layers_inner_residual=None, **kwargs):
        super().__init__(
            n_feats=n_feats, n_resgroups=n_resgroups, n_resblocks=n_resblocks,
            reduction=reduction, style=style, include_q_layer=include_q_layer,
            selective_meta_blocks=(tuple(selective_meta_blocks)
                                   if selective_meta_blocks else None),
            num_q_layers_inner_residual=num_q_layers_inner_residual, **kwargs)

    def build_module(self, **kw):
        return QHAN(scale=self.scale, in_feats=self.in_features,
                    num_metadata=self.num_metadata, dtype=self.dtype, **kw)


@register_model("qelan")
class QELANHandler(QModelHandler):
    """QELAN: ELAN with a ParaCALayer of the metadata every ``meta_every``
    blocks; BatchNorm as in ``elan``."""

    def __init__(self, m_elan=36, c_elan=180, window_sizes=(4, 8, 16), n_share=0, r_expand=2,
                 meta_every=2, **kwargs):
        super().__init__(m_elan=m_elan, c_elan=c_elan, window_sizes=tuple(window_sizes),
                         n_share=n_share, r_expand=r_expand, meta_every=meta_every, **kwargs)

    def build_module(self, **kw):
        return QELAN(scale=self.scale, in_feats=self.in_features,
                     num_metadata=self.num_metadata, dtype=self.dtype, **kw)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        sr = self.module(lr.permute(0, 3, 1, 2), self._metadata(batch), train=train)
        return sr.permute(0, 2, 3, 1), {}, extra
