"""DIC: Deep Iterative Collaboration face SR.

Port of ``rumpy_tpu/models/dic.py``. Each of ``num_steps`` iterations runs a
feedback block of up/down projection groups (step 0's own weights, then one
block with heatmap attention for every later step) to an SR image, and a
feedback hourglass estimates 68 landmark heatmaps from that image; the next
step merges them into 5 face regions and pools its features by their
softmax. The hidden states of both recurrences are threaded explicitly.
Everything is cuDNN convs and PyTorch ops: the JAX package computes none of
it in a Pallas kernel, so no RCAB kernel runs.

The handler trains with the sum over steps of the L1 loss plus 0.1 times
the heatmaps' MSE against Gaussian heatmaps rendered on the device from
each image's 68 landmarks. The landmarks come from a pickle
``{image name: (68, 2)}``, looked up on the host from the batch's tags (an
image's tag with ``_<anything>.`` cut to ``.`` first), in HR pixels; the
lookup ignores where the crop was cut, as the JAX handler does (ROADMAP.md
section 3). The hourglass takes no gradient before step ``hg_release_step``
(2,000,000 by default): its gradients are multiplied by 0 (so Adam's moments
still decay, as optax's do), by the handler's own step count, which a step
reads without waiting for the card.
"""

from __future__ import annotations

import pickle
import re
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import to_device, true_div
from rumpy_tpu_torch.models.base import PIXEL_LOSSES, BaseHandler
from rumpy_tpu_torch.models.common import Conv, pixel_shuffle
from rumpy_tpu_torch.models.face_attribute_gans import PRelu, TorchConvTranspose
from rumpy_tpu_torch.registry import register_model


def _lrelu(v):
    return F.leaky_relu(v, 0.2)


class ConvBlock(nn.Module):
    """A conv (``groups`` as flax's ``feature_group_count``; padding (k - 1)
    // 2 unless ``valid_padding`` is off, then ``padding``), then a PReLU
    with one slope at 0.2, a leaky relu 0.2 (``act="lrelu"``) or nothing."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1,
                 act: Optional[str] = "prelu", valid_padding: bool = True, padding: int = 0,
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        p = (kernel - 1) // 2 if valid_padding else padding
        self.conv = Conv(in_features, features, kernel, stride=stride, padding=p, groups=groups,
                         dtype=dtype)
        self.act = act
        self.prelu = PRelu(1, 0.2) if act == "prelu" else None

    def forward(self, x):
        x = self.conv(x)
        if self.prelu is not None:
            return self.prelu(x)
        return _lrelu(x) if self.act == "lrelu" else x

    def flax_children(self):
        out = [("conv", ("conv",), self.conv)]
        if self.prelu is not None:
            out.append(("prelu", ("prelu",), self.prelu))
        return out


class DeconvBlock(nn.Module):
    """torch's ``ConvTranspose2d(k, s, p)`` and a PReLU (slope 0.2)."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int, padding: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.deconv = TorchConvTranspose(in_features, features, kernel, stride, padding,
                                         dtype=dtype)
        self.prelu = PRelu(1, 0.2)

    def forward(self, x):
        return self.prelu(self.deconv(x))

    def flax_children(self):
        return [("deconv", ("deconv",), self.deconv), ("prelu", ("prelu",), self.prelu)]


class ResidualBlockHG(nn.Module):
    """The hourglass's BN-free bottleneck: 1x1 to half, ReLU, 3x3, 1x1 to
    ``features``, added to the input (through a 1x1 where the channel count
    changes)."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        half = features // 2
        self.c0 = Conv(in_features, half, 1, dtype=dtype)
        self.c1 = Conv(half, half, 3, dtype=dtype)
        self.c2 = Conv(half, features, 1, dtype=dtype)
        self.c3_skip = Conv(in_features, features, 1, dtype=dtype) \
            if in_features != features else None

    def forward(self, x):
        r = self.c2(self.c1(torch.relu(self.c0(x))))
        if self.c3_skip is not None:
            x = self.c3_skip(x)
        return x + r

    def flax_children(self):
        names = ("c0", "c1", "c2") + (("c3_skip",) if self.c3_skip is not None else ())
        return [(n, (n,), getattr(self, n)) for n in names]


def upsample_bilinear_align(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Bilinear upsampling of (N, C, H, W) by ``factor`` with aligned
    corners: output j samples input j (in - 1) / (out - 1)."""
    return F.interpolate(x, size=(x.shape[2] * factor, x.shape[3] * factor), mode="bilinear",
                         align_corners=True)


class HourGlassDIC(nn.Module):
    """The recursive BN-free hourglass: ``r0_up(x) + up(r3_out(inner(
    r1_low(maxpool(x)))))``, the inner level an hourglass of one depth less,
    or a residual block at depth 1; max pool 2/2 (floor), bilinear x2 with
    aligned corners."""

    def __init__(self, depth: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.r0_up = ResidualBlockHG(features, features, dtype)
        self.r1_low = ResidualBlockHG(features, features, dtype)
        self.r2_inner = (HourGlassDIC(depth - 1, features, dtype) if depth > 1
                         else ResidualBlockHG(features, features, dtype))
        self.r3_out = ResidualBlockHG(features, features, dtype)

    def forward(self, x):
        up1 = self.r0_up(x)
        low = self.r3_out(self.r2_inner(self.r1_low(F.max_pool2d(x, 2, 2))))
        return up1 + upsample_bilinear_align(low, 2)

    def flax_children(self):
        return [(n, (n,), getattr(self, n)) for n in ("r0_up", "r1_low", "r2_inner", "r3_out")]


class FeedbackHourGlass(nn.Module):
    """The landmark estimator: a 7x7 conv (stride 2 at x8) and three
    residual blocks with a max pool to ``num_feature`` channels, the hidden
    state (its own features at the first step) concatenated and compressed
    to 2F, one 2F-channel hourglass of depth 4; the heatmap head on the
    first F channels, the second F the next hidden state."""

    def __init__(self, num_feature: int, num_keypoints: int, scale: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f = num_feature
        self.f = f
        self.p0_conv = Conv(3, f // 4, 7, stride=2 if scale == 8 else 1, padding=3, dtype=dtype)
        self.p1_res = ResidualBlockHG(f // 4, f // 2, dtype)
        self.p2_res = ResidualBlockHG(f // 2, f // 2, dtype)
        self.p3_res = ResidualBlockHG(f // 2, f, dtype)
        self.q0_compress = Conv(2 * f, 2 * f, 1, dtype=dtype)
        self.q1_hg = HourGlassDIC(4, 2 * f, dtype)
        self.q2_res = ResidualBlockHG(f, f, dtype)
        self.q3_lin = Conv(f, f, 1, dtype=dtype)
        self.q4_pred = Conv(f, num_keypoints, 1, dtype=dtype)

    def forward(self, x, last_hidden=None):
        h = self.p1_res(torch.relu(self.p0_conv(x)))
        h = self.p3_res(self.p2_res(F.max_pool2d(h, 2, 2)))
        paired = torch.cat([h, h if last_hidden is None else last_hidden], dim=1)
        feature = self.q1_hg(self.q0_compress(paired))
        head = torch.relu(self.q3_lin(self.q2_res(feature[:, :self.f])))
        return self.q4_pred(head), feature[:, self.f:]

    def flax_children(self):
        names = ("p0_conv", "p1_res", "p2_res", "p3_res", "q0_compress", "q1_hg", "q2_res",
                 "q3_lin", "q4_pred")
        return [(n, (n,), getattr(self, n)) for n in names]


def merge_heatmap_5(heatmap: torch.Tensor, detach: bool) -> torch.Tensor:
    """(N, K, H, W) heatmaps, each divided by its spatial max (at least
    0.05); 68 landmarks merged into 5 face regions (left eye, right eye,
    nose, mouth, silhouette), 5 kept as they are."""
    max_heat = heatmap.amax(dim=(2, 3), keepdim=True).clamp(min=0.05)
    heatmap = heatmap / max_heat
    k = heatmap.shape[1]
    if k == 68:
        heatmap = torch.stack([heatmap[:, a:b].sum(1) for a, b in
                               ((36, 42), (42, 48), (27, 36), (48, 68), (0, 27))], dim=1)
    elif k != 5:
        raise NotImplementedError(f"heatmap merge for {k} landmarks not implemented")
    return heatmap.detach() if detach else heatmap


class FeatureHeatmapFusingBlock(nn.Module):
    """Features expanded to K groups (1x1, leaky relu), ``num_block``
    grouped residual blocks, then each pixel's groups summed with the
    softmax of the K heatmaps over channels as weights."""

    def __init__(self, features: int, num_heatmap: int, num_block: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k, res_ch = num_heatmap, features * num_heatmap
        self.k, self.features = k, features
        self.a_conv_in = ConvBlock(features, res_ch, 1, act="lrelu", dtype=dtype)
        self.blocks = nn.ModuleList(
            nn.ModuleList([ConvBlock(res_ch, res_ch, 3, act="lrelu", groups=k, dtype=dtype),
                           ConvBlock(res_ch, res_ch, 3, act=None, groups=k, dtype=dtype)])
            for _ in range(num_block))

    def forward(self, feature, heatmap):
        feature = self.a_conv_in(feature)
        for c0, c1 in self.blocks:
            feature = feature + c1(c0(feature))
        attention = torch.softmax(heatmap, dim=1)
        b, _, h, w = feature.shape
        feature = feature.reshape(b, self.k, self.features, h, w)
        return (feature * attention[:, :, None]).sum(dim=1)

    def flax_children(self):
        out = [("a_conv_in", ("a_conv_in",), self.a_conv_in)]
        for i, (c0, c1) in enumerate(self.blocks):
            out += [(f"blocks.{i}.0", (f"b{i:02d}_c0",), c0),
                    (f"blocks.{i}.1", (f"b{i:02d}_c1",), c1)]
        return out


# (kernel, stride, padding) of the projection groups' up and down convs
PROJECTION = {2: (6, 2, 2), 3: (7, 3, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


class _ProjectionGroups(nn.Module):
    """The feedback block's dense up/down projection groups: each group
    compresses all LR states so far (1x1, after the first), projects them
    up, compresses all HR states so far (1x1, after the first) and projects
    back down; the LR states after the input are concatenated and
    compressed (1x1)."""

    def __init__(self, features: int, groups: int, scale: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k, s, p = PROJECTION[scale]
        f = features
        self.groups = groups
        self.uptran = nn.ModuleList(ConvBlock(f * (i + 1), f, 1, dtype=dtype)
                                    for i in range(1, groups))
        self.up = nn.ModuleList(DeconvBlock(f, f, k, s, p, dtype=dtype) for _ in range(groups))
        self.downtran = nn.ModuleList(ConvBlock(f * (i + 1), f, 1, dtype=dtype)
                                      for i in range(1, groups))
        self.down = nn.ModuleList(ConvBlock(f, f, k, stride=s, valid_padding=False, padding=p,
                                            dtype=dtype) for _ in range(groups))
        self.compress_out = ConvBlock(f * groups, f, 1, dtype=dtype)

    def forward(self, x):
        lr_features, hr_features = [x], []
        for idx in range(self.groups):
            ld_l = torch.cat(lr_features, dim=1)
            if idx > 0:
                ld_l = self.uptran[idx - 1](ld_l)
            hr_features.append(self.up[idx](ld_l))
            ld_h = torch.cat(hr_features, dim=1)
            if idx > 0:
                ld_h = self.downtran[idx - 1](ld_h)
            lr_features.append(self.down[idx](ld_h))
        return self.compress_out(torch.cat(lr_features[1:], dim=1))

    def flax_children(self):
        out = []
        for i in range(self.groups):
            if i > 0:
                out.append((f"uptran.{i - 1}", (f"g{i:02d}a_uptran",), self.uptran[i - 1]))
            out.append((f"up.{i}", (f"g{i:02d}b_up",), self.up[i]))
            if i > 0:
                out.append((f"downtran.{i - 1}", (f"g{i:02d}c_downtran",),
                            self.downtran[i - 1]))
            out.append((f"down.{i}", (f"g{i:02d}d_down",), self.down[i]))
        return out + [("compress_out", ("z_compress_out",), self.compress_out)]


class FeedbackBlockCustom(nn.Module):
    """The first step's feedback block: a 1x1 compression, then the
    projection groups."""

    def __init__(self, features: int, groups: int, scale: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.a_compress_in = ConvBlock(features, features, 1, dtype=dtype)
        self.b_groups = _ProjectionGroups(features, groups, scale, dtype)

    def forward(self, x):
        return self.b_groups(self.a_compress_in(x))

    def flax_children(self):
        return [(n, (n,), getattr(self, n)) for n in ("a_compress_in", "b_groups")]


class FeedbackBlockHeatmapAttention(nn.Module):
    """The later steps' feedback block: the input and the last hidden state
    concatenated and compressed (1x1), fused with the merged heatmaps, then
    the projection groups."""

    def __init__(self, features: int, groups: int, scale: int, num_heatmap: int,
                 num_fusion_block: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.a_compress_in = ConvBlock(2 * features, features, 1, dtype=dtype)
        self.b_fusion = FeatureHeatmapFusingBlock(features, num_heatmap, num_fusion_block, dtype)
        self.c_groups = _ProjectionGroups(features, groups, scale, dtype)

    def forward(self, x, heatmap, last_hidden):
        x = self.a_compress_in(torch.cat([x, last_hidden], dim=1))
        return self.c_groups(self.b_fusion(x, heatmap))

    def flax_children(self):
        return [(n, (n,), getattr(self, n)) for n in ("a_compress_in", "b_fusion", "c_groups")]


class DIC(nn.Module):
    """DIC at x4 or x8. ``forward`` returns (SR images, heatmaps), one of
    each per step, (N, C, H, W). The input's bilinear upscale
    (half-pixel, no antialias: upscaling only) is added to every step's
    reconstruction; the features enter at 2x LR by a pixel shuffle."""

    def __init__(self, scale: int = 4, num_steps: int = 4, num_features: int = 48,
                 num_groups: int = 6, hg_num_feature: int = 256, hg_num_keypoints: int = 68,
                 num_fusion_block: int = 7, detach_attention: bool = False,
                 in_channels: int = 3, out_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if scale == 8:
            dk, ds, dp = 8, 4, 2
        elif scale == 4:
            dk, ds, dp = 4, 2, 1
        else:
            raise NotImplementedError(f"Upscale factor {scale} not implemented!")
        f = num_features
        self.scale, self.num_steps, self.detach_attention = scale, num_steps, detach_attention
        self.conv_in = ConvBlock(in_channels, 4 * f, 3, dtype=dtype)
        self.first_block = FeedbackBlockCustom(f, num_groups, scale, dtype)
        self.block = FeedbackBlockHeatmapAttention(f, num_groups, scale, 5, num_fusion_block,
                                                   dtype)
        self.out_deconv = DeconvBlock(f, f, dk, ds, dp, dtype=dtype)
        self.conv_out = ConvBlock(f, out_channels, 3, act=None, dtype=dtype)
        self.hg = FeedbackHourGlass(hg_num_feature, hg_num_keypoints, scale, dtype)

    def forward(self, x):
        h, w = x.shape[2:]
        inter_res = F.interpolate(x, size=(h * self.scale, w * self.scale), mode="bilinear",
                                  align_corners=False)
        feat = pixel_shuffle(self.conv_in(x), 2)
        srs, heatmaps = [], []
        hg_hidden = fb_hidden = heatmap = None
        for step in range(self.num_steps):
            if step == 0:
                fb_hidden = self.first_block(feat)
            else:
                fb_hidden = self.block(feat, merge_heatmap_5(heatmap, self.detach_attention),
                                       fb_hidden)
            sr = inter_res + self.conv_out(self.out_deconv(fb_hidden))
            heatmap, hg_hidden = self.hg(sr, hg_hidden)
            srs.append(sr)
            heatmaps.append(heatmap)
        return srs, heatmaps

    def flax_children(self):
        names = ("conv_in", "first_block", "block", "out_deconv", "conv_out", "hg")
        return [(n, (n,), getattr(self, n)) for n in names]


def render_heatmaps(coords: torch.Tensor, height: int, width: int,
                    sigma: float = 1.0) -> torch.Tensor:
    """Gaussian heatmaps ``exp(-d^2 / (2 sigma^2))`` of (B, K, 2) landmark
    (x, y) positions in heatmap pixels, drawn on the coordinates' device:
    NHWC (B, height, width, K)."""
    ys = torch.arange(height, dtype=torch.float32, device=coords.device)
    xs = torch.arange(width, dtype=torch.float32, device=coords.device)
    dx = xs[None, None, :] - coords[..., 0][..., None]
    dy = ys[None, None, :] - coords[..., 1][..., None]
    d2 = dy[:, :, :, None] ** 2 + dx[:, :, None, :] ** 2
    hm = torch.exp(true_div(-d2, 2.0 * sigma * sigma))
    return hm.permute(0, 2, 3, 1)


@register_model("dic")
class DICHandler(BaseHandler):
    """DIC with its per-step L1 plus 0.1 x heatmap MSE (module docstring).
    Landmarks reach the step as (B, 68, 2) HR-pixel (x, y) positions, in
    the batch (``landmarks``) or looked up from ``landmarks_file`` by tag;
    without either the alignment term is 0. The schedule defaults to
    ``multi_step_lr`` at 10k, 20k, 40k and 80k steps, x0.5."""

    loss_type = "l1"
    colorspace = "rgb"
    size_multiple = 8  # the heatmaps are at 2x LR and feed a depth-4 hourglass
    wants_tags = True
    missing_grads_as_zeros = True

    def __init__(self, num_steps=4, num_features=48, num_groups=6, hg_num_feature=256,
                 hg_num_keypoints=68, num_fusion_block=7, detach_attention=False,
                 landmarks_file: Optional[str] = None, heatmap_sigma: float = 1.0,
                 hg_release_step: int = 2_000_000, scheduler="multi_step_lr",
                 scheduler_params=None, **kwargs):
        self.landmarks = None
        if landmarks_file:
            with open(landmarks_file, "rb") as f:
                self.landmarks = pickle.load(f)
        self.heatmap_sigma = heatmap_sigma
        self.hg_release_step = hg_release_step
        if scheduler_params is None and scheduler == "multi_step_lr":
            scheduler_params = {"milestones": [10000, 20000, 40000, 80000], "gamma": 0.5}
        super().__init__(num_steps=num_steps, num_features=num_features, num_groups=num_groups,
                         hg_num_feature=hg_num_feature, hg_num_keypoints=hg_num_keypoints,
                         num_fusion_block=num_fusion_block, detach_attention=detach_attention,
                         scheduler=scheduler, scheduler_params=scheduler_params, **kwargs)

    def build_module(self, **kw):
        return DIC(scale=self.scale, dtype=self.dtype, **kw)

    def _lookup_landmarks(self, tag: str) -> np.ndarray:
        key = re.sub(r"_(.*?)\.", ".", tag)
        marks = self.landmarks.get(key, self.landmarks.get(tag))
        if marks is None:
            raise KeyError(f"no landmarks for image {tag!r}")
        return np.asarray(marks, np.float32)

    def train_batch(self, state, batch):
        batch = dict(batch)
        tags = batch.pop("tags", None)
        if tags is not None and self.landmarks is not None and "landmarks" not in batch:
            coords = np.stack([self._lookup_landmarks(t) for t in tags])
            batch["landmarks"] = to_device(coords, self.device)
        elif "landmarks" in batch:
            batch["landmarks"] = to_device(batch["landmarks"], self.device, torch.float32)
        return super().train_batch(state, batch)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        srs, heatmaps = self.module(lr.permute(0, 3, 1, 2))
        return srs[-1].permute(0, 2, 3, 1), {"_srs": srs, "_heatmaps": heatmaps}, extra

    def compute_losses(self, sr, batch, aux):
        srs, heatmaps = aux.pop("_srs"), aux.pop("_heatmaps")
        hr = batch["hr"].float()
        pix = sum(PIXEL_LOSSES["l1"](s.float().permute(0, 2, 3, 1), hr) for s in srs)
        losses = {"pix_loss": pix}
        if "landmarks" in batch:
            coords = true_div(batch["landmarks"].float(), self.scale / 2.0)
            gt = render_heatmaps(coords, heatmaps[0].shape[2], heatmaps[0].shape[3],
                                 self.heatmap_sigma)
            align = sum(((h.float().permute(0, 2, 3, 1) - gt) ** 2).mean() for h in heatmaps)
            losses["align_loss"] = 0.1 * align
            losses["train-loss"] = pix + 0.1 * align
        else:
            losses["align_loss"] = torch.zeros((), device=hr.device)
            losses["train-loss"] = pix
        losses["full_loss"] = losses["train-loss"]
        return losses

    def transform_grads(self, grads, state, batch):
        """The hourglass's gradients times 0 before ``hg_release_step``."""
        if self.hg_release_step and int(state.step) < self.hg_release_step:
            hg = [g for k, g in grads.items() if k.startswith("hg.")]
            if hg:
                torch._foreach_mul_(hg, 0.0)
        return grads


@register_model("dicnet")
class DICNetHandler(DICHandler):
    """``dic`` under its older name and arguments: ``nf`` is
    ``num_features``, ``iterations`` ``num_steps``; ``num_landmarks`` is
    ignored with a warning."""

    def __init__(self, nf=None, iterations=None, num_landmarks=None, **kwargs):
        if nf is not None:
            kwargs.setdefault("num_features", nf)
        if iterations is not None:
            kwargs.setdefault("num_steps", iterations)
        if num_landmarks is not None:
            warnings.warn(
                "dicnet's old num_landmarks kwarg is ignored — the reference-exact DIC "
                "predicts hg_num_keypoints heatmaps merged to 5 attention groups", stacklevel=2)
        super().__init__(**kwargs)
