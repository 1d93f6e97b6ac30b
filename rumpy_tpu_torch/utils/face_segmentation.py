"""BiSeNet face parsing.

Port of ``rumpy_tpu/utils/face_segmentation.py`` (the reference vendors the
public zllrunning/face-parsing.PyTorch BiSeNet): a ResNet-18 context path
with attention-refinement modules and a global-average shortcut, the
stride-8 feature standing in for the spatial path, a feature-fusion
module, and three heads resized to the input with align_corners bilinear.
Inference only: BatchNorm uses its running statistics.

Modules are named as the flax tree is (``cp/resnet/layer1_0/conv1``), so
the flax-layout npz both packages read (``load_bisenet_npz``; written by
``convert_torch_bisenet`` from the reference's ``.pth``) gives both the
same weights. :class:`BiSeNet` takes and returns NHWC and runs
channels_last. :class:`BiSeNetSegmenter` is gated on its weights, resizes
to 512 with Pillow's bilinear (``ops/resize.py``), normalises with the
ImageNet statistics and takes the argmax, all on its device.
"""

from __future__ import annotations

import colorsys
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import resolve_device, true_div
from rumpy_tpu_torch.ops.resize import pil_resize

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _nearest_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ``F.interpolate(mode='nearest')`` on NCHW, by the integer index
    map floor(i * in / out)."""
    h, w = x.shape[2:]
    H, W = out_hw
    iy = torch.arange(H, device=x.device) * h // H
    ix = torch.arange(W, device=x.device) * w // W
    return x[:, :, iy][:, :, :, ix]


def _bilinear_ac_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``F.interpolate(mode='bilinear', align_corners=True)`` on NCHW."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


def _conv(cin, cout, k=3, stride=1, pad=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=False)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, out_chan: int, ks: int = 3, stride: int = 1, pad: int = 1):
        super().__init__()
        self.conv = _conv(cin, out_chan, ks, stride, pad)
        self.bn = nn.BatchNorm2d(out_chan)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_chan, out_chan, 3, stride, 1)
        self.bn1 = nn.BatchNorm2d(out_chan)
        self.conv2 = _conv(out_chan, out_chan, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(out_chan)
        self.has_downsample = in_chan != out_chan or stride != 1
        if self.has_downsample:
            self.downsample_0 = _conv(in_chan, out_chan, 1, stride)
            self.downsample_1 = nn.BatchNorm2d(out_chan)

    def forward(self, x):
        r = F.relu(self.bn1(self.conv1(x)))
        r = self.bn2(self.conv2(r))
        short = self.downsample_1(self.downsample_0(x)) if self.has_downsample else x
        return F.relu(short + r)


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        for name, cin, cout, stride in (("layer1_0", 64, 64, 1), ("layer1_1", 64, 64, 1),
                                        ("layer2_0", 64, 128, 2), ("layer2_1", 128, 128, 1),
                                        ("layer3_0", 128, 256, 2), ("layer3_1", 256, 256, 1),
                                        ("layer4_0", 256, 512, 2), ("layer4_1", 512, 512, 1)):
            setattr(self, name, BasicBlock(cin, cout, stride))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer1_1(self.layer1_0(x))
        f8 = self.layer2_1(self.layer2_0(x))
        f16 = self.layer3_1(self.layer3_0(f8))
        f32 = self.layer4_1(self.layer4_0(f16))
        return f8, f16, f32


class AttentionRefinementModule(nn.Module):
    def __init__(self, cin: int, out_chan: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, out_chan)
        self.conv_atten = _conv(out_chan, out_chan, 1)
        self.bn_atten = nn.BatchNorm2d(out_chan)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.conv_avg = ConvBNReLU(512, 128, ks=1, pad=0)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.arm16 = AttentionRefinementModule(256, 128)
        self.conv_head16 = ConvBNReLU(128, 128)

    def forward(self, x):
        f8, f16, f32 = self.resnet(x)
        avg = self.conv_avg(f32.mean(dim=(2, 3), keepdim=True))
        f32_up = _nearest_resize(self.arm32(f32) + avg, f16.shape[2:])
        f32_up = self.conv_head32(f32_up)
        f16_up = _nearest_resize(self.arm16(f16) + f32_up, f8.shape[2:])
        f16_up = self.conv_head16(f16_up)
        return f8, f16_up, f32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, cin: int, out_chan: int):
        super().__init__()
        self.convblk = ConvBNReLU(cin, out_chan, ks=1, pad=0)
        self.conv1 = _conv(out_chan, out_chan // 4, 1)
        self.conv2 = _conv(out_chan // 4, out_chan, 1)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = self.conv2(F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True))))
        return feat * torch.sigmoid(atten) + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin: int, mid_chan: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid_chan)
        self.conv_out = _conv(mid_chan, n_classes, 1)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """(N, H, W, 3) normalised images -> the three heads' logits, each
    (N, H, W, n_classes)."""

    def __init__(self, n_classes: int = 19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x):
        hw = x.shape[1:3]
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        f_res8, f_cp8, f_cp16 = self.cp(x)
        outs = (self.conv_out(self.ffm(f_res8, f_cp8)), self.conv_out16(f_cp8),
                self.conv_out32(f_cp16))
        return tuple(_bilinear_ac_resize(o, hw).permute(0, 2, 3, 1) for o in outs)

    def load_variables(self, variables) -> "BiSeNet":
        """Weights from a flax-layout tree ``{'params': ..., 'batch_stats':
        ...}`` (numpy leaves): conv kernels HWIO, BatchNorm scale/bias and
        mean/var."""
        params, stats = variables["params"], variables.get("batch_stats", {})

        def leaf(tree, path):
            for p in path:
                tree = tree[p]
            return tree

        state = {}
        for name, ref in self.state_dict().items():
            *path, last = name.split(".")
            if last == "num_batches_tracked":
                state[name] = ref
                continue
            if last == "weight" and ref.dim() == 4:
                val = np.asarray(leaf(params, path)["kernel"]).transpose(3, 2, 0, 1)
            elif last in ("weight", "bias"):
                val = leaf(params, path)["scale" if last == "weight" else "bias"]
            else:
                val = leaf(stats, path)["mean" if last == "running_mean" else "var"]
            state[name] = torch.as_tensor(np.array(val, dtype=np.float32))
        self.load_state_dict(state)
        return self


# ---------------------------------------------------------------------------
# Weight conversion / loading
# ---------------------------------------------------------------------------

def convert_torch_bisenet(state_dict, out_npz: Optional[str] = None):
    """The reference BiSeNet ``.pth`` (or its state dict; torch names like
    'cp.resnet.layer1.0.conv1.weight') as the flax-layout tree
    ``{'params': ..., 'batch_stats': ...}``; with ``out_npz`` also written
    as a flat npz ('params/cp/resnet/layer1_0/conv1/kernel', ...)."""
    if isinstance(state_dict, str):
        state_dict = torch.load(state_dict, map_location="cpu")
    params: dict = {}
    stats: dict = {}

    def put(root, path, leaf, val):
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val

    for key, val in state_dict.items():
        parts = key.split(".")
        leaf = parts[-1]
        # a numeric segment joins the name before it ('layer1.0' -> 'layer1_0')
        path = []
        for p in parts[:-1]:
            if p.isdigit():
                path[-1] = f"{path[-1]}_{p}"
            else:
                path.append(p)
        arr = np.asarray(val)
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight" and arr.ndim == 4:
            put(params, path, "kernel", arr.transpose(2, 3, 1, 0))
        elif leaf == "weight":  # BatchNorm gamma
            put(params, path, "scale", arr)
        elif leaf == "bias":
            put(params, path, "bias", arr)
        elif leaf == "running_mean":
            put(stats, path, "mean", arr)
        elif leaf == "running_var":
            put(stats, path, "var", arr)
        else:
            raise KeyError(f"unexpected checkpoint leaf {key}")
    variables = {"params": params, "batch_stats": stats}
    if out_npz:
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + (k,))
                else:
                    flat["/".join(prefix + (k,))] = v

        walk(variables, ())
        np.savez(out_npz, **flat)
    return variables


def load_bisenet_npz(path: str) -> Dict:
    """The flax-layout tree of a flat npz, numpy leaves."""
    variables: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = variables
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return variables


class BiSeNetSegmenter:
    """Face parser: BiSeNet at 512 x 512 with ImageNet normalisation, the
    argmax of the main head, on ``device`` (default "cuda"). Weights: the
    reference's ``.pth`` or a converted npz."""

    def __init__(self, weights_path: Optional[str] = None, n_classes: int = 19,
                 device=None):
        if not weights_path:
            raise NotImplementedError(
                "Face segmentation needs a BiSeNet checkpoint "
                "(pass weights_path: the reference's .pth or a converted "
                "npz — see convert_torch_bisenet)")
        self.device = resolve_device(device)
        variables = (load_bisenet_npz(weights_path) if weights_path.endswith(".npz")
                     else convert_torch_bisenet(weights_path))
        self.module = BiSeNet(n_classes).load_variables(variables).eval().to(
            self.device, memory_format=torch.channels_last)
        self.mean = torch.tensor(_IMAGENET_MEAN, device=self.device)
        self.std = torch.tensor(_IMAGENET_STD, device=self.device)

    @torch.no_grad()
    def parse_tensor(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) uint8 on the device -> (512, 512) int64 class map there."""
        x = true_div(pil_resize(image, (512, 512), filter="bilinear").float(), 255.0)
        x = (x - self.mean) / self.std
        return self.module(x[None])[0][0].argmax(dim=-1)

    def parse(self, image: np.ndarray) -> np.ndarray:
        """image: (H, W, 3) RGB uint8 or float in [0, 1] (any size; resized
        to 512 internally). Returns the (512, 512) int32 class map."""
        image = np.asarray(image)
        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        t = torch.from_numpy(np.array(image)).to(self.device)  # a writable copy
        return self.parse_tensor(t).to(torch.int32).cpu().numpy()


def colorize_parsing(parsing: np.ndarray) -> np.ndarray:
    """Class map -> RGB visualisation: white background, a distinct hue a
    class."""
    n = int(parsing.max()) + 1
    out = np.full(parsing.shape + (3,), 255, np.uint8)
    for c in range(1, n):
        rgb = colorsys.hsv_to_rgb(((c - 1) * 0.41) % 1.0, 0.85, 1.0)
        out[parsing == c] = [int(v * 255) for v in rgb]
    return out
