"""Perceptual and recognition feature extractors.

Port of ``rumpy_tpu/models/feature_extractors.py``: the VGG-19 trunk up to
a named tap (the perceptual loss's extractor), the VGG-16 trunk with
numbered taps, LightCNN-9, and the npz weight format both packages read.
Pretrained weights are not shipped: construction from weights reads an npz
of the flax layout (``Conv_<i>/kernel`` HWIO, ``Conv_<i>/bias``), which
:func:`convert_torch_vgg19` and ``PerceptualExtractor.convert_torch_vgg16``
write from a torchvision state dict. Modules take NCHW tensors (channels
last in memory) in [0, 1]; public calls take and return NHWC.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import resolve_device
from rumpy_tpu_torch.models.common import Conv

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")

# torchvision-style layer names in execution order, for the tap
# ('conv5_4' is features[:35], pre-activation)
VGG19_LAYER_NAMES = []
for _blk, _n in ((1, 2), (2, 2), (3, 4), (4, 4), (5, 4)):
    for _i in range(_n):
        VGG19_LAYER_NAMES += [f"conv{_blk}_{_i + 1}", f"relu{_blk}_{_i + 1}"]
    VGG19_LAYER_NAMES.append(f"pool{_blk}")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _FlaxConvs(nn.Module):
    """Base of an extractor whose convs are flax's ``Conv_<i>`` in order."""

    def flax_children(self):
        return [(f"convs.{i}", (f"Conv_{i}",), c) for i, c in enumerate(self.convs)]

    def load_params(self, params) -> "_FlaxConvs":
        """Weights from a flat ``{Conv_<i>: {kernel, bias}}`` tree (an npz's,
        :func:`load_extractor_params`); convs the module does not build (a
        shallow tap's) are left out, as flax ignores them."""
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        used = {f"Conv_{i}": params[f"Conv_{i}"] for i in range(len(self.convs))}
        with torch.no_grad():
            self.load_state_dict(state_dict_from_jax(used, self))
        return self

    @classmethod
    def from_npz(cls, path: str, device=None, **kwargs):
        """The extractor with the npz's weights, on ``device`` (default
        ``"cuda"``), channels_last, in eval mode and without gradients."""
        module = cls(**kwargs).load_params(load_extractor_params(path))
        return module.to(resolve_device(device)).to(
            memory_format=torch.channels_last).eval().requires_grad_(False)


class VGG19Features(_FlaxConvs):
    """VGG-19 trunk up to the named ``tap`` ('conv5_4' or 'conv54'; the tap
    is taken where the layer ends, so a conv tap is pre-activation), after
    ImageNet normalisation in float32. Only the layers up to the tap are
    built."""

    def __init__(self, tap: str = "conv5_4", normalise_input: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        names = VGG19_LAYER_NAMES
        wanted = [n for n in names if n == tap or n.replace("_", "") == tap]
        if not wanted:
            raise KeyError(f"unknown VGG19 tap {tap!r} (expected one of {names})")
        self.stop = names.index(wanted[0])
        self.normalise_input = normalise_input
        self.plan = []  # "M" or a conv's index, then "relu", up to the tap
        convs, li, cin = [], 0, 3
        for spec in VGG19_CFG:
            if li > self.stop:
                break
            if spec == "M":
                self.plan.append("M")
                li += 1
                continue
            convs.append(Conv(cin, spec, 3, dtype=dtype))
            cin = spec
            self.plan.append(len(convs) - 1)
            li += 1
            if li <= self.stop:
                self.plan.append("relu")
                li += 1
        self.convs = nn.ModuleList(convs)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x):
        if self.normalise_input:
            x = (x.float() - self.mean) / self.std
        for step in self.plan:
            if step == "M":
                x = F.max_pool2d(x, 2, 2)
            elif step == "relu":
                x = torch.relu(x)
            else:
                x = self.convs[step](x)
        return x


class VGG16Features(_FlaxConvs):
    """VGG-16 trunk returning the activations at torchvision layer indices
    ``taps`` (a list when there are several)."""

    def __init__(self, taps: Tuple[int, ...] = (22,), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.taps = tuple(taps)
        convs, cin = [], 3
        for spec in VGG16_CFG:
            if spec != "M":
                convs.append(Conv(cin, spec, 3, dtype=dtype))
                cin = spec
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        outputs, layer_idx, ci = [], 0, 0
        for spec in VGG16_CFG:
            if spec == "M":
                x = F.max_pool2d(x, 2, 2)
                layer_idx += 1
            else:
                x = torch.relu(self.convs[ci](x))
                ci += 1
                layer_idx += 2
            if layer_idx - 1 in self.taps or layer_idx in self.taps:
                outputs.append(x)
        return outputs if len(outputs) > 1 else outputs[0]


class LightCNNFeatures(_FlaxConvs):
    """LightCNN-9 style extractor (max-feature-map activations), returning
    the spatial mean (N, 256)."""

    SPEC = ((96, 5, True), (192, 3, True), (384, 3, True), (512, 3, False), (256, 3, True))

    def __init__(self, in_nc: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        ins = (in_nc,) + tuple(f for f, _, _ in self.SPEC[:-1])
        self.convs = nn.ModuleList(Conv(i, f * 2, k, dtype=dtype)
                                   for i, (f, k, _) in zip(ins, self.SPEC))

    def forward(self, x):
        for conv, (_, _, pool) in zip(self.convs, self.SPEC):
            a, b = conv(x).chunk(2, dim=1)
            x = torch.maximum(a, b)
            if pool:
                x = F.max_pool2d(x, 2, 2)
        return x.mean(dim=(2, 3))


class PerceptualExtractor:
    """A feature extractor with loaded weights, on NHWC images."""

    def __init__(self, module: nn.Module):
        self.module = module

    def __call__(self, images):
        out = self.module(images.permute(0, 3, 1, 2))
        if isinstance(out, list):
            return [o.permute(0, 2, 3, 1) for o in out]
        return out.permute(0, 2, 3, 1) if out.dim() == 4 else out

    @staticmethod
    def convert_torch_vgg16(torch_state_dict_path: str, out_npz: str) -> str:
        """A torchvision VGG-16 state dict as the flax-layout npz."""
        sd = torch.load(torch_state_dict_path, map_location="cpu")
        convs = [(k, v) for k, v in sd.items()
                 if k.startswith("features") and k.endswith("weight")]
        out = {}
        for i, (k, w) in enumerate(convs):
            out[f"Conv_{i}/kernel"] = w.permute(2, 3, 1, 0).numpy()
            out[f"Conv_{i}/bias"] = sd[k.replace("weight", "bias")].numpy()
        np.savez(out_npz, **out)
        return out_npz


def load_extractor_params(npz_path: str):
    """An extractor's param tree from a flat ``Layer_i/leaf`` npz (numpy
    leaves)."""
    data = np.load(npz_path)
    params = {}
    for key in data.files:
        layer, leaf = key.split("/")
        params.setdefault(layer, {})[leaf] = data[key]
    return params


def convert_torch_vgg19(torch_state_dict, out_npz: str) -> str:
    """A torchvision-layout VGG-19 state dict ('features.N.weight'), or its
    path, as the flax-layout npz."""
    if isinstance(torch_state_dict, str):
        torch_state_dict = torch.load(torch_state_dict, map_location="cpu")
    convs = sorted((int(k.split(".")[1]), k) for k in torch_state_dict
                   if k.startswith("features") and k.endswith("weight"))
    out = {}
    for i, (_, k) in enumerate(convs):
        w = torch_state_dict[k]
        b = torch_state_dict[k.replace("weight", "bias")]
        out[f"Conv_{i}/kernel"] = np.asarray(w).transpose(2, 3, 1, 0)
        out[f"Conv_{i}/bias"] = np.asarray(b)
    np.savez(out_npz, **out)
    return out_npz


def perceptual_loss_mechanism(name: str = "vgg", weights: Optional[str] = None,
                              taps: Sequence[int] = (22,), tap: str = "conv5_4",
                              device=None) -> PerceptualExtractor:
    """'vgg' (the VGG-19 perceptual extractor at ``tap``), 'vggface'
    (VGG-16 at ``taps``) or 'lightcnn', from a weights npz; raises without
    one, as the JAX package does."""
    if weights is None:
        raise NotImplementedError(
            f"Perceptual extractor '{name}' needs pretrained weights: pass "
            "weights=<npz> (use convert_torch_vgg19 / "
            "PerceptualExtractor.convert_torch_vgg16 to convert a "
            "torchvision checkpoint)")
    if name == "vgg":
        cls, kw = VGG19Features, {"tap": tap}
    elif name == "vggface":
        cls, kw = VGG16Features, {"taps": tuple(taps)}
    elif name == "lightcnn":
        cls, kw = LightCNNFeatures, {}
    else:
        raise KeyError(name)
    return PerceptualExtractor(cls.from_npz(weights, device=device, **kw))
