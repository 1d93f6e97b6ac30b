"""LPIPS perceptual distance with the AlexNet backbone.

Port of ``rumpy_tpu/utils/lpips_jax.py``. The pretrained AlexNet and
linear-head weights are gated as in the JAX package: nothing is
downloaded, and :class:`LPIPS` raises ``NotImplementedError`` without an
npz, which :func:`convert_torch_lpips` writes from the official torch
checkpoints. The npz holds ``Conv_<i>/kernel`` (HWIO) and ``Conv_<i>/bias``
of AlexNet's five feature convs and ``lin<i>`` (C, 1) heads; the heads are
taken in the npz's file order, as the JAX package takes them.

Everything runs on the images' device in float32: the scaling layer, the
five convs (cuDNN; torchvision's AlexNet padding: conv1 k11 s4 p2, a 3/2
'VALID' max pool after taps 0 and 1), each tap unit-normalised over its
channels by (norm + 1e-10), the squared difference weighted by the 1x1 head
and averaged over the image, summed over the taps.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import resolve_device, true_div
from rumpy_tpu_torch.models.common import Conv

# ImageNet normalisation of LPIPS's scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ALEX_CFG: Tuple[Tuple[int, int, int, int], ...] = (
    # (features, kernel, stride, padding): torchvision's AlexNet
    (64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))


class AlexFeatures(nn.Module):
    """AlexNet's feature convs, each followed by a ReLU whose output is a
    tap; a 3 x 3 stride-2 'VALID' max pool after taps 0 and 1. Takes NCHW
    (channels_last) float32, returns the five taps."""

    def __init__(self):
        super().__init__()
        chans = [3] + [f for f, _, _, _ in ALEX_CFG]
        self.convs = nn.ModuleList(
            Conv(c_in, f, k, stride=s, padding=p)
            for c_in, (f, k, s, p) in zip(chans, ALEX_CFG))

    def flax_children(self):
        return [(f"convs.{i}", (f"Conv_{i}",), c) for i, c in enumerate(self.convs)]

    def forward(self, x):
        taps = []
        for i, conv in enumerate(self.convs):
            x = torch.relu(conv(x))
            taps.append(x)
            if i in (0, 1):
                x = F.max_pool2d(x, 3, 2)
        return taps


class LPIPS(nn.Module):
    """``lpips(net='alex')``: unit-normalised feature differences, 1 x 1
    linear heads, the spatial mean, summed over the taps. ``weights`` is
    the npz; ``device`` defaults to the card."""

    def __init__(self, weights: Optional[str] = None, device=None):
        super().__init__()
        if weights is None:
            raise NotImplementedError(
                "LPIPS needs pretrained AlexNet + linear-head weights "
                "(npz; see convert_torch_lpips)")
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        data = np.load(weights)
        params, lins = {}, []
        for key in data.files:  # the heads in file order, as the JAX package
            if key.startswith("lin"):
                lins.append(data[key])
            else:
                layer, leaf = key.split("/")
                params.setdefault(layer, {})[leaf] = data[key]
        self.backbone = AlexFeatures()
        self.backbone.load_state_dict(state_dict_from_jax(params, self.backbone))
        self.num_heads = len(lins)
        for i, v in enumerate(lins):
            self.register_buffer(f"lin_{i}", torch.from_numpy(
                np.asarray(v, np.float32).reshape(-1)), persistent=False)
        self.register_buffer("shift", torch.tensor(_SHIFT)[:, None, None], persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[:, None, None], persistent=False)
        self.to(resolve_device(device)).eval().requires_grad_(False)

    def forward(self, a, b):
        return self.distance(a, b)

    def distance(self, a, b, params=None, lins: Optional[Sequence] = None) -> torch.Tensor:
        """(N,) distances of two (N, H, W, 3) batches in [0, 1]. ``params``
        (a flax tree ``{Conv_<i>: {kernel, bias}}``) and ``lins`` (the
        heads) replace the loaded weights where given. The weights take no
        gradient; the images do, where they carry one (FSSR-DSGAN's
        perceptual loss)."""
        backbone = self.backbone
        dev = self.shift.device
        if params is not None:
            from rumpy_tpu_torch.utils.weights import state_dict_from_jax
            backbone = AlexFeatures()
            backbone.load_state_dict(state_dict_from_jax(
                {k: {n: np.asarray(v) for n, v in leaf.items()} for k, leaf in params.items()},
                backbone))
            backbone = backbone.to(dev).requires_grad_(False)
        heads = [getattr(self, f"lin_{i}") for i in range(self.num_heads)] if lins is None else [
            torch.as_tensor(np.asarray(v, np.float32).reshape(-1), device=dev) for v in lins]
        x = torch.cat([torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)])
        x = x.float().permute(0, 3, 1, 2)
        x = true_div(x * 2 - 1 - self.shift, self.scale)
        n = x.shape[0] // 2
        total = torch.zeros(n, device=dev)
        for tap, lin in zip(backbone(x.contiguous(memory_format=torch.channels_last)), heads):
            unit = tap / (torch.linalg.vector_norm(tap, dim=1, keepdim=True) + 1e-10)
            diff = (unit[:n] - unit[n:]) ** 2
            total = total + (diff * lin[:, None, None]).sum(dim=1).mean(dim=(1, 2))
        return total


def convert_torch_lpips(lpips_ckpt: str, alexnet_ckpt: str, out_npz: str) -> str:
    """Write the npz :class:`LPIPS` reads from the official checkpoints: a
    torchvision AlexNet state dict (``features.<k>.weight``/``bias``) and
    LPIPS's linear heads (``lin<i>.model.1.weight``), by ``torch.load``."""
    alex = torch.load(alexnet_ckpt, map_location="cpu")
    lins = torch.load(lpips_ckpt, map_location="cpu")
    out = {}
    conv_idx = 0
    for k, v in alex.items():
        if "features" in k and k.endswith("weight"):
            out[f"Conv_{conv_idx}/kernel"] = v.permute(2, 3, 1, 0).numpy()
            out[f"Conv_{conv_idx}/bias"] = alex[k.replace("weight", "bias")].numpy()
            conv_idx += 1
    for i in range(5):
        out[f"lin{i}"] = lins[f"lin{i}.model.1.weight"].squeeze().numpy().reshape(-1, 1)
    np.savez(out_npz, **out)
    return out_npz
