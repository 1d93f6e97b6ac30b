"""Per-example blur as one grouped depthwise convolution.

Port of ``rumpy_tpu/ops/blur.py``: reflect-pad, then a cross-correlation
of each image with its own kernel. The batch is folded into the channel
axis, (B, H, W, C) -> (1, B*C, H, W), and blurred by a single
``conv2d`` with ``groups=B*C`` whose filters are each example's kernel
repeated over its channels: one launch for the batch, no loop over
examples.

The JAX op pins full float32 precision. cuDNN runs float32 convolutions in
TF32 when ``torch.backends.cudnn.allow_tf32`` is set (PyTorch's default),
so the convolution runs under a scoped ``allow_tf32=False`` whatever the
process-wide flag says.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def full_f32_convs():
    """A context in which cuDNN convolutions compute in full float32; the
    other cuDNN flags keep their current values."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def apply_kernels(images: torch.Tensor, kernels: torch.Tensor,
                  pad_mode: str = "reflect") -> torch.Tensor:
    """Blur each image with its own kernel.

    :param images: (B, H, W, C) float tensor; H and W larger than k // 2.
    :param kernels: (B, k, k) float tensor (normalized), k odd.
    :param pad_mode: 'reflect' as ``jnp.pad`` and ``F.pad`` define it.
    """
    b, h, w, c = images.shape
    pad = kernels.shape[-1] // 2
    x = images.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = F.pad(x, (pad, pad, pad, pad), mode=pad_mode)
    k = kernels.shape[-1]
    weight = kernels.to(images.dtype)[:, None].expand(b, c, k, k).reshape(b * c, 1, k, k)
    with full_f32_convs():
        out = F.conv2d(x, weight, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)
