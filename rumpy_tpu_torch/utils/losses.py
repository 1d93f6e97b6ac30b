"""Loss functions.

Port of ``rumpy_tpu/utils/losses.py``: the supervised contrastive loss
(SupConLoss semantics, views in view-major order), the occupancy loss and
the VGG perceptual loss.
The logits are a full float32 product (:func:`full_f32_matmuls`), as the
JAX package's ``Precision.HIGHEST``, whatever the process-wide TF32 flags
say. The perceptual loss reads pretrained VGG weights from an npz.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from rumpy_tpu_torch.device import true_div


@contextlib.contextmanager
def full_f32_matmuls():
    """A context in which float32 matmuls on the card compute in full
    float32 (no TF32), restoring the process-wide setting after it."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def supcon_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                temperature: float = 0.07, base_temperature: float = 0.07,
                contrast_mode: str = "all") -> torch.Tensor:
    """Supervised contrastive loss.

    :param features: (N, V, D) L2-normalized, V views per example.
    :param labels: (N,) int labels; None => SimCLR (positives = the other
        views of the same example).
    """
    n, v, d = features.shape
    # contrast order: view-major, torch.cat(torch.unbind(f, 1), 0)
    flat = features.transpose(0, 1).reshape(n * v, d)
    if labels is None:
        mask = torch.eye(n, device=features.device)
    else:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.T).to(torch.float32)
    # 'one' anchors on the first view only, 'all' on every view
    if contrast_mode == "one":
        anchor, anchor_count = flat[:n], 1
    elif contrast_mode == "all":
        anchor, anchor_count = flat, v
    else:
        raise ValueError(f"Unknown contrast_mode {contrast_mode!r}")
    mask = mask.repeat(anchor_count, v)

    with full_f32_matmuls():
        logits = true_div(anchor.float() @ flat.float().T, temperature)
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    # mask out self-contrast
    logits_mask = 1.0 - torch.eye(n * v, device=features.device)[:n * anchor_count]
    mask = mask * logits_mask
    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True) + 1e-12)
    mask_sum = mask.sum(dim=1).clamp(min=1e-12)
    mean_log_prob_pos = true_div((mask * log_prob).sum(dim=1), mask_sum)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return loss.mean()


def occupancy_loss(pred: torch.Tensor, target: torch.Tensor,
                   occupancy_mask: torch.Tensor) -> torch.Tensor:
    """Masked L1: scored only where the occupancy mask is set."""
    diff = (pred - target).abs() * occupancy_mask
    return true_div(diff.sum(), occupancy_mask.sum().clamp(min=1.0))


class PerceptualMechanism:
    """VGG-feature perceptual loss: ``lambda_pixel * L1(sr, y) + lambda_per
    * L1(vgg(sr), vgg(y))`` with the VGG-19 extractor at ``vgg_layer``
    (conv5_4 by default, pre-activation, ImageNet-normalised input), the
    target's features without gradient. Weights come from a converted
    torchvision checkpoint (``models/feature_extractors.py::
    convert_torch_vgg19``); without them construction raises, as in the JAX
    package. Inputs are NHWC RGB float in [0, 1]."""

    def __init__(self, weights_path: Optional[str] = None,
                 lambda_pixel: float = 1.0, lambda_per: float = 0.01,
                 vgg_layer: str = "conv5_4", device=None,
                 dtype: torch.dtype = torch.float32):
        if weights_path is None:
            raise NotImplementedError(
                "Perceptual loss needs pretrained VGG weights; pass a "
                "weights npz path (convert_torch_vgg19)")
        from rumpy_tpu_torch.models.feature_extractors import VGG19Features
        self.lambda_pixel = lambda_pixel
        self.lambda_per = lambda_per
        self.module = VGG19Features.from_npz(weights_path, tap=vgg_layer, dtype=dtype,
                                             device=device)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """The tap's features (NHWC) of NHWC images."""
        return self.module(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def __call__(self, sr: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        gen_features = self.features(sr)
        with torch.no_grad():
            real_features = self.features(y)
        vgg_loss = (gen_features.float() - real_features.float()).abs().mean()
        pixel_loss = (sr.float() - y.float()).abs().mean()
        return self.lambda_pixel * pixel_loss + self.lambda_per * vgg_loss
