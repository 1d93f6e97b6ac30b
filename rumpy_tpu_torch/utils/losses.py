"""Loss functions.

Port of ``rumpy_tpu/utils/losses.py``: the supervised contrastive loss
(SupConLoss semantics, views in view-major order) and the occupancy loss.
The logits are a full float32 product (:func:`full_f32_matmuls`), as the
JAX package's ``Precision.HIGHEST``, whatever the process-wide TF32 flags
say. The VGG perceptual loss needs pretrained VGG weights and comes with
ROADMAP queue 1 item 9.
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
    """VGG-feature perceptual loss of the JAX package: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the VGG perceptual loss is not ported yet: it needs pretrained VGG "
            "weights and comes with ROADMAP queue 1 item 9")
