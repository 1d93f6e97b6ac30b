"""Degradation class labelling for supervised-contrastive training.

Port of ``rumpy_tpu/models/contrastive_labelling.py``: metadata keys are
canonicalized (:func:`register_metadata`), a decision tree is laid out per
available degradation type (:func:`partition_metadata`, plain Python), and
each example's metadata row maps to an integer class by mixed-radix
encoding of its decision bits (:func:`assign_classes`), computed for a
whole batch with tensor ops on the batch's device.

Decision layout (``labelling_strategy``):
  * noise:        default [colour(2), type(2)]; double [mag(2), colour, type];
                  triple [mag(3), colour, type]
  * compression:  [mag(2 or 3)] (+ [type(2)] when both JM and JPEG present)
  * blur:         [kernel_type(7), sigma_x(3), sigma_y(3)]
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch


def register_metadata(keys: Sequence[str]) -> List[str]:
    processed = []
    for key in keys:
        if "gaussian_noise" in key:
            processed.append("gaussian_noise_scale")
        elif "poisson_noise" in key:
            processed.append("poisson_noise_scale")
        elif "downsample" in key:
            processed.append("scale")
        elif "gray_noise" in key:
            processed.append("gray_noise_boolean")
        elif "jpeg" in key:
            processed.append("jpeg_quality_factor")
        elif "qpi" in key:
            processed.append("jm_qpi")
        elif "realesrganblur" in key:
            processed.append(key.split("realesrganblur-")[-1])
        else:
            processed.append("unknown")
    return processed


def partition_metadata(m_map: Dict[str, int], selected_metadata="all",
                       labelling_strategy: str = "default"
                       ) -> Tuple[List[str], List[int], int]:
    """(available degradation types, each decision's place value, number
    of classes) for the metadata keys in ``m_map``."""
    accepted = (["blur", "compression", "noise"]
                if selected_metadata == "all" else list(selected_metadata))
    available: List[str] = []
    decisions: List[int] = []

    if "poisson_noise_scale" in m_map and "noise" in accepted:
        available.append("noise")
        decisions.extend({"default": [2, 2],
                          "double_precision": [2, 2, 2],
                          "triple_precision": [3, 2, 2]}[labelling_strategy])

    if (("jpeg_quality_factor" in m_map or "jm_qpi" in m_map)
            and "compression" in accepted):
        available.append("compression")
        decisions.extend([3] if labelling_strategy == "triple_precision" else [2])
        if "jpeg_quality_factor" in m_map and "jm_qpi" in m_map:
            decisions.append(2)
            available.append("jm_jpg_compression")

    if "kernel_type" in m_map and "blur" in accepted:
        available.append("blur")
        decisions.extend([7, 3, 3])

    num_classes = math.prod(decisions) if decisions else 0
    mags = [math.prod(decisions[:i]) for i in range(len(decisions))]
    return available, mags, num_classes


def _partition_magnitude(mag: torch.Tensor, splits: int) -> torch.Tensor:
    if splits == 2:
        return (mag > 0.5).to(torch.int64)
    return (mag > 0.66).to(torch.int64) + (mag > 0.33).to(torch.int64)


def assign_classes(metadata: torch.Tensor, m_map: Dict[str, int],
                   valid_metadata: Sequence[str], decision_mags: Sequence[int],
                   num_classes: int, labelling_strategy: str = "default") -> torch.Tensor:
    """Batched class retrieval: metadata (N, M) -> labels (N,) int64, on
    the metadata's device."""
    split = 3 if labelling_strategy == "triple_precision" else 2
    split_noise = labelling_strategy in ("double_precision", "triple_precision")
    tree: List[torch.Tensor] = []

    def col(name):
        return metadata[:, m_map[name]]

    if "noise" in valid_metadata:
        gauss = col("gaussian_noise_scale")
        is_gauss = gauss > 0
        if split_noise:
            tree.append(_partition_magnitude(
                torch.where(is_gauss, gauss, col("poisson_noise_scale")), split))
        tree.append((col("gray_noise_boolean") > 0).to(torch.int64))
        tree.append(is_gauss.to(torch.int64))

    if "compression" in valid_metadata:
        has_jpeg = "jpeg_quality_factor" in m_map
        has_jm = "jm_qpi" in m_map
        if has_jpeg and has_jm:
            is_jpeg = col("jpeg_quality_factor") > 0
            c_mag = torch.where(is_jpeg, col("jpeg_quality_factor"), col("jm_qpi"))
        elif has_jpeg:
            is_jpeg = None
            c_mag = col("jpeg_quality_factor")
        else:
            is_jpeg = None
            c_mag = col("jm_qpi")
        tree.append(_partition_magnitude(c_mag, split))
        if "jm_jpg_compression" in valid_metadata:
            tree.append((~is_jpeg).to(torch.int64))

    if "blur" in valid_metadata:
        tree.append(col("kernel_type").to(torch.int64))
        tree.append(_partition_magnitude(col("sigma_x"), 3))
        tree.append(_partition_magnitude(col("sigma_y"), 3))

    labels = torch.zeros(metadata.shape[0], dtype=torch.int64, device=metadata.device)
    for d, mag in zip(tree, decision_mags):
        labels = labels + d * mag
    return labels


def degradation_vector_size(valid_metadata: Sequence[str]) -> int:
    return 2 * sum(1 for d in valid_metadata if d in ("noise", "compression", "blur"))


def degradation_vectors(metadata: torch.Tensor, m_map: Dict[str, int],
                        valid_metadata: Sequence[str]) -> torch.Tensor:
    """Batched vector retrieval (WeakCon's continuous labels): (N, V)
    float32 on the metadata's device."""
    cols: List[torch.Tensor] = []
    zeros = torch.zeros(metadata.shape[0], dtype=metadata.dtype, device=metadata.device)

    def col(name):
        return metadata[:, m_map[name]]

    if "noise" in valid_metadata:
        gauss = col("gaussian_noise_scale")
        is_gauss = gauss > 0
        cols.append(torch.where(is_gauss, gauss, zeros))
        cols.append(torch.where(is_gauss, zeros, col("poisson_noise_scale")))
    if "compression" in valid_metadata:
        has_jpeg = "jpeg_quality_factor" in m_map
        has_jm = "jm_qpi" in m_map
        if has_jpeg and not has_jm:
            cols += [col("jpeg_quality_factor"), zeros]
        elif has_jpeg and has_jm:
            is_jpeg = col("jpeg_quality_factor") > 0
            cols.append(torch.where(is_jpeg, col("jpeg_quality_factor"), zeros))
            cols.append(torch.where(is_jpeg, zeros, col("jm_qpi")))
        else:
            cols += [zeros, col("jm_qpi")]
    if "blur" in valid_metadata:
        cols += [col("sigma_x"), col("sigma_y")]
    if not cols:
        return metadata.new_zeros((metadata.shape[0], 0))
    return torch.stack(cols, dim=1)
