"""Degradation pipeline: config-driven op chains on the device.

Port of ``rumpy_tpu/degradations/pipeline.py``'s device path:
``pipeline = [[op, cfg-id], ...]`` with ``deg_configs`` tables, metadata
keys ``<step>-<op>-<attr>``, and :meth:`ImagePipeline.degrade_batch`,
which runs the ops in order on a (B, H, W, C) float batch inside the
train step, drawing from one ``torch.Generator`` on the batch's device.
No op reads a value back to the host, so the chain never stalls the
card's queue. The offline host path (``run_pipeline``, its CSV files and
``pipeline_prep_and_run``) comes with the tools slice and raises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Tuple

import torch

from rumpy_tpu_torch.degradations.base import DegradationOp, tools_slice
from rumpy_tpu_torch.registry import get_tool


def _parse_pipeline(pipeline) -> List[Tuple[str, str]]:
    if all(isinstance(i, (list, tuple)) for i in pipeline):
        return [(op.lower(), cfg) for op, cfg in pipeline]
    return [(op.lower(), "default") for op in pipeline]


def format_metadata_key(step: int, operation: str, attribute: str) -> str:
    return f"{step}-{operation}-{attribute}"


class ImagePipeline:
    def __init__(self, pipeline, deg_configs=None, **kwargs):
        """``kwargs``: ``scale`` overrides the downsample's; the host path's
        options (``seed``, ``output_extension``) have no effect here."""
        self.pipeline: "OrderedDict[Tuple[int, str], Any]" = OrderedDict()
        for index, (operation, cfg_id) in enumerate(_parse_pipeline(pipeline)):
            op_params = {} if cfg_id == "default" else dict(deg_configs[cfg_id])
            if operation == "downsample" and "scale" in kwargs:
                op_params["scale"] = kwargs["scale"]
            self.pipeline[(index, operation)] = get_tool(operation)(**op_params)

    def run_pipeline(self, *args, **kwargs):
        raise tools_slice("ImagePipeline.run_pipeline (offline degradation of "
                          "image files, with its CSV files)")

    def _write_csvs(self, *args, **kwargs):
        raise tools_slice("the degradation metadata and hyperparameter CSV files")

    def supports_fused(self) -> bool:
        """True when every op has a device path (host-only ops inherit the
        raising base ``batch_apply``)."""
        return all(type(op).batch_apply is not DegradationOp.batch_apply
                   for op in self.pipeline.values())

    def degrade_batch(self, generator: torch.Generator, hr_batch: torch.Tensor,
                      views: int = 1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run the chain on a (B, H, W, C) float batch on the generator's
        device. Returns (lr_batch, {step-op-attr: (B,) or (B, M) tensors}).

        Multi-view mode (``views`` > 1, for contrastive training): the batch
        stacks ``views`` crops of each of B / views images, image-major, and
        the whole stack is degraded in one pass with one set of draws an
        image, shared by its views (kernel, noise type, level and field,
        codec and quality; Poisson samples, which follow each view's pixels,
        excepted). The metadata has a row an image."""
        if hr_batch.shape[0] % views:
            raise ValueError(f"a batch of {hr_batch.shape[0]} is not {views} views an image")
        x = hr_batch
        metadata: Dict[str, torch.Tensor] = {}
        for (step, opname), op in self.pipeline.items():
            x, meta = op.batch_apply(generator, x, views)
            metadata.update({format_metadata_key(step, opname, a): v
                             for a, v in meta.items()})
        return x, metadata

    @staticmethod
    def metadata_matrix(metadata: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, List[str]]:
        """A (B, M) float32 matrix and its key list, keys in sorted order,
        a (B, M) value's key repeated M times."""
        cols: List[torch.Tensor] = []
        keys: List[str] = []
        for k in sorted(metadata):
            v = metadata[k]
            if v.dim() == 1:
                cols.append(v[:, None])
                keys.append(k)
            else:
                cols.append(v)
                keys.extend([k] * v.shape[1])
        if not cols:
            return torch.zeros((0, 0)), []
        return torch.cat(cols, dim=1).to(torch.float32), keys


def pipeline_prep_and_run(*args, **kwargs):
    raise tools_slice("pipeline_prep_and_run (the offline degradation CLI)")
