"""Degradation pipeline: config-driven op chains, on the device and offline.

Port of ``rumpy_tpu/degradations/pipeline.py``:
``pipeline = [[op, cfg-id], ...]`` with ``deg_configs`` tables and metadata
keys ``<step>-<op>-<attr>``.

* Device path: :meth:`ImagePipeline.degrade_batch` runs the ops in order
  on a (B, H, W, C) float batch inside the train step, drawing from one
  ``torch.Generator`` on the batch's device. No op reads a value back to
  the host, so the chain never stalls the card's queue.
* Host path (offline datagen, ``cli/image_manipulate.py``):
  :meth:`ImagePipeline.run_pipeline` runs each op's ``__call__`` on one
  image at a time (``multiples`` copies with ``_qN`` names), the tensor
  work on the pipeline's ``device``, and writes ``degradation_metadata.csv``
  and ``degradation_hyperparameters.csv`` with the ``csv`` module, in the
  text pandas gives the JAX package. Its numpy draws come from one
  ``RandomState(seed)`` that the pipeline hands its ops, in the JAX
  package's order (which seeds numpy's global generator), and op ``i``
  gets ``seed + i`` for its own generator. Without PIL it reads and writes
  uint8 ``.npy`` images (the default ``output_extension`` is then
  ``.npy``). :func:`pipeline_prep_and_run` runs a folder and writes
  ``degradation_config.toml`` beside the outputs.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from rumpy_tpu_torch.degradations.base import DegradationOp
from rumpy_tpu_torch.device import resolve_device
from rumpy_tpu_torch.registry import get_tool
from rumpy_tpu_torch.utils.csv_text import write_table

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
ARRAY_EXT = ".npy"
BLUR_OPS = ("srmdgaussianblur", "bsrganblur", "realesrganblur")


def _pil_available() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def _parse_pipeline(pipeline) -> List[Tuple[str, str]]:
    if all(isinstance(i, (list, tuple)) for i in pipeline):
        return [(op.lower(), cfg) for op, cfg in pipeline]
    return [(op.lower(), "default") for op in pipeline]


def format_metadata_key(step: int, operation: str, attribute: str) -> str:
    return f"{step}-{operation}-{attribute}"


def _read_image(path: str):
    """An image file as a PIL RGB image, or a ``.npy`` file as uint8."""
    if path.lower().endswith(ARRAY_EXT):
        arr = np.load(path)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"{path}: expected a uint8 (H, W, 3) array, got "
                             f"{arr.dtype} {arr.shape}")
        return arr
    from PIL import Image
    return Image.open(path).convert("RGB")


def _save_image(image, path: str) -> None:
    """A PIL image, uint8 array or [0, 1] float array to ``path``: a uint8
    ``.npy`` file for that extension, else an image file through PIL."""
    if hasattr(image, "save"):
        if path.lower().endswith(ARRAY_EXT):
            np.save(path, np.asarray(image.convert("RGB")))
        else:
            image.save(path)
        return
    arr = np.asarray(image)
    u8 = np.clip(arr * (255.0 if arr.dtype.kind == "f" else 1.0), 0, 255).astype(np.uint8)
    if path.lower().endswith(ARRAY_EXT):
        np.save(path, u8)
    else:
        from PIL import Image
        Image.fromarray(u8).save(path)


class ImagePipeline:
    def __init__(self, pipeline, deg_configs=None, output_extension=None,
                 seed: Optional[int] = None, device=None, **kwargs):
        """``kwargs``: ``scale`` overrides the downsample's. The host path's
        options: ``seed`` (its numpy draws, and ``seed + i`` for op i),
        ``output_extension`` (default ``.png``, or ``.npy`` without PIL) and
        ``device`` (its tensor work; default "cuda", resolved when it runs)."""
        ops_cfgs = _parse_pipeline(pipeline)
        op_names = [o for o, _ in ops_cfgs]
        self.jm_present = "jmcompress" in op_names or "randomcompress" in op_names
        self.blur_present: Optional[Tuple[int, str]] = None
        self.pipeline: "OrderedDict[Tuple[int, str], Any]" = OrderedDict()
        # numpy's global generator after np.random.seed(seed) in the JAX
        # package: the same stream from a generator of the pipeline's own
        self.rng = np.random.RandomState(seed) if seed is not None else None
        for index, (operation, cfg_id) in enumerate(ops_cfgs):
            op_params = {} if cfg_id == "default" else dict(deg_configs[cfg_id])
            if operation == "downsample" and "scale" in kwargs:
                op_params["scale"] = kwargs["scale"]
            if operation == "downsample" and self.jm_present:
                op_params["jm"] = True
            if seed is not None:
                op_params.setdefault("seed", seed + index)
            self.pipeline[(index, operation)] = get_tool(operation)(**op_params)
            if operation in BLUR_OPS:
                self.blur_present = (index, operation)
        if output_extension is None:
            output_extension = ".png" if _pil_available() else ARRAY_EXT
        self.output_extension = output_extension
        self.device = device

    # ------------------------------------------------------------------
    # Host path (offline datagen, the image_manipulate CLI)
    # ------------------------------------------------------------------

    def run_pipeline(self, images=None, image_files=None, save_to_dir=None,
                     progress_bar_off=False, multiples=1):
        """Degrade ``images`` (PIL images or uint8 arrays) or the files
        ``image_files``; with ``save_to_dir`` write the outputs and the two
        CSV files there, else return them. Returns (images, metadata values,
        metadata keys) as the JAX package does."""
        if (images is None) == (image_files is None):
            raise RuntimeError("Either image variables or image files need "
                               "to be provided.")
        if isinstance(image_files, str):
            image_files = [image_files]
        device = resolve_device(self.device)
        for op in self.pipeline.values():
            op.bind_host(device, self.rng)

        named: "OrderedDict[str, Any]" = OrderedDict()
        if image_files is None:
            if not isinstance(images, list):
                images = [images]
            for i, im in enumerate(images):
                named[f"temp_name_{i}"] = im
        else:
            for f in image_files:
                named[os.path.splitext(os.path.basename(f))[0] + self.output_extension] = f

        if save_to_dir and self.blur_present:
            self.pipeline[self.blur_present].save_pca_matrix(save_to_dir)

        items = named.items()
        if not progress_bar_off:
            try:
                from tqdm import tqdm
                items = tqdm(items)
            except ImportError:
                pass

        final_images: List[Any] = []
        final_metadata: "OrderedDict[str, Dict]" = OrderedDict()
        for image_name, image in items:
            start = _read_image(image) if isinstance(image, str) else image
            for m in range(multiples):
                flux = start.copy() if hasattr(start, "copy") else start
                meta_dict: Dict[str, Any] = {}
                for (step, opname), op in self.pipeline.items():
                    flux, meta = op(flux)
                    meta_dict.update({format_metadata_key(step, opname, k): v
                                      for k, v in meta.items()})
                if multiples == 1:
                    out_name = image_name
                else:
                    dot = image_name.find(".")
                    out_name = image_name[:dot] + f"_q{m}" + image_name[dot:]
                final_metadata[out_name] = meta_dict
                if save_to_dir:
                    if not os.path.splitext(out_name)[1]:
                        out_name += self.output_extension  # in-memory inputs carry none
                    _save_image(flux, os.path.join(save_to_dir, out_name))
                else:
                    final_images.append(flux)

        if save_to_dir:
            self._write_csvs(save_to_dir, final_metadata)

        meta_vals, meta_keys = self._vectorize_metadata(final_metadata)
        if len(final_images) == 1:
            final_images = final_images[0]
        return final_images, meta_vals, meta_keys

    @staticmethod
    def _vectorize_metadata(final_metadata):
        """Per-image metadata dicts as a value matrix and its key list, keys
        in the first image's sorted order and a list value's key repeated:
        a 1-D vector for one image, an (N, K) matrix for several."""
        meta_keys: List[str] = []
        rows: List[List[float]] = []
        ordered_keys: List[str] = []
        for meta_dict in final_metadata.values():
            values: List[float] = []
            if not ordered_keys:
                ordered_keys = sorted(meta_dict.keys())
            meta_keys = []
            for k in ordered_keys:
                v = meta_dict[k]
                if isinstance(v, list):
                    values.extend(v)
                    meta_keys.extend([k] * len(v))
                else:
                    values.append(v)
                    meta_keys.append(k)
            rows.append(values)
        if not rows:
            return np.zeros(0), meta_keys
        meta_vals = np.asarray(rows)
        if meta_vals.shape[0] == 1:
            meta_vals = meta_vals[0]
        return meta_vals, meta_keys

    def _write_csvs(self, save_to_dir, final_metadata) -> None:
        """``degradation_metadata.csv`` (index ``image``, a column a key in
        order of first appearance, a value an image lacks empty) and
        ``degradation_hyperparameters.csv`` (index ``index_num``: each op's
        hyperparameters in step order)."""
        columns: "OrderedDict[str, List[Any]]" = OrderedDict()
        for meta in final_metadata.values():
            for k in meta:
                columns.setdefault(k, [])
        for k, col in columns.items():
            col.extend(meta.get(k) for meta in final_metadata.values())
        write_table(os.path.join(save_to_dir, "degradation_metadata.csv"), "image",
                    list(final_metadata), columns)

        rows: "OrderedDict[str, List[Any]]" = OrderedDict(
            (k, []) for k in ("index_num", "degradation", "hyperparam", "value"))
        for (step, opname), op in self.pipeline.items():
            for hp, val in op.get_hyperparams().items():
                for k, v in zip(rows, (step, opname, hp, val)):
                    rows[k].append(v)
        if rows["index_num"]:
            index = rows.pop("index_num")
            write_table(os.path.join(save_to_dir, "degradation_hyperparameters.csv"),
                        "index_num", index, rows)

    # ------------------------------------------------------------------
    # Device path (online training datagen)
    # ------------------------------------------------------------------

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


def pipeline_prep_and_run(pipeline_config, source_dir=None, output_dir=None,
                          seed=None, multiples=1, recursive=False, **kwargs):
    """Build a pipeline from a config dict, degrade every image of a folder
    (``.npy`` arrays included), write the outputs, their CSV files and
    ``degradation_config.toml`` to ``output_dir``; returns it. ``kwargs``
    go to :class:`ImagePipeline` (``device``, ``output_extension``, ...)."""
    from rumpy_tpu_torch.config.loader import dump_toml

    cfg = dict(pipeline_config)
    pipeline = cfg.pop("pipeline")
    deg_configs = cfg.pop("deg_configs", None)
    seed = cfg.pop("seed", seed)
    multiples = cfg.pop("multiples", multiples)
    source_dir = cfg.pop("source_dir", source_dir)
    output_dir = cfg.pop("output_dir", output_dir)

    files = []
    for root, _dirs, names in os.walk(source_dir):
        for n in sorted(names):
            if n.lower().endswith(IMAGE_EXTS + (ARRAY_EXT,)):
                files.append(os.path.join(root, n))
        if not recursive:
            break
    if not files:
        raise FileNotFoundError(f"No images found in {source_dir}")

    os.makedirs(output_dir, exist_ok=True)
    pipe = ImagePipeline(pipeline, deg_configs=deg_configs, seed=seed, **cfg, **kwargs)
    pipe.run_pipeline(image_files=files, save_to_dir=output_dir, multiples=multiples)
    dump_toml({"pipeline": [list(p) if isinstance(p, (list, tuple)) else p
                            for p in pipeline],
               **({"deg_configs": {k: dict(v) for k, v in deg_configs.items()}}
                  if deg_configs else {})},
              os.path.join(output_dir, "degradation_config.toml"))
    return output_dir
