"""EvalHub: full-image evaluation of one or more trained models.

Port of ``rumpy_tpu/evaluation/eval_hub.py`` without pandas:

* loads each (experiment, epoch) through ``SISRInterface`` (torch or flax
  checkpoints), and drops a model that needs metadata keys the set lacks
  (a ``metadata_file`` CSV, or ``"on_site"``: the LR folder's
  ``degradation_metadata.csv``);
* gives each model its columns of an image's metadata row, narrowed by
  its ``select_metadata``, uploaded with the image;
* always computes the bicubic reference (and Lanczos with
  ``lanczos_upsample``) by ``ops/resize.py::pil_resize`` on the device,
  Pillow's arithmetic bit for bit, with its ``runtime`` (on the card its
  device time by CUDA events);
* scores PSNR/SSIM on the Y channel of jpg-mode BT.601 YCbCr of the
  outputs clipped to [0, 1], and LPIPS (``lpips_weights``: an npz) on the
  RGB outputs against the RGB HR image, on the device, one copy of an
  image's metrics to the host;
* writes ``individual_metrics.csv`` (rows images, two header rows model
  and metric, then ``image``) and ``average_metrics.csv`` (one ``mean``
  row) with the ``csv`` module in the layout pandas gives the JAX package,
  and per-model PNGs with ``save_im``;
* with ``gallery`` (and not ``no_image_comparison``), a collage an image,
  ``<stem>_comparison.pdf``: HR and each output captioned with its PSNR
  (matplotlib; where it is missing, building the hub raises);
* face recognition (``fr_gallery``: a features npz with ``out_stack`` and
  ``id_stack``, or a folder of ``<identity>`` images; ``fr_extractor``
  with ``fr_extractor_weights``): a per-image ``FR_rank`` column for every
  output, the image's stem its identity, and under ``fr_metrics/`` the CMC
  (``cmc_fr_metrics.csv``), AUC and EER (``extra_fr_metrics.csv``) and the
  ranks (``individual_im_ranks.csv``), with ``cmc_curves.pdf`` where
  matplotlib is installed.

LPIPS without weights raises ``NotImplementedError``, as in the JAX
package.
"""

from __future__ import annotations

import math
import os
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rumpy_tpu_torch.data.datasets import SuperResImages
from rumpy_tpu_torch.data.loader import DataLoader
from rumpy_tpu_torch.device import resolve_device, to_device, true_div
from rumpy_tpu_torch.interface import SISRInterface
from rumpy_tpu_torch.ops.resize import pil_resize
from rumpy_tpu_torch.utils import metrics as metrics_mod
from rumpy_tpu_torch.utils.color import rgb_to_ycbcr
from rumpy_tpu_torch.utils.csv_text import float_cell, write_rows, write_table
from rumpy_tpu_torch.utils.visualization import (interpret_sisr_images, pyplot,
                                                 safe_image_save)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class MetricTable:
    """``full_image_protocol``'s result: one row of values per image, the
    columns (model, metric) pairs sorted as pandas' ``sort_index(axis=1)``
    sorts them; a value an image lacks is NaN."""

    def __init__(self, rows: Dict[str, Dict[str, float]]):
        keys: Dict[str, None] = {}
        for row in rows.values():
            keys.update(dict.fromkeys(row))
        self.images: List[str] = list(rows)
        self.columns: List[Tuple[str, str]] = sorted(tuple(k.split(">", 1)) for k in keys)
        self.values: List[List[float]] = [
            [float(rows[im].get(f"{m}>{met}", math.nan)) for m, met in self.columns]
            for im in self.images]

    def mean(self) -> List[float]:
        """Each column's mean over the images that have a value, as pandas'
        ``mean(axis=0)``: a float64 sum of the values over their count."""
        arr = np.asarray(self.values, dtype=np.float64).reshape(len(self.images), -1)
        have = ~np.isnan(arr)
        sums = np.where(have, arr, 0.0).sum(axis=0)
        counts = have.sum(axis=0)
        return [float(s / c) if c else math.nan for s, c in zip(sums, counts)]

    def write_csv(self, path: str, rows: Sequence[Tuple[str, List[float]]],
                  index_name: Optional[str]) -> None:
        """Rows under the two header rows ``model,...`` and ``metric,...``
        (and ``index_name,,...``), floats as pandas writes them."""
        head = [["model"] + [m for m, _ in self.columns],
                ["metric"] + [met for _, met in self.columns]]
        if index_name is not None:
            head.append([index_name] + [""] * len(self.columns))
        write_rows(path, head + [[label] + [float_cell(v) for v in vals] for label, vals in rows])

    def save(self, out_loc: str) -> None:
        self.write_csv(os.path.join(out_loc, "individual_metrics.csv"),
                       list(zip(self.images, self.values)), "image")
        self.write_csv(os.path.join(out_loc, "average_metrics.csv"),
                       [("mean", self.mean())], None)

    def mean_string(self) -> str:
        """The mean row, one ``model metric value`` line a column."""
        return "\n".join(f"{m:<12} {met:<10} {v:.6f}"
                         for (m, met), v in zip(self.columns, self.mean()))


class EvalHub:
    def __init__(self,
                 models: Sequence[Dict[str, Any]],
                 model_loc: str,
                 data_cfg: Dict[str, Any],
                 out_loc: str,
                 scale: int = 4,
                 metrics: Sequence[str] = ("PSNR", "SSIM"),
                 save_im: bool = False,
                 gallery: bool = False,
                 lanczos_upsample: bool = False,
                 time_models: bool = False,
                 no_image_comparison: bool = False,
                 lpips_weights: Optional[str] = None,
                 fr_gallery: Optional[str] = None,
                 fr_extractor: str = "lightcnn",
                 fr_extractor_weights: Optional[str] = None,
                 pad_to_bucket: Optional[int] = None,
                 device=None):
        self.collages = not no_image_comparison and gallery
        if self.collages:
            pyplot()  # matplotlib missing: raise before any model runs
        self.device = resolve_device(device)
        self.out_loc = out_loc
        self.scale = scale
        # zero-pad model inputs up to a multiple of this (output cropped
        # back before the metrics); None keeps the unpadded forward
        self.pad_to_bucket = pad_to_bucket
        self.save_im = save_im
        self.lanczos = lanczos_upsample
        self.time_models = time_models
        os.makedirs(out_loc, exist_ok=True)

        ds_cfg = dict(data_cfg)
        ds_cfg.setdefault("scale", scale)
        ds_cfg.setdefault("colorspace", "rgb")
        self.dataset = SuperResImages(**ds_cfg, device=self.device)
        self.loader = DataLoader(self.dataset, batch_size=1, shuffle=False,
                                 num_workers=2)

        self.models: Dict[str, SISRInterface] = {}
        available = self.dataset.metadata_keys
        for spec in models:
            name = spec.get("label") or spec["experiment"]
            iface = SISRInterface(
                model_loc=model_loc, experiment=spec["experiment"],
                mode="eval", load_epoch=spec.get("epoch", "best"),
                scale=scale, no_directories=True,
                new_params=spec.get("new_params") or {}, device=self.device)
            required = getattr(iface.model, "metadata_keys", None)
            if required:
                # 'all' takes whatever the set has; a key matches exactly or
                # as the suffix of a 'step-op-key' column
                missing = [k for k in required if k != "all" and not any(
                    a == k or a.endswith(f"-{k}") for a in available)]
                if missing:
                    print(f"dropping {name}: dataset lacks metadata {missing}")
                    continue
            self.models[name] = iface

        # face recognition: the per-image FR_rank columns are computed here
        # (features extracted once an output, kept for the CMC/ROC report),
        # so 'FR_rank' leaves the metric hub's list
        metrics = list(metrics)
        self.face_recognizer = None
        if fr_gallery or "FR_rank" in metrics:
            from rumpy_tpu_torch.models.feature_extractors import perceptual_loss_mechanism
            from rumpy_tpu_torch.utils.face_recognition import FaceRecognizer
            if not fr_gallery:
                raise KeyError("FR_rank requested but no fr_gallery configured "
                               "(dir of <id>.png images or a features .npz)")
            extractor = perceptual_loss_mechanism(fr_extractor, weights=fr_extractor_weights,
                                                  device=self.device)
            self.face_recognizer = FaceRecognizer(extractor)
            self._register_gallery(fr_gallery)
            self._fr_feats: Dict[str, list] = defaultdict(list)
            metrics = [m for m in metrics if m != "FR_rank"]
        self.metric_hub = metrics_mod.Metrics(metrics, lpips_weights=lpips_weights,
                                              hr_data_loc=self.dataset.hr_dir)
        self._timed_shapes: set = set()

    def _register_gallery(self, source: str) -> None:
        """A features npz (``out_stack``, ``id_stack``) or a folder of
        ``<identity>`` images (``.npy`` arrays too), each resized to the
        first one's size with Pillow's bicubic where it differs."""
        if source.endswith(".npz"):
            g = np.load(source, allow_pickle=True)
            self.face_recognizer.register_gallery(features=g["out_stack"],
                                                  gallery_ids=list(g["id_stack"]))
            return
        from rumpy_tpu_torch.data.datasets import _decode
        names = sorted(n for n in os.listdir(source)
                       if n.lower().endswith((".png", ".jpg", ".jpeg", ".npy")))
        if not names:
            raise FileNotFoundError(f"No gallery images in {source}")
        ims, ids = [], []
        shape = None
        for n in names:
            im = _decode(os.path.join(source, n))
            if shape is None:
                shape = im.shape[:2]
            elif im.shape[:2] != shape:
                im = np.asarray(pil_resize(im, shape))  # on the CPU
            ims.append(np.asarray(im, np.float32) / 255.0)
            ids.append(os.path.splitext(n)[0])
        self.face_recognizer.register_gallery(images=np.stack(ims), gallery_ids=ids)

    # ------------------------------------------------------------------

    def _resize(self, lr_u8: torch.Tensor, filter: str) -> torch.Tensor:
        h, w = lr_u8.shape[:2]
        return pil_resize(lr_u8, (h * self.scale, w * self.scale), filter=filter)

    def _reference_outputs(self, lr: torch.Tensor) -> Dict[str, tuple]:
        """Bicubic (and Lanczos) upsampled references on the device, each
        with a function that gives its runtime in seconds once the image's
        metrics are fetched. On the card that is the device time by CUDA
        events (no wait for the card here); on the CPU the call's time. The
        first call at a shape runs untimed first."""
        lr_u8 = (lr.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        filters = ["bicubic"] + (["lanczos"] if self.lanczos else [])
        key = ("bicubic", tuple(lr_u8.shape[:2]))
        if key not in self._timed_shapes:
            for flt in filters:
                self._resize(lr_u8, flt)
            self._timed_shapes.add(key)
        out = {}
        for flt in filters:
            if self.device.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                img = self._resize(lr_u8, flt)
                end.record()
                seconds = lambda s=start, e=end: s.elapsed_time(e) / 1e3
            else:
                t0 = time.perf_counter()
                img = self._resize(lr_u8, flt)
                elapsed = time.perf_counter() - t0
                seconds = lambda t=elapsed: t
            out[flt] = (true_div(img.float(), 255.0), seconds)
        return out

    @staticmethod
    def _y_channel(rgb: torch.Tensor) -> torch.Tensor:
        return rgb_to_ycbcr(rgb.clamp(0.0, 1.0), y_only=True, im_type="jpg")

    def _model_output(self, name: str, iface: SISRInterface, inp: torch.Tensor,
                      meta: Optional[np.ndarray]):
        """(SR image, seconds or None) of one model on one image and its
        metadata row (1, M) or None."""
        if self.time_models:
            # a warm-up forward per shape (per bucket under pad_to_bucket),
            # so that runtime reports steady-state inference
            h, w = inp.shape[:2]
            if self.pad_to_bucket:
                b = self.pad_to_bucket
                h, w = h + (-h) % b, w + (-w) % b
            if (name, (h, w)) not in self._timed_shapes:
                iface.net_run(inp[None], meta, pad_multiple=self.pad_to_bucket)
                self._timed_shapes.add((name, (h, w)))
            _sync(self.device)
        t0 = time.perf_counter()
        rgb, _ = iface.net_run(inp[None], meta, pad_multiple=self.pad_to_bucket)
        if not self.time_models:
            return rgb[0], None
        _sync(self.device)
        return rgb[0], time.perf_counter() - t0

    def full_image_protocol(self) -> MetricTable:
        rows: Dict[str, Dict[str, float]] = defaultdict(dict)
        for batch in self.loader:
            lr = to_device(batch["lr"][0], self.device, torch.float32)
            hr = to_device(batch["hr"][0], self.device, torch.float32)
            tag = batch["tag"][0]
            hr_y = self._y_channel(hr)
            metas = batch.get("metadata")
            meta = (np.asarray(metas[0])[None]
                    if metas is not None and np.size(metas[0]) else None)

            outputs: Dict[str, torch.Tensor] = {}
            refs = self._reference_outputs(lr)
            for ref_name, (img, _) in refs.items():
                outputs[ref_name] = img
            for name, iface in self.models.items():
                inp = (outputs["bicubic"]
                       if getattr(iface.model, "im_input", "unmodified") == "interp"
                       else lr)
                # the model's columns of the set's row, on the host; the
                # row goes up with the forward's other inputs
                selector = getattr(iface.model, "select_metadata", None)
                model_meta = (selector(meta, keys=self.dataset.metadata_keys)
                              if meta is not None and selector is not None else meta)
                outputs[name], elapsed = self._model_output(name, iface, inp, model_meta)
                if elapsed is not None:
                    rows[tag][f"{name}>runtime"] = elapsed

            stem = os.path.splitext(tag)[0]
            values = {}
            for name, img in outputs.items():
                res = self.metric_hub.compute(self._y_channel(img)[None], hr_y[None],
                                              max_value=1.0, probe_names=[stem],
                                              rgb_a=img[None], rgb_ref=hr[None])
                values.update({f"{name}>{m}": v for m, v in res.items()})
            rows[tag].update({k: v[0] for k, v in metrics_mod.fetch(values).items()})
            if self.face_recognizer is not None:
                for name, img in outputs.items():
                    # one extraction an output, for its rank and the report
                    feats = self.face_recognizer._extract(img.clamp(0.0, 1.0)[None])
                    rank = self.face_recognizer.fr_rank(features=feats, probe_ids=[stem])
                    rows[tag][f"{name}>FR_rank"] = float(rank[0])
                    self._fr_feats[name].append((stem, feats[0]))
            for ref_name, (_, seconds) in refs.items():
                rows[tag][f"{ref_name}>runtime"] = seconds()
            if self.save_im:
                for name, img in outputs.items():
                    safe_image_save(img, os.path.join(self.out_loc, name), tag)
            if self.collages:
                caps = {n: f"PSNR {rows[tag].get(f'{n}>PSNR', 0):.2f}" for n in outputs}
                interpret_sisr_images({"HR": hr, **outputs},
                                      os.path.join(self.out_loc, f"{stem}_comparison.pdf"),
                                      captions=caps)
        if self.face_recognizer is not None:
            self.face_recognition_calculations()
        table = MetricTable(rows)
        table.save(self.out_loc)
        return table

    def face_recognition_calculations(self) -> str:
        """The CMC/ROC report under ``<out_loc>/fr_metrics/``, each file in
        the layout pandas gives the JAX package: ``cmc_fr_metrics.csv``
        (index ``Rank``, a column an output), ``extra_fr_metrics.csv``
        (``AUC`` and ``EER``), ``individual_im_ranks.csv`` (index
        ``Image_Name``), and the CMC plot where matplotlib is installed."""
        from rumpy_tpu_torch.utils.face_recognition import plot_cmc
        fr_dir = os.path.join(self.out_loc, "fr_metrics")
        os.makedirs(fr_dir, exist_ok=True)
        plot_data, cmc, extra, ranks = {}, {}, {}, {}
        cmc_x, stems = None, None
        for name, entries in self._fr_feats.items():
            stems = [s for s, _ in entries]
            pkg = self.face_recognizer.full_package(
                features=np.stack([f for _, f in entries]), probe_ids=stems)
            plot_data[name] = (pkg["CMC_x"], pkg["CMC_y"])
            cmc_x = pkg["CMC_x"]
            cmc[name] = [float(v) for v in pkg["CMC_y"]]
            extra[name] = [pkg["AUC"], pkg["EER"]]
            ranks[name] = [float(v) for v in pkg["ranks"]]
        try:
            plot_cmc(plot_data, save_loc=fr_dir)
        except ImportError:
            print("matplotlib not installed: no cmc_curves.pdf")
        write_table(os.path.join(fr_dir, "cmc_fr_metrics.csv"), "Rank", cmc_x or [], cmc)
        write_table(os.path.join(fr_dir, "extra_fr_metrics.csv"), "Metric", ["AUC", "EER"],
                    extra)
        write_table(os.path.join(fr_dir, "individual_im_ranks.csv"), "Image_Name",
                    stems or [], ranks)
        return fr_dir
