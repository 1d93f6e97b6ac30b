"""Training orchestration.

Port of ``rumpy_tpu/training/trainer.py::TrainingHandler``: the epoch loop,
loss aggregation, summary.csv, early stopping, per-epoch checkpointing,
periodic cleanup, and resume with branching. One device, no mesh
(``use_mesh`` is accepted for call compatibility). The data-vs-compute
efficiency line is kept: it says how far the input pipeline holds the card
back. Losses stay on the device during an epoch and are fetched once at
its end.

A ``[data.online_degradations]`` table trains from HR-only sets: the
datasets return HR crops and the pipeline (``degradations/pipeline.py``)
degrades each batch on the device at the start of the train step.

Not ported yet, and raising ``NotImplementedError``: validation
(``eval_sets`` need ``utils/metrics.py``, the metrics slice),
``profile_steps`` and Aim logging.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Any, Dict, List

import numpy as np
import torch

from rumpy_tpu_torch.config.constants import metric_best_val
from rumpy_tpu_torch.data.loader import sisr_data_setup
from rumpy_tpu_torch.interface import SISRInterface
from rumpy_tpu_torch.utils import stats as stats_mod
from rumpy_tpu_torch.utils.checkpoint import available_epochs, checkpoint_path


class TrainingHandler:
    def __init__(self, config, use_mesh: bool = True, verbose: bool = True,
                 device=None):
        self.cfg = config
        self.verbose = verbose
        data_cfg = config.get("data") or {}
        model_cfg = config.get("model") or {}
        train_cfg = config.get("training") or {}

        if data_cfg.get("eval_sets"):
            raise NotImplementedError(
                "validation (data.eval_sets) is not ported yet: it comes "
                "with utils/metrics.py in the metrics slice; drop eval_sets "
                "to train without validation")
        if train_cfg.get("profile_steps"):
            raise NotImplementedError("training.profile_steps is not ported yet")
        if train_cfg.get("logging") == "aim":
            raise NotImplementedError("Aim experiment tracking is not ported yet")

        self.seed = int(train_cfg.get("seed") or 0)
        # num_epochs counts epochs to run FROM the resume point;
        # epoch_cutoff is the absolute total including previously-run epochs
        self.num_epochs = int(train_cfg.get("num_epochs") or 1)
        self.epoch_cutoff = train_cfg.get("epoch_cutoff")
        self.early_stopping_patience = train_cfg.get("early_stopping_patience")
        self.best_metric = train_cfg.get("best_metric") or "val-PSNR"
        self.aggressive_cleanup = bool(train_cfg.get("aggressive_cleanup"))
        self.early_stopping_metric = (train_cfg.get("early_stopping_metric")
                                      or self.best_metric)
        self.cleanup_metric = (train_cfg.get("cleanup_metric")
                               or self.best_metric)
        self.model_cleanup_frequency = train_cfg.get("model_cleanup_frequency")
        self.eval_frequency = int(train_cfg.get("eval_frequency") or 1)

        scale = int(data_cfg.get("scale") or 4)
        # sample configs put batch_size under [data]; [training] wins
        self.batch_size = int(train_cfg.get("batch_size")
                              or data_cfg.get("batch_size") or 8)
        load_epoch = train_cfg.get("continue_from_epoch")

        self.model = SISRInterface(
            model_loc=config.get("experiment_save_loc"),
            experiment=config.get("experiment") or "experiment",
            mode="train",
            new_params=model_cfg,
            load_epoch=load_epoch,
            scale=scale,
            no_directories=bool(config.get("no_directories")),
            new_params_override_load=train_cfg.get("new_params_override_load"),
            seed=self.seed,
            device=device)
        self.device = self.model.device

        # branching: resuming from a non-final epoch forks a branch dir
        if load_epoch is not None and self.model.model_save_dir:
            eps = available_epochs(self.model.model_save_dir)
            if eps and self.model.model_epoch - 1 < max(eps):
                self.model.branch(self.model.model_epoch - 1)
            # truncate stats past the resume point even when NOT branching:
            # a crash between the CSV row write and the checkpoint save
            # leaves an orphan row for an epoch that will be re-run
            if eps:
                stats_mod.truncate_statistics(self.model.logs_dir,
                                              self.model.model_epoch - 1)

        handler = self.model.model
        online_cfg = data_cfg.get("online_degradations")
        if online_cfg:
            if not isinstance(online_cfg, dict):
                raise ValueError(
                    "[data.online_degradations] must be a table with a "
                    "'pipeline' list (got a bare boolean); see "
                    "examples/train_rcan_blind_x4.toml")
            # a global online pipeline makes the training sets HR-only (the
            # LR is made on the device inside the step)
            for ds in (data_cfg.get("training_sets") or {}).values():
                if ds.get("online_degradations") is None:
                    ds["online_degradations"] = True
        self.train_data, self.eval_data = sisr_data_setup(
            data_cfg, scale=scale,
            batch_size=self.batch_size,
            dataloader_threads=int(data_cfg.get("dataloader_threads") or 4),
            input=getattr(handler, "im_input", "unmodified"),
            colorspace=handler.colorspace,
            crop=data_cfg.get("crop"),
            crop_count=int(data_cfg.get("crop_count") or 1),
            augmentations=bool(data_cfg.get("augmentations")),
            metadata=data_cfg.get("metadata"),
            sampler_attributes=data_cfg.get("sampler_attributes"),
            seed=self.seed,
            device=self.device)
        self.online_pipeline = None
        if online_cfg:
            self._set_online_pipeline(handler, online_cfg, scale,
                                      data_cfg.get("metadata"))
        self.stats: Dict[int, Dict[str, float]] = {}

    def _set_online_pipeline(self, handler, online_cfg, scale: int, requested) -> None:
        """Build the degradation pipeline and hand it to the handler as its
        input pipeline: hr -> lr and the requested metadata columns (all
        of them when none or 'all' is requested)."""
        from rumpy_tpu_torch.degradations.pipeline import ImagePipeline
        pipe = ImagePipeline(online_cfg["pipeline"],
                             deg_configs=online_cfg.get("deg_configs"), scale=scale)
        self.online_pipeline = pipe
        columns = {}  # device -> index tensor of the requested columns

        def input_fn(generator, batch):
            lr, meta = pipe.degrade_batch(generator, batch["hr"])
            mat, keys = pipe.metadata_matrix(meta)
            new_batch = dict(batch)
            new_batch["lr"] = lr
            if requested and "all" not in requested:
                idx = [i for r in requested for i, k in enumerate(keys)
                       if k == r or k.endswith(f"-{r}")]
                if idx:
                    if mat.device not in columns:  # uploaded once, not every step
                        columns[mat.device] = torch.tensor(idx, device=mat.device)
                    new_batch["metadata"] = mat.index_select(1, columns[mat.device])
            else:
                new_batch["metadata"] = mat
            return new_batch

        try:
            handler.set_input_pipeline(input_fn)
        except NotImplementedError:
            # handlers that degrade their own views refuse the hook
            pass

    # ------------------------------------------------------------------

    def _put(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in batch.items()
                if isinstance(v, np.ndarray) and v.dtype != object and v.size > 0}

    def train(self, epoch: int) -> Dict[str, float]:
        agg: Dict[str, List[torch.Tensor]] = defaultdict(list)
        data_t = compute_t = 0.0
        t0 = time.perf_counter()
        for batch in self.train_data:
            t1 = time.perf_counter()
            data_t += t1 - t0
            device_batch = self._put(batch)
            # fetch=False: losses stay on the device and the whole epoch's
            # scalars come back in one transfer below
            losses = self.model.train_batch(
                lr=device_batch.get("lr"), hr=device_batch.get("hr"),
                metadata=device_batch.get("metadata"),
                tags=batch.get("tag"), fetch=False)
            for k, v in losses.items():
                agg[k].append(v)
            t0 = time.perf_counter()
            compute_t += t0 - t1
        if not agg:
            n = len(self.train_data.dataset) \
                if hasattr(self.train_data, "dataset") else "?"
            raise RuntimeError(
                f"Training loader produced no batches (dataset size {n}, "
                f"batch_size {self.train_data.batch_size}, drop_last) — "
                "reduce batch_size or add training data.")
        # one synchronizing transfer per loss for every step's scalars;
        # the sync time is epoch compute, so count it as such
        t1 = time.perf_counter()
        fetched = {k: torch.stack([x.float() for x in v]).cpu().numpy()
                   for k, v in agg.items()}
        compute_t += time.perf_counter() - t1
        out = {k: float(np.mean(v)) for k, v in fetched.items()}
        total = data_t + compute_t
        out["compute_efficiency"] = (compute_t / total * 100.0) if total else 0.0
        if self.verbose:
            print(f"epoch {epoch}: train-loss "
                  f"{out.get('train-loss', float('nan')):.5f} | "
                  f"compute efficiency {out['compute_efficiency']:.1f}%")
        return out

    def eval(self, epoch: int) -> Dict[str, float]:
        if self.eval_data is None:
            return {}
        raise NotImplementedError(
            "validation is not ported yet: it comes with utils/metrics.py "
            "in the metrics slice")

    # ------------------------------------------------------------------

    def _best_epoch_by(self, metric: str) -> int:
        """Best epoch of this run under ``metric``'s improve direction."""
        d = metric_best_val.get(metric, "max")
        vals = {e: r[metric] for e, r in self.stats.items() if metric in r}
        if not vals:
            return max(self.stats) if self.stats else 0
        return (max if d == "max" else min)(vals, key=vals.get)

    def _cleanup_checkpoints(self, best_epoch: int, last_epoch: int,
                             force: bool = False) -> None:
        """Keep best-1 / best / best+1 / last."""
        if not (self.aggressive_cleanup or force) \
                or not self.model.model_save_dir:
            return
        keep = {best_epoch - 1, best_epoch, best_epoch + 1, last_epoch}
        for e in available_epochs(self.model.model_save_dir):
            if e not in keep:
                os.remove(checkpoint_path(self.model.model_save_dir, e))

    def run_experiment(self) -> Dict[int, Dict[str, float]]:
        self.model.save_metadata()
        self.model.model_structure_dump()
        start = self.model.model_epoch
        direction = metric_best_val.get(self.early_stopping_metric, "max")
        best_val = -np.inf if direction == "max" else np.inf
        stale = 0
        end = (int(self.epoch_cutoff) if self.epoch_cutoff is not None
               else start + self.num_epochs)
        for epoch in range(start, end):
            self.model.set_epoch(epoch)
            row: Dict[str, float] = {"epoch": epoch}
            row.update(self.train(epoch))
            if epoch % self.eval_frequency == 0:
                row.update(self.eval(epoch))
            self.stats[epoch] = row
            if self.model.logs_dir and not self.model.no_directories:
                stats_mod.save_statistics(self.model.logs_dir, row)
            if self.model.model_save_dir and not self.model.no_directories:
                self.model.save()

            # early stopping on the tracked metric plateau
            track = row.get(self.early_stopping_metric)
            if track is not None:
                improved = (track > best_val if direction == "max"
                            else track < best_val)
                if improved:
                    best_val, stale = track, 0
                else:
                    stale += 1
                if (self.early_stopping_patience
                        and stale >= self.early_stopping_patience):
                    if self.verbose:
                        print(f"early stopping at epoch {epoch} "
                              f"(no {self.early_stopping_metric} "
                              f"improvement for {stale} epochs)")
                    self._cleanup_checkpoints(
                        self._best_epoch_by(self.cleanup_metric), epoch)
                    break
            freq = self.model_cleanup_frequency
            self._cleanup_checkpoints(
                self._best_epoch_by(self.cleanup_metric), epoch,
                force=bool(freq and (epoch + 1) % int(freq) == 0))
        return self.stats
