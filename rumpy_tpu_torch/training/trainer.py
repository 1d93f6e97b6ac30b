"""Training orchestration.

Port of ``rumpy_tpu/training/trainer.py::TrainingHandler``: the epoch loop,
loss aggregation, summary.csv, early stopping, per-epoch checkpointing,
periodic cleanup, and resume with branching. The data-vs-compute
efficiency line is kept: it says how far the input pipeline holds the card
back. Losses stay on the device during an epoch and are fetched once at
its end.

Data parallel (``use_mesh``, under ``torchrun --nproc_per_node=N``): the
process joins the group of ``parallel/mesh.py`` on ``cuda:LOCAL_RANK``
(NCCL; gloo where more ranks than cards share a host). As in
the JAX trainer the data axis is ``gcd(batch, ranks)``; where that is not
every rank, the trainer raises. Every rank runs the global loader, with the
same seed and order, and keeps its rows of each batch (an array whose
first axis does not divide stays whole), as JAX's one process shards one
host batch; the online chain draws for the global batch and applies this
rank's draws; the handlers average gradients and losses and take
BatchNorm statistics and queue entries over the group. Parameters are
broadcast from rank 0 at build and after a resume. Every rank scores the
whole validation set and the means are averaged over the group, so every
rank holds the same numbers (and stops early together); only rank 0
writes summary.csv, checkpoints, samples, the profile trace and Aim rows.

A ``[data.online_degradations]`` table trains from HR-only sets: the
datasets return HR crops and the pipeline (``degradations/pipeline.py``)
degrades each batch on the device at the start of the train step.

Validation (``[data.eval_sets]``) runs every ``eval_frequency`` epochs, as
the JAX package's does: eval images bucketed by shape, one forward per
chunk of ``eval_batch_size``, Y-channel PSNR/SSIM on the device
(``utils/metrics.py``) and one copy of a chunk's metrics to the host; the
means go into summary.csv as ``val-<metric>``.

``[data.multi_frame_config]`` trains on ``VideoSequenceImages``; its
``use_masks`` sets the model's ``loss_masking``, as the JAX trainer does.
Like the JAX trainer's, the train loop hands the step the batch's lr, hr,
metadata and tags, and not its mask: a loss mask reaches the loss only
from a caller that puts ``"mask"`` into the batch it hands the handler
(``ROADMAP.md`` §3).

``[training] profile_steps = N`` traces the first N steps of the first
epoch with ``torch.profiler`` (host activity, and the card's where the
device is CUDA), each step in a ``train_step`` span, and writes the trace
as Chrome-trace JSON to ``result_outputs/profile/train_steps.json``
(chrome://tracing or Perfetto read it). The profiler stops between steps,
after the N-th or at the epoch's end.

``logging = "aim"`` tracks hparams and every summary.csv column an epoch in
an Aim run, replaying the earlier epochs on a resume; without the ``aim``
package it prints the JAX package's message and trains on. After each
epoch ``utils/stats.plot_stats`` draws ``loss_plots.pdf`` where matplotlib
is installed.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict
from typing import Any, Dict, List

import numpy as np
import torch

from rumpy_tpu_torch.config.constants import metric_best_val
from rumpy_tpu_torch.data.loader import sisr_data_setup
from rumpy_tpu_torch.device import to_device
from rumpy_tpu_torch.interface import SISRInterface
from rumpy_tpu_torch.parallel import mesh as mesh_mod
from rumpy_tpu_torch.utils import metrics as metrics_mod
from rumpy_tpu_torch.utils import stats as stats_mod
from rumpy_tpu_torch.utils.checkpoint import available_epochs, checkpoint_path
from rumpy_tpu_torch.utils.color import rgb_to_ycbcr
from rumpy_tpu_torch.utils.metrics import Metrics
from rumpy_tpu_torch.utils.visualization import safe_image_save

# the profiler's span around each traced train step
STEP_SPAN = "train_step"


class TrainingHandler:
    def __init__(self, config, use_mesh: bool = True, verbose: bool = True,
                 device=None):
        self.cfg = config
        self.verbose = verbose
        data_cfg = config.get("data") or {}
        model_cfg = config.get("model") or {}
        train_cfg = config.get("training") or {}

        # [training] profile_steps = N: a torch.profiler trace of the first N
        # steps of the first epoch into result_outputs/profile/
        self.profile_steps = int(train_cfg.get("profile_steps") or 0)
        self._profiled = False

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
        self.metrics_list = list(train_cfg.get("metrics") or ["PSNR", "SSIM"])
        # None: save the first validation sample where PIL is installed
        self.save_samples = train_cfg.get("save_samples")
        self.max_im_val = float(train_cfg.get("max_im_val") or 1.0)
        if self.max_im_val != 1.0 and verbose:
            print(f"WARNING: training.max_im_val={self.max_im_val} but the data "
                  "layer emits [0, 1] images; validation PSNR/SSIM will use it "
                  "as the peak value verbatim. Use 1.0 unless you know why.")

        scale = int(data_cfg.get("scale") or 4)
        # sample configs put batch_size under [data]; [training] wins
        self.batch_size = int(train_cfg.get("batch_size")
                              or data_cfg.get("batch_size") or 8)
        load_epoch = train_cfg.get("continue_from_epoch")

        # the data-parallel group: the JAX trainer sizes its data axis
        # gcd(batch, devices); here the axis is the whole group or nothing
        self.mesh = None
        if use_mesh and ("WORLD_SIZE" in os.environ
                         or mesh_mod.joined()):
            mesh = mesh_mod.get_mesh(device=device)
            if math.gcd(self.batch_size, mesh.size) != mesh.size:
                raise ValueError(
                    f"batch_size {self.batch_size} does not divide over the {mesh.size} "
                    f"ranks of the group: the data axis would be "
                    f"gcd = {math.gcd(self.batch_size, mesh.size)} ranks, and every "
                    "rank must hold rows of the batch (pick a batch that the rank "
                    "count divides)")
            self.mesh, device = mesh, mesh.device
        # only rank 0 writes files
        self.writes = mesh_mod.process_index() == 0

        # multi_frame_config.use_masks turns on the model's loss masking
        if (data_cfg.get("multi_frame_config") or {}).get("use_masks"):
            model_cfg = dict(model_cfg)
            internal = dict(model_cfg.get("internal_params") or {})
            internal.setdefault("loss_masking", True)
            model_cfg["internal_params"] = internal

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
        # the same weights on every rank, after a resume too
        mesh_mod.replicate(self.mesh, self.model.state)

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
        # face-boundary metrics read face_boundaries_0.csv from the first
        # eval set's HR dir
        eval_sets = data_cfg.get("eval_sets") or {}
        first_eval = next(iter(eval_sets.values())) if eval_sets else {}
        self.metric_hub = Metrics(
            self.metrics_list, lpips_weights=train_cfg.get("lpips_weights"),
            hr_data_loc=first_eval.get("hr_dir") or first_eval.get("hr"))
        self.stats: Dict[int, Dict[str, float]] = {}

        # optional Aim experiment tracking, gated on the aim import
        self.tracker = None
        if (train_cfg.get("logging") == "aim" and not config.get("no_directories")
                and self.writes):
            try:
                import aim
                self.tracker = aim.Run(experiment=config.get("experiment") or "experiment",
                                       system_tracking_interval=60)
                self.tracker["hparams"] = (config.as_plain() if hasattr(config, "as_plain")
                                           else dict(config))
                # a resumed run's earlier epochs, replayed into the new run
                if self.model.model_epoch > 0 and self.model.logs_dir:
                    prior = stats_mod.load_statistics(self.model.logs_dir) or {}
                    for ep in range(len(next(iter(prior.values()), []))):
                        for k, v in prior.items():
                            self.tracker.track(float(v[ep]), name=k, epoch=ep)
            except ImportError:
                print("aim not installed; experiment tracking disabled")

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
            # under a group, this rank's rows of the global batch's chain
            rows = None if self.mesh is None else self.mesh.rows(batch["hr"].shape[0])
            lr, meta = (pipe.degrade_batch(generator, batch["hr"]) if rows is None
                        else pipe.degrade_batch(generator, batch["hr"], rows=rows))
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
        """The batch's arrays on the device; under a group this rank's rows
        of each array whose first axis divides over it."""
        arrays = {k: v for k, v in batch.items()
                  if isinstance(v, np.ndarray) and v.dtype != object and v.size > 0}
        if self.mesh is not None and self.mesh.size > 1:
            n, r = self.mesh.size, self.mesh.rank
            arrays = {k: v[r * (len(v) // n):(r + 1) * (len(v) // n)]
                      if len(v) % n == 0 else v for k, v in arrays.items()}
        return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                for k, v in arrays.items()}

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, steps: int) -> None:
        """Stops the profiler (on the card it waits for the steps traced)
        and writes its trace."""
        prof.stop()
        out_dir = os.path.join(self.model.logs_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "train_steps.json")
        prof.export_chrome_trace(path)
        if self.verbose:
            print(f"profile of {steps} train steps: {path}")

    def train(self, epoch: int) -> Dict[str, float]:
        agg: Dict[str, List[torch.Tensor]] = defaultdict(list)
        data_t = compute_t = 0.0
        profiler = None
        if (self.profile_steps and not self._profiled and self.writes
                and self.model.logs_dir and not self.model.no_directories):
            self._profiled = True
            profiler = self._start_profile()
        steps = 0
        t0 = time.perf_counter()
        try:
            for batch in self.train_data:
                t1 = time.perf_counter()
                data_t += t1 - t0
                device_batch = self._put(batch)
                # fetch=False: losses stay on the device and the whole
                # epoch's scalars come back in one transfer below
                with (torch.profiler.record_function(STEP_SPAN) if profiler is not None
                      else contextlib.nullcontext()):
                    losses = self.model.train_batch(
                        lr=device_batch.get("lr"), hr=device_batch.get("hr"),
                        metadata=device_batch.get("metadata"),
                        tags=batch.get("tag"), fetch=False)
                for k, v in losses.items():
                    agg[k].append(v)
                steps += 1
                if profiler is not None and steps >= self.profile_steps:
                    done, profiler = profiler, None
                    self._stop_profile(done, steps)
                t0 = time.perf_counter()
                compute_t += t0 - t1
        finally:
            if profiler is not None:  # the epoch ended first, or a step raised
                self._stop_profile(profiler, steps)
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

    def _eval_groups(self) -> Dict[tuple, list]:
        """The eval set's images bucketed by (LR shape, metadata shape):
        [(lr, hr, metadata, stem)] per bucket."""
        groups: Dict[tuple, list] = defaultdict(list)
        for batch in self.eval_data:
            if "hr" not in batch:
                raise ValueError(
                    "eval set yields no HR images — validation metrics need "
                    "ground truth (add hr_dir to the eval_sets table, or drop "
                    "eval_sets to skip validation)")
            lrs, hrs, metas = batch["lr"], batch["hr"], batch.get("metadata")
            keys = (batch.get("metadata_keys") or [None])[0]
            selector = getattr(self.model.model, "select_metadata", None)
            for i in range(len(lrs)):
                meta = None
                if metas is not None and np.size(metas[i]):
                    meta = np.asarray(metas[i])
                    if selector is not None and keys:
                        # the handler's columns of the CSV row
                        meta = np.asarray(selector(meta[None], list(keys))[0])
                lr = np.asarray(lrs[i])
                tag = batch["tag"][i] if "tag" in batch else f"im{i}"
                mshape = None if meta is None else meta.shape
                groups[(lr.shape, mshape)].append(
                    (lr, np.asarray(hrs[i]), meta, os.path.splitext(str(tag))[0]))
        return groups

    def eval(self, epoch: int) -> Dict[str, float]:
        """Validation: ``val-<metric>`` means over the eval sets."""
        if self.eval_data is None:
            return {}
        agg: Dict[str, List[float]] = defaultdict(list)
        # a cap on a forward's batch within a shape bucket: a large
        # same-shape set must not become one forward
        chunk = int((self.cfg.get("training") or {}).get("eval_batch_size") or 8)
        sample = self.save_samples is not False and self.model.logs_dir \
            and not self.model.no_directories and self.writes
        for items in self._eval_groups().values():
            for lo in range(0, len(items), chunk):
                part = items[lo:lo + chunk]
                meta = (np.stack([it[2] for it in part])
                        if part[0][2] is not None else None)
                rgb, ycc = self.model.net_run(np.stack([it[0] for it in part]),
                                              metadata=meta)
                hr = to_device(np.stack([it[1] for it in part]), self.device,
                               torch.float32)
                hr_y = (rgb_to_ycbcr(hr, y_only=True, im_type="jpg")
                        if hr.shape[-1] == 3 else hr)
                sr_y = ycc[..., :1].clamp(0.0, 1.0)
                values = metrics_mod.fetch(self.metric_hub.compute(
                    sr_y, hr_y, max_value=self.max_im_val,
                    probe_names=[it[3] for it in part], rgb_a=rgb,
                    rgb_ref=hr if hr.shape[-1] == 3 else None))
                for k, v in values.items():
                    agg[f"val-{k}"].extend(v)
                if sample:
                    sample = False  # the first SR image of each validation
                    self._save_sample(rgb[0], epoch)
        means = {k: float(np.mean(v)) for k, v in agg.items()}
        if self.mesh is not None and self.mesh.size > 1:
            # the same numbers on every rank: the group's mean of each
            values = torch.tensor(list(means.values()), dtype=torch.float64,
                                  device=self.device)
            mesh_mod.mean_over_group([values], self.mesh)
            means = dict(zip(means, values.tolist()))
        return means

    def _save_sample(self, img, epoch: int) -> None:
        """The epoch's first SR image as a PNG in result_outputs/samples.
        Without PIL the sample is skipped, unless the config asked for it."""
        try:
            safe_image_save(img, os.path.join(self.model.logs_dir, "samples"),
                            f"epoch_{epoch}_sample.png")
        except ImportError:
            if self.save_samples:
                raise
            self.save_samples = False
            if self.verbose:
                print("PIL is not installed: validation samples are not saved")

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
                or not self.model.model_save_dir or not self.writes:
            return
        keep = {best_epoch - 1, best_epoch, best_epoch + 1, last_epoch}
        for e in available_epochs(self.model.model_save_dir):
            if e not in keep:
                os.remove(checkpoint_path(self.model.model_save_dir, e))

    def run_experiment(self) -> Dict[int, Dict[str, float]]:
        if self.writes:
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
            if self.model.logs_dir and not self.model.no_directories and self.writes:
                stats_mod.save_statistics(self.model.logs_dir, row)
                try:
                    stats_mod.plot_stats(self.model.logs_dir)
                except Exception:  # no matplotlib, or nothing to plot
                    pass
            if self.model.model_save_dir and not self.model.no_directories and self.writes:
                self.model.save()
            if self.tracker is not None:
                for k, v in row.items():
                    if k != "epoch":
                        self.tracker.track(v, name=k, epoch=epoch)

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
