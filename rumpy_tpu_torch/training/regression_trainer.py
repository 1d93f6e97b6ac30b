"""Regression (degradation-predictor) training.

Port of ``rumpy_tpu/training/regression_trainer.py``: trains the
contrastive encoders (MoCo / SupMoCo / WeakCon / SupCon) and the direct
regressors (``models/regressors.py``) on degraded LR patches, with
contrastive evaluation every
``eval_frequency`` epochs (embeddings, clustering scores, an embedding
dump; no scatter plots: ROADMAP queue 1 item 10) and an optional warm start
from an earlier experiment or a packaged network.

A dataset item holds ``crop_count`` = positives + 1 patches of one image,
the query and its keys; for a direct regressor it holds one patch, and the
step regresses the item's metadata row from it (the JAX trainer gives it
two, and its step fails: ``ROADMAP.md`` section 3). The contrastive
evaluation reads a direct regressor's predictions as its embeddings. With a metadata CSV the classes (and WeakCon's
vectors) come from each image's metadata row; with
``[data.online_degradations]`` the items are HR crops and the step
degrades all views of a batch in one pass on the device, the views of one
image with one set of draws (``degradations/pipeline.py``, multi-view
mode), from the handler's generator, then classes from those draws'
metadata. The batch never returns to the host; the losses come back once
an epoch.
"""

from __future__ import annotations

import inspect
import os
import time
from collections import defaultdict
from typing import Any, Dict, List

import numpy as np
import torch

from rumpy_tpu_torch.models import contrastive_labelling as cl
from rumpy_tpu_torch.parallel import mesh as mesh_mod
from rumpy_tpu_torch.training.trainer import TrainingHandler
from rumpy_tpu_torch.utils import checkpoint as ckpt

QUEUE_SIDES = ("queue_labels", "queue_vectors")


def _default_positives(model_name: str):
    """The handler's own default of ``positives_per_class`` (or
    ``positives``), found along its MRO: WeakCon inherits SupMoCo's."""
    from rumpy_tpu_torch.registry import get_model
    try:
        klass = get_model(model_name or "")
    except KeyError:
        return None
    for k in inspect.getmro(klass):
        init = k.__dict__.get("__init__")
        if init is None:
            continue
        params = inspect.signature(init).parameters
        par = params.get("positives_per_class") or params.get("positives")
        if par is not None and par.default is not inspect.Parameter.empty:
            return par.default
    return None


def _direct_regressor(model_name: str) -> bool:
    """Whether the handler registered as ``model_name`` regresses the
    degradation directly (``models/regressors.py``)."""
    from rumpy_tpu_torch.registry import get_model
    try:
        return bool(getattr(get_model(model_name or ""), "direct_regressor", False))
    except KeyError:
        return False


def _state_group(key: str) -> str:
    """The JAX package's state entry a port state_dict key belongs to:
    ``network``, ``key_params``, ``q_bstats``, ``k_bstats`` or a queue
    buffer's own name."""
    if key in ("queue", "queue_ptr") + QUEUE_SIDES:
        return key
    running = key.endswith((".running_mean", ".running_var"))
    if key.startswith("key_encoder."):
        return "k_bstats" if running else "key_params"
    return "q_bstats" if running else "network"


class RegressionTrainingHandler(TrainingHandler):
    def __init__(self, config, **kwargs):
        data_cfg = config.get("data") or {}
        model_cfg = config.get("model") or {}
        internal = dict(model_cfg.get("internal_params") or {})
        self._labelling_strategy = internal.pop("labelling_strategy", None) or "default"
        self._selected_metadata = internal.pop("selected_metadata", None) or "all"
        self._warm_start = (config.get("training") or {}).get("warm_start")
        # crop_count = positives + 1: positives_per_class from the config,
        # else from data.crop_count, else the handler's own default (a
        # 2-crop batch would break SupMoCo's (n, positives, dim) reshape)
        positives = internal.get("positives_per_class") or internal.get("positives")
        cfg_crops = data_cfg.get("crop_count")
        if _direct_regressor(model_cfg.get("name")):
            # one crop an item, which the step takes as it is: the JAX
            # trainer gives a direct regressor two, and its step then finds
            # no "lr" (ROADMAP.md section 3)
            if cfg_crops and int(cfg_crops) != 1:
                raise ValueError(f"data.crop_count={cfg_crops}: a direct regressor trains "
                                 "on one crop an item")
            self._positives = 0
        else:
            if not positives and cfg_crops:
                positives = int(cfg_crops) - 1
            if not positives:
                positives = _default_positives(model_cfg.get("name"))
            self._positives = int(positives or 1)
            if cfg_crops and int(cfg_crops) != self._positives + 1:
                raise ValueError(
                    f"data.crop_count={cfg_crops} conflicts with "
                    f"positives_per_class={self._positives}: contrastive batches need "
                    f"crop_count = positives + 1 = {self._positives + 1}")
        data_cfg["crop_count"] = self._positives + 1
        # SimCLR colour jitter on the views, independent draws per view
        self._colour_distort = bool(data_cfg.get("colour_distort"))
        self._distortion_strength = float(data_cfg.get("distortion_strength") or 1.0)
        model_cfg["internal_params"] = internal
        super().__init__(config, **kwargs)

        handler = self.model.model
        self._m_map: Dict[str, int] = {}
        self._valid: List[str] = []
        self._mags: List[int] = []
        self._num_classes = 0
        ds = self._first_dataset()
        meta_keys = list(ds.metadata_keys) if ds is not None and ds.metadata_keys else []
        if not meta_keys and self.online_pipeline is not None:
            # online: the keys of the chain's own metadata, from a dummy batch
            with torch.no_grad():
                _, meta = self.online_pipeline.degrade_batch(
                    torch.Generator(device=self.device).manual_seed(0),
                    torch.zeros((1, 32, 32, 3), device=self.device))
            _, meta_keys = self.online_pipeline.metadata_matrix(meta)
        if meta_keys:
            self._m_map = {k: i for i, k in enumerate(cl.register_metadata(meta_keys))}
            self._valid, self._mags, self._num_classes = cl.partition_metadata(
                self._m_map, self._selected_metadata, self._labelling_strategy)
        if hasattr(handler, "register_classes") and self._num_classes:
            handler.register_classes(self._num_classes)
        if hasattr(handler, "register_vector") and self._valid:
            handler.register_vector(cl.degradation_vector_size(self._valid))
        if self._warm_start:
            self._do_warm_start(self._warm_start)
            mesh_mod.replicate(self.mesh, self.model.state)

    def _first_dataset(self):
        if self.train_data is None:
            return None
        ds = self.train_data.dataset
        return ds.datasets[0] if hasattr(ds, "datasets") else ds

    @torch.no_grad()
    def _do_warm_start(self, spec):
        """Start from a previous experiment's checkpoint or a packaged
        network's (``rumpy_tpu/pretrained/<name>``), the port's or the JAX
        package's. The query encoder's parameters must match this model's
        shapes (else RuntimeError); every other entry of the JAX package's
        state (key encoder, either BatchNorm statistics, the feature queue)
        is taken whole where its shapes match, except the label and vector
        queues, which keep this run's: the old run's classes belong to its
        own labelling. A queue not taken keeps its fresh pointer too."""
        handler = self.model.model
        path_dir = spec.get("model_save_dir") if isinstance(spec, dict) else spec
        if isinstance(path_dir, str):
            path_dir = ckpt.resolve_packaged(path_dir)
        summary = os.path.join(os.path.dirname(path_dir.rstrip(os.sep)),
                               "result_outputs", "summary.csv")
        epoch = ckpt.select_epoch(
            path_dir, spec.get("epoch", "last") if isinstance(spec, dict) else "last",
            summary if os.path.isfile(summary) else None)
        path = ckpt.checkpoint_path(path_dir, epoch)
        loaded = ckpt.load_checkpoint(path)
        try:
            incoming = (handler._jax_state_dict(loaded)
                        if ckpt.checkpoint_format(path) == "flax" else loaded["network"])
        except (KeyError, ValueError) as err:
            raise RuntimeError(f"warm start from {path_dir}: checkpoint network shapes do "
                               f"not match this model's configuration ({err})") from err
        fresh = handler.module.state_dict()

        def by_group(sd):
            out: Dict[str, Dict[str, torch.Tensor]] = defaultdict(dict)
            for k, v in sd.items():
                out[_state_group(k)][k] = v
            return out

        def same(a, b):
            return a.keys() == b.keys() and all(a[k].shape == b[k].shape for k in a)

        have, take = by_group(incoming), by_group(fresh)
        if not same(have.get("network", {}), take["network"]):
            raise RuntimeError(f"warm start from {path_dir}: checkpoint network shapes do "
                               "not match this model's configuration")
        new = dict(fresh)
        taken = set()
        for group, entries in take.items():
            if group in QUEUE_SIDES or group not in have or not same(have[group], entries):
                continue
            new.update(have[group])
            taken.add(group)
        if "queue" in take and "queue" not in taken:
            new["queue_ptr"] = fresh["queue_ptr"].clone()
        handler.module.load_state_dict(new)
        handler._optimizer = None
        state = self.model.state
        self.model.state = handler._own_state(state.step, state.extra)
        print(f"warm-started from {path_dir} (epoch {epoch})")

    # ------------------------------------------------------------------

    def _degrade_views(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The HR crops (N, P, H, W, C) of a batch degraded on the device in
        one pass, each image's P views with one set of draws; the metadata
        (N, M) of those draws; colour distortion, if asked, with
        independent draws per view. Under a data-parallel group the batch is
        this rank's images and the draws are the global batch's."""
        from rumpy_tpu_torch.ops.color_aug import apply_colour_distortion, colour_distortion_draws
        gen = self.model.model.rng
        hr = batch["hr"]
        if hr.dim() == 4:
            hr = hr[:, None]
        n, p = hr.shape[:2]
        rows = None if self.mesh is None else self.mesh.rows(n)
        with torch.no_grad():
            lr, meta = self.online_pipeline.degrade_batch(
                gen, hr.reshape((n * p,) + tuple(hr.shape[2:])), views=p, rows=rows)
            mat, _ = self.online_pipeline.metadata_matrix(meta)
            if self._colour_distort:
                view_rows = None if rows is None else rows._replace(
                    start=rows.start * p, count=n * p, total=rows.total * p)
                draws = colour_distortion_draws(
                    gen, n * p if rows is None else rows.total * p, self._distortion_strength)
                lr = apply_colour_distortion(lr, *mesh_mod.take_rows(draws, view_rows))
        out = dict(batch)
        out["lr"] = lr.reshape((n, p) + tuple(lr.shape[1:]))
        out["metadata"] = mat
        return out

    def _assemble_contrastive_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """crops (N, P + 1, h, w, C) -> the query views, the key views
        (image-major) and, from the metadata, labels and vectors."""
        crops = batch["lr"]
        n, pc = crops.shape[:2]
        out: Dict[str, Any] = {
            "image_query": crops[:, 0],
            "image_key": crops[:, 1:].reshape((n * (pc - 1),) + tuple(crops.shape[2:])),
        }
        metas = batch.get("metadata")
        if metas is not None and metas.numel():
            metas = metas.to(torch.float32)
            if self._m_map and self._num_classes:
                out["labels"] = cl.assign_classes(metas, self._m_map, self._valid, self._mags,
                                                  self._num_classes, self._labelling_strategy)
            if self._m_map and self._valid:
                out["vector"] = cl.degradation_vectors(metas, self._m_map, self._valid)
            out["metadata"] = metas
        return out

    def train(self, epoch: int) -> Dict[str, float]:
        handler = self.model.model
        agg: Dict[str, List[torch.Tensor]] = defaultdict(list)
        data_t = compute_t = 0.0
        t0 = time.perf_counter()
        for batch in self.train_data:
            t1 = time.perf_counter()
            data_t += t1 - t0
            db = self._put(batch)
            if "lr" not in db and self.online_pipeline is not None:
                db = self._degrade_views(db)
            if getattr(handler, "task", None) == "regression" and db["lr"].dim() == 5:
                db = self._assemble_contrastive_batch(db)
            self.model.state, losses = handler.train_batch(self.model.state, db)
            for k, v in losses.items():
                agg[k].append(v)
            t0 = time.perf_counter()
            compute_t += t0 - t1
        if not agg:
            raise RuntimeError("Training loader produced no batches: reduce batch_size "
                               "or add training data.")
        t1 = time.perf_counter()
        fetched = {k: torch.stack([x.float() for x in v]).cpu().numpy() for k, v in agg.items()}
        compute_t += time.perf_counter() - t1
        out = {k: float(np.mean(v)) for k, v in fetched.items()}
        total = data_t + compute_t
        out["compute_efficiency"] = (compute_t / total * 100.0) if total else 0.0
        if self.verbose:
            print(f"epoch {epoch}: train-loss {out.get('train-loss', float('nan')):.5f} | "
                  f"compute efficiency {out['compute_efficiency']:.1f}%")
        return out

    def eval(self, epoch: int) -> Dict[str, float]:
        """Contrastive evaluation: the eval set's embeddings and classes,
        their clustering scores as ``val-<score>``, and the embeddings
        dumped to ``result_outputs/encodings_epoch_<epoch>.{npz,csv}``."""
        if self.eval_data is None:
            return {}
        from rumpy_tpu_torch.evaluation.contrastive_eval import ContrastiveEval
        ce = ContrastiveEval(self.model.model, self.model.state, m_map=self._m_map,
                             valid=self._valid, mags=self._mags,
                             num_classes=self._num_classes,
                             labelling_strategy=self._labelling_strategy)
        embeddings, labels = ce.generate_data_encoding(self.eval_data)
        scores = ce.clustering_scores(embeddings, labels)
        if self.model.logs_dir and not self.model.no_directories and self.writes:
            ce.dump_embeddings(embeddings, labels, os.path.join(
                self.model.logs_dir, f"encodings_epoch_{epoch}"))
        if self.mesh is not None and self.mesh.size > 1:  # the same numbers on every rank
            keys = sorted(scores)
            values = torch.tensor([scores[k] for k in keys], dtype=torch.float64,
                                  device=self.device)
            mesh_mod.mean_over_group([values], self.mesh)
            scores = dict(zip(keys, values.tolist()))
        return {f"val-{k}": v for k, v in scores.items()}
