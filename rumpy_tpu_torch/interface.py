"""SISRInterface — the model interface layer.

Port of ``rumpy_tpu/interface.py``: owns the experiment directory layout
(``saved_models/``, ``result_outputs/``), config persistence and diff
arbitration, epoch selection (int | 'best' | 'last'), branching, handler
construction through the registry, the train step's entry point, and
colorspace post-processing of eval outputs (Y-channel models get Cb/Cr
carried over from the LR input).
"""

from __future__ import annotations

import math
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rumpy_tpu_torch.config.loader import (NoneDict, config_diff, dump_toml,
                                           load_config)
from rumpy_tpu_torch.device import to_device
from rumpy_tpu_torch.registry import get_model
from rumpy_tpu_torch.utils import checkpoint as ckpt
from rumpy_tpu_torch.utils.color import rgb_to_ycbcr, ycbcr_to_rgb


class SISRInterface:
    def __init__(self, model_loc: Optional[str] = None,
                 experiment: str = "experiment",
                 gpu: str = "single",  # accepted for config parity; unused
                 sp_gpu: int = 0,
                 mode: str = "train",
                 new_params: Optional[Dict[str, Any]] = None,
                 load_epoch=None,
                 scale: Optional[int] = None,
                 no_directories: bool = False,
                 new_params_override_load: Optional[bool] = None,
                 save_subdir: Optional[str] = None,
                 seed: int = 0,
                 device=None,
                 **kwargs):
        self.experiment = experiment
        self.mode = mode
        self.scale = scale
        self.no_directories = no_directories

        self.base_folder = (os.path.join(model_loc, experiment)
                            if model_loc else None)
        if save_subdir and self.base_folder:
            self.base_folder = os.path.join(self.base_folder, save_subdir)
        self.model_save_dir = (os.path.join(self.base_folder, "saved_models")
                               if self.base_folder else None)
        self.logs_dir = (os.path.join(self.base_folder, "result_outputs")
                         if self.base_folder else None)
        if self.base_folder and not no_directories:
            os.makedirs(self.model_save_dir, exist_ok=True)
            os.makedirs(self.logs_dir, exist_ok=True)

        self.metadata = self._metadata_load(new_params or {}, load_epoch,
                                            new_params_override_load)
        _name = self.metadata.get("name")
        if not _name:
            raise ValueError(
                "config declares no model name — add a [model] table with "
                "name = \"...\" (and the checkpoint being loaded, if any, "
                "carries no saved name either)")
        self.name = _name.lower()

        internal = dict(self.metadata.get("internal_params") or {})
        if scale is not None:
            internal.setdefault("scale", scale)
        internal.setdefault("seed", seed)
        self.configuration = internal
        self.model = get_model(self.name)(device=device, **internal)
        self.device = self.model.device

        self.state = self.model.init_state(seed)
        self.model_epoch = 0
        if load_epoch is not None:
            summary = (os.path.join(self.logs_dir, "summary.csv")
                       if self.logs_dir else None)
            # evaluation needs no optimizer state (and a JAX-written
            # checkpoint's optax state does not map onto torch.optim yet)
            self.state, self.model_epoch = self.model.load_model(
                self.model_save_dir, load_epoch, summary_csv=summary,
                skip_optimizer_load=mode != "train")
            self.model_epoch += 1  # resume from the NEXT epoch
            # phase-switched handlers must know the loaded epoch
            if hasattr(self.model, "set_epoch"):
                self.model.set_epoch(self.model_epoch)

    # ------------------------------------------------------------------
    # Config persistence / diff arbitration
    # ------------------------------------------------------------------

    def _metadata_load(self, new_params, load_epoch, override):
        cfg_path = (os.path.join(self.base_folder, "config.toml")
                    if self.base_folder else None)
        new_params = (new_params.as_plain()
                      if isinstance(new_params, NoneDict) else dict(new_params))
        if load_epoch is None or not cfg_path or not os.path.isfile(cfg_path):
            meta = new_params
        else:
            original = load_config(cfg_path).as_plain().get("model", {})
            diff = config_diff(original, new_params) if new_params else {}
            changed = {k: v for k, v in diff.items()
                       if v["old"] is not None and v["new"] is not None}
            if not changed:
                meta = new_params if override else (original or new_params)
            elif override is None:
                raise RuntimeError(
                    "Parameter inconsistencies between current config and "
                    f"saved-model config at {cfg_path}. Set "
                    "new_params_override_load under [training] to True/False "
                    f"to arbitrate. Diff: {changed}")
            else:
                meta = new_params if override else original
        if (meta and self.scale is not None
                and meta.get("internal_params", {}).get("scale") not in
                (None, self.scale)):
            raise Exception("The model loaded has been trained for a "
                            "different scale, and cannot produce the "
                            "requested images.")
        return meta or {}

    def save_metadata(self) -> None:
        if not self.base_folder or self.no_directories:
            return
        dump_toml({"model": self.metadata},
                  os.path.join(self.base_folder, "config.toml"))

    # ------------------------------------------------------------------
    # Branching: resuming from a non-final epoch forks into
    # branch_epoch_N to protect existing results.
    # ------------------------------------------------------------------

    def branch(self, epoch: int) -> str:
        branch_dir = os.path.join(self.base_folder, f"branch_epoch_{epoch}")
        new_models = os.path.join(branch_dir, "saved_models")
        new_logs = os.path.join(branch_dir, "result_outputs")
        os.makedirs(new_models, exist_ok=True)
        os.makedirs(new_logs, exist_ok=True)
        src_ckpt = ckpt.checkpoint_path(self.model_save_dir, epoch)
        if os.path.isfile(src_ckpt):
            shutil.copy(src_ckpt, ckpt.checkpoint_path(new_models, epoch))
        summary = os.path.join(self.logs_dir, "summary.csv")
        if os.path.isfile(summary):
            shutil.copy(summary, os.path.join(new_logs, "summary.csv"))
        self.base_folder = branch_dir
        self.model_save_dir = new_models
        self.logs_dir = new_logs
        return branch_dir

    # ------------------------------------------------------------------
    # Train / eval entry points
    # ------------------------------------------------------------------

    def train_batch(self, lr=None, hr=None, metadata=None, fetch=True,
                    **kwargs):
        """One optimizer step on a batch of NHWC arrays or tensors.
        ``fetch=False`` keeps the losses as device scalars: every float()
        is a blocking device-to-host copy, so the training loop fetches
        once per epoch instead."""
        batch = {}
        if lr is not None:
            batch["lr"] = lr
        if hr is not None:
            batch["hr"] = hr
        if metadata is not None and (
                metadata.numel() if torch.is_tensor(metadata) else np.size(metadata)):
            batch["metadata"] = metadata
        if kwargs.get("tags") is not None and getattr(
                self.model, "wants_tags", False):
            batch["tags"] = list(kwargs["tags"])
        self.state, losses = self.model.train_batch(self.state, batch)
        if not fetch:
            return losses
        return {k: float(v) for k, v in losses.items()}

    def set_epoch(self, epoch: int) -> None:
        self.model_epoch = epoch
        # epoch-switched handlers depend on it
        if hasattr(self.model, "set_epoch"):
            self.model.set_epoch(epoch)

    def net_run(self, lr, metadata=None, pad_multiple: Optional[int] = None):
        """Eval forward with colorspace post-processing, on the device and
        without waiting for it. ``lr`` is channel-last RGB float [0,1],
        (H,W,C) or (N,H,W,C), a numpy array or a tensor. Returns (rgb,
        ycbcr) float32 tensors on the handler's device, cropped to
        ``scale`` x the input size; rgb clipped to [0, 1].

        Images are padded only to the handler's ``size_multiple``
        (reflect) unless ``pad_multiple`` asks for shape buckets, which are
        padded with zeros, as the JAX package does."""
        lr = to_device(lr, self.device, torch.float32)
        if lr.dim() == 3:
            lr = lr[None]
        orig_h, orig_w = lr.shape[1:3]
        bucket = pad_multiple is not None
        size_mult = getattr(self.model, "size_multiple", 1)
        if pad_multiple is None:
            pad_multiple = size_mult
        elif size_mult > 1:
            pad_multiple = math.lcm(int(pad_multiple), int(size_mult))
        if pad_multiple and pad_multiple > 1:
            ph = (-orig_h) % pad_multiple
            pw = (-orig_w) % pad_multiple
            if ph or pw:
                lr = F.pad(lr.permute(0, 3, 1, 2), (0, pw, 0, ph),
                           mode="constant" if bucket else "reflect")
                lr = lr.permute(0, 2, 3, 1).contiguous()
        batch: Dict[str, Any] = {}
        if metadata is not None and np.size(metadata):
            batch["metadata"] = to_device(metadata, self.device)
        if self.model.colorspace == "rgb":
            batch["lr"] = lr
            out_rgb = self.model.run_eval(self.state, batch).float()
            out_rgb = out_rgb.clamp(0.0, 1.0)
            out_ycc = rgb_to_ycbcr(out_rgb, im_type="jpg")
        else:
            ycc = rgb_to_ycbcr(lr, im_type="jpg")
            batch["lr"] = ycc[..., :1].contiguous()
            out_y = self.model.run_eval(self.state, batch).float()
            out_ycc = torch.cat([out_y, ycc[..., 1:]], dim=-1)
            out_rgb = ycbcr_to_rgb(out_ycc, im_type="jpg").clamp(0.0, 1.0)
        s = out_rgb.shape[1] // lr.shape[1]
        return out_rgb[:, :orig_h * s, :orig_w * s], out_ycc[:, :orig_h * s, :orig_w * s]

    def net_run_and_process(self, lr=None, hr=None, metadata=None,
                            timing: bool = False,
                            pad_multiple: Optional[int] = None, **kwargs):
        """:meth:`net_run`, its outputs fetched: (rgb, ycbcr, None,
        seconds-or-None) as float32 numpy arrays. ``timing`` times the
        forward to the end of its work on the device (the upload of ``lr``
        comes first and is not timed)."""
        lr = to_device(lr, self.device, torch.float32)
        t0 = time.perf_counter()
        out_rgb, out_ycc = self.net_run(lr, metadata, pad_multiple)
        if out_rgb.is_cuda:
            torch.cuda.synchronize(out_rgb.device)
        elapsed = time.perf_counter() - t0
        out_rgb, out_ycc = out_rgb.cpu().numpy(), out_ycc.cpu().numpy()
        return out_rgb, out_ycc, None, (elapsed if timing else None)

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    def save(self, minimal: bool = False) -> str:
        return self.model.save_model(self.state, self.model_save_dir,
                                     self.model_epoch, minimal=minimal)

    def num_parameters(self) -> int:
        return self.model.num_parameters(self.state)

    def print_overview(self) -> None:
        print(f"Model: {self.name} | params: {self.num_parameters():,} | "
              f"scale: {self.configuration.get('scale')}")

    def model_structure_dump(self) -> None:
        """The module tree and its parameter count, into
        ``result_outputs/model_structure.txt``."""
        if not self.logs_dir or self.no_directories:
            return
        with open(os.path.join(self.logs_dir, "model_structure.txt"), "w") as f:
            f.write(f"{self.model.module}\n\nparameters: "
                    f"{self.num_parameters():,}\n")
