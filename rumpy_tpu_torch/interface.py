"""SISRInterface — the model interface layer (eval half).

Port of ``rumpy_tpu/interface.py``: owns the experiment directory layout
(``saved_models/``, ``result_outputs/``), config persistence and diff
arbitration, epoch selection (int | 'best' | 'last'), handler construction
through the registry, and colorspace post-processing of eval outputs
(Y-channel models get Cb/Cr carried over from the LR input). Training
entry points come with the training slice.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from rumpy_tpu_torch.config.loader import (NoneDict, config_diff, dump_toml,
                                           load_config)
from rumpy_tpu_torch.registry import get_model
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
            self.state, self.model_epoch = self.model.load_model(
                self.model_save_dir, load_epoch, summary_csv=summary)
            self.model_epoch += 1  # resume from the NEXT epoch

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
    # Eval entry point
    # ------------------------------------------------------------------

    def net_run_and_process(self, lr=None, hr=None, metadata=None,
                            timing: bool = False,
                            pad_multiple: Optional[int] = None, **kwargs):
        """Eval forward with colorspace post-processing. ``lr`` is
        channel-last RGB float [0,1], (H,W,C) or (N,H,W,C). Returns
        (rgb, ycbcr, None, seconds-or-None) as float32 numpy arrays, both
        clipped and cropped to ``scale`` x the input size.

        Images are padded only to the handler's ``size_multiple``
        (reflect) unless ``pad_multiple`` asks for shape buckets, which are
        padded with zeros, as the JAX package does."""
        lr = torch.as_tensor(np.asarray(lr, np.float32), device=self.device)
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
            batch["metadata"] = torch.as_tensor(np.asarray(metadata),
                                                device=self.device)
        t0 = time.perf_counter()
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
        if out_rgb.is_cuda:
            torch.cuda.synchronize(out_rgb.device)
        elapsed = time.perf_counter() - t0
        s = out_rgb.shape[1] // lr.shape[1]
        out_rgb = out_rgb[:, :orig_h * s, :orig_w * s].cpu().numpy()
        out_ycc = out_ycc[:, :orig_h * s, :orig_w * s].cpu().numpy()
        if timing:
            return out_rgb, out_ycc, None, elapsed
        return out_rgb, out_ycc, None, None

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    def save(self, minimal: bool = False) -> str:
        return self.model.save_model(self.state, self.model_save_dir,
                                     self.model_epoch, minimal=minimal)

    def num_parameters(self) -> int:
        return self.model.num_parameters(self.state)
