"""Model handler layer: the eval half of ``rumpy_tpu/models/base.py``.

A handler owns one ``nn.Module`` on one device and the config vocabulary
the JAX handler takes. Its parameters live in the module; the
:class:`TrainState` a handler hands out holds the module's own parameter
tensors, so ``run_eval(state, batch)`` with that state costs nothing extra,
and a state from elsewhere is copied in first. Public inputs and outputs
keep the JAX package's NHWC layout.

Schedules, optimizers, losses and the train step come with the training
slice; their constructor arguments are accepted and stored so that
configs load.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from rumpy_tpu_torch.device import resolve_device
from rumpy_tpu_torch.utils import checkpoint as ckpt


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    extra: Dict[str, Any] = field(default_factory=dict)


class BaseHandler:
    """One handler per architecture family; the registry instantiates these
    by name."""

    loss_type: str = "l1"
    uses_metadata: bool = False
    # Channels the network consumes ('rgb' => 3, 'ycbcr'-Y-only => 1).
    colorspace: str = "rgb"
    # Input spatial dims must divide this; the eval interface pads up to it
    # and crops the SR output back.
    size_multiple: int = 1

    def __init__(self, scale: int = 4, in_features: int = 3,
                 lr: float = 1e-4, optimizer_type: str = "adam",
                 scheduler: Optional[str] = None,
                 scheduler_params: Optional[Dict[str, Any]] = None,
                 grad_clip: Optional[float] = None,
                 loss: Optional[str] = None,
                 dtype: str = "float32",
                 seed: int = 0,
                 optimizer_params: Optional[Dict[str, Any]] = None,
                 loss_masking: bool = False,
                 device=None,
                 **model_kwargs):
        self.device = resolve_device(device)
        self.scale = scale
        self.in_features = in_features
        self.loss_masking = bool(loss_masking)
        self.dtype = (torch.bfloat16 if dtype in ("bf16", "bfloat16")
                      else torch.float32)
        # training configuration, used by the training slice
        self.lr = lr
        self.optimizer_type = optimizer_type
        self.scheduler = scheduler
        self.scheduler_params = scheduler_params
        self.grad_clip = grad_clip
        self.optimizer_params = optimizer_params
        if loss is not None:
            self.loss_type = loss
        self.seed = seed
        self.model_kwargs = model_kwargs
        self.module = self.build_module(**model_kwargs).to(
            self.device, memory_format=torch.channels_last).eval()
        self._state_params = None

    # -- subclass surface --------------------------------------------------

    def build_module(self, **kwargs) -> nn.Module:
        raise NotImplementedError

    def example_inputs(self, batch: int = 1, size: int = 16) -> Tuple:
        """NHWC inputs for shape checks."""
        return (torch.zeros((batch, size, size, self.in_features),
                            device=self.device),)

    def apply(self, params, batch: Dict[str, Any], train: bool = False,
              rng=None, extra: Any = None):
        """Network forward for a batch dict (NHWC ``lr``). Returns
        (sr NHWC, aux_dict, extra)."""
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        sr = self.module(lr.permute(0, 3, 1, 2))  # channels_last view
        return sr.permute(0, 2, 3, 1), {}, extra

    def handler_metadata(self) -> Dict[str, Any]:
        return {}

    # -- state lifecycle ---------------------------------------------------

    def _own_state(self, step: int = 0, extra=None) -> TrainState:
        self._state_params = dict(self.module.state_dict())
        return TrainState(step=step, params=self._state_params,
                          extra=dict(extra or {}))

    def _use_params(self, params) -> None:
        if params is not self._state_params:
            self.module.load_state_dict(params)
            self._state_params = params

    @torch.no_grad()
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Fresh weights from a seeded CPU generator (the same values on
        every device)."""
        gen = torch.Generator().manual_seed(self.seed if seed is None else seed)
        for m in self.module.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(gen)
        return self._own_state()

    def num_parameters(self, state: TrainState) -> int:
        return sum(t.numel() for t in state.params.values())

    # -- eval --------------------------------------------------------------

    def run_eval(self, state: TrainState, batch) -> torch.Tensor:
        with torch.inference_mode():
            sr, _, _ = self.apply(state.params, batch, train=False,
                                  extra=state.extra)
        return sr

    def run_model(self, state: TrainState, lr_img, metadata=None):
        batch = {"lr": lr_img}
        if metadata is not None:
            batch["metadata"] = metadata
        return self.run_eval(state, batch)

    # -- checkpointing -----------------------------------------------------

    def save_model(self, state: TrainState, model_save_dir: str, epoch: int,
                   minimal: bool = False) -> str:
        path = ckpt.checkpoint_path(model_save_dir, epoch)
        payload = {
            "network": {k: v.detach().cpu() for k, v in state.params.items()},
            "extra": state.extra,
            "step": int(state.step),
            "model_name": getattr(self, "registered_name", type(self).__name__),
            "model_epoch": epoch,
            "handler_metadata": self.handler_metadata(),
        }
        ckpt.save_checkpoint(path, payload, minimal=minimal)
        return path

    def load_model(self, model_save_dir: str, epoch="last",
                   summary_csv: Optional[str] = None,
                   skip_optimizer_load: bool = False) -> Tuple[TrainState, int]:
        epoch = ckpt.select_epoch(model_save_dir, epoch, summary_csv)
        loaded = ckpt.load_checkpoint(ckpt.checkpoint_path(model_save_dir, epoch))
        with torch.no_grad():
            self.module.load_state_dict(loaded["network"])
        return self._own_state(int(loaded["step"]), loaded.get("extra")), epoch
