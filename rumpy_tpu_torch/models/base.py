"""Model handler layer: port of ``rumpy_tpu/models/base.py``.

A handler owns one ``nn.Module`` on one device, a ``torch.optim``
optimizer built from the config vocabulary the JAX handler takes
(adam/adamw/rmsprop/sgd; multi_step_lr / step_lr / cosine warm restarts /
one_cycle / the custom lambdas; global-norm clipping), and the train and
eval steps. Its parameters live in the module; the :class:`TrainState` a
handler hands out holds the module's own parameter tensors, so a step with
that state costs nothing extra, and a state from elsewhere is copied in
first. The optimizer updates those tensors in place. Public inputs and
outputs keep the JAX package's NHWC layout. Parameters are float32;
``dtype="bf16"`` makes the activations bfloat16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from rumpy_tpu_torch.device import resolve_device
from rumpy_tpu_torch.utils import checkpoint as ckpt


@dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]
    extra: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Schedules / optimizers
# ---------------------------------------------------------------------------

def build_schedule(lr: float, scheduler: Optional[str],
                   sp: Optional[Dict[str, Any]] = None) -> Callable[[int], float]:
    """The learning rate as a Python function of the optimizer step ``t``
    (0 for the first update), for the JAX package's scheduler vocabulary.
    The custom lambdas keep torch LambdaLR semantics: their values
    MULTIPLY the base lr."""
    sp = dict(sp or {})
    if scheduler is None:
        return lambda t: lr
    if scheduler == "multi_step_lr":
        gamma = sp.get("gamma", 0.5)
        milestones = sorted(int(m) for m in sp.get("milestones", []))
        return lambda t: lr * gamma ** sum(1 for m in milestones if t >= m)
    if scheduler == "step_lr":
        gamma = sp.get("gamma", 0.1)
        step_size = int(sp.get("step_size", 1000))
        return lambda t: lr * gamma ** (t // step_size)
    if scheduler in ("cosine_annealing_warm_restarts", "cosine_warm_restarts"):
        t0 = int(sp.get("restart_period", sp.get("t_0", 100000)))
        t_mult = int(sp.get("t_mult", 1))
        eta_min = sp.get("lr_min", sp.get("eta_min", 1e-7))

        def sched(t):
            # torch CosineAnnealingWarmRestarts: cycle i spans
            # t0 * t_mult**i steps
            start, period = 0, t0
            while t_mult > 1 and t >= start + period:
                start, period = start + period, period * t_mult
            frac = (t % t0) / t0 if t_mult == 1 else (t - start) / period
            return eta_min + (lr - eta_min) * 0.5 * (1 + math.cos(math.pi * frac))
        return sched
    if scheduler in ("one_cycle_lr", "one_cycle"):
        # torch OneCycleLR's two-phase anneal: its phase endpoints are
        # pct_start*total-1 and total-1
        total = int(sp.get("total_steps", 100000))
        peak = float(sp.get("lr_max", sp.get("max_lr", lr * 10)))
        div = float(sp.get("div_factor", 25.0))
        fdiv = float(sp.get("final_div_factor", 1e4))
        initial = peak / div
        min_lr = initial / fdiv
        peak_step = float(sp.get("pct_start", 0.3)) * total - 1
        end_step = float(total - 1)
        if peak_step <= 0 or end_step <= peak_step:
            raise ValueError(
                "one_cycle_lr needs 1 < pct_start*total_steps < "
                f"total_steps; got pct_start={sp.get('pct_start', 0.3)}, "
                f"total_steps={total} (degenerate warmup/anneal phase "
                "would divide by zero)")
        linear = sp.get("anneal_strategy", "cos") == "linear"

        def _anneal(a, b, pct):
            if linear:
                return a + (b - a) * pct
            return b + (a - b) * 0.5 * (1 + math.cos(math.pi * pct))

        def sched(t):
            if t <= peak_step:
                return _anneal(initial, peak, t / peak_step)
            return _anneal(peak, min_lr, (t - peak_step) / (end_step - peak_step))
        return sched
    if scheduler == "custom_dasr":
        train_type = sp.get("train_type")
        table = {"long": (60, 225, 100, 125), "short": (21, 79, 35, 44),
                 "no_encoder_long": (0, 225, 100, 125)}
        if train_type not in table:
            raise ValueError("Need to select from long or short scheduler "
                             "type for DASR.")
        warm, drop, c0, cd = table[train_type]

        def sched(t):
            if t < warm:
                return lr * 1e-3
            if t < drop:
                return lr * 1e-4
            return lr * 1e-4 * 0.5 ** max(math.floor((t - c0) / cd), 0)
        return sched
    if scheduler == "custom_contrastive":
        return lambda t: lr * (0.1 if t < 260 else 5e-4)
    if scheduler == "custom":
        fn = sp["function"]  # callable of the step count
        return lambda t: lr * fn(t)
    if scheduler == "cosine":
        total = int(sp.get("total_steps", 100000))
        alpha = sp.get("alpha", 0.0)

        def sched(t):
            c = 0.5 * (1 + math.cos(math.pi * min(t, total) / total))
            return lr * ((1 - alpha) * c + alpha)
        return sched
    raise ValueError(f"Unknown scheduler {scheduler!r}")


def build_optimizer(params, lr: float = 1e-4, optimizer_type: str = "adam",
                    scheduler_params: Optional[Dict[str, Any]] = None,
                    weight_decay: float = 0.0,
                    optimizer_params: Optional[Dict[str, Any]] = None
                    ) -> torch.optim.Optimizer:
    """The optimizer factory vocabulary over ``torch.optim``:
    case-insensitive type names, adam betas via optimizer_params {beta_1,
    beta_2}, rmsprop smoothing via {alpha}. The schedule and the clipping
    are applied by the train step (``BaseHandler.train_batch``), which sets
    the lr before every update."""
    op = dict(optimizer_params or {})
    optimizer_type = optimizer_type.lower()
    betas = (op.get("beta_1", 0.9), op.get("beta_2", 0.999))
    if optimizer_type == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    if optimizer_type == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                 weight_decay=weight_decay)
    if optimizer_type == "rmsprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=op.get("alpha", 0.99),
                                   eps=1e-8)
    if optimizer_type == "sgd":
        momentum = op.get("momentum", (scheduler_params or {}).get("momentum", 0.9))
        return torch.optim.SGD(params, lr=lr, momentum=momentum)
    raise ValueError(f"Unknown optimizer {optimizer_type!r}")


def clip_by_global_norm(grads, max_norm: float) -> None:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)`` with
    ``norm`` the global L2 norm: optax's rule, without the 1e-6 that
    ``torch.nn.utils.clip_grad_norm_`` adds. Stays on the device."""
    grads = list(grads)
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)


PIXEL_LOSSES: Dict[str, Callable] = {
    "l1": lambda a, b: (a - b).abs().mean(),
    "l2": lambda a, b: ((a - b) ** 2).mean(),
    "mse": lambda a, b: ((a - b) ** 2).mean(),
    "charbonnier": lambda a, b: torch.sqrt((a - b) ** 2 + 1e-6).mean(),
}


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
        self.schedule = build_schedule(lr, scheduler, scheduler_params)
        self._optimizer = None  # built at the first train step or load
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

    def compute_losses(self, sr, batch, aux: Dict[str, Any]) -> Dict[str, Any]:
        pixel = PIXEL_LOSSES[self.loss_type](sr.float(), batch["hr"].float())
        losses = {"train-loss": pixel}
        losses.update(aux)
        return losses

    def transform_grads(self, grads: Dict[str, torch.Tensor], state, batch):
        """Hook for gradient surgery inside the train step: takes and
        returns {parameter name: gradient}. Default: identity."""
        return grads

    def transform_updates(self, updates: Dict[str, torch.Tensor], state, batch):
        """Hook for masking optimizer updates inside the train step: takes
        and returns {parameter name: new value - old value}. Default:
        identity (and then no copy of the parameters is made)."""
        return updates

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
        self._optimizer = None  # fresh weights, fresh optimizer state
        return self._own_state()

    def num_parameters(self, state: TrainState) -> int:
        return sum(t.numel() for t in state.params.values())

    # -- train -------------------------------------------------------------

    def optimizer(self) -> torch.optim.Optimizer:
        if self._optimizer is None:
            self._optimizer = build_optimizer(
                self.module.parameters(), self.lr, self.optimizer_type,
                scheduler_params=self.scheduler_params,
                optimizer_params=self.optimizer_params)
        return self._optimizer

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """One optimizer step: gradients, clip, the schedule's lr at step
        ``state.step``, update. Returns the next state (the same parameter
        tensors, updated in place) and the losses as device scalars."""
        self._use_params(state.params)
        opt = self.optimizer()
        batch = {k: (torch.as_tensor(v, device=self.device)
                     if k in ("lr", "hr", "mask", "metadata") else v)
                 for k, v in batch.items()}
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            sr, aux, new_extra = self.apply(state.params, batch, train=True,
                                            extra=state.extra)
            lbatch = batch
            if self.loss_masking and "mask" in batch:
                # a pixel counts only when EVERY channel of the mask is
                # non-black; SR and HR are masked before the loss
                m = (batch["mask"] != 0).all(dim=-1, keepdim=True).to(sr.dtype)
                sr = sr * m
                lbatch = dict(batch)
                lbatch["hr"] = batch["hr"] * m
            losses = self.compute_losses(sr, lbatch, aux)
            losses["train-loss"].backward()
        named = {k: p for k, p in self.module.named_parameters()
                 if p.grad is not None}
        grads = {k: p.grad for k, p in named.items()}
        changed = self.transform_grads(grads, state, batch)
        if changed is not grads:
            for k, p in named.items():
                p.grad = changed[k]
            grads = changed
        if self.grad_clip is not None:
            clip_by_global_norm(grads.values(), float(self.grad_clip))
        lr = float(self.schedule(int(state.step)))
        for group in opt.param_groups:
            group["lr"] = lr
        hooked = type(self).transform_updates is not BaseHandler.transform_updates
        if hooked:
            before = {k: p.detach().clone() for k, p in named.items()}
        opt.step()
        if hooked:
            with torch.no_grad():
                updates = self.transform_updates(
                    {k: p.detach() - before[k] for k, p in named.items()},
                    state, batch)
                for k, p in named.items():
                    p.copy_(before[k] + updates[k])
        new_state = TrainState(step=int(state.step) + 1, params=state.params,
                               extra=state.extra if new_extra is None else new_extra)
        return new_state, {k: v.detach() for k, v in losses.items()}

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
            "optimizer": (None if self._optimizer is None
                          else self._optimizer.state_dict()),
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
        # minimal checkpoints carry no optimizer state, and a caller may
        # skip it to load weights trained under another optimizer config:
        # both start from a fresh optimizer
        self._optimizer = None
        if not skip_optimizer_load and loaded.get("optimizer") is not None:
            self.optimizer().load_state_dict(loaded["optimizer"])
        return self._own_state(int(loaded["step"]), loaded.get("extra")), epoch
