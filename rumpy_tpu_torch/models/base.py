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
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
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


def optimizer_update(opt: torch.optim.Optimizer, params, loss, clip: Optional[float] = None,
                     lr: Optional[float] = None) -> None:
    """One update of ``opt`` from ``loss``: gradients (set to none first,
    zeros where a parameter got none, as optax updates every leaf), optax's
    global-norm clipping where ``clip`` is set, the lr where given, the
    step."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if clip is not None:
        clip_by_global_norm([p.grad for p in params], float(clip))
    if lr is not None:
        for group in opt.param_groups:
            group["lr"] = float(lr)
    opt.step()


# ---------------------------------------------------------------------------
# Optax state of JAX-written checkpoints
# ---------------------------------------------------------------------------

# The JAX package's optimizer (``rumpy_tpu/models/base.py::build_optimizer``)
# is ``optax.chain([clip_by_global_norm,] opt)``; flax serialises a chain as
# a dict keyed "0", "1", .... Each torch optimizer's ``opt`` chain, entry by
# entry: the fields of its moment state, LR (``scale_by_learning_rate``: {}
# at a constant lr, {count} under a schedule) or a stateless transform's {}.
LR = "lr"
OPTAX_CHAINS = (  # AdamW before Adam, its base class
    (torch.optim.AdamW, "adamw", ({"count", "mu", "nu"}, set(), LR)),
    (torch.optim.Adam, "adam", ({"count", "mu", "nu"}, LR)),
    (torch.optim.RMSprop, "rmsprop", ({"nu"}, LR, set())),
    (torch.optim.SGD, "sgd", ({"trace"}, LR)),
)
# optax moment -> the torch optimizer state that holds it
TORCH_MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer"}


def _torch_field(kind: str, field: str) -> str:
    return "square_avg" if (kind, field) == ("rmsprop", "nu") else TORCH_MOMENTS[field]


class OptaxTarget(NamedTuple):
    """One of a handler's optimizers as the JAX package keeps it."""
    optimizer: Callable[[], torch.optim.Optimizer]  # builds or returns it
    part: Optional[str]  # the ``network`` subtree it updates; None: all of it
    clip: bool  # whether its chain starts with the global-norm clip
    name: Optional[str] = None  # the handler's name of its step count


def _optax_chain(opt: torch.optim.Optimizer):
    for cls, name, chain in OPTAX_CHAINS:
        if isinstance(opt, cls):
            return name, chain
    raise TypeError(f"no optax counterpart of {type(opt).__name__}")


def _scalar_dtype() -> torch.dtype:
    """The dtype torch gives a non-fused optimizer's ``step``."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32


def parse_optax_state(tree, opt: torch.optim.Optimizer, clip: bool, where: str):
    """The moment trees ({"mu": ..., "nu": ...}), the moment state's count,
    the schedule's count (None where the chain has none) and the moment
    state's path below ``where``, of one optax chain state as flax
    serialised it. Raises, naming the path, where the
    tree is not the chain of ``opt`` (with the clip where ``clip``)."""
    kind, chain = _optax_chain(opt)

    def keys(node, path):
        if not isinstance(node, Mapping):
            raise ValueError(f"{where}{path}: expected a dict of optax state, "
                             f"found {type(node).__name__}")
        return set(node)

    def entries(node, n, path, what):
        want = {str(i) for i in range(n)}
        if keys(node, path) != want:
            raise ValueError(f"{where}{path}: {what} has entries {sorted(want)}, "
                             f"the checkpoint {sorted(node)}")
        return [node[str(i)] for i in range(n)]

    outer = entries(tree, 2 if clip else 1, "",
                    f"the handler's chain ({'clip, ' if clip else ''}{kind})")
    if clip and keys(outer[0], "/0"):
        raise ValueError(f"{where}/0: expected the clip's empty state, found {sorted(outer[0])}")
    inner_path = "/1" if clip else "/0"
    inner = entries(outer[-1], len(chain), inner_path, kind)
    moments = sched = None
    for i, (want, node) in enumerate(zip(chain, inner)):
        path, got = f"{inner_path}/{i}", keys(node, f"{inner_path}/{i}")
        if want == LR:
            if got not in (set(), {"count"}):
                raise ValueError(f"{where}{path}: expected the learning rate's state "
                                 f"({{}} or {{count}}), found {sorted(got)}")
            sched = int(np.asarray(node["count"])) if got else None
        elif got != want:
            raise ValueError(f"{where}{path}: {kind} expects {sorted(want)}, "
                             f"the checkpoint holds {sorted(got)}")
        elif want:
            moments = node
    count = int(np.asarray(moments["count"])) if "count" in moments else None
    return ({k: v for k, v in moments.items() if k != "count"}, count, sched,
            f"{inner_path}/0")


@torch.no_grad()
def set_optax_moments(opt: torch.optim.Optimizer, moments: Dict[str, Dict[str, torch.Tensor]],
                      names: Dict[int, str], step: int, where: str) -> None:
    """The torch state of every parameter of ``opt`` that takes a gradient:
    ``moments`` {optax field: {parameter name: tensor}} as the torch
    moments, each on its parameter's device, in its dtype and memory format,
    and ``step`` as a CPU scalar tensor, as torch makes it for a non-fused
    optimizer (a CUDA step would be read back on every update). SGD's
    momentum buffer is left unset before the first update, where torch's
    first step then starts from the gradient, as optax's trace from zeros
    does."""
    have = set.intersection(*(set(m) for m in moments.values()))
    params = [p for g in opt.param_groups for p in g["params"] if p.requires_grad]
    keys = [names[id(p)] for p in params]
    missing = sorted(set(keys) - have)
    if missing:
        raise ValueError(f"{where}: no optax state for the port parameters {missing}")
    unused = sorted(have - set(keys))
    if unused:
        raise ValueError(f"{where}: optax state for {unused}, which this optimizer "
                         "does not update")
    kind, _ = _optax_chain(opt)
    for group in opt.param_groups:
        for p in group["params"]:
            if not p.requires_grad:
                continue
            state = {}
            if kind != "sgd":
                state["step"] = torch.tensor(float(step), dtype=_scalar_dtype())
            elif step == 0 or not group["momentum"]:
                continue
            for field, by_name in moments.items():
                state[_torch_field(kind, field)] = torch.empty_like(
                    p, memory_format=torch.preserve_format).copy_(by_name[names[id(p)]])
            opt.state[p] = state


def optax_state_tree(opt: torch.optim.Optimizer, module: nn.Module, clip: bool,
                     scheduled: bool, count: int) -> Dict[str, Any]:
    """The inverse of :func:`parse_optax_state` and
    :func:`set_optax_moments`: ``opt``'s state over ``module``'s parameters
    as the JAX package's optax chain state, nested dicts of numpy arrays in
    flax's layout (the schedule and moment counts ``count``), for a
    handler whose ``network`` tree is ``module``'s own."""
    from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict
    kind, chain = _optax_chain(opt)
    named = dict(module.named_parameters())

    def moment(field):
        name = _torch_field(kind, field)
        return jax_tree_from_state_dict(
            {k: opt.state[p][name] if name in opt.state.get(p, {}) else torch.zeros_like(p)
             for k, p in named.items()}, module)

    c = np.asarray(count, np.int32)
    inner = {}
    for i, want in enumerate(chain):
        if want == LR:
            inner[str(i)] = {"count": c} if scheduled else {}
        else:
            inner[str(i)] = {f: (c if f == "count" else moment(f)) for f in want}
    return {"0": {}, "1": inner} if clip else {"0": inner}


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
    # A parameter the loss does not reach gets a zero gradient, not None,
    # in a train step: optax advances every parameter's moments and step
    # count, while torch.optim.Adam skips a parameter without a gradient,
    # so its bias correction would fall behind.
    missing_grads_as_zeros: bool = False

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
        # 4-D parameters channels_last (``Module.to(memory_format=...)``
        # refuses the 5-D kernel of a conv3d)
        self.module = self.build_module(**model_kwargs).to(self.device)._apply(
            lambda t: t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t
        ).eval()
        self.schedule = build_schedule(lr, scheduler, scheduler_params)
        self._optimizer = None  # built at the first train step or load
        self._state_params = None
        # Optional batch transform run on the device at the start of every
        # train step (the online degradation pipeline: hr -> lr, metadata),
        # drawing from this generator; its state is saved with the
        # checkpoint, so that a resumed run continues its stream.
        self.input_fn = None
        self.rng = torch.Generator(device=self.device).manual_seed(seed)

    def set_input_pipeline(self, fn) -> None:
        """``fn(generator, batch) -> batch``, run on the device without
        gradients before the forward pass of every train step."""
        self.input_fn = fn

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
        every device), and the input pipeline's generator seeded anew."""
        seed = self.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        self.rng.manual_seed(seed)
        for m in self.module.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(gen)
        self._optimizer = None  # fresh weights, fresh optimizer state
        return self._own_state()

    def num_parameters(self, state: TrainState) -> int:
        return sum(t.numel() for t in state.params.values())

    # -- train -------------------------------------------------------------

    def trainable_parameters(self):
        """The parameters the optimizer updates: all of the module's."""
        return self.module.parameters()

    def optimizer(self) -> torch.optim.Optimizer:
        if self._optimizer is None:
            self._optimizer = build_optimizer(
                self.trainable_parameters(), self.lr, self.optimizer_type,
                scheduler_params=self.scheduler_params,
                optimizer_params=self.optimizer_params)
        return self._optimizer

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """One optimizer step: gradients, clip, the schedule's lr at step
        ``state.step``, update. Returns the next state (the same parameter
        tensors, updated in place) and the losses as device scalars."""
        self._use_params(state.params)
        batch = {k: (torch.as_tensor(v, device=self.device)
                     if k in ("lr", "hr", "mask", "metadata") else v)
                 for k, v in batch.items()}
        if self.input_fn is not None:
            with torch.no_grad():
                batch = self.input_fn(self.rng, batch)
        new_extra = state.extra

        def loss_fn():
            nonlocal new_extra
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
            return self.compute_losses(sr, lbatch, aux)

        losses = self._optimize(state, batch, loss_fn)
        new_state = TrainState(step=int(state.step) + 1, params=state.params,
                               extra=state.extra if new_extra is None else new_extra)
        return new_state, losses

    def _optimize(self, state: TrainState, batch, loss_fn) -> Dict[str, torch.Tensor]:
        """The update of one train step: ``loss_fn()`` (losses, its
        "train-loss" differentiated) under autograd, the gradient hook,
        clipping, the schedule's lr at ``state.step``, the optimizer step,
        the update hook. Returns the losses, detached, on the device."""
        opt = self.optimizer()
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            losses = loss_fn()
            losses["train-loss"].backward()
        if self.missing_grads_as_zeros:
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
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
            # multi-tensor ops: a few launches for all parameters, not four
            # a parameter (x * 1 keeps every value's bits, -0.0 included)
            params = [p.detach() for p in named.values()]
            before = torch._foreach_mul(params, 1.0)
        opt.step()
        if hooked:
            with torch.no_grad():
                updates = self.transform_updates(
                    dict(zip(named, torch._foreach_sub(params, before))), state, batch)
                torch._foreach_add_(before, [updates[k] for k in named])
                torch._foreach_copy_(params, before)
        return {k: v.detach() for k, v in losses.items()}

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

    def optimizer_state(self):
        """The optimizer state a checkpoint holds: None before the first
        step (a handler with several optimizers returns them by name)."""
        return None if self._optimizer is None else self._optimizer.state_dict()

    def load_optimizer_state(self, saved) -> None:
        """Fresh optimizer state, then a checkpoint's ``saved`` state where
        given."""
        self._optimizer = None
        if saved is not None:
            self.optimizer().load_state_dict(saved)

    def save_model(self, state: TrainState, model_save_dir: str, epoch: int,
                   minimal: bool = False) -> str:
        path = ckpt.checkpoint_path(model_save_dir, epoch)
        payload = {
            "network": {k: v.detach().cpu() for k, v in state.params.items()},
            "extra": state.extra,
            "step": int(state.step),
            "rng": self.rng.get_state(),
            "optimizer": self.optimizer_state(),
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
        path = ckpt.checkpoint_path(model_save_dir, epoch)
        loaded = ckpt.load_checkpoint(path)
        if ckpt.checkpoint_format(path) == "flax":
            return self._load_jax_checkpoint(loaded, path, skip_optimizer_load), epoch
        with torch.no_grad():
            self.module.load_state_dict(loaded["network"])
        state_bytes = loaded.get("rng")
        # a generator's state is its device's: the card's does not fit a CPU
        # generator (nor the reverse), which then keeps its seed, and says so
        if state_bytes is not None:
            if state_bytes.numel() == self.rng.get_state().numel():
                self.rng.set_state(state_bytes)
            else:
                print(f"{path}: the saved generator state is another device type's; "
                      f"the {self.rng.device.type} generator keeps its seed")
        # minimal checkpoints carry no optimizer state, and a caller may
        # skip it to load weights trained under another optimizer config:
        # both start from a fresh optimizer
        self.load_optimizer_state(None if skip_optimizer_load else loaded.get("optimizer"))
        return self._own_state(int(loaded["step"]), loaded.get("extra")), epoch

    def _load_jax_checkpoint(self, loaded, path: str,
                             skip_optimizer_load: bool) -> TrainState:
        """A checkpoint the JAX package wrote: its flax params through the
        weight bridge (``utils/weights.py``, which raises on any unused or
        missing leaf; ``_jax_state_dict``, where a handler also maps trees
        of its ``extra``, such as BatchNorm statistics) and its step; the
        rest of its ``extra`` is not kept. Its ``rng`` is a JAX key, which a
        torch generator cannot continue, so the handler's generator keeps
        its seed. Its optax state goes onto the handler's torch optimizers
        (``_load_optax_state``) unless the caller skips it (evaluation, or a
        fine-tune from fresh optimizer state); a minimal checkpoint has
        none, and starts fresh."""
        with torch.no_grad():
            self.module.load_state_dict(self._jax_state_dict(loaded))
        self.load_optimizer_state(None)
        if loaded.get("optimizer") is not None and not skip_optimizer_load:
            self._load_optax_state(loaded, path)
        return self._own_state(int(np.asarray(loaded["step"])))

    def optax_targets(self) -> Dict[Optional[str], OptaxTarget]:
        """The handler's optimizers by their names in the JAX package's
        ``opt_state`` (None: that state is the one optax chain)."""
        return {None: OptaxTarget(self.optimizer, None, self.grad_clip is not None)}

    def set_optax_counts(self, counts: Dict[Optional[str], int]) -> None:
        """Hook for a handler that keeps each optimizer's schedule position
        itself: {``OptaxTarget.name``: the optax count}. The base handler's
        position is the checkpoint's step."""

    def _load_optax_state(self, loaded, path: str) -> None:
        """A JAX checkpoint's optax state onto the handler's torch
        optimizers: each optimizer's moments leaf by leaf through the weight
        bridge, its count as torch's ``step`` (RMSprop and SGD keep none:
        the schedule's count, else the checkpoint's step). Raises, naming
        the path, where the state does not fit the handler's optimizers."""
        targets, state = self.optax_targets(), loaded["optimizer"]
        if None not in targets:
            unknown = sorted(set(state) - set(targets))
            if unknown:
                raise ValueError(f"{path}: optimizer/{unknown[0]} is none of this handler's "
                                 f"optimizers {sorted(targets)}")
        trees = {None: state} if None in targets else state
        names = {id(p): k for k, p in self.module.named_parameters()}
        counts = {}
        for key, tree in trees.items():
            target = targets[key]
            where = f"{path}: optimizer" + ("" if key is None else f"/{key}")
            opt = target.optimizer()
            moments, count, sched, below = parse_optax_state(tree, opt, target.clip, where)
            position = next((c for c in (sched, count) if c is not None),
                            int(np.asarray(loaded["step"])))
            try:
                mapped = self._jax_moments(loaded, moments, target.part)
            except (KeyError, ValueError) as e:
                raise ValueError(f"{where}{below}/{'|'.join(sorted(moments))} does not fit "
                                 f"{type(self).__name__}'s parameters: {e}") from e
            set_optax_moments(opt, mapped, names,
                              count if count is not None else position, where)
            counts[target.name] = position
        self.set_optax_counts(counts)

    def _jax_moments(self, loaded, moments: Dict[str, Any],
                     part: Optional[str]) -> Dict[str, Dict[str, torch.Tensor]]:
        """{optax field: {port parameter name: tensor}} for moment trees
        shaped like the ``network`` subtree ``part`` (None: all of it): each
        goes through ``_jax_state_dict`` in that subtree's place, so a
        handler's own split of its tree holds for its optimizer state too.
        The names kept are those the subtree's leaves land on, found by
        sending a copy of the subtree with every leaf +inf the same way."""
        def through_bridge(tree):
            network = tree if part is None else {**loaded["network"], part: tree}
            return self._jax_state_dict({**loaded, "network": network})

        def inf(tree):
            return ({k: inf(v) for k, v in tree.items()} if isinstance(tree, Mapping)
                    else np.full(np.shape(tree), np.inf, np.float32))

        probe = through_bridge(inf(next(iter(moments.values()))))
        ours = {k for k, v in probe.items() if v.numel() and torch.isposinf(v).all()}
        out = {}
        for field_name, tree in moments.items():
            mapped = through_bridge(tree)
            out[field_name] = {k: mapped[k] for k in ours}
        return out

    def _jax_state_dict(self, loaded) -> Dict[str, torch.Tensor]:
        """The module's state_dict from a JAX-written checkpoint's trees: its
        params and, where the JAX handler keeps them in
        ``extra.vars.batch_stats`` (SPARNet, ELAN, WaveletSRNet), the
        BatchNorm running statistics."""
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        stats = ((loaded.get("extra") or {}).get("vars") or {}).get("batch_stats")
        return state_dict_from_jax(loaded["network"], self.module, batch_stats=stats or None)
