"""IKC: iterative kernel correction.

Port of ``rumpy_tpu/models/ikc.py``. Three child networks in one module:
SFTMD (``sr_model``), a kernel-code Predictor and a Corrector that refines
the code from the SR output, each with its own Adam optimizer.

Training:
  * while ``curr_epoch < sftmd_pretrain_epochs`` only SFTMD trains, on the
    true kernel code (L1);
  * after: the Predictor takes one step (MSE against the true code), then
    ``correction_steps`` times SFTMD runs without a gradient on the current
    code and the Corrector takes one step (MSE), its output the next code,
    all inside one ``train_batch``; ``train-loss`` is the smallest of the
    per-iteration SFTMD losses.

Evaluation dispatches on each call: in the pretrain phase, with metadata,
SFTMD on the true code; otherwise blind, the Predictor's code corrected
``correction_steps`` times. Best-epoch selection ignores the pretrain phase
(``handler_metadata``'s ``best_epoch_cutoff``). Every layer is a cuDNN conv
or a PyTorch op: the JAX package computes none of them in a Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.base import BaseHandler, OptaxTarget, TrainState, build_optimizer
from rumpy_tpu_torch.models.common import Conv, Linear, tile_maps
from rumpy_tpu_torch.models.contrastive import device_batch
from rumpy_tpu_torch.models.sftmd_variants import SFTMD
from rumpy_tpu_torch.parallel import mesh as mesh_mod
from rumpy_tpu_torch.registry import register_model

CHILDREN = ("sr_model", "predictor", "corrector")


def _lrelu(v):
    return F.leaky_relu(v, 0.2)


class Predictor(nn.Module):
    """LR -> kernel code: six 5x5 convs (stride 2 at the fourth, padding 2
    on every side even there), each followed by LeakyReLU(0.2), then a
    global average pool."""

    STRIDES = (1, 1, 1, 2, 1, 1)

    def __init__(self, code_length: int = 10, nf: int = 64, in_nc: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ins = (in_nc,) + (nf,) * 5
        outs = (nf,) * 5 + (code_length,)
        self.convs = nn.ModuleList(Conv(i, o, 5, dtype=dtype, stride=s)
                                   for i, o, s in zip(ins, outs, self.STRIDES))

    def forward(self, x):
        for conv in self.convs:
            x = _lrelu(conv(x))
        return x.mean(dim=(2, 3))

    def flax_children(self):
        return [(f"convs.{i}", (f"TConv_{i}",), c) for i, c in enumerate(self.convs)]


class Corrector(nn.Module):
    """(SR, code) -> refined code: seven 5x5 convs of the SR (stride 2 at
    the second and fourth), two dense layers of the code tiled over the
    features, three 1x1 convs of their concat, a global pool: the code plus
    that correction."""

    STRIDES = (1, 2, 1, 2, 1, 1, 1)

    def __init__(self, code_length: int = 10, nf: int = 64, in_nc: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(Conv(in_nc if i == 0 else nf, nf, 5, dtype=dtype, stride=s)
                                   for i, s in enumerate(self.STRIDES))
        self.dense = nn.ModuleList([Linear(code_length, nf, dtype=dtype),
                                    Linear(nf, nf, dtype=dtype)])
        self.mix = nn.ModuleList([Conv(2 * nf, 2 * nf, 1, dtype=dtype),
                                  Conv(2 * nf, nf, 1, dtype=dtype),
                                  Conv(nf, code_length, 1, dtype=dtype)])

    def forward(self, sr, code):
        x = sr
        for conv in self.convs:
            x = _lrelu(conv(x))
        c = _lrelu(self.dense[1](_lrelu(self.dense[0](code))))
        mid = torch.cat([x, tile_maps(c, *x.shape[2:]).to(x.dtype)], dim=1)
        mid = _lrelu(self.mix[1](_lrelu(self.mix[0](mid))))
        return self.mix[2](mid).mean(dim=(2, 3)) + code

    def flax_children(self):
        n = len(self.convs)
        return ([(f"convs.{i}", (f"TConv_{i}",), c) for i, c in enumerate(self.convs)]
                + [(f"dense.{i}", (f"TDense_{i}",), d) for i, d in enumerate(self.dense)]
                + [(f"mix.{i}", (f"TConv_{n + i}",), c) for i, c in enumerate(self.mix)])


class IKCModule(nn.Module):
    """The three children under their flax names."""

    def __init__(self, sr_model: nn.Module, predictor: nn.Module, corrector: nn.Module):
        super().__init__()
        self.sr_model = sr_model
        self.predictor = predictor
        self.corrector = corrector

    def forward(self, x, code):
        return self.sr_model(x, code)

    def flax_children(self):
        return [(name, (name,), getattr(self, name)) for name in CHILDREN]


def _mse(a, b):
    return ((a.float() - b.float()) ** 2).mean()


@register_model("ikc")
class IKCHandler(BaseHandler):
    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"
    uses_metadata = True

    def __init__(self, sftmd_pretrain_epochs=5, correction_steps=7, code_length=10,
                 num_features=64, num_blocks=16, force_final_eval_iter=True,
                 sft_type="standard", **kwargs):
        self.sftmd_pretrain_epochs = sftmd_pretrain_epochs
        self.correction_steps = correction_steps
        self.code_length = code_length
        self.force_final_eval_iter = force_final_eval_iter
        self.curr_epoch = 0
        self._optimizers: Dict[str, torch.optim.Optimizer] = {}
        super().__init__(num_features=num_features, num_blocks=num_blocks,
                         sft_type=sft_type, **kwargs)

    def set_epoch(self, epoch: int) -> None:
        self.curr_epoch = epoch

    def build_module(self, num_features, num_blocks, sft_type):
        return IKCModule(
            SFTMD(scale=self.scale, in_nc=self.in_features, input_para=self.code_length,
                  num_features=num_features, num_blocks=num_blocks, sft_type=sft_type,
                  dtype=self.dtype),
            Predictor(code_length=self.code_length, in_nc=self.in_features, dtype=self.dtype),
            Corrector(code_length=self.code_length, dtype=self.dtype))

    # -- optimizers: one Adam a child, at the handler's lr -------------------

    def child_optimizer(self, name: str) -> torch.optim.Optimizer:
        if name not in self._optimizers:
            self._optimizers[name] = build_optimizer(
                getattr(self.module, name).parameters(), self.lr)
        return self._optimizers[name]

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        self._optimizers = {}
        return super().init_state(seed)

    def optimizer_state(self):
        if not self._optimizers:
            return None
        return {name: opt.state_dict() for name, opt in self._optimizers.items()}

    def load_optimizer_state(self, saved) -> None:
        self._optimizers = {}
        for name, sd in (saved or {}).items():
            self.child_optimizer(name).load_state_dict(sd)

    def optax_targets(self):
        """The JAX handler's ``child_tx``, one a child."""
        return {name: OptaxTarget(lambda name=name: self.child_optimizer(name), name, False)
                for name in ("sr_model", "predictor", "corrector")}

    def _step(self, name: str, loss_fn):
        """One update of child ``name``: ``loss_fn()`` -> (loss, output),
        its gradient, averaged over the data-parallel group with the loss,
        the child's optimizer step. Returns both, detached."""
        opt = self.child_optimizer(name)
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, out = loss_fn()
            loss.backward()
        loss = loss.detach()
        mesh_mod.mean_over_group([p.grad for g in opt.param_groups for p in g["params"]
                                  if p.grad is not None] + [loss])
        opt.step()
        return loss, out.detach()

    # -- train ---------------------------------------------------------------

    def _sr(self, lr, code):
        return self.module.sr_model(lr.permute(0, 3, 1, 2), code).permute(0, 2, 3, 1)

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        self._use_params(state.params)
        batch = device_batch(batch, self.device)
        if self.input_fn is not None:  # the online degradation pipeline
            with torch.no_grad():
                batch = self.input_fn(self.rng, batch)
        lr, hr = batch["lr"], batch["hr"]
        code = batch["metadata"].float()
        mod = self.module
        if self.curr_epoch < self.sftmd_pretrain_epochs:
            loss, _ = self._step("sr_model", lambda: (
                (self._sr(lr, code).float() - hr.float()).abs().mean(), code))
            losses = {"train-loss": loss, "predictor-loss": torch.zeros((), device=self.device)}
        else:
            losses = {}
            p_loss, est = self._step("predictor", lambda: (
                lambda p: (_mse(p, code), p))(mod.predictor(lr.permute(0, 3, 1, 2))))
            losses["predictor-loss"] = p_loss
            s_losses = []
            for step in range(self.correction_steps):
                with torch.no_grad():
                    sr = self._sr(lr, est)
                s_loss = (sr.float() - hr.float()).abs().mean()
                c_loss, est = self._step("corrector", lambda: (
                    lambda c: (_mse(c, code), c))(mod.corrector(sr.permute(0, 3, 1, 2), est)))
                losses[f"sftmd_loss_{step}"] = s_loss
                losses[f"corrector_loss_{step}"] = c_loss
                s_losses.append(s_loss)
            mesh_mod.mean_over_group(s_losses)  # the global batch's, before the min
            losses["train-loss"] = torch.stack(s_losses).min()
        return TrainState(step=int(state.step) + 1, params=state.params,
                          extra=state.extra), losses

    # -- eval ----------------------------------------------------------------

    def run_eval(self, state: TrainState, batch) -> torch.Tensor:
        """The phase is read here, per call: in the pretrain phase with
        metadata SFTMD runs on the true code, else blind."""
        self._use_params(state.params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        meta = batch.get("metadata")
        with torch.inference_mode():
            if self.curr_epoch < self.sftmd_pretrain_epochs and meta is not None:
                return self._sr(lr, torch.as_tensor(meta, device=self.device).float())
            code = self.module.predictor(lr.permute(0, 3, 1, 2))
            for _ in range(self.correction_steps):
                sr = self._sr(lr, code)
                code = self.module.corrector(sr.permute(0, 3, 1, 2), code)
            return sr

    def apply(self, params, batch, train=False, rng=None, extra=None):
        """SFTMD on the batch's code (its ``metadata``)."""
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        code = torch.as_tensor(batch["metadata"], device=self.device).float()
        return self._sr(lr, code), {}, extra

    def handler_metadata(self):
        return {"best_epoch_cutoff": self.sftmd_pretrain_epochs,
                "correction_steps": self.correction_steps}
