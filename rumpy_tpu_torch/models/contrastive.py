"""Contrastive degradation encoders (MoCo / SupMoCo / WeakCon / SupCon)
and the direct degradation regressor.

Port of ``rumpy_tpu/models/contrastive.py``. The DASR encoder: six 3x3
convs with BatchNorm and LeakyReLU(0.1), global average pooling, a
two-layer projection MLP and an optional dropdown regression head. The
MoCo-family handlers keep the momentum (key) encoder as a second
``DASREncoder`` without gradients, and the negative queue, its pointer
and its label and vector side-queues as buffers of one module, so a
checkpoint holds the whole state and a run resumes bit for bit. A train
step is the momentum update (one foreach pass), the key forward, the
query forward and its contrast against the queue, the optimizer step and
the enqueue, all on the device, with no host sync.

Float details kept from the JAX package: normalization is ``v / (|v| +
1e-12)``; the products with the queue and the label matches are full
float32 (no TF32, whatever the process-wide flags); an empty queue slot's
label is -1 and matches no class; the two encoders' BatchNorm statistics
advance once each a step (the key forward the key encoder's); a divisor
is a true division (``device.true_div``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.device import true_div
from rumpy_tpu_torch.models.base import BaseHandler, TrainState
from rumpy_tpu_torch.models.common import BatchNorm, Conv, Linear
from rumpy_tpu_torch.registry import register_model
from rumpy_tpu_torch.utils.losses import full_f32_matmuls, supcon_loss

# (features, stride) of the six convs
DASR_SPEC = ((64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1))


def _lrelu(v):
    return F.leaky_relu(v, 0.1)


class DASREncoder(nn.Module):
    """DASR encoder on NCHW (channels_last) input. Its stride-2 convs pad
    one pixel on every side, as the JAX package's explicit (1, 1) padding
    does. BatchNorm follows flax (``models/common.py::BatchNorm``): batch
    statistics and a running-stat update with ``train=True``, the running
    statistics otherwise."""

    def __init__(self, dropdown_q: Optional[int] = None, out_dim: int = 256,
                 in_features: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        ins = (in_features,) + tuple(f for f, _ in DASR_SPEC[:-1])
        self.convs = nn.ModuleList(Conv(i, f, 3, dtype=dtype, stride=s)
                                   for i, (f, s) in zip(ins, DASR_SPEC))
        self.norms = nn.ModuleList(BatchNorm(f, dtype=dtype) for f, _ in DASR_SPEC)
        self.mlp = nn.ModuleList([Linear(256, 256, dtype=dtype),
                                  Linear(256, out_dim, dtype=dtype)])
        self.dropdown = (nn.ModuleList([Linear(out_dim, 64, dtype=dtype),
                                        Linear(64, 32, dtype=dtype),
                                        Linear(32, dropdown_q, dtype=dtype)])
                         if dropdown_q is not None else None)

    def forward(self, x, train: bool = False,
                update_stats: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns the pooled features (N, 256) and {"q": projection,
        "dropdown_q": the dropdown head's output, if any}. ``train``
        normalises by the batch's statistics and, with ``update_stats``,
        updates the running ones."""
        for conv, norm in zip(self.convs, self.norms):
            x = _lrelu(norm(conv(x), train, update_stats))
        fea = x.mean(dim=(2, 3))
        out = self.mlp[1](_lrelu(self.mlp[0](fea)))
        outputs = {"q": out}
        if self.dropdown is not None:
            d = _lrelu(self.dropdown[0](out))
            d = _lrelu(self.dropdown[1](d))
            outputs["dropdown_q"] = self.dropdown[2](d)
        return fea, outputs


def _normalize(v):
    """``v / (|v| + 1e-12)`` in float32 whatever ``v``'s type: the queue and
    the logits are float32, and a jitted bf16 step of the JAX package keeps
    this in excess precision too."""
    v = v.float()
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def softmax_cross_entropy_first(logits: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of ``logits`` (N, 1 + K) against class 0 (the
    positive), as optax's ``softmax_cross_entropy_with_integer_labels``
    computes it: shifted by the detached row maximum, log-sum-exp minus the
    label's logit."""
    shifted = logits - logits.max(dim=1, keepdim=True).values.detach()
    return (torch.log(torch.exp(shifted).sum(dim=1)) - shifted[:, 0]).mean()


def class_matches(labels: torch.Tensor, queue_labels: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """(N, K) float32, 1 where a batch label equals a queue slot's label:
    the JAX package's ``one_hot(labels, nc) @ one_hot(queue_labels, nc).T``
    with ``nc = num_classes + 1``, whose out-of-range labels (the -1 of an
    empty slot among them) are zero rows and match nothing."""
    valid = (labels >= 0) & (labels < num_classes + 1)
    return ((labels[:, None] == queue_labels[None, :]) & valid[:, None]).to(torch.float32)


def moco_logits(q: torch.Tensor, kp: torch.Tensor, queue: torch.Tensor, T: float,
                labels: Optional[torch.Tensor] = None,
                queue_labels: Optional[torch.Tensor] = None,
                num_classes: int = 0) -> torch.Tensor:
    """The MoCo logits (N, 1 + K) of the normalized query ``q`` (N, D)
    against its P keys ``kp`` (N, P, D) and the ``queue`` (K, D): the mean
    positive logit, then the negatives ``q . queue^T / T`` as a full
    float32 product. With ``labels`` (SupMoCo) the queue's entries of each
    query's class (``class_matches`` against ``queue_labels``) join the
    positives, their sum a full float32 product too."""
    p = kp.shape[1]
    l_pos = true_div((q[:, None, :] * kp).sum(dim=2), T).sum(dim=1)
    if labels is None:
        l_pos = true_div(l_pos, p).float()
    else:
        pos_y_q = class_matches(labels, queue_labels, num_classes)  # (N, K)
        with full_f32_matmuls():
            pos_f_q = pos_y_q @ queue  # (N, D)
        pos_q = true_div((q.float() * pos_f_q).sum(dim=1), T)
        l_pos = true_div(l_pos.float() + pos_q, p + pos_y_q.sum(dim=1))
    with full_f32_matmuls():
        l_neg = true_div(q.float() @ queue.T, T)
    return torch.cat([l_pos[:, None], l_neg], dim=1)


def enqueue(queue: torch.Tensor, ptr: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Write ``values`` (n, ...) into ``queue`` (K, ...) at the slots from
    ``ptr``, in place, with no host sync: the JAX package's
    ``dynamic_update_slice``, whose start is clamped to K - n."""
    n = values.shape[0]
    start = ptr.clamp(max=queue.shape[0] - n)
    idx = start + torch.arange(n, device=queue.device)
    queue.index_copy_(0, idx, values.to(queue.dtype))
    return queue


def check_queue_batch(K: int, n: int) -> None:
    if K % n != 0:
        raise ValueError(
            f"queue size K={K} must be a multiple of the global enqueue batch {n} "
            "(moco.py _dequeue_and_enqueue assert)")


@torch.no_grad()
def momentum_update(key_encoder: nn.Module, encoder: nn.Module, m: float) -> None:
    """``key = key * m + query * (1 - m)`` on the parameters (not the
    BatchNorm statistics), in one pass of foreach ops: the same float
    expression as the JAX package's, rounded after each product and the
    sum (``lerp`` is another expression)."""
    kp = list(key_encoder.parameters())
    qp = list(encoder.parameters())
    torch._foreach_mul_(kp, m)
    torch._foreach_add_(kp, torch._foreach_mul(qp, 1.0 - m))


def device_batch(batch, device):
    """The batch's arrays as tensors on ``device`` (lists, such as tags,
    as they are)."""
    return {k: v if isinstance(v, (list, str)) else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def _nhwc_to_nchw(x) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class MoCoModule(nn.Module):
    """The query encoder, the momentum (key) encoder, which takes no
    gradient, and the queue: its features, its pointer and the side-queues
    a handler asks for, as buffers."""

    def __init__(self, encoder_kwargs: Dict, K: int, proj_dim: int,
                 sides: Dict[str, torch.Tensor]):
        super().__init__()
        self.encoder = DASREncoder(**encoder_kwargs)
        self.key_encoder = DASREncoder(**encoder_kwargs).requires_grad_(False)
        self.register_buffer("queue", torch.zeros(K, proj_dim))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.int64))
        for name, t in sides.items():
            self.register_buffer(name, t)

    def forward(self, x, train: bool = False):
        return self.encoder(x, train=train)


def _prefixed(prefix: str, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}{k}": v for k, v in sd.items()}


@register_model("moco")
class MoCoHandler(BaseHandler):
    """Momentum-contrast degradation encoder: ``train_batch`` runs the
    momentum update, the key forward, the query forward and its queue
    contrast, the optimizer step and the enqueue on the device, with no
    host sync."""

    colorspace = "rgb"
    task = "regression"
    # extra-tree entries of a JAX checkpoint that map onto queue buffers
    QUEUE_SIDES: Tuple[str, ...] = ()

    def __init__(self, dim=256, K=8192, m=0.999, T=0.07, positives=1,
                 dropdown=None, contrastive_dropdown=False, **kwargs):
        self.dim = dim
        self.K = K
        self.m = m
        self.T = T
        self.positives = positives
        self.dropdown = dropdown
        self.contrastive_dropdown = contrastive_dropdown and dropdown
        # width of the vector contrasted and enqueued
        self.proj_dim = dropdown if self.contrastive_dropdown else dim
        super().__init__(**kwargs)

    def set_input_pipeline(self, fn) -> None:
        raise NotImplementedError(
            "contrastive handlers take query/key view batches, not raw HR batches: "
            "the regression trainer degrades the views (training/regression_trainer.py)")

    def queue_sides(self) -> Dict[str, torch.Tensor]:
        """The side-queues' initial values (none for MoCo)."""
        return {}

    def build_module(self, **kw):
        enc = dict(dropdown_q=self.dropdown, out_dim=self.dim,
                   in_features=self.in_features, dtype=self.dtype)
        return MoCoModule(enc, self.K, self.proj_dim, self.queue_sides())

    def trainable_parameters(self):
        return self.module.encoder.parameters()

    @torch.no_grad()
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Fresh encoder weights, the key encoder a copy of them (BatchNorm
        statistics too), a queue of normalized N(0, 1) rows from the seed,
        its pointer at 0 and the side-queues at their initial values."""
        state = super().init_state(seed)
        mod = self.module
        mod.key_encoder.load_state_dict(mod.encoder.state_dict())
        gen = torch.Generator().manual_seed((self.seed if seed is None else seed) + 1)
        mod.queue.copy_(_normalize(torch.randn(mod.queue.shape, generator=gen)))
        mod.queue_ptr.zero_()
        for name, t in self.queue_sides().items():
            getattr(mod, name).copy_(t)
        return state

    # -- contrast --------------------------------------------------------

    def _proj(self, outputs):
        return outputs["dropdown_q"] if self.contrastive_dropdown else outputs["q"]

    def compute_logits(self, q, k, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """MoCo logits (N, 1 + K) and the keys to enqueue."""
        kp = k.reshape(q.shape[0], self.positives, self.proj_dim)
        return moco_logits(q, kp, self.module.queue, self.T), kp[:, 0]

    def enqueue_sides(self, batch, ptr) -> None:
        """Writes the batch's side-queue entries at ``ptr`` (none for MoCo)."""

    def extra_losses(self, outputs, batch) -> Dict[str, torch.Tensor]:
        return {}

    # -- train -----------------------------------------------------------

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        self._use_params(state.params)
        batch = device_batch(batch, self.device)
        # K must divide evenly by the enqueue batch, or the writes and the
        # pointer fall out of step
        check_queue_batch(self.K, batch["image_query"].shape[0])
        mod = self.module
        # the momentum update from the parameters before this step's update
        momentum_update(mod.key_encoder, mod.encoder, self.m)
        with torch.no_grad():
            _, k_out = mod.key_encoder(_nhwc_to_nchw(batch["image_key"]), train=True)
            k = _normalize(self._proj(k_out))
        side = {}

        def loss_fn():
            _, out = mod.encoder(_nhwc_to_nchw(batch["image_query"]), train=True)
            q = _normalize(self._proj(out))
            logits, side["enqueue"] = self.compute_logits(q, k, batch)
            loss = softmax_cross_entropy_first(logits)
            losses = {"train-loss": loss, "contrastive-loss": loss}
            losses.update(self.extra_losses(out, batch))
            total = loss
            for name, v in losses.items():
                if name not in ("train-loss", "contrastive-loss"):
                    total = total + v
            losses["train-loss"] = total
            return losses

        losses = self._optimize(state, batch, loss_fn)
        with torch.no_grad():
            enq = side["enqueue"].detach()
            ptr = mod.queue_ptr.clone()
            enqueue(mod.queue, ptr, enq)
            self.enqueue_sides(batch, ptr)
            mod.queue_ptr.copy_((ptr + enq.shape[0]) % self.K)
        return TrainState(step=int(state.step) + 1, params=state.params,
                          extra=state.extra), losses

    # -- eval ------------------------------------------------------------

    def apply(self, params, batch, train=False, rng=None, extra=None):
        """The pooled features (N, 256) of ``batch["lr"]``."""
        self._use_params(params)
        fea, _ = self.module.encoder(_nhwc_to_nchw(
            torch.as_tensor(batch["lr"], device=self.device)), train=train)
        return fea, {}, extra

    def run_embedding(self, state: TrainState, images, get_q: bool = False):
        """The pooled features of NHWC ``images`` by the query encoder with
        its running statistics (and its projection, with ``get_q``)."""
        self._use_params(state.params)
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images)
                                else images, device=self.device, dtype=torch.float32)
            fea, out = self.module.encoder(_nhwc_to_nchw(x), train=False)
        return (fea, out["q"]) if get_q else fea

    # -- the JAX package's state -------------------------------------------

    def _jax_state_dict(self, loaded) -> Dict[str, torch.Tensor]:
        """A MoCo-family checkpoint of the JAX package, whole: ``network``
        and ``extra.q_bstats`` onto the query encoder, ``extra.key_params``
        and ``k_bstats`` onto the key encoder, and the queue, its pointer
        and side-queues onto the buffers."""
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        extra = loaded.get("extra") or {}
        mod = self.module
        sd = _prefixed("encoder.", state_dict_from_jax(
            loaded["network"], mod.encoder, batch_stats=extra.get("q_bstats") or None))
        sd.update(_prefixed("key_encoder.", state_dict_from_jax(
            extra["key_params"], mod.key_encoder, batch_stats=extra.get("k_bstats") or None)))
        for name in ("queue", "queue_ptr") + self.QUEUE_SIDES:
            sd[name] = torch.as_tensor(np.array(extra[name])).to(getattr(mod, name).dtype)
        missing = sorted(set(mod.state_dict()) - set(sd))
        if missing:  # a checkpoint without BatchNorm statistics keeps these
            sd.update({k: mod.state_dict()[k] for k in missing})
        return sd

    def jax_trees(self, state: TrainState) -> Dict[str, Any]:
        """The inverse bridge: {"network": params, "extra": {...}} as the
        JAX package's MoCo-family state holds them (nested dicts of numpy
        arrays), for ``flax.serialization.from_state_dict``."""
        from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict
        self._use_params(state.params)
        mod = self.module

        def trees(enc):
            sd = enc.state_dict()
            return (jax_tree_from_state_dict(sd, enc, "params"),
                    jax_tree_from_state_dict(sd, enc, "batch_stats"))

        params, q_stats = trees(mod.encoder)
        key_params, k_stats = trees(mod.key_encoder)
        extra = {"key_params": key_params, "q_bstats": q_stats, "k_bstats": k_stats,
                 "queue": mod.queue.cpu().numpy().copy(),
                 "queue_ptr": np.asarray(int(mod.queue_ptr), np.int32)}
        for name in self.QUEUE_SIDES:
            buf = getattr(mod, name).cpu().numpy()
            extra[name] = buf.astype(np.int32) if name == "queue_labels" else buf.copy()
        return {"network": params, "extra": extra}


@register_model("supmoco")
class SupMoCoHandler(MoCoHandler):
    """Supervised MoCo: positives from the same degradation class, in the
    batch and in the queue through a label side-queue."""

    QUEUE_SIDES = ("queue_labels",)

    def __init__(self, num_classes=0, positives_per_class=4,
                 contrastive_dropdown=True, include_direct_loss=False,
                 direct_loss_keys=None, **kwargs):
        self.num_classes = num_classes
        self.positives_per_class = positives_per_class
        self.include_direct_loss = include_direct_loss
        self.direct_loss_keys = direct_loss_keys
        super().__init__(contrastive_dropdown=contrastive_dropdown, **kwargs)

    def register_classes(self, num_classes: int) -> None:
        self.num_classes = int(num_classes)

    def queue_sides(self):
        # -1 marks an empty slot: it matches no class
        return {"queue_labels": torch.full((self.K,), -1, dtype=torch.int64)}

    def compute_logits(self, q, k, batch):
        if self.num_classes == 0:
            raise RuntimeError("Maximum number of classes must be "
                               "registered before running a training step.")
        mod = self.module
        kp = k.reshape(q.shape[0], self.positives_per_class, self.proj_dim)
        return moco_logits(q, kp, mod.queue, self.T, batch["labels"].to(torch.int64),
                           mod.queue_labels, self.num_classes), kp[:, 0]

    def enqueue_sides(self, batch, ptr):
        enqueue(self.module.queue_labels, ptr, batch["labels"].to(torch.int64))

    def extra_losses(self, outputs, batch):
        if not (self.include_direct_loss and self.dropdown):
            return {}
        target = batch["vector"].to(torch.float32)
        return {"direct-loss": (outputs["dropdown_q"].float() - target).abs().mean()}


@register_model("weakcon")
class WeakConHandler(SupMoCoHandler):
    """Weakly-supervised contrast: distances between continuous degradation
    vectors weight the negative logits."""

    QUEUE_SIDES = ("queue_vectors",)

    def __init__(self, vector_size=2, **kwargs):
        self.vector_size = vector_size
        kwargs.setdefault("contrastive_dropdown", False)
        kwargs.setdefault("num_classes", 1)  # unused; satisfies SupMoCo's gate
        super().__init__(**kwargs)

    @torch.no_grad()
    def register_vector(self, vector_size: int) -> None:
        """A vector width other than the constructor's re-creates the
        vector side-queue, zero-filled."""
        self.vector_size = int(vector_size)
        buf = self.module.queue_vectors
        if buf.shape[1] != self.vector_size:
            self.module.queue_vectors = torch.zeros(self.K, self.vector_size,
                                                    device=buf.device)
            if self._state_params is not None:  # the state handed out sees it
                self._state_params["queue_vectors"] = self.module.queue_vectors

    def queue_sides(self):
        return {"queue_vectors": torch.zeros(self.K, self.vector_size)}

    def compute_logits(self, q, k, batch):
        mod = self.module
        vec = batch["vector"].to(torch.float32)  # (N, V)
        queue, queue_vectors = mod.queue, mod.queue_vectors
        n = q.shape[0]
        p = self.positives_per_class
        kp = k.reshape(n, p, self.proj_dim)
        l_pos = true_div(true_div((q[:, None, :] * kp).sum(dim=2), self.T).sum(dim=1), p)
        with full_f32_matmuls():
            l_neg = q.float() @ queue.T
            cross = vec @ queue_vectors.T
        d2 = ((vec ** 2).sum(dim=1)[:, None] + (queue_vectors ** 2).sum(dim=1)[None, :]
              - 2 * cross)
        weights = torch.sqrt(d2.clamp(min=0.0))
        l_neg = true_div(l_neg * weights, self.T)
        return torch.cat([l_pos.float()[:, None], l_neg], dim=1), kp[:, 0]

    def enqueue_sides(self, batch, ptr):
        enqueue(self.module.queue_vectors, ptr, batch["vector"].to(torch.float32))


@register_model("supcon")
class SupConHandler(MoCoHandler):
    """Plain SupCon (no queue, no momentum): the supervised contrastive
    loss over the two views, the query encoder running on both (its
    BatchNorm statistics advance twice a step, as in the JAX package)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("K", 8)  # the queue is unused; kept tiny
        super().__init__(**kwargs)

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        self._use_params(state.params)
        batch = device_batch(batch, self.device)
        enc = self.module.encoder

        def loss_fn():
            _, out = enc(_nhwc_to_nchw(batch["image_query"]), train=True)
            _, out2 = enc(_nhwc_to_nchw(batch["image_key"]), train=True)
            feats = torch.stack([_normalize(out["q"]), _normalize(out2["q"])], dim=1)
            loss = supcon_loss(feats, labels=batch.get("labels"), temperature=self.T)
            return {"train-loss": loss}

        losses = self._optimize(state, batch, loss_fn)
        return TrainState(step=int(state.step) + 1, params=state.params,
                          extra=state.extra), losses


@register_model("degradationregressor")
class DegradationRegressorHandler(BaseHandler):
    """Direct regression of degradation parameters from LR patches: the
    DASR backbone with a dropdown MLP, L1 against the metadata vector."""

    colorspace = "rgb"
    task = "regression"
    loss_type = "l1"

    def __init__(self, num_targets=2, **kwargs):
        self.num_targets = num_targets
        super().__init__(**kwargs)

    def build_module(self, **kw):
        return DASREncoder(dropdown_q=self.num_targets, in_features=self.in_features,
                           dtype=self.dtype)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        _, out = self.module(_nhwc_to_nchw(torch.as_tensor(batch["lr"], device=self.device)),
                             train=train)
        return out["dropdown_q"], {}, extra

    def compute_losses(self, pred, batch, aux):
        target = batch["metadata"].to(torch.float32)
        return {"train-loss": (pred.float() - target).abs().mean()}

    def _jax_state_dict(self, loaded) -> Dict[str, torch.Tensor]:
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        stats = (loaded.get("extra") or {}).get("q_bstats")
        return state_dict_from_jax(loaded["network"], self.module, batch_stats=stats or None)
