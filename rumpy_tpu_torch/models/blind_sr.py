"""Blind SR with a degradation encoder: the Best-of-Both-Worlds (BoBW)
pipelines.

Port of ``rumpy_tpu/models/blind_sr.py``: an encoder E (``DASREncoder``)
predicts an embedding of the LR image, an optional reducer MLP shrinks it,
and a meta-attention generator G(x, embedding) (QRCAN) super-resolves.
Embedding taps: ``pre-q`` (the pooled features), ``q`` (the projection)
and ``q-dropdown``.

With ``encoder_freeze_mode="all"`` the encoder's parameters take no
gradient and no optimizer step; it runs under ``no_grad``, which gives the
generator the same gradients, since nothing trainable lies upstream of it.
In a train step it still normalises by the batch's statistics and updates
its BatchNorm running statistics, as the JAX package's pipeline does with
``train=True``; evaluation uses the running statistics. The encoder
warm-starts from a trained predictor experiment or a packaged pretrained
network (``utils/checkpoint.py::resolve_packaged``), its BatchNorm running
statistics included.

Joint training (``combined_loss_mode`` ``"moco"`` / ``"supmoco"``): E
trains with G on ``l1_weight`` x pixel loss + ``contrastive_weight`` x the
MoCo (or SupMoCo) cross entropy of the query crop against the key crops and
a queue. The pipeline then also holds the momentum (key) encoder, without
gradients, and the queue, its pointer and (SupMoCo) its label queue, as
buffers. A step: the momentum update (from the parameters before the
step's update), the key forward (batch statistics, running ones left as
they are), the pipeline's forward, whose encoder pass serves the SR
embedding and the contrastive query alike (so E's running statistics
advance once a step, as in the JAX package, which runs E a third time and
discards that pass's update), the optimizer step over G, E and the
reducer, and the enqueue, with no host sync. As in the JAX package the key
encoder is copied from E at initialisation, before a warm start loads E.

Generators: QRCAN (``contrastiveblindqrcan``), QEDSR
(``contrastiveblindqedsr``), QHAN (``contrastiveblindqhan``: the ``standard``
style with q-layers, so every block runs the fused kernel with shared
``bd``/``bu`` and a per-image scale), QELAN (``contrastiveblindqelan``),
QSAN (``contrastiveblindqsan``), QRRDBNet and Metabed. ``sft_mode`` tiles the embedding to
(N, D, H, W) maps and feeds them to QRCAN's SFT layers; ``srmd_mode``
concatenates the maps to the input instead (``in_feats`` 3 + D), so its
QRCAN keeps ``max_concat`` and the fused kernel. As in the JAX package the
generator is called without ``train``: QELAN's BatchNorm normalises by its
running statistics in a train step too, and never updates them; in
``sft_mode`` the maps land in QELAN's ``train`` and in no argument of SAN's
or QRRDBNet's, and these fail at their first forward; QHAN ignores them, and
so does Metabed (they land in its ``encoded``, read only with an encoder).
QRRDBNet (``contrastiveblindqrealesrgan``) and Metabed
(``contrastiveblindmetabed``) train by the pixel loss alone here, without a
discriminator.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.attention_manipulators import QEDSR, QRCAN
from rumpy_tpu_torch.models.base import PIXEL_LOSSES, BaseHandler, TrainState
from rumpy_tpu_torch.models.common import Linear, tile_maps
from rumpy_tpu_torch.models.contrastive import (DASREncoder, _normalize, check_queue_batch,
                                                device_batch, enqueue, global_enqueue_batch,
                                                moco_logits, momentum_update,
                                                softmax_cross_entropy_first)
from rumpy_tpu_torch.models.han_elan import QELAN, QHAN
from rumpy_tpu_torch.models.san import SAN
from rumpy_tpu_torch.parallel import mesh as mesh_mod
from rumpy_tpu_torch.registry import register_model
from rumpy_tpu_torch.utils import checkpoint as ckpt


class EncodingReducer(nn.Module):
    """An MLP that shrinks the encoder's embedding before injection."""

    def __init__(self, in_features: int, layer_sizes: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ins = (in_features,) + tuple(layer_sizes[:-1])
        self.layers = nn.ModuleList(Linear(i, o, dtype=dtype)
                                    for i, o in zip(ins, layer_sizes))

    def forward(self, x):
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i != last:
                x = F.leaky_relu(x, 0.1)
        return x


class BlindSRPipeline(nn.Module):
    """E + optional reducer + G. ``encoder``, ``generator`` and ``reducer``
    are the JAX pipeline's param subtrees of the same names."""

    def __init__(self, generator: nn.Module, encoder: nn.Module,
                 reducer: Optional[nn.Module] = None, embedding_type: str = "pre-q",
                 frozen_encoder: bool = True, sft_mode: bool = False,
                 srmd_mode: bool = False):
        super().__init__()
        if embedding_type not in ("pre-q", "q", "q-dropdown"):
            raise RuntimeError("Incorrect type of embedding selected.")
        self.generator = generator
        self.encoder = encoder
        self.reducer = reducer
        self.embedding_type = embedding_type
        self.frozen_encoder = frozen_encoder
        self.sft_mode = sft_mode
        self.srmd_mode = srmd_mode

    def embed(self, x, train: bool = False):
        """The embedding of NCHW ``x``, and the encoder's outputs. A frozen
        encoder runs without gradients (its BatchNorm still updates its
        running statistics when ``train``)."""
        grad = contextlib.nullcontext() if not self.frozen_encoder else torch.no_grad()
        with grad:
            fea, outs = self.encoder(x, train=train)
        if self.embedding_type == "pre-q":
            emb = fea
        elif self.embedding_type == "q":
            emb = outs["q"]
        else:
            emb = outs["dropdown_q"]
        if self.reducer is not None:
            emb = self.reducer(emb)
        return emb, outs

    def generate(self, x, emb):
        """G on NCHW ``x`` and the embedding (N, D): with ``sft_mode`` the
        embedding also goes in as (N, D, H, W) maps, to the SFT layers or,
        with ``srmd_mode``, concatenated to the input."""
        if not self.sft_mode:
            return self.generator(x, emb)
        maps = tile_maps(emb, *x.shape[2:])
        if self.srmd_mode:
            return self.generator(torch.cat([x, maps.to(x.dtype)], dim=1), emb)
        return self.generator(x, emb, maps)

    def forward(self, x, train: bool = False):
        emb, _ = self.embed(x, train=train)
        return self.generate(x, emb)


def _build_generator(name: str, scale: int, num_metadata: int, dtype,
                     gen_kwargs: Dict[str, Any], sft_mode: bool,
                     srmd_mode: bool) -> nn.Module:
    name = name.lower()
    if name in ("qrcan", "rcan"):
        return QRCAN(scale=scale, num_metadata=num_metadata,
                     include_q_layer=gen_kwargs.pop("include_q_layer", True),
                     include_sft_layer=sft_mode and not srmd_mode,
                     in_feats=gen_kwargs.pop("in_feats", 3)
                     + (num_metadata if srmd_mode else 0),
                     style=gen_kwargs.pop("style", "max_concat"),
                     dtype=dtype, **gen_kwargs)
    if name in ("qedsr", "edsr"):
        return QEDSR(scale=scale, input_para=num_metadata, dtype=dtype, **gen_kwargs)
    # the JAX generators below infer their input width: srmd_mode's is 3 + D
    in_feats = 3 + (num_metadata if srmd_mode else 0)
    if name in ("qhan", "han"):
        return QHAN(scale=scale, in_feats=in_feats, num_metadata=num_metadata, dtype=dtype,
                    **gen_kwargs)
    if name in ("qelan", "elan"):
        return QELAN(scale=scale, in_feats=in_feats, num_metadata=num_metadata, dtype=dtype,
                     **gen_kwargs)
    if name in ("qsan", "san"):
        return SAN(scale=scale, in_feats=in_feats, num_metadata=num_metadata, dtype=dtype,
                   **gen_kwargs)
    if name in ("qrealesrgan", "qrrdbnet", "realesrgan"):
        from rumpy_tpu_torch.models.gan_models import QRRDBNet
        return QRRDBNet(scale=scale, in_nc=in_feats, num_metadata=num_metadata, dtype=dtype,
                        **gen_kwargs)
    if name == "metabed":
        from rumpy_tpu_torch.models.metabed import Metabed
        return Metabed(scale=scale, in_features=in_feats, input_para=num_metadata, dtype=dtype,
                       **gen_kwargs)
    raise KeyError(f"Unknown generator {name}")


class ContrastiveBlindSRHandler(BaseHandler):
    """Frozen-encoder and non-joint trainable-encoder BoBW pipelines."""

    uses_metadata = False
    colorspace = "rgb"
    im_input = "unmodified"
    generator_name = "qrcan"

    def __init__(self, generator=None, contrastive_encoder="default",
                 embedding_type="pre-q", encoder_freeze_mode="all",
                 combined_loss_mode=None, crop_count=None,
                 pre_trained_encoder_weights=None, block_encoder_loading=False,
                 encoder_dropdown=None, reducer_layer_sizes=None,
                 sft_mode=False, srmd_mode=False,
                 contrastive_T=0.07, contrastive_m=0.999, contrastive_K=8192,
                 num_classes=0, l1_weight=1.0, contrastive_weight=1.0,
                 encoder_dim=256, **kwargs):
        self.sft_mode = sft_mode or srmd_mode
        self.srmd_mode = srmd_mode
        self.embedding_type = embedding_type
        self.encoder_freeze_mode = encoder_freeze_mode
        self.combined_loss_mode = combined_loss_mode
        self.crop_count = crop_count
        self.pre_trained_encoder_weights = pre_trained_encoder_weights
        self.block_encoder_loading = block_encoder_loading
        self.encoder_dropdown = encoder_dropdown
        self.reducer_layer_sizes = (tuple(reducer_layer_sizes)
                                    if reducer_layer_sizes else None)
        self.encoder_dim = encoder_dim
        self.T = contrastive_T
        self.m = contrastive_m
        self.K = contrastive_K
        self.num_classes = num_classes
        self.l1_weight = l1_weight
        self.contrastive_weight = contrastive_weight
        self._generator = generator or self.generator_name
        super().__init__(**kwargs)
        if self.frozen:
            self.module.encoder.requires_grad_(False)

    @property
    def joint(self) -> bool:
        return self.combined_loss_mode in ("moco", "supmoco")

    @property
    def frozen(self) -> bool:
        return self.encoder_freeze_mode == "all" and not self.joint

    @property
    def emb_size(self) -> int:
        """The embedding's width as the generator sees it."""
        if self.reducer_layer_sizes:
            return self.reducer_layer_sizes[-1]
        return self._encoder_emb_size

    @property
    def _encoder_emb_size(self) -> int:
        if self.embedding_type == "q-dropdown":
            return self.encoder_dropdown
        return 256 if self.embedding_type == "pre-q" else self.encoder_dim

    def build_module(self, **gen_kwargs):
        encoder = DASREncoder(dropdown_q=self.encoder_dropdown, out_dim=self.encoder_dim,
                              dtype=self.dtype)
        reducer = (EncodingReducer(self._encoder_emb_size, self.reducer_layer_sizes,
                                   dtype=self.dtype)
                   if self.reducer_layer_sizes else None)
        generator = _build_generator(self._generator, self.scale, self.emb_size,
                                     self.dtype, dict(gen_kwargs), self.sft_mode,
                                     self.srmd_mode)
        pipeline = BlindSRPipeline(generator, encoder, reducer, self.embedding_type,
                                   frozen_encoder=self.frozen, sft_mode=self.sft_mode,
                                   srmd_mode=self.srmd_mode)
        if self.joint:
            pipeline.key_encoder = DASREncoder(
                dropdown_q=self.encoder_dropdown, out_dim=self.encoder_dim,
                dtype=self.dtype).requires_grad_(False)
            pipeline.register_buffer("queue", torch.zeros(self.K, self.encoder_dim))
            pipeline.register_buffer("queue_ptr", torch.zeros((), dtype=torch.int64))
            if self.combined_loss_mode == "supmoco":
                pipeline.register_buffer("queue_labels",
                                         torch.full((self.K,), -1, dtype=torch.int64))
        return pipeline

    def trainable_parameters(self):
        """The generator's and the reducer's, and the encoder's unless it
        is frozen."""
        return [p for p in self.module.parameters() if p.requires_grad]

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        state = super().init_state(seed)
        if self.joint:
            with torch.no_grad():
                mod = self.module
                mod.key_encoder.load_state_dict(mod.encoder.state_dict())
                gen = torch.Generator().manual_seed((self.seed if seed is None else seed) + 1)
                mod.queue.copy_(_normalize(torch.randn(mod.queue.shape, generator=gen)))
                mod.queue_ptr.zero_()
                if self.combined_loss_mode == "supmoco":
                    mod.queue_labels.fill_(-1)
        if self.pre_trained_encoder_weights and not self.block_encoder_loading:
            state = self.load_encoder(state, self.pre_trained_encoder_weights)
        return state

    @torch.no_grad()
    def load_encoder(self, state: TrainState, weights_dir: str, epoch="last") -> TrainState:
        """Warm-start the encoder from a trained predictor experiment or a
        packaged pretrained network's name, the JAX package's or the port's
        own: its weights and its BatchNorm running statistics (without them
        a frozen encoder would normalise by fresh mean-0/var-1 statistics
        at evaluation). A JAX checkpoint holds them as ``network`` and
        ``extra.q_bstats``; a port MoCo-family checkpoint as the
        ``encoder.*`` entries of its state."""
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        weights_dir = ckpt.resolve_packaged(weights_dir)
        ep = ckpt.select_epoch(weights_dir, epoch)
        path = ckpt.checkpoint_path(weights_dir, ep)
        raw = ckpt.load_checkpoint(path)
        encoder = self.module.encoder
        if ckpt.checkpoint_format(path) == "flax":
            stats = (raw.get("extra") or {}).get("q_bstats")
            sd = state_dict_from_jax(raw["network"], encoder, batch_stats=stats or None)
        else:
            sd = {k[len("encoder."):]: v for k, v in raw["network"].items()
                  if k.startswith("encoder.")}
            if not sd:
                raise ValueError(f"{path}: no encoder.* entries (not a predictor's checkpoint)")
        self._use_params(state.params)
        encoder.load_state_dict({**encoder.state_dict(), **sd})
        if not self.frozen:
            self._optimizer = None  # fresh optimizer state over the new weights
        return self._own_state(state.step, state.extra)

    def _jax_state_dict(self, loaded) -> Dict[str, torch.Tensor]:
        """A BoBW experiment of the JAX package: the frozen encoder's
        params sit in ``extra.frozen_encoder`` and every BatchNorm's running
        statistics in ``extra.bstats``."""
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        extra = loaded.get("extra") or {}
        params = dict(loaded["network"])
        if "frozen_encoder" in extra:
            params["encoder"] = extra["frozen_encoder"]
        if not self.joint:
            return state_dict_from_jax(params, self.module, batch_stats=extra.get("bstats"))
        # joint: the pipeline's subtrees, the key encoder and the queue
        mod, stats = self.module, extra.get("bstats") or {}
        sd: Dict[str, torch.Tensor] = {}
        for name in ("generator", "encoder", "reducer"):
            if getattr(mod, name) is not None:
                sub = state_dict_from_jax(params[name], getattr(mod, name),
                                          batch_stats=stats.get(name))
                sd.update({f"{name}.{k}": v for k, v in sub.items()})
        key = state_dict_from_jax(extra["key_params"], mod.key_encoder)
        sd.update({f"key_encoder.{k}": v for k, v in key.items()})
        for k, v in mod.key_encoder.state_dict().items():  # statistics unused in JAX
            sd.setdefault(f"key_encoder.{k}", v)
        for name in ("queue", "queue_ptr", "queue_labels"):
            if hasattr(mod, name):
                sd[name] = torch.as_tensor(np.array(extra[name])).to(getattr(mod, name).dtype)
        return sd

    # -- joint training ------------------------------------------------------

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if not self.joint:
            return super().train_batch(state, batch)
        batch = device_batch(batch, self.device)
        lr = batch["lr"]
        if "image_key" not in batch and lr.dim() == 5:
            # a multi-crop stack (B, P, h, w, C): crop 0 is the SR and query
            # view, crops 1.. the keys
            batch["lr"] = lr[:, 0]
            batch["image_key"] = lr[:, 1:].reshape((-1,) + tuple(lr.shape[2:]))
        return self._joint_step(state, batch)

    def _joint_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        self._use_params(state.params)
        mod = self.module
        n = batch["lr"].shape[0]
        check_queue_batch(self.K, global_enqueue_batch(n))
        labels = (batch["labels"].to(torch.int64)
                  if self.combined_loss_mode == "supmoco" else None)
        momentum_update(mod.key_encoder, mod.encoder, self.m)
        with torch.no_grad():
            _, k_outs = mod.key_encoder(batch["image_key"].permute(0, 3, 1, 2), train=True,
                                        update_stats=False)
            k = _normalize(k_outs["q"])
        p = (self.crop_count - 1) if self.crop_count else k.shape[0] // n
        kp = k.reshape(n, p, self.encoder_dim)

        def loss_fn():
            x = batch["lr"].permute(0, 3, 1, 2)
            emb, outs = mod.embed(x, train=True)  # E's running statistics advance here only
            sr = mod.generate(x, emb).permute(0, 2, 3, 1)
            logits = moco_logits(_normalize(outs["q"]), kp, mod.queue, self.T, labels,
                                 getattr(mod, "queue_labels", None), max(self.num_classes, 1))
            ce = softmax_cross_entropy_first(logits)
            pixel = PIXEL_LOSSES[self.loss_type](sr.float(), batch["hr"].float())
            total = self.l1_weight * pixel + self.contrastive_weight * ce
            return {"train-loss": total, "pixel-loss": pixel, "contrastive-loss": ce}

        losses = self._optimize(state, batch, loss_fn)
        with torch.no_grad():
            # every rank's keys (and labels), in rank order: the global batch
            keys = mesh_mod.all_gather_rows(kp[:, 0])
            ptr = mod.queue_ptr.clone()
            enqueue(mod.queue, ptr, keys)
            if labels is not None:
                enqueue(mod.queue_labels, ptr, mesh_mod.all_gather_rows(labels))
            mod.queue_ptr.copy_((ptr + keys.shape[0]) % self.K)
        return TrainState(step=int(state.step) + 1, params=state.params,
                          extra=state.extra), losses

    # -- forward -------------------------------------------------------------

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device).permute(0, 3, 1, 2)
        sr = self.module(lr, train=train)
        return sr.permute(0, 2, 3, 1), {}, extra

    def handler_metadata(self):
        return {"combined_loss_mode": self.combined_loss_mode,
                "embedding_type": self.embedding_type,
                "generator": self._generator}


@register_model("contrastiveblindqrcan")
class ContrastiveBlindQRCANHandler(ContrastiveBlindSRHandler):
    generator_name = "qrcan"


@register_model("contrastiveblindqedsr")
class ContrastiveBlindQEDSRHandler(ContrastiveBlindSRHandler):
    generator_name = "qedsr"


@register_model("contrastiveblindqhan")
class ContrastiveBlindQHANHandler(ContrastiveBlindSRHandler):
    generator_name = "qhan"


@register_model("contrastiveblindqelan")
class ContrastiveBlindQELANHandler(ContrastiveBlindSRHandler):
    generator_name = "qelan"


@register_model("contrastiveblindqsan")
class ContrastiveBlindQSANHandler(ContrastiveBlindSRHandler):
    generator_name = "qsan"


@register_model("contrastiveblindqrealesrgan")
class ContrastiveBlindQRealESRGANHandler(ContrastiveBlindSRHandler):
    """QRRDBNet under the BoBW pipeline, trained by L1 (no discriminator)."""

    generator_name = "qrealesrgan"


@register_model("contrastiveblindmetabed")
class ContrastiveBlindMetaBedHandler(ContrastiveBlindSRHandler):
    """The Metabed generator under the BoBW pipeline: the embedding feeds
    its blocks' metadata layers; ``selective_meta_blocks="front_only"`` (the
    default) gates block 0 alone."""

    generator_name = "metabed"

    def __init__(self, selective_meta_blocks="front_only", meta_block="q-layer",
                 num_blocks=8, **kwargs):
        if selective_meta_blocks == "front_only":
            smb = (True,) + (False,) * (num_blocks - 1)
        elif selective_meta_blocks in ("none", None):
            smb = None
        else:
            smb = tuple(selective_meta_blocks)
        super().__init__(selective_meta_blocks=smb, meta_block=meta_block,
                         num_blocks=num_blocks, **kwargs)
