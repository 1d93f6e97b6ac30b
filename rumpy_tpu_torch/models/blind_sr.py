"""Blind SR with a degradation encoder: the Best-of-Both-Worlds (BoBW)
pipelines.

Port of ``rumpy_tpu/models/blind_sr.py`` for the frozen-encoder pipeline
and the non-joint trainable-encoder one: an encoder E (``DASREncoder``)
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

Joint ``moco``/``supmoco`` training, the SFT/SRMD modes and generators
other than QRCAN raise ``NotImplementedError`` (ROADMAP queue 1 item 6b).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.attention_manipulators import LATER, QRCAN
from rumpy_tpu_torch.models.base import BaseHandler, TrainState
from rumpy_tpu_torch.models.common import Linear
from rumpy_tpu_torch.models.contrastive import DASREncoder
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
                 frozen_encoder: bool = True):
        super().__init__()
        if embedding_type not in ("pre-q", "q", "q-dropdown"):
            raise RuntimeError("Incorrect type of embedding selected.")
        self.generator = generator
        self.encoder = encoder
        self.reducer = reducer
        self.embedding_type = embedding_type
        self.frozen_encoder = frozen_encoder

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

    def forward(self, x, train: bool = False):
        emb, _ = self.embed(x, train=train)
        return self.generator(x, emb)


def _build_generator(name: str, scale: int, num_metadata: int, dtype,
                     gen_kwargs: Dict[str, Any]) -> nn.Module:
    name = name.lower()
    if name not in ("qrcan", "rcan"):
        raise NotImplementedError(
            f"BoBW generator {name!r} is not ported yet; only QRCAN is ({LATER})")
    return QRCAN(scale=scale, num_metadata=num_metadata,
                 include_q_layer=gen_kwargs.pop("include_q_layer", True),
                 in_feats=gen_kwargs.pop("in_feats", 3),
                 style=gen_kwargs.pop("style", "max_concat"),
                 dtype=dtype, **gen_kwargs)


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
        if combined_loss_mode in ("moco", "supmoco"):
            raise NotImplementedError(
                f"joint encoder training (combined_loss_mode={combined_loss_mode!r}) "
                f"is not ported yet ({LATER})")
        if sft_mode or srmd_mode:
            raise NotImplementedError(f"the SFT/SRMD pipeline modes are not ported yet ({LATER})")
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
        self._generator = generator or self.generator_name
        super().__init__(**kwargs)
        if self.frozen:
            self.module.encoder.requires_grad_(False)

    @property
    def frozen(self) -> bool:
        return self.encoder_freeze_mode == "all"

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
                                     self.dtype, dict(gen_kwargs))
        return BlindSRPipeline(generator, encoder, reducer, self.embedding_type,
                               frozen_encoder=self.frozen)

    def trainable_parameters(self):
        """The generator's and the reducer's, and the encoder's unless it
        is frozen."""
        return [p for p in self.module.parameters() if p.requires_grad]

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        state = super().init_state(seed)
        if self.pre_trained_encoder_weights and not self.block_encoder_loading:
            state = self.load_encoder(state, self.pre_trained_encoder_weights)
        return state

    @torch.no_grad()
    def load_encoder(self, state: TrainState, weights_dir: str, epoch="last") -> TrainState:
        """Warm-start the encoder from a trained predictor experiment or a
        packaged pretrained network's name: its weights and its BatchNorm
        running statistics (the checkpoint's ``extra.q_bstats``; without
        them a frozen encoder would normalise by fresh mean-0/var-1
        statistics at evaluation)."""
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        weights_dir = ckpt.resolve_packaged(weights_dir)
        ep = ckpt.select_epoch(weights_dir, epoch)
        path = ckpt.checkpoint_path(weights_dir, ep)
        if ckpt.checkpoint_format(path) != "flax":
            raise NotImplementedError(
                f"{path}: encoder checkpoints written by the port's own MoCo-family "
                f"handlers wait for them ({LATER}); the JAX package's load")
        raw = ckpt.load_checkpoint(path)
        stats = (raw.get("extra") or {}).get("q_bstats")
        encoder = self.module.encoder
        sd = state_dict_from_jax(raw["network"], encoder, batch_stats=stats or None)
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
        return state_dict_from_jax(params, self.module, batch_stats=extra.get("bstats"))

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
