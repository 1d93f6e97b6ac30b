"""Metabed: a truncated EDSR for comparing metadata-insertion mechanisms.

Port of ``rumpy_tpu/models/metabed.py``. Each residual block may feed the
metadata in through one of six layers: a q-layer (``ParaCALayer``), the
multi-pipe and split-pipe q-layers, SFT on metadata maps, DASR's
degradation-aware conv and the DGFMB layer; ``selective_meta_blocks``
picks the blocks that do. With ``use_encoder`` a 1x1-conv autoencoder
squeezes the metadata to ``num_bottleneck_nodes`` values first, and the
handler trains it beside the SR loss for ``encoder_pretrain_epochs``
(``set_epoch`` flips the phase; the loss is read at each step). After that
phase the encoder and the decoder may be frozen: their outputs are
detached, as the JAX package's ``stop_gradient``, and their parameters take
zero gradients, which optax's Adam (and this handler's) still applies. The
GAN variant runs Metabed under the ESRGAN recipe (``gan_models``). Every
layer is a cuDNN conv or a PyTorch op: the JAX package computes none of
them in a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from rumpy_tpu_torch.models.attention_manipulators import (DGFMBLayer, ParaCALayer, QModelHandler,
                                                           ResPipesCALayer, ResPipesSplitCALayer,
                                                           SFTLayer, compute_num_metadata,
                                                           select_metadata_columns)
from rumpy_tpu_torch.models.common import Conv, Upsampler, tile_maps
from rumpy_tpu_torch.models.gan_models import BaseGANHandler
from rumpy_tpu_torch.registry import register_model

META_TYPES = ("q-layer", "res-pipe-q-layer", "res-pipe-split-q-layer", "SFT", "da-layer",
              "dgfmb-layer")


class MetaResBlock(nn.Module):
    """EDSR residual block (conv, ReLU, conv, ``res_scale``) with the
    metadata layer ``meta_type`` (or none) on its branch."""

    def __init__(self, n_feats: int, n_params: int, meta_type: Optional[str] = None,
                 num_meta_layers=2, num_pipes: int = 3, combine_pipes: str = "concat",
                 split_percent: float = 0.25, res_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.res_scale = res_scale
        self.meta_type = meta_type
        self.conv1 = Conv(n_feats, n_feats, 3, dtype=dtype)
        self.conv2 = Conv(n_feats, n_feats, 3, dtype=dtype)
        if meta_type == "q-layer":
            meta = ParaCALayer(n_feats, n_params, nonlinearity=True,
                               num_layers=num_meta_layers, dtype=dtype)
        elif meta_type == "res-pipe-q-layer":
            meta = ResPipesCALayer(n_feats, n_params, nonlinearity=True,
                                   num_layers=num_meta_layers, num_pipes=num_pipes,
                                   combine_pipes=combine_pipes, dtype=dtype)
        elif meta_type == "res-pipe-split-q-layer":
            meta = ResPipesSplitCALayer(n_feats, n_params, nonlinearity=True,
                                        num_layers=num_meta_layers, num_pipes=num_pipes,
                                        split_percent=split_percent, dtype=dtype)
        elif meta_type == "SFT":
            meta = SFTLayer(n_feats, n_params, dtype=dtype)
        elif meta_type == "da-layer":
            from rumpy_tpu_torch.models.dasr import DAConv
            meta = DAConv(n_feats, n_feats, 3, dtype=dtype, embedding_dim=n_params)
        elif meta_type == "dgfmb-layer":
            meta = DGFMBLayer(num_channels=n_feats, degradation_full_dim=n_params,
                              num_layers=num_meta_layers, dtype=dtype)
        elif meta_type is None:
            meta = None
        else:
            raise ValueError(f"unknown meta block {meta_type!r} (one of {META_TYPES})")
        self.meta = meta

    def forward(self, x, metadata, meta_maps=None):
        res = self.conv2(torch.relu(self.conv1(x))) * self.res_scale
        if self.meta_type == "SFT":
            maps = meta_maps
            if maps is None:
                maps = tile_maps(metadata.to(res.dtype), *res.shape[2:])
            res = self.meta(res, maps)
        elif self.meta is not None:
            res = self.meta(res, metadata)
        return x + res

    def flax_children(self):
        out = [("conv1", ("Conv_0", "TConv_0"), self.conv1),
               ("conv2", ("Conv_1", "TConv_0"), self.conv2)]
        if self.meta is not None:
            out.append(("meta", (f"{type(self.meta).__name__}_0",), self.meta))
        return out


class MetadataCoder(nn.Module):
    """The metadata autoencoder's encoder or decoder: 1x1 convs through
    ``widths`` on an (N, M) vector, a ReLU after each (the last too),
    float32 out."""

    def __init__(self, widths: Sequence[int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(Conv(a, b, 1, dtype=dtype)
                                   for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, v):
        for conv in self.convs:
            v = torch.relu(conv.as_linear(v))
        return v.float()

    def flax_children(self):
        return [(f"convs.{i}", (f"TConv_{i}",), c) for i, c in enumerate(self.convs)]


class Metabed(nn.Module):
    """Truncated EDSR with a metadata hook in each block: head conv,
    ``num_blocks`` MetaResBlocks (``meta_block`` in those
    ``selective_meta_blocks`` marks, all by default), a body conv plus the
    head's output, the sub-pixel upsampler, a tail conv."""

    def __init__(self, scale: int = 4, in_features: int = 3, out_features: int = 3,
                 num_features: int = 64, input_para: int = 1, meta_block: Optional[str] = None,
                 num_meta_layers=2, num_pipes: int = 3, combine_pipes: str = "concat",
                 split_percent: float = 0.25, num_blocks: int = 8, res_scale: float = 0.1,
                 selective_meta_blocks: Optional[Sequence[bool]] = None,
                 use_encoder: bool = False, num_bottleneck_nodes: int = 16,
                 encoder_layers_sizes: Optional[Sequence[int]] = None,
                 decoder_layers_sizes: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_encoder = use_encoder
        meta_size = input_para
        self.meta_enc = self.meta_dec = None
        if use_encoder:  # metadata -> bottleneck -> metadata
            self.meta_enc = MetadataCoder(
                [input_para, *(encoder_layers_sizes or [36, 24]), num_bottleneck_nodes], dtype)
            self.meta_dec = MetadataCoder(
                [num_bottleneck_nodes, *(decoder_layers_sizes or [24, 36]), input_para], dtype)
            meta_size = num_bottleneck_nodes
        self.head = Conv(in_features, num_features, 3, dtype=dtype)
        self.blocks = nn.ModuleList(
            MetaResBlock(num_features, meta_size,
                         meta_type=(meta_block if selective_meta_blocks is None
                                    or selective_meta_blocks[i] else None),
                         num_meta_layers=num_meta_layers, num_pipes=num_pipes,
                         combine_pipes=combine_pipes, split_percent=split_percent,
                         res_scale=res_scale, dtype=dtype)
            for i in range(num_blocks))
        self.final_body = Conv(num_features, num_features, 3, dtype=dtype)
        self.upsampler = Upsampler(scale, num_features, dtype=dtype)
        self.tail_conv = Conv(num_features, out_features, 3, dtype=dtype)

    def encode_metadata(self, metadata):
        return self.meta_enc(metadata)

    def decode_metadata(self, enc):
        return self.meta_dec(enc)

    def forward(self, x, metadata=None, encoded=False):
        if metadata is not None and self.use_encoder and not encoded:
            metadata = self.meta_enc(metadata)
        x = self.head(x)
        res = x
        for block in self.blocks:
            res = block(res, metadata)
        res = self.final_body(res) + x
        return self.tail_conv(self.upsampler(res))

    def flax_children(self):
        out = []
        if self.use_encoder:
            out += [("meta_enc", ("meta_enc",), self.meta_enc),
                    ("meta_dec", ("meta_dec",), self.meta_dec)]
        out.append(("head", ("head", "TConv_0"), self.head))
        out += [(f"blocks.{i}", (f"blocks_{i}",), b) for i, b in enumerate(self.blocks)]
        return out + [("final_body", ("final_body", "TConv_0"), self.final_body),
                      ("upsampler", ("upsampler",), self.upsampler),
                      ("tail_conv", ("tail_conv", "TConv_0"), self.tail_conv)]


def _selective(selective_meta_blocks):
    return tuple(selective_meta_blocks) if selective_meta_blocks is not None else None


@register_model("metabed")
class MetaBedHandler(QModelHandler):
    """Metabed. With ``use_encoder`` the metadata autoencoder trains
    alongside: loss = L1(sr) + mult * L1(decoded, metadata), ``mult`` =
    ``encoder_loss_scaling`` in the first ``encoder_pretrain_epochs`` and 0
    after."""

    loss_type = "l1"
    # frozen parts take zero gradients, which Adam applies as optax does
    missing_grads_as_zeros = True

    def __init__(self, num_blocks=8, num_features=64, res_scale=0.1,
                 meta_block=None, use_encoder=False,
                 encoder_pretrain_epochs=None, encoder_loss_scaling=5.0,
                 freeze_encoder_after_pretrain=False,
                 freeze_decoder_after_pretrain=True,
                 selective_meta_blocks=None, **kwargs):
        self.meta_block = meta_block
        self.no_metadata = meta_block is None
        self.use_encoder = use_encoder
        self.encoder_pretrain_epochs = encoder_pretrain_epochs
        self.encoder_loss_scaling = encoder_loss_scaling
        self.freeze_encoder_after_pretrain = freeze_encoder_after_pretrain
        self.freeze_decoder_after_pretrain = freeze_decoder_after_pretrain
        self.curr_epoch = 0
        super().__init__(num_blocks=num_blocks, num_features=num_features,
                         res_scale=res_scale,
                         selective_meta_blocks=_selective(selective_meta_blocks), **kwargs)

    def build_module(self, **kw):
        return Metabed(scale=self.scale, in_features=self.in_features,
                       input_para=self.num_metadata, meta_block=self.meta_block,
                       use_encoder=self.use_encoder, dtype=self.dtype, **kw)

    def set_epoch(self, epoch: int) -> None:
        self.curr_epoch = epoch

    def _in_pretrain(self) -> bool:
        return (self.encoder_pretrain_epochs is not None
                and self.curr_epoch < self.encoder_pretrain_epochs)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device).permute(0, 3, 1, 2)
        meta = batch.get("metadata")
        if meta is not None:
            meta = torch.as_tensor(meta, device=self.device).float()
        elif not self.no_metadata:
            raise RuntimeError("Metadata needs to be specified for this "
                               "network to run properly.")
        mod = self.module
        if not self.use_encoder:
            return mod(lr, meta).permute(0, 2, 3, 1), {}, extra
        enc = mod.encode_metadata(meta)
        post = not self._in_pretrain() and self.encoder_pretrain_epochs is not None
        if post and self.freeze_encoder_after_pretrain:
            enc = enc.detach()
        dec_in = enc.detach() if post and self.freeze_decoder_after_pretrain else enc
        decoded = mod.decode_metadata(dec_in)
        if post and self.freeze_decoder_after_pretrain:
            decoded = decoded.detach()
        sr = mod(lr, enc, encoded=True)
        ae = (decoded - meta).abs().mean()
        return sr.permute(0, 2, 3, 1), {"l1-loss-ae": ae}, extra

    def compute_losses(self, sr, batch, aux):
        l1 = (sr.float() - batch["hr"].float()).abs().mean()
        if not self.use_encoder:
            return {"train-loss": l1}
        mult = self.encoder_loss_scaling if self._in_pretrain() else 0.0
        scaled = mult * aux["l1-loss-ae"]
        return {"train-loss": l1 + scaled, "l1-loss": l1,
                "l1-loss-ae": aux["l1-loss-ae"], "scaled-l1-loss-ae": scaled}


@register_model("metabedesrgan")
class MetabedESRGANHandler(BaseGANHandler):
    """Metabed under the ESRGAN recipe: L1 pre-training, then the
    relativistic adversarial phase against the VGG-128 discriminator."""

    gan_mode = "relativistic"
    uses_metadata = True

    def __init__(self, metadata=None, metadata_bypass_len=None,
                 num_blocks=8, num_features=64, res_scale=0.1,
                 meta_block=None, selective_meta_blocks=None, **kwargs):
        if metadata is None and metadata_bypass_len is None:
            metadata = ["qpi"]
        self.metadata_keys = list(metadata) if metadata else None
        self.num_metadata = compute_num_metadata(metadata, metadata_bypass_len)
        self.meta_block = meta_block
        self.no_metadata = meta_block is None
        for k in ("nf", "nb", "gc"):
            kwargs.pop(k, None)
        super().__init__(num_blocks=num_blocks, num_features=num_features,
                         res_scale=res_scale,
                         selective_meta_blocks=_selective(selective_meta_blocks), **kwargs)

    def build_generator(self, nf=None, nb=None, gc=None, **kw):
        return Metabed(scale=self.scale, in_features=self.in_features,
                       input_para=self.num_metadata, meta_block=self.meta_block,
                       dtype=self.dtype, **kw)

    def example_inputs(self, batch: int = 1, size: int = 16):
        return (torch.zeros((batch, size, size, self.in_features), device=self.device),
                torch.zeros((batch, self.num_metadata), device=self.device))

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device).permute(0, 3, 1, 2)
        meta = batch.get("metadata")
        meta = torch.as_tensor(meta, device=self.device).float() if meta is not None else None
        if meta is None and not self.no_metadata:
            raise RuntimeError("Metadata needs to be specified for this "
                               "network to run properly.")
        return self.module.generator(lr, meta).permute(0, 2, 3, 1), {}, extra

    def handler_metadata(self):
        return {"metadata_keys_used_in_training": self.metadata_keys,
                "num_metadata": self.num_metadata}

    def select_metadata(self, metadata, keys=None):
        return select_metadata_columns(metadata, keys, self.metadata_keys)
