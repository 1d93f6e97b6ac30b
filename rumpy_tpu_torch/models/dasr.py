"""DASR: degradation-aware SR with a contrastive degradation representation;
and DCLS's compact kernel estimator.

Port of ``rumpy_tpu/models/dasr.py``. A MoCo-trained DASR encoder gives a
256-d embedding of the LR image, compressed to 64-d; each DA conv predicts
a depthwise 3x3 kernel per example and channel from it, applied as one
grouped conv with the batch folded into the channels (index ``example * C +
channel``, ``groups = B * C``), beside a channel-attention branch.

Training: ``encoder_pretrain_epochs`` of the contrastive loss alone (the SR
net's gradients are zeros then, and Adam still advances its moments and
step count on them, as optax does), then SR L1 + the contrastive cross
entropy, whose SR term reaches the encoder through the live embedding. A
step: the momentum update of the key encoder from the parameters before the
step's update, the key forward (batch statistics, running ones untouched),
the query forward (the only one that updates the encoder's BatchNorm
statistics), the optimizer step and the enqueue. The key encoder and the
queue are module state, so a checkpoint holds them.

DCLS is the JAX package's compact stand-in for the DCLS estimator: LR -> a
softmaxed 21x21 kernel, scored by L1 against the full-kernel metadata.
Every layer is a cuDNN conv or a PyTorch op: the JAX package computes none
of them in a Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rumpy_tpu_torch.models.base import BaseHandler, TrainState
from rumpy_tpu_torch.models.common import Conv, Linear, Upsampler
from rumpy_tpu_torch.models.contrastive import (DASREncoder, _normalize, check_queue_batch,
                                                device_batch, enqueue, global_enqueue_batch,
                                                moco_logits, momentum_update,
                                                softmax_cross_entropy_first)
from rumpy_tpu_torch.parallel import mesh as mesh_mod
from rumpy_tpu_torch.registry import register_model


def _lrelu(v):
    return F.leaky_relu(v, 0.1)


class DAConv(nn.Module):
    """Degradation-aware conv: per-example depthwise kernels predicted from
    the embedding ``k_v`` (``embedding_dim`` wide: DASR's is 64, Metabed's
    the metadata's), LeakyReLU(0.1), a 1x1 conv; plus the input gated by a
    channel attention of ``k_v``."""

    def __init__(self, channels_in: int, channels_out: int, kernel_size: int = 3,
                 reduction: int = 8, dtype: torch.dtype = torch.float32,
                 embedding_dim: int = 64):
        super().__init__()
        self.kernel_size = kernel_size
        self.kernel = nn.ModuleList([
            Linear(embedding_dim, 64, dtype=dtype, use_bias=False),
            Linear(64, channels_in * kernel_size ** 2, dtype=dtype, use_bias=False)])
        self.conv = Conv(channels_in, channels_out, 1, dtype=dtype)
        mid = max(1, channels_in // reduction)
        self.att = nn.ModuleList([Conv(embedding_dim, mid, 1, use_bias=False, dtype=dtype),
                                  Conv(mid, channels_out, 1, use_bias=False, dtype=dtype)])

    def forward(self, x, k_v):
        b, c, h, w = x.shape
        ks = self.kernel_size
        kernels = self.kernel[1](_lrelu(self.kernel[0](k_v)))
        folded = x.reshape(1, b * c, h, w)  # channel example * c + channel
        out = F.conv2d(folded, kernels.reshape(b * c, 1, ks, ks).to(x.dtype),
                       padding=(ks - 1) // 2, groups=b * c).reshape(b, c, h, w)
        out = self.conv(_lrelu(out))
        att = self.att[1](_lrelu(self.att[0](k_v[:, :, None, None].to(x.dtype))))
        return out + x * torch.sigmoid(att)

    def flax_children(self):
        return ([(f"kernel.{i}", (f"TDense_{i}",), d) for i, d in enumerate(self.kernel)]
                + [("conv", ("TConv_0",), self.conv), ("att.0", ("TConv_1",), self.att[0]),
                   ("att.1", ("TConv_2",), self.att[1])])


class DAB(nn.Module):
    def __init__(self, n_feat: int, reduction: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.da = nn.ModuleList(DAConv(n_feat, n_feat, 3, reduction, dtype=dtype)
                                for _ in range(2))
        self.convs = nn.ModuleList(Conv(n_feat, n_feat, 3, dtype=dtype) for _ in range(2))

    def forward(self, x, k_v):
        out = _lrelu(self.da[0](x, k_v))
        out = _lrelu(self.convs[0](out))
        out = _lrelu(self.da[1](out, k_v))
        return self.convs[1](out) + x

    def flax_children(self):
        return ([(f"da.{i}", (f"DAConv_{i}",), d) for i, d in enumerate(self.da)]
                + [(f"convs.{i}", (f"Conv_{i}", "TConv_0"), c)
                   for i, c in enumerate(self.convs)])


class DAG(nn.Module):
    def __init__(self, n_feat: int, n_blocks: int = 5, reduction: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(DAB(n_feat, reduction, dtype=dtype)
                                    for _ in range(n_blocks))
        self.tail = Conv(n_feat, n_feat, 3, dtype=dtype)

    def forward(self, x, k_v):
        res = x
        for block in self.blocks:
            res = block(res, k_v)
        return self.tail(res) + x

    def flax_children(self):
        return ([(f"blocks.{i}", (f"DAB_{i}",), b) for i, b in enumerate(self.blocks)]
                + [("tail", ("Conv_0", "TConv_0"), self.tail)])


class DASRNet(nn.Module):
    def __init__(self, scale: int = 4, n_groups: int = 5, n_blocks: int = 5, n_feats: int = 64,
                 reduction: int = 8, in_nc: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compress = Linear(256, 64, dtype=dtype, use_bias=False)
        self.head = Conv(in_nc, n_feats, 3, dtype=dtype)
        self.groups = nn.ModuleList(DAG(n_feats, n_blocks, reduction, dtype=dtype)
                                    for _ in range(n_groups))
        self.body = Conv(n_feats, n_feats, 3, dtype=dtype)
        self.upsampler = Upsampler(scale, n_feats, dtype=dtype)
        self.tail = Conv(n_feats, 3, 3, dtype=dtype)

    def forward(self, x, embedding):
        k_v = _lrelu(self.compress(embedding))
        x = self.head(x)
        res = x
        for group in self.groups:
            res = group(res, k_v)
        res = self.body(res) + x
        return self.tail(self.upsampler(res))

    def flax_children(self):
        return ([("compress", ("TDense_0",), self.compress),
                 ("head", ("Conv_0", "TConv_0"), self.head)]
                + [(f"groups.{i}", (f"DAG_{i}",), g) for i, g in enumerate(self.groups)]
                + [("body", ("Conv_1", "TConv_0"), self.body),
                   ("upsampler", ("Upsampler_0",), self.upsampler),
                   ("tail", ("Conv_2", "TConv_0"), self.tail)])


class DASRPipeline(nn.Module):
    """The SR net on the encoder's pooled features; the momentum (key)
    encoder, without gradients, and the queue of keys and its pointer as
    buffers. ``flax_children`` names the JAX param tree's two subtrees."""

    def __init__(self, sr_net: nn.Module, K: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.sr_net = sr_net
        self.encoder = DASREncoder(dtype=dtype)
        self.key_encoder = DASREncoder(dtype=dtype).requires_grad_(False)
        self.register_buffer("queue", torch.zeros(K, 256))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.int64))

    def forward(self, x, train: bool = False):
        fea, _ = self.encoder(x, train=train)
        return self.sr_net(x, fea)

    def flax_children(self):
        return [("sr_net", ("sr_net",), self.sr_net), ("encoder", ("encoder",), self.encoder)]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


@register_model("dasr")
class DASRHandler(BaseHandler):
    loss_type = "l1"
    colorspace = "rgb"
    im_input = "unmodified"
    missing_grads_as_zeros = True  # the SR net's zero gradients while the encoder pretrains

    def __init__(self, encoder_pretrain_epochs=0, n_groups=5, n_blocks=5, n_feats=64,
                 contrastive_K=8192, contrastive_T=0.07, contrastive_m=0.999, **kwargs):
        self.encoder_pretrain_epochs = encoder_pretrain_epochs
        self.K = contrastive_K
        self.T = contrastive_T
        self.m = contrastive_m
        self.curr_epoch = 0
        super().__init__(n_groups=n_groups, n_blocks=n_blocks, n_feats=n_feats, **kwargs)

    def set_epoch(self, epoch: int) -> None:
        self.curr_epoch = epoch

    def build_module(self, **kw):
        return DASRPipeline(DASRNet(scale=self.scale, in_nc=self.in_features, dtype=self.dtype,
                                    **kw), self.K, dtype=self.dtype)

    @torch.no_grad()
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Fresh weights, the key encoder a copy of the encoder, and a queue
        of normalized N(0, 1) rows from the seed."""
        state = super().init_state(seed)
        mod = self.module
        mod.key_encoder.load_state_dict(mod.encoder.state_dict())
        gen = torch.Generator().manual_seed((self.seed if seed is None else seed) + 1)
        mod.queue.copy_(_normalize(torch.randn(mod.queue.shape, generator=gen)))
        mod.queue_ptr.zero_()
        return state

    def train_batch(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """A batch holds ``image_query`` and ``image_key`` (NHWC), or an
        ``lr`` stack (B, P, h, w, C) whose crop 0 is the query and crop 1 the
        key; and ``hr``, the query's target, outside the encoder's pretrain."""
        self._use_params(state.params)
        batch = device_batch(batch, self.device)
        lr = batch.get("lr")
        if "image_query" not in batch and lr is not None and lr.dim() == 5:
            batch["image_query"] = lr[:, 0]
            batch["image_key"] = lr[:, 1 % lr.shape[1]]
            batch.pop("lr")
        if self.curr_epoch < self.encoder_pretrain_epochs:
            batch.pop("hr", None)
        joint = batch.get("hr") is not None
        n = batch["image_query"].shape[0]
        check_queue_batch(self.K, global_enqueue_batch(n))
        mod = self.module
        momentum_update(mod.key_encoder, mod.encoder, self.m)
        with torch.no_grad():
            _, k_outs = mod.key_encoder(_nchw(batch["image_key"]), train=True,
                                        update_stats=False)
            k = _normalize(k_outs["q"])

        def loss_fn():
            x = _nchw(batch["image_query"])
            fea, outs = mod.encoder(x, train=True)
            logits = moco_logits(_normalize(outs["q"]), k[:, None, :], mod.queue, self.T)
            ce = softmax_cross_entropy_first(logits)
            losses = {"contrastive-loss": ce}
            total = ce
            if joint:  # the SR loss reaches the encoder through fea
                sr = mod.sr_net(x, fea).permute(0, 2, 3, 1)
                pixel = (sr.float() - batch["hr"].float()).abs().mean()
                losses["pixel-loss"] = pixel
                total = pixel + ce
            losses["train-loss"] = total
            return losses

        losses = self._optimize(state, batch, loss_fn)
        with torch.no_grad():
            keys = mesh_mod.all_gather_rows(k[:n])  # the global batch's, in rank order
            ptr = mod.queue_ptr.clone()
            enqueue(mod.queue, ptr, keys)
            mod.queue_ptr.copy_((ptr + keys.shape[0]) % self.K)
        return TrainState(step=int(state.step) + 1, params=state.params,
                          extra=state.extra), losses

    def apply(self, params, batch, train=False, rng=None, extra=None):
        """SR of ``batch["lr"]``, the encoder on its running statistics."""
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        return self.module(_nchw(lr), train=False).permute(0, 2, 3, 1), {}, extra

    # -- the JAX package's state -------------------------------------------

    def state_dict_from_jax_trees(self, params, extra) -> Dict[str, torch.Tensor]:
        """The module's state_dict from a JAX DASR state's ``params`` and
        ``extra`` (``bstats``: the encoder's BatchNorm statistics;
        ``key_params``; the queue and its pointer). The key encoder's own
        statistics, which the JAX package never uses, stay as they are."""
        from rumpy_tpu_torch.utils.weights import state_dict_from_jax
        mod = self.module
        stats = (extra.get("bstats") or {}).get("encoder")
        sd = {f"sr_net.{k}": v
              for k, v in state_dict_from_jax(params["sr_net"], mod.sr_net).items()}
        sd.update({f"encoder.{k}": v for k, v in state_dict_from_jax(
            params["encoder"], mod.encoder, batch_stats=stats).items()})
        sd.update({f"key_encoder.{k}": v for k, v in state_dict_from_jax(
            extra["key_params"], mod.key_encoder).items()})
        for k, v in mod.state_dict().items():  # statistics absent from the checkpoint
            sd.setdefault(k, v)
        sd["queue"] = torch.as_tensor(np.array(extra["queue"], np.float32))
        sd["queue_ptr"] = torch.as_tensor(int(np.asarray(extra["queue_ptr"])))
        return sd

    def _jax_state_dict(self, loaded) -> Dict[str, torch.Tensor]:
        return self.state_dict_from_jax_trees(loaded["network"], loaded.get("extra") or {})

    def jax_trees(self, state: TrainState) -> Dict[str, Any]:
        """The inverse: {"params", "extra"} as the JAX handler's state holds
        them (nested dicts of numpy arrays)."""
        from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict
        self._use_params(state.params)
        mod = self.module

        def tree(m, coll="params"):
            return jax_tree_from_state_dict(m.state_dict(), m, coll)

        return {"params": {"sr_net": tree(mod.sr_net), "encoder": tree(mod.encoder)},
                "extra": {"bstats": {"encoder": tree(mod.encoder, "batch_stats")},
                          "key_params": tree(mod.key_encoder),
                          "queue": mod.queue.cpu().numpy().copy(),
                          "queue_ptr": np.asarray(int(mod.queue_ptr), np.int32)}}


class KernelEstimator(nn.Module):
    """DCLS's compact estimator: four 5x5 convs (strides 1, 2, 1, 2; flax's
    'SAME' padding; He-normal init), each followed by LeakyReLU(0.2), a
    global pool, a dense layer to k^2 logits and a softmax: (N, k, k)."""

    def __init__(self, nf: int = 64, kernel_size: int = 21, in_nc: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.convs = nn.ModuleList(
            Conv(in_nc if i == 0 else nf, nf, 5, dtype=dtype, stride=s, flax_same=True,
                 init="he_normal") for i, s in enumerate((1, 2, 1, 2)))
        self.dense = Linear(nf, kernel_size ** 2, dtype=dtype)

    def forward(self, x):
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.2)
        kernel = torch.softmax(self.dense(x.mean(dim=(2, 3))), dim=-1)
        return kernel.reshape(-1, self.kernel_size, self.kernel_size)

    def flax_children(self):
        return ([(f"convs.{i}", (f"TConv_{i}",), c) for i, c in enumerate(self.convs)]
                + [("dense", ("TDense_0",), self.dense)])


@register_model("dcls")
class DCLSHandler(BaseHandler):
    """LR -> a normalised k x k kernel, trained by L1 against the flattened
    full-kernel metadata."""

    loss_type = "l1"
    colorspace = "rgb"
    uses_metadata = True

    def __init__(self, kernel_size=21, nf=64, **kwargs):
        self.kernel_size = kernel_size
        super().__init__(nf=nf, **kwargs)

    def build_module(self, nf):
        return KernelEstimator(nf=nf, kernel_size=self.kernel_size, in_nc=self.in_features,
                               dtype=self.dtype)

    def apply(self, params, batch, train=False, rng=None, extra=None):
        self._use_params(params)
        lr = torch.as_tensor(batch["lr"], device=self.device)
        return self.module(_nchw(lr)), {}, extra

    def compute_losses(self, kernels, batch, aux):
        target = torch.as_tensor(batch["metadata"], device=self.device).float()
        flat = kernels.reshape(kernels.shape[0], -1)
        return {"train-loss": (flat.float() - target).abs().mean()}
