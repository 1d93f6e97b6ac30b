"""Weight bridge to and from the JAX package: flax param tree <-> port
state_dict.

The inverse of ``rumpy_tpu/utils/torch_convert.py::convert_by_order``, but
by name rather than by order: a flax tree that has crossed ``jax.jit``
comes back key-sorted, so ``RCAB_10`` sorts before ``RCAB_2`` and an order
zip would misassign. Each port module knows which flax auto-name each of
its children had. ``nn.remat`` renames ``ResidualGroup_<i>`` to
``CheckpointResidualGroup_<i>``; both are accepted. Conv kernels go
HWIO -> OIHW (the 1x1 kernels ``(1,1,in,out)`` too); Dense kernels
(in, out) -> ``Linear`` weights (out, in); a BatchNorm's ``scale`` and
``bias`` are params, its ``mean`` and ``var`` come from the
``batch_stats`` tree at the same path and become the running-stat buffers.
Covered: RCAN, EDSR (and EDSRMD), QRCAN (``QResidualGroup_<i>``,
``QRCAB_<j>``, ``QCALayer_0``, ``PALayer_0``, ``ParaCALayer_0``,
``SFTLayer_0``), QEDSR (``ParamResBlock_<i>``), SRMD, SFTMD (its SFT
layers and q-layers), the DASR encoder (``TConv_0..5``,
``BatchNorm_0..5``, ``TDense_<k>``) and the BoBW pipeline's
``generator``/``encoder``/``reducer`` subtrees. Flax names a compact
module's children in the order they are constructed, and an outer conv
is constructed before its inner one: an ``SFTLayer``'s ``TConv_0`` is
its scale branch's second conv. Any unused or missing
leaf, and any shape mismatch, raises. ``jax_tree_from_state_dict`` is the
inverse, with flax's plain (not remat) names.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rumpy_tpu_torch.models.advanced import EDSR, RCAN, SRMD, ResidualGroup
from rumpy_tpu_torch.models.attention_manipulators import (QEDSR, QRCAB, QRCAN, PALayer,
                                                           ParaCALayer, ParamResBlock,
                                                           QCALayer, QResidualGroup, SFTLayer)
from rumpy_tpu_torch.models.blind_sr import BlindSRPipeline, EncodingReducer
from rumpy_tpu_torch.models.common import (RCAB, BatchNorm, CALayer, Conv, Linear,
                                           ResBlock, Upsampler)
from rumpy_tpu_torch.models.contrastive import DASREncoder
from rumpy_tpu_torch.models.sftmd_variants import SFTMD, SFTResidualBlock, SftConvs

Path = Tuple[str, ...]
LEAF_TYPES = (Conv, Linear, BatchNorm)


def _entries(module: nn.Module, port: str, flax: Path) -> Iterator[Tuple[str, Path, nn.Module]]:
    """(port prefix, flax path of the module's leaves, module) for every
    Conv, Linear and BatchNorm under ``module``."""
    def sub(child, name, *path):
        yield from _entries(child, f"{port}{name}.", flax + path)

    def conv(child, name, index):  # a flax Conv wraps one TConv
        yield from sub(child, name, f"Conv_{index}", "TConv_0")

    if isinstance(module, LEAF_TYPES):
        yield port.rstrip("."), flax, module
    elif isinstance(module, (RCAN, QRCAN)):
        group = "ResidualGroup" if isinstance(module, RCAN) else "QResidualGroup"
        yield from conv(module.head, "head", 0)
        for i, g in enumerate(module.groups):
            yield from sub(g, f"groups.{i}", f"{group}_{i}")
        yield from conv(module.body_tail, "body_tail", 1)
        yield from sub(module.upsampler, "upsampler", "Upsampler_0")
        yield from conv(module.tail, "tail", 2)
    elif isinstance(module, (EDSR, QEDSR)):
        body, block = (("body", "ResBlock") if isinstance(module, EDSR)
                       else ("blocks", "ParamResBlock"))
        yield from conv(module.head, "head", 0)
        for i, b in enumerate(getattr(module, body)):
            yield from sub(b, f"{body}.{i}", f"{block}_{i}")
        yield from conv(module.body_tail, "body_tail", 1)
        yield from sub(module.upsampler, "upsampler", "Upsampler_0")
        yield from conv(module.tail, "tail", 2)
    elif isinstance(module, ParamResBlock):
        yield from conv(module.conv1, "conv1", 0)
        yield from conv(module.conv2, "conv2", 1)
        if module.q is not None:
            yield from sub(module.q, "q", "ParaCALayer_0")
    elif isinstance(module, SRMD):
        for i, c in enumerate(module.convs):
            yield from conv(c, f"convs.{i}", i)
    elif isinstance(module, SFTMD):
        for i, c in enumerate(module.convs):
            yield from conv(c, f"convs.{i}", i)
        for i, b in enumerate(module.blocks):
            yield from sub(b, f"blocks.{i}", f"SFTResidualBlock_{i}")
        if module.final_sft is not None:
            yield from sub(module.final_sft, "final_sft", f"{module.final_sft.flax_name}_0")
        if module.final_q is not None:
            yield from sub(module.final_q, "final_q", "ParaCALayer_0")
        yield from sub(module.out, "out", "TConv_0")
    elif isinstance(module, SFTResidualBlock):
        for i, s in enumerate((module.sft1, module.sft2)):
            if s is not None:
                yield from sub(s, f"sft{i + 1}", f"{s.flax_name}_{i}")
        yield from conv(module.conv1, "conv1", 0)
        yield from conv(module.conv2, "conv2", 1)
        for i, q in enumerate((module.q1, module.q2)):
            if q is not None:
                yield from sub(q, f"q{i + 1}", f"ParaCALayer_{i}")
    elif isinstance(module, SftConvs):
        for i, c in enumerate(module.convs):
            yield from conv(c, f"convs.{i}", i)
    elif isinstance(module, (ResidualGroup, QResidualGroup)):
        block = "RCAB" if isinstance(module, ResidualGroup) else "QRCAB"
        for i, b in enumerate(module.blocks):
            yield from sub(b, f"blocks.{i}", f"{block}_{i}")
        yield from conv(module.tail, "tail", 0)
    elif isinstance(module, QRCAB):
        yield from conv(module.conv1, "conv1", 0)
        yield from conv(module.conv2, "conv2", 1)
        yield from sub(module.ca, "ca", "QCALayer_0")
        if module.pa is not None:
            yield from sub(module.pa, "pa", "PALayer_0")
        if module.q is not None:
            yield from sub(module.q, "q", "ParaCALayer_0")
        if module.sft is not None:
            yield from sub(module.sft, "sft", "SFTLayer_0")
    elif isinstance(module, RCAB):
        yield from conv(module.conv1, "conv1", 0)
        yield from conv(module.conv2, "conv2", 1)
        yield from sub(module.ca, "ca", "CALayer_0")
    elif isinstance(module, QCALayer) and module.style == "extended_attention":
        for i, c in enumerate(module.concat):
            yield from sub(c, f"concat.{i}", f"TConv_{i}")
        yield from sub(module.up, "up", f"TConv_{len(module.concat)}")
    elif isinstance(module, (CALayer, QCALayer, PALayer)):
        yield from sub(module.down, "down", "TConv_0")
        yield from sub(module.up, "up", "TConv_1")
    elif isinstance(module, SFTLayer):
        for i, name in enumerate(("scale_out", "scale_in", "shift_out", "shift_in")):
            yield from sub(getattr(module, name), name, f"TConv_{i}")
    elif isinstance(module, ParaCALayer):
        for i, c in enumerate(module.convs):
            yield from sub(c, f"convs.{i}", f"TConv_{i}")
    elif isinstance(module, ResBlock):
        yield from conv(module.conv1, "conv1", 0)
        yield from conv(module.conv2, "conv2", 1)
    elif isinstance(module, Upsampler):
        for i, c in enumerate(module.convs):
            yield from conv(c, f"convs.{i}", i)
    elif isinstance(module, DASREncoder):
        for i, (c, n) in enumerate(zip(module.convs, module.norms)):
            yield from sub(c, f"convs.{i}", f"TConv_{i}")
            yield from sub(n, f"norms.{i}", f"BatchNorm_{i}")
        dense = list(module.mlp) + list(module.dropdown or [])
        for i, d in enumerate(dense):
            name = f"mlp.{i}" if i < 2 else f"dropdown.{i - 2}"
            yield from sub(d, name, f"TDense_{i}")
    elif isinstance(module, EncodingReducer):
        for i, d in enumerate(module.layers):
            yield from sub(d, f"layers.{i}", f"TDense_{i}")
    elif isinstance(module, BlindSRPipeline):
        yield from sub(module.generator, "generator", "generator")
        yield from sub(module.encoder, "encoder", "encoder")
        if module.reducer is not None:
            yield from sub(module.reducer, "reducer", "reducer")
    else:
        raise TypeError(f"no flax name map for {type(module).__name__}")


def _convs(module: nn.Module, port: str, flax: Path) -> Iterator[Tuple[str, Path, Conv]]:
    """(port prefix, flax path of the {kernel, bias} dict, Conv) for every
    conv under ``module``."""
    return ((p, f, m) for p, f, m in _entries(module, port, flax) if isinstance(m, Conv))


# port tensor name -> (flax collection, leaf name) of each leaf type
_LEAVES = {
    Conv: {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    Linear: {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    BatchNorm: {"scale": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var")},
}


def _leaf_names(module: nn.Module) -> Dict[str, Tuple[str, str]]:
    names = dict(_LEAVES[type(module)])
    if isinstance(module, Conv) and module.bias is None:
        del names["bias"]
    return names


def _to_port(arr: np.ndarray, module: nn.Module, name: str) -> np.ndarray:
    if name == "weight" and isinstance(module, Conv):
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if name == "weight" and isinstance(module, Linear):
        return arr.T  # (in, out) -> (out, in)
    return arr


def _to_flax(arr: np.ndarray, module: nn.Module, name: str) -> np.ndarray:
    if name == "weight" and isinstance(module, Conv):
        return arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if name == "weight" and isinstance(module, Linear):
        return arr.T
    return arr


def _lookup(tree: Mapping, path: Path) -> Tuple[Mapping, Path]:
    node, real = tree, ()
    for key in path:
        if not isinstance(node, Mapping):
            raise KeyError(f"flax tree: {'/'.join(real)} is a leaf, not a module")
        if key not in node and f"Checkpoint{key}" in node:
            key = f"Checkpoint{key}"  # nn.remat's renamed module
        if key not in node:
            raise KeyError(f"flax tree is missing {'/'.join(real + (key,))}")
        node, real = node[key], real + (key,)
    return node, real


def _leaves(tree, prefix: Path = ()) -> Iterator[Path]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix


def state_dict_from_jax(params, module: nn.Module,
                        batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Map a flax param tree (nested dicts of arrays, as ``state.params``
    of a JAX handler), and its ``batch_stats`` tree where the module has
    BatchNorm, onto ``module``'s state_dict keys, as float32 CPU tensors
    ready for ``load_state_dict``. Without ``batch_stats`` the BatchNorm
    running statistics are left out of the result (and not asked for)."""
    trees = {"params": params, "batch_stats": batch_stats}
    out: Dict[str, torch.Tensor] = {}
    used = {"params": set(), "batch_stats": set()}
    for port, flax, mod in _entries(module, "", ()):
        nodes = {}
        for name, (collection, leaf) in _leaf_names(mod).items():
            if trees[collection] is None:
                continue
            if collection not in nodes:
                nodes[collection] = _lookup(trees[collection], flax)
            node, real = nodes[collection]
            if leaf not in node:
                raise KeyError(f"flax {collection} tree is missing {'/'.join(real + (leaf,))}")
            arr = node[leaf]
            arr = (arr.float().numpy() if torch.is_tensor(arr)
                   else np.asarray(arr, dtype=np.float32))
            arr = _to_port(arr, mod, name)
            target = tuple(getattr(mod, name).shape)
            if arr.shape != target:
                raise ValueError(f"shape mismatch at {'/'.join(real + (leaf,))}: "
                                 f"{arr.shape} vs {port}.{name} {target}")
            out[f"{port}.{name}"] = torch.from_numpy(arr.copy())
            used[collection].add(real + (leaf,))
    for collection, tree in trees.items():
        if tree is None:
            continue
        unused = sorted("/".join(p) for p in _leaves(tree) if p not in used[collection])
        if unused:
            raise ValueError(f"flax {collection} leaves not used by "
                             f"{type(module).__name__}: {unused}")
    wanted = set(module.state_dict())
    if batch_stats is None:
        wanted -= {k for k in wanted if k.endswith((".running_mean", ".running_var"))}
    missing = sorted(wanted - set(out))
    if missing:
        raise KeyError(f"port parameters with no flax leaf: {missing}")
    return out


def jax_tree_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                             module: nn.Module, collection: str = "params") -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax`: ``module``'s state_dict
    as a flax tree of ``collection`` ("params", or "batch_stats" for the
    BatchNorm running statistics), nested dicts of float32 numpy arrays
    (conv kernels OIHW -> HWIO, dense weights (out, in) -> (in, out)), so
    parameters can be compared leaf for leaf."""
    tree: Dict[str, Any] = {}
    used = set()
    for port, flax, mod in _entries(module, "", ()):
        for name, (coll, leaf) in _leaf_names(mod).items():
            key = f"{port}.{name}"
            used.add(key)
            if coll != collection:
                continue
            node = tree
            for k in flax:
                node = node.setdefault(k, {})
            arr = state_dict[key].detach().cpu().float().numpy()
            node[leaf] = np.ascontiguousarray(_to_flax(arr, mod, name))
    unused = sorted(set(state_dict) - used)
    if unused:
        raise ValueError(f"state_dict entries with no flax leaf: {unused}")
    return tree
