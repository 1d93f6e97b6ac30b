"""Weight bridge to and from the JAX package: flax param tree <-> port
state_dict.

The inverse of ``rumpy_tpu/utils/torch_convert.py::convert_by_order``, but
by name rather than by order: a flax tree that has crossed ``jax.jit``
comes back key-sorted, so ``RCAB_10`` sorts before ``RCAB_2`` and an order
zip would misassign. Each port module knows which flax auto-name each of
its children had. ``nn.remat`` renames ``ResidualGroup_<i>`` to
``CheckpointResidualGroup_<i>``; both are accepted. Conv kernels go
HWIO -> OIHW (the CA 1x1 kernels ``(1,1,C,C//r)`` too). Any unused or
missing leaf, and any shape mismatch, raises. ``jax_tree_from_state_dict``
is the inverse, with flax's plain (not remat) names.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from rumpy_tpu_torch.models.advanced import EDSR, RCAN, ResidualGroup
from rumpy_tpu_torch.models.common import (RCAB, CALayer, Conv, ResBlock,
                                           Upsampler)

Path = Tuple[str, ...]


def _convs(module: nn.Module, port: str, flax: Path) -> Iterator[Tuple[str, Path, Conv]]:
    """(port prefix, flax path of the {kernel, bias} dict, Conv) for every
    conv under ``module``."""
    def sub(child, name, *path):
        yield from _convs(child, f"{port}{name}.", flax + path)

    def conv(child, name, index):  # a flax Conv wraps one TConv
        yield from sub(child, name, f"Conv_{index}", "TConv_0")

    if isinstance(module, Conv):
        yield port.rstrip("."), flax, module
    elif isinstance(module, RCAN):
        yield from conv(module.head, "head", 0)
        for i, g in enumerate(module.groups):
            yield from sub(g, f"groups.{i}", f"ResidualGroup_{i}")
        yield from conv(module.body_tail, "body_tail", 1)
        yield from sub(module.upsampler, "upsampler", "Upsampler_0")
        yield from conv(module.tail, "tail", 2)
    elif isinstance(module, EDSR):
        yield from conv(module.head, "head", 0)
        for i, b in enumerate(module.body):
            yield from sub(b, f"body.{i}", f"ResBlock_{i}")
        yield from conv(module.body_tail, "body_tail", 1)
        yield from sub(module.upsampler, "upsampler", "Upsampler_0")
        yield from conv(module.tail, "tail", 2)
    elif isinstance(module, ResidualGroup):
        for i, b in enumerate(module.blocks):
            yield from sub(b, f"blocks.{i}", f"RCAB_{i}")
        yield from conv(module.tail, "tail", 0)
    elif isinstance(module, RCAB):
        yield from conv(module.conv1, "conv1", 0)
        yield from conv(module.conv2, "conv2", 1)
        yield from sub(module.ca, "ca", "CALayer_0")
    elif isinstance(module, CALayer):
        yield from sub(module.down, "down", "TConv_0")
        yield from sub(module.up, "up", "TConv_1")
    elif isinstance(module, ResBlock):
        yield from conv(module.conv1, "conv1", 0)
        yield from conv(module.conv2, "conv2", 1)
    elif isinstance(module, Upsampler):
        for i, c in enumerate(module.convs):
            yield from conv(c, f"convs.{i}", i)
    else:
        raise TypeError(f"no flax name map for {type(module).__name__}")


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


def state_dict_from_jax(params, module: nn.Module) -> Dict[str, torch.Tensor]:
    """Map a flax param tree (nested dicts of arrays, as ``state.params``
    of a JAX handler) onto ``module``'s state_dict keys, as float32 CPU
    tensors ready for ``load_state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for port, flax, conv in _convs(module, "", ()):
        node, real = _lookup(params, flax)
        wanted = {"weight": "kernel"}
        if conv.bias is not None:
            wanted["bias"] = "bias"
        for name, leaf in wanted.items():
            if leaf not in node:
                raise KeyError(f"flax tree is missing {'/'.join(real + (leaf,))}")
            arr = np.asarray(node[leaf], dtype=np.float32)
            if name == "weight":
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            target = tuple(getattr(conv, name).shape)
            if arr.shape != target:
                raise ValueError(f"shape mismatch at {'/'.join(real + (leaf,))}: "
                                 f"{arr.shape} vs {port}.{name} {target}")
            out[f"{port}.{name}"] = torch.from_numpy(arr.copy())
            used.add(real + (leaf,))
    unused = sorted("/".join(p) for p in _leaves(params) if p not in used)
    if unused:
        raise ValueError(f"flax leaves not used by {type(module).__name__}: {unused}")
    missing = sorted(set(module.state_dict()) - set(out))
    if missing:
        raise KeyError(f"port parameters with no flax leaf: {missing}")
    return out


def jax_tree_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                             module: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax`: ``module``'s state_dict
    as a flax param tree (nested dicts of float32 numpy arrays, conv
    kernels OIHW -> HWIO), so parameters can be compared leaf for leaf."""
    tree: Dict[str, Any] = {}
    used = set()
    for port, flax, conv in _convs(module, "", ()):
        node = tree
        for key in flax:
            node = node.setdefault(key, {})
        w = state_dict[f"{port}.weight"].detach().cpu().float().numpy()
        node["kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        used.add(f"{port}.weight")
        if conv.bias is not None:
            node["bias"] = state_dict[f"{port}.bias"].detach().cpu().float().numpy().copy()
            used.add(f"{port}.bias")
    unused = sorted(set(state_dict) - used)
    if unused:
        raise ValueError(f"state_dict entries with no flax leaf: {unused}")
    return tree
