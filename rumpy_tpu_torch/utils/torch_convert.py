"""Reference (RUMpy) torch checkpoints onto port modules, by registration order.

Port of ``rumpy_tpu/utils/torch_convert.py``. The reference's networks and
the JAX package's register their parameters in the same order, so a
reference state dict converts by zipping its tensors with the flax tree's
leaves in order, each in the flax layout:

* conv3d weight OIDHW -> DHWIO, conv weight OIHW -> HWIO;
* linear weight (out, in) -> (in, out);
* every other tensor (biases, BatchNorm's weight and bias) as it is; the
  BatchNorm running statistics are not zipped.

The flax-layout template of a port module is
``utils/weights.py::jax_tree_from_state_dict`` of its state dict, and the
converted tree goes back onto the module through
``utils/weights.py::state_dict_from_jax``: the port keeps one mapping
between the two layouts. A shape that differs, a template leaf with no
torch tensor left, and torch tensors left over raise ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from rumpy_tpu_torch.utils.weights import jax_tree_from_state_dict, state_dict_from_jax

# torch layout -> flax layout, by the tensor's rank
_LAYOUTS = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}


def _flatten_with_paths(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """The leaves of a nested dict in its order, with their paths. A leaf
    dict of ``kernel`` and ``bias`` (or ``scale`` and ``bias``) gives the
    weight first whatever its key order, as a key-sorted tree (one that
    crossed a ``jax.jit``) would put ``bias`` first."""
    out: List[Tuple[Tuple[str, ...], Any]] = []
    if isinstance(tree, Mapping):
        keys = list(tree.keys())
        if set(keys) == {"kernel", "bias"}:
            keys = ["kernel", "bias"]
        elif set(keys) == {"scale", "bias"}:
            keys = ["scale", "bias"]
        for k in keys:
            out.extend(_flatten_with_paths(tree[k], prefix + (k,)))
    else:
        out.append((prefix, tree))
    return out


def convert_by_order(torch_state: Mapping[str, torch.Tensor],
                     module: torch.nn.Module) -> Dict[str, Any]:
    """The tensors of ``torch_state`` (less the BatchNorm running
    statistics) zipped in order onto the leaves of ``module``'s flax-layout
    param tree, each transposed to the flax layout. Returns the tree,
    nested dicts of float32 numpy arrays, in the template's order."""
    template = jax_tree_from_state_dict(module.state_dict(), module)
    torch_items = [(k, v) for k, v in torch_state.items()
                   if "running_" not in k and "num_batches" not in k]
    new_leaves = {}
    ti = 0
    for path, leaf in _flatten_with_paths(template):
        if ti >= len(torch_items):
            raise ValueError(f"ran out of torch params at {path}")
        name, tensor = torch_items[ti]
        arr = tensor.detach().cpu().float().numpy()
        arr = arr.transpose(_LAYOUTS[arr.ndim]) if arr.ndim in _LAYOUTS else arr
        leaf_shape = tuple(leaf.shape)
        if arr.shape != leaf_shape:
            raise ValueError(f"shape mismatch at {path}: torch {name} {arr.shape} "
                             f"vs flax {leaf_shape}")
        new_leaves[path] = np.array(arr, dtype=np.float32)  # a copy, C order
        ti += 1
    if ti != len(torch_items):
        raise ValueError(f"{len(torch_items) - ti} torch params unused")

    def rebuild(tree, prefix=()):
        if isinstance(tree, Mapping):
            return {k: rebuild(v, prefix + (k,)) for k, v in tree.items()}
        return new_leaves[prefix]

    return rebuild(template)


@torch.no_grad()
def load_reference_checkpoint(torch_ckpt_path: str, handler, state=None):
    """A reference ``train_model_N`` torch checkpoint's network weights
    (``payload["network"]``, or the payload itself where it is a bare
    state dict) loaded into ``handler.module`` on its device; the BatchNorm
    running statistics keep their values. Returns the handler's state
    (``state``'s step and extra where given)."""
    payload = torch.load(torch_ckpt_path, map_location="cpu")
    net_state = payload.get("network", payload)
    module = handler.module
    tree = convert_by_order(net_state, module)
    module.load_state_dict(state_dict_from_jax(tree, module), strict=False)
    if state is None:
        return handler._own_state()
    return handler._own_state(state.step, state.extra)
