"""Checkpoint store.

Port of ``rumpy_tpu/utils/checkpoint.py``, with the same contract: one file
per epoch, ``saved_models/train_model_<epoch>``, holding the network
weights, optional optimizer state, step and the metadata keys
``model_name``, ``model_epoch`` and ``handler_metadata``; ``best | last |
<int>`` selection driven by ``result_outputs/summary.csv``. Files are
written with ``torch.save`` and read with ``torch.load(weights_only=True)``.
:func:`load_checkpoint` reads the JAX package's flax-msgpack files too,
under the same names, through the pure-Python reader ``utils/flax_msgpack``:
it tells the formats apart by their first bytes (a torch file is a zip,
``PK\\x03\\x04``; a flax file starts with a msgpack map header).
"""

from __future__ import annotations

import csv
import json
import os
import re
from typing import Any, Dict, Optional

import torch

from rumpy_tpu_torch.config.constants import metric_best_val
from rumpy_tpu_torch.parallel.mesh import process_index
from rumpy_tpu_torch.utils import flax_msgpack

CKPT_PREFIX = "train_model_"
# Packaged pretrained networks, <dir>/<name>/saved_models: the JAX package's
# directory, read as data (nothing of that package is imported).
PRETRAINED_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "rumpy_tpu", "pretrained")

# Keys holding JSON-able metadata rather than tensors.
_META_KEYS = ("model_name", "model_epoch", "handler_metadata")


def save_checkpoint(path: str, payload: Dict[str, Any],
                    minimal: bool = False) -> None:
    """``payload`` to ``path`` through a temporary file. In a data-parallel
    group every rank holds the same state and only rank 0 writes."""
    if process_index() != 0:
        return
    payload = dict(payload)
    if minimal:
        payload.pop("optimizer", None)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def checkpoint_format(path: str) -> str:
    """``"torch"`` or ``"flax"``, from the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"PK\x03\x04":
        return "torch"
    if flax_msgpack.is_msgpack_map(head):
        return "flax"
    raise ValueError(f"{path}: neither a torch checkpoint nor a flax-msgpack one "
                     f"(starts with {head!r})")


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """A checkpoint's payload. A flax file gives the JAX package's payload:
    its array tree (``network``, ``step``, ``rng``, ``extra``, and
    ``optimizer`` unless it was saved minimal) with numpy leaves, and the
    keys of its ``meta_json``."""
    if checkpoint_format(path) == "torch":
        return torch.load(path, map_location=map_location, weights_only=True)
    with open(path, "rb") as f:
        blob = flax_msgpack.msgpack_restore(f.read())
    out = dict(blob["arrays"])
    out.update(json.loads(bytes(blob["meta_json"]).decode()))
    return out


def checkpoint_path(model_save_dir: str, epoch: int) -> str:
    return os.path.join(model_save_dir, f"{CKPT_PREFIX}{epoch}")


def available_epochs(model_save_dir: str):
    if not os.path.isdir(model_save_dir):
        return []
    eps = []
    for fname in os.listdir(model_save_dir):
        m = re.fullmatch(rf"{CKPT_PREFIX}(\d+)", fname)
        if m:
            eps.append(int(m.group(1)))
    return sorted(eps)


def resolve_packaged(path_or_name: str) -> str:
    """A checkpoint directory, or the ``saved_models`` directory of a
    packaged pretrained network of that name. Raises when neither holds
    checkpoints."""
    if available_epochs(path_or_name):
        return path_or_name
    packaged = os.path.join(PRETRAINED_DIR, path_or_name, "saved_models")
    if available_epochs(packaged):
        return packaged
    raise RuntimeError(
        f"The warm start model '{path_or_name}' is not available (no "
        f"checkpoints there, and no packaged network at {packaged}).")


def _read_summary(summary_csv: str) -> Dict[str, list]:
    """Columns of a summary.csv as lists of strings."""
    with open(summary_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = list(rows[0]) if rows else []
    return {k: [row[k] for row in rows] for k in cols}


def select_epoch(model_save_dir: str, which, summary_csv: Optional[str] = None,
                 metric: str = "val-PSNR",
                 fallback: Optional[str] = None) -> int:
    """Resolve 'best' | 'last' | int to a concrete epoch number.

    'best' requires a readable summary.csv with a known metric column; an
    ambiguous 'best' raises unless the caller passes a ``fallback``
    selector (e.g. 'last')."""
    if isinstance(which, int):
        return which
    if isinstance(which, str) and which.lstrip("-").isdigit():
        return int(which)  # CLI flags arrive as strings
    eps = available_epochs(model_save_dir)
    if not eps:
        raise FileNotFoundError(f"No checkpoints in {model_save_dir}")
    if which == "last":
        return eps[-1]
    if which == "best":
        if summary_csv is None or not os.path.isfile(summary_csv):
            if fallback is not None:
                return select_epoch(model_save_dir, fallback)
            raise FileNotFoundError(
                f"'best' epoch requested but no summary.csv found at "
                f"{summary_csv!r}; pass fallback='last' to accept the "
                f"latest checkpoint instead")
        cols = _read_summary(summary_csv)
        if metric not in cols:
            present = [m for m in metric_best_val if m in cols]
            if not present:
                if fallback is not None:
                    return select_epoch(model_save_dir, fallback)
                raise ValueError(
                    f"'best' epoch requested but {summary_csv} has no "
                    f"known metric column (looked for {metric!r} and "
                    f"{sorted(metric_best_val)}); pass fallback='last' "
                    f"to accept the latest checkpoint")
            metric = present[0]
        values = [float(v) for v in cols[metric]]
        epochs = ([int(float(e)) for e in cols["epoch"]] if "epoch" in cols
                  else list(range(len(values))))
        # rows of an aborted earlier run: the last row per epoch wins
        last_row = {e: i for i, e in enumerate(epochs)}
        rows = sorted(last_row.values())
        direction = metric_best_val.get(metric, "max")
        pick = max if direction == "max" else min
        idx = pick(rows, key=lambda i: values[i])  # first best, as idxmax
        epoch = epochs[idx]
        # snap to an existing checkpoint (pruned epochs)
        return min(eps, key=lambda e: abs(e - epoch))
    raise ValueError(f"Unknown epoch selector {which!r}")
