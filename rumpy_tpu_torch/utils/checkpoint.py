"""Checkpoint store.

Port of ``rumpy_tpu/utils/checkpoint.py``, with the same contract: one file
per epoch, ``saved_models/train_model_<epoch>``, holding the network
weights, optional optimizer state, step and the metadata keys
``model_name``, ``model_epoch`` and ``handler_metadata``; ``best | last |
<int>`` selection driven by ``result_outputs/summary.csv``. Files are
written with ``torch.save`` and read with ``torch.load(weights_only=True)``.
Reading the JAX package's flax-msgpack checkpoints is not supported yet.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Any, Dict, Optional

import torch

from rumpy_tpu_torch.config.constants import metric_best_val

CKPT_PREFIX = "train_model_"

# Keys holding JSON-able metadata rather than tensors.
_META_KEYS = ("model_name", "model_epoch", "handler_metadata")


def save_checkpoint(path: str, payload: Dict[str, Any],
                    minimal: bool = False) -> None:
    payload = dict(payload)
    if minimal:
        payload.pop("optimizer", None)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)


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
