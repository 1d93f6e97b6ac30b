"""Training statistics: summary.csv append, load and truncate.

Port of ``rumpy_tpu/utils/stats.py`` over the standard ``csv`` module: one
row per epoch appended to ``result_outputs/summary.csv``, new metric
columns zero-backfilled for earlier epochs, and ``loss_plots.pdf`` with one
subplot per metric (matplotlib, imported when called: the package does
not need it).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np


def _read(path: str):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        return list(reader.fieldnames or []), rows


def _write(path: str, columns: List[str], rows: List[Dict]) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns)
        writer.writeheader()
        writer.writerows(rows)
    os.replace(tmp, path)


def _number(text: str) -> float:
    return 0.0 if text in ("", None) else float(text)


def save_statistics(log_dir: str, stats: Dict[str, float],
                    filename: str = "summary.csv") -> str:
    """Append one epoch row; align columns with any existing file,
    zero-filling metrics that a row lacks."""
    path = os.path.join(log_dir, filename)
    os.makedirs(log_dir, exist_ok=True)
    columns, rows = _read(path) if os.path.isfile(path) else ([], [])
    columns += [k for k in stats if k not in columns]
    rows.append(dict(stats))
    _write(path, columns, [{c: r.get(c) if r.get(c) not in ("", None) else 0.0
                            for c in columns} for r in rows])
    return path


def load_statistics(log_dir: str, filename: str = "summary.csv"
                    ) -> Optional[Dict[str, List[float]]]:
    """The columns of summary.csv as lists of floats; None without a file."""
    path = os.path.join(log_dir, filename)
    if not os.path.isfile(path):
        return None
    columns, rows = _read(path)
    return {c: [_number(r[c]) for r in rows] for c in columns}


def truncate_statistics(log_dir: str, epoch: int,
                        filename: str = "summary.csv") -> None:
    """Drop rows past ``epoch`` on resume/branch."""
    path = os.path.join(log_dir, filename)
    if not os.path.isfile(path):
        return
    columns, rows = _read(path)
    if "epoch" in columns:
        rows = [r for r in rows if _number(r["epoch"]) <= epoch]
    else:
        rows = rows[: epoch + 1]
    _write(path, columns, rows)


def plot_stats(log_dir: str, stats: Optional[Dict[str, List[float]]] = None,
               filename: str = "loss_plots.pdf") -> Optional[str]:
    """One subplot per metric column against epoch, three a row, into
    ``log_dir/filename``; ``stats`` as :func:`load_statistics` returns it
    (read from summary.csv when not given). Returns the file's path, or
    None where there is no metric to plot."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if stats is None:
        stats = load_statistics(log_dir)
    cols = [c for c in stats or {} if c != "epoch"]
    if not cols:
        return None
    n = len(cols)
    ncols = min(3, n)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(5 * ncols, 3.5 * nrows), squeeze=False)
    x = stats["epoch"] if "epoch" in stats else np.arange(len(stats[cols[0]]))
    for i, c in enumerate(cols):
        ax = axes[i // ncols][i % ncols]
        ax.plot(x, stats[c])
        ax.set_title(c)
        ax.set_xlabel("epoch")
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    out = os.path.join(log_dir, filename)
    fig.savefig(out)
    plt.close(fig)
    return out
