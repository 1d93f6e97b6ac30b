"""Training statistics: summary.csv append, load and truncate.

Port of ``rumpy_tpu/utils/stats.py`` over the standard ``csv`` module: one
row per epoch appended to ``result_outputs/summary.csv``, new metric
columns zero-backfilled for earlier epochs. ``plot_stats`` waits for a
later slice.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional


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
