"""Degradation-metadata CSV ingestion.

Port of ``rumpy_tpu/data/metadata.py`` with the ``csv`` module and
``json`` in place of pandas: the first column names the image, list-valued
columns (JSON) expand into repeated keys, numeric columns normalize to
[0, 1] by their min and max (QPI pinned to the (20, 40) range when
``force_qpi_range``), optional QPI band filtering, keys lowercased, and
the ``N-`` degradation-position prefix stripped on request. A column is
numeric, as pandas infers it, when every cell parses as a number (an
empty cell is NaN) or every cell is ``True``/``False``.
CelebA attributes come with ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import csv
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _number(cell: str) -> Optional[float]:
    """The cell as pandas reads a numeric cell, or None if it is not one."""
    s = cell.strip()
    if s == "":
        return math.nan
    try:
        return float(s)
    except ValueError:
        return None


def _column(cells: List[str]) -> Tuple[str, list]:
    """('numeric', floats) or ('object', cells), by pandas' inference."""
    if cells and all(c.strip() in ("True", "False") for c in cells):
        return "numeric", [1.0 if c.strip() == "True" else 0.0 for c in cells]
    values = [_number(c) for c in cells]
    if all(v is not None for v in values):
        return "numeric", values
    return "object", cells


def read_augmentation_list(metadata_file: Optional[str], filenames: Sequence[str],
                           normalize=True, ignore_degradation_location: bool = False,
                           force_qpi_range: bool = True,
                           qpi_selection: Optional[Sequence[float]] = None,
                           attribute_skip: Optional[Sequence[str]] = None,
                           ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """({filename: float32 metadata row}, keys) for ``filenames`` from the
    CSV at ``metadata_file``."""
    keys: List[str] = []
    qpi_cutoffs = bool(qpi_selection) and None not in qpi_selection
    if metadata_file is None:
        return {f: np.array([]) for f in filenames}, keys

    with open(metadata_file, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = [r for r in reader if r]
    names = [r[0] for r in rows]
    columns = header[1:]
    if ignore_degradation_location:
        columns = [c[2:] if c[:1].isdigit() else c for c in columns]

    parsed: List[list] = []  # per kept column, its values row by row
    for j, col in enumerate(columns):
        if attribute_skip and col in attribute_skip:
            continue
        kind, values = _column([r[j + 1] for r in rows])
        if kind == "object":
            values = [json.loads(v) for v in values]
            keys.extend([col.lower()] * len(values[0]))
        else:
            keys.append(col.lower())
            if col == "QPI" and force_qpi_range:
                lo, hi = 20.0, 40.0
            else:
                finite = [v for v in values if not math.isnan(v)]
                lo, hi = (min(finite), max(finite)) if finite else (math.nan, math.nan)
            wants_norm = (col in normalize if isinstance(normalize, list)
                          else bool(normalize))
            if wants_norm and hi > lo:
                values = [(v - lo) / (hi - lo) for v in values]
                if col == "QPI" and qpi_cutoffs:
                    qpi_selection = [(q - lo) / (hi - lo) for q in qpi_selection]
        parsed.append(values)

    by_name = {}
    for i, name in enumerate(names):
        vals: List[float] = []
        for values in parsed:
            v = values[i]
            vals.extend(v if isinstance(v, list) else [v])
        by_name[name] = vals
    out = {name: np.asarray(by_name[name], dtype=np.float32) for name in filenames}

    if qpi_cutoffs and "qpi" in keys:
        pos = keys.index("qpi")
        out = {im: v for im, v in out.items()
               if qpi_selection[0] <= v[pos] <= qpi_selection[-1]}
    return out, keys


def select_metadata(vector: np.ndarray, keys: Sequence[str],
                    requested: Sequence[str]) -> np.ndarray:
    """The entries whose key matches a requested key, in the request's
    order; a repeated key (the columns of one list value) gives all its
    entries."""
    out: List[float] = []
    for req in requested:
        for i, k in enumerate(keys):
            if k == req or k.endswith(f"-{req}"):
                out.append(vector[i])
    return np.asarray(out, dtype=np.float32)
