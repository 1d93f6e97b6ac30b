"""Degradation-metadata CSV ingestion.

Port of ``rumpy_tpu/data/metadata.py`` with the ``csv`` module and
``json`` in place of pandas: the first column names the image, list-valued
columns (JSON) expand into repeated keys, numeric columns normalize to
[0, 1] by their min and max (QPI pinned to the (20, 40) range when
``force_qpi_range``), optional QPI band filtering, keys lowercased, and
the ``N-`` degradation-position prefix stripped on request. A column is
numeric, as pandas infers it, when every cell parses as a number (an
empty cell is NaN) or every cell is ``True``/``False``.

``read_celeba_attributes`` reads CelebA's ``list_attr_celeba.txt`` layout
(a count line, a line of attribute names, then one whitespace-separated
row an image whose first field, the image name, is one field more than
the names) with the stdlib, as ``pd.read_csv(..., skiprows=1,
sep=r"\\s+")`` reads it.
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


def _read_attribute_table(path: str) -> Tuple[List[str], Dict[str, List[int]]]:
    """(attribute names, {image name: its row of -1/1 values}) of a
    ``list_attr_celeba.txt`` file; a repeated image name keeps its last
    row."""
    with open(path) as fh:
        fh.readline()  # the image count
        names = fh.readline().split()
        rows: Dict[str, List[int]] = {}
        for line in fh:
            fields = line.split()
            if not fields:
                continue
            if len(fields) != len(names) + 1:
                raise ValueError(f"{path}: a row of {len(fields)} fields under "
                                 f"{len(names)} attribute names")
            rows[fields[0]] = [int(v) for v in fields[1:]]
    return names, rows


def read_celeba_attributes(attributes_loc: str, image_dict: Dict[str, np.ndarray],
                           selected_metadata="all", attribute_amplification=None
                           ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Merge CelebA facial attributes into an image metadata dict: the
    table's -1/1 values become 0/1 (or -2/2 with
    ``attribute_amplification``), restricted to ``selected_metadata`` in its
    order unless it is ``"all"`` (``Young`` answers to ``age`` and ``Male``
    to ``gender`` when those are selected), and prepended to each image's
    vector. An image is looked up by its CelebA stem: ``NNNNNN.jpg`` of
    ``NNNNNN_anything.ext``. Returns ({image: float32 vector}, attribute
    keys)."""
    names, rows = _read_attribute_table(attributes_loc)
    if attribute_amplification is not None:
        def level(v):
            return -2.0 if v < 0 else (2.0 if v > 0 else 0.0)
    else:
        def level(v):
            return 0.0 if v < 0 else float(v)
    columns = list(range(len(names)))
    if selected_metadata != "all":
        aliases = {}
        if "age" in selected_metadata:
            aliases["Young"] = "age"
        if "gender" in selected_metadata:
            aliases["Male"] = "gender"
        names = [aliases.get(n, n) for n in names]
        missing = [k for k in selected_metadata if k not in names]
        if missing:
            raise KeyError(f"{missing} not among the attributes of {attributes_loc}")
        columns = [names.index(k) for k in selected_metadata]
        names = list(selected_metadata)
    out = {}
    for key in sorted(image_dict):
        stem = key.split("_")[0].split(".")[0] + ".jpg"
        row = rows[stem]
        added = np.asarray([level(row[j]) for j in columns], np.float32)
        out[key] = np.concatenate([added, image_dict[key]])
    return out, names


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
