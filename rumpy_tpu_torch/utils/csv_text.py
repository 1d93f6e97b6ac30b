"""CSV files in the text pandas' ``to_csv`` gives the JAX package, written
with the ``csv`` module (pandas is not on the card machine): floats as
their float64 ``repr``, NaN and None empty, lists as ``"[a, b]"``."""

from __future__ import annotations

import csv
import math
from typing import Any, Dict, Iterable, List, Sequence

import numpy as np


def _is_int(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))


def _is_number(v) -> bool:
    return _is_int(v) or (isinstance(v, (float, np.floating)) and not isinstance(v, bool))


def _missing(v) -> bool:
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def float_cell(v) -> str:
    """A float as pandas writes it in a float column: its float64 repr, NaN
    and None empty."""
    return "" if _missing(v) else repr(float(v))


def csv_cells(values: List[Any]) -> List[str]:
    """A column's cells as pandas' ``to_csv`` writes them: an all-integer
    column as integers; a numeric one (a missing value counts as NaN) as
    float64 reprs, NaN empty; anything else (lists, strings, tuples) as
    ``str`` of each value, None empty."""
    present = [v for v in values if not _missing(v)]
    if present and all(_is_int(v) for v in values):
        return [str(int(v)) for v in values]
    if present and all(_missing(v) or _is_number(v) for v in values):
        return [float_cell(v) for v in values]
    return [float_cell(v) if _missing(v) or isinstance(v, np.floating) else str(v)
            for v in values]


def write_rows(path: str, rows: Iterable[Sequence[str]]) -> None:
    """Rows of cells, one line each, ``\\n``-terminated as pandas ends them."""
    with open(path, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)


def write_table(path: str, index_name: str, index: List[Any],
                columns: Dict[str, List[Any]]) -> None:
    """One header row (``index_name`` then the columns) and a row an index
    entry, each column's cells as :func:`csv_cells` writes them."""
    cells = [csv_cells(v) for v in columns.values()]
    write_rows(path, [[index_name] + list(columns)]
               + [[label] + [c[i] for c in cells] for i, label in enumerate(index)])
