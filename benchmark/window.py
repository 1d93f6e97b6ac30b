"""One run of a cell: the generator of its traffic's ``kind``, found by name
as ``generators/<kind>.py``, and what the generators share.

A generator module has ``run(cell, seed, seconds, traced, devices,
t_start) -> dict``: it builds the program on ``devices`` (the cell's
cards), sets up and warms up from the seed, measures for ``seconds``,
optionally traces, frees the program, runs the plain reference and
returns ``attempted``, ``failed``, ``setup_s``, ``memory_peak_bytes`` (the
fullest card's), ``end_to_end`` (the cell's end-to-end metrics but
``setup_s``), ``run`` (what the per-layer readers in ``metrics/`` read),
``numbers`` (what decides ``correct``), ``reference`` (the reference's
raw outputs, which ``control.py`` compares the control with) and
``detail``. A new kind of traffic is a new file there; the traffic files
of one kind are its parameters.
"""

from __future__ import annotations

import gc
import importlib

import torch


def generator(kind: str):
    """The module ``generators/<kind>.py``."""
    return importlib.import_module(f"benchmark.generators.{kind}")


def run(cell: dict, seed: int, seconds: float, traced: bool, devices, t_start: float) -> dict:
    """Run ``cell`` once on ``devices`` (a list, one entry a card)."""
    return generator(cell["traffic"]["kind"]).run(cell, seed, seconds, traced, list(devices),
                                                   t_start)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values, q: float) -> float:
    """The q-th percentile of all values (linear between order
    statistics, numpy's default)."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def finite(v: float) -> bool:
    return v == v and abs(v) != float("inf")
