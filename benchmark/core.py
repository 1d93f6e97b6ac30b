"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (one entry of ``workloads``) is assembled from files found by name:
``configs/<config>.json`` (sizes, the program's handler and options, the
plain reference's module ``reference/<reference>.py``, the families of
leaves that ``check.py`` compares), ``traffic/<mix>.json`` (parameters,
read by the generator of its ``kind``, ``generators/<kind>.py``),
``limits/<cell>.json`` (the limits of the numbers that decide ``correct``)
and ``metrics/<metric>.py`` (a per-layer metric's reader). Adding a cell,
a configuration, a mix, a kind of traffic or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rumpy_tpu")


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def reference_module(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, workload: str) -> dict:
    """The cell ``workload`` with its files read."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return {
        "name": w["name"], "chips": w["chips"],
        "config": read_json(os.path.join(ROOT, cfg_entry["file"])),
        "traffic": read_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
        "limits": read_json(os.path.join(HERE, "limits", f"{w['name']}.json")),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, w["name"])],
        "per_layer": [m for m in bench["per_layer"] if applies(m, w["name"])],
    }


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole (``rumpy_tpu_torch`` is not
    ``rumpy_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_cards(count: int) -> None:
    import torch
    if not torch.cuda.is_available():
        print("benchmark: CUDA is not available", file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < count:
        print(f"benchmark: {torch.cuda.device_count()} CUDA devices, the cell needs {count}",
              file=sys.stderr)
        raise SystemExit(2)
