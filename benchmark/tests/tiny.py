"""Tiny cells for the CPU: the benchmark's cells with 16 features, one group
of two blocks, and small batches and images."""

import copy

from benchmark import core

TINY_SEED = 2 ** 33 + 5


def cells(kind: str) -> list:
    """The benchmark's cells whose traffic is of ``kind``."""
    bench = core.load_benchmark()
    return [w["name"] for w in bench["workloads"]
            if core.cell(bench, w["name"])["traffic"]["kind"] == kind]


def tiny_cell(name: str, dtype: str = "bf16") -> dict:
    cell = copy.deepcopy(core.cell(core.load_benchmark(), name))
    cell["config"].update(n_feats=16, n_resgroups=1, n_resblocks=2, dtype=dtype)
    t = cell["traffic"]
    if t["kind"] == "train":
        t.update(batch=4, hr_side=32, reference_rows=3)
    else:
        t.update(hr_sizes=[[64, 96]], pool=2, sample_from=4, sample=2)
    return cell
