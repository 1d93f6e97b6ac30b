"""Readers shared by the per-layer metrics in ``metrics/``. Each takes the
run (the ``run`` record of a generator in ``generators/``) and returns a
number, or None where the run has nothing to read (another kind of
traffic, no trace, no range that matched)."""

from __future__ import annotations

from benchmark import roofline
from benchmark.trace import union_us


def _trace(run, kind, which="trace"):
    """The run's trace with the host's ops ("trace"), or of the CUDA
    activity alone ("lean"), where the run is of ``kind``."""
    if run.get("kind") != kind:
        return None
    return run.get(which)


def kernels_per_unit(run, kind):
    t = _trace(run, kind, "lean")
    if t is None:
        return None
    return sum(1 for e in t.device if e["cat"] == "kernel") / t.units


def range_device_ms(run, kind, name: str):
    """Device ms a step or image of the operations launched inside the
    benchmark's host range ``name``."""
    t = _trace(run, kind)
    if t is None:
        return None
    events = t.launched_in(lambda n: n == name)
    return union_us(events) / 1e3 / t.units if events else None


def mfu(run, kind):
    """The window's model FLOPs over its seconds times the peak of the
    configuration's type, in percent."""
    if run.get("kind") != kind or not run.get("window_units"):
        return None
    return run["window_flops"] / (run["window_s"] * roofline.PEAK_FLOPS[run["dtype"]]) * 100


def block_roofline(run, kind, match, work):
    """The least time of the block calls found (each traced unit's launch
    shape, by ``work``, times the calls a unit) over the device time of
    the operations launched inside them, in percent. ``match`` picks the
    host ranges of one call each."""
    t = _trace(run, kind)
    if t is None:
        return None
    events = t.launched_in(match)
    calls = sum(len(v) for v in t.ranges(match).values())
    if not events or not calls:
        return None
    shapes = run["unit_shapes"]
    least = calls / len(shapes) * sum(
        roofline.least_seconds(*work(*shape, run["dtype"]), run["dtype"]) for shape in shapes)
    return least / (union_us(events) / 1e6) * 100


def idle_share(run, kind):
    t = _trace(run, kind, "lean")
    if t is None:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100


def peak_gib(run, kind):
    if run.get("kind") != kind:
        return None
    return run["peak_window_bytes"] / 2 ** 30
