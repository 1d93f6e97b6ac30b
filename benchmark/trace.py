"""A profiler window and the arithmetic that reads it.

``kernel_name`` and ``union_us`` are frozen copies of ``chip_smoke.py``'s
functions of those names (the port's smoke run, as of the benchmark's first
version): a kernel's own name out of the profiler's, and the time covered
by the union of intervals (a programmatic dependent launch starts before
the kernel ahead of it ends, so sums of durations count overlaps twice).
``profiled`` follows ``chip_smoke.py::traced``: a ``torch.profiler`` session
(CUDA activity, and the host's ops where asked), its Chrome trace read back
as JSON, traced again when a session records no device event (seen now and
then on the card).

On top of those, :class:`Trace` attributes each device operation to the
host range it was launched from: a kernel's launch (the runtime call with
the same correlation id) lies inside a ``record_function`` range, or inside
an autograd node's op, on the launching thread.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_name(traced_name: str) -> str:
    """A kernel's own name out of the profiler's: no return type, namespace,
    template or argument list."""
    name = traced_name.replace("(anonymous namespace)::", "")
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", name.replace("void ", ""))
    return m.group(1) if m else traced_name


def union_us(events):
    """The time covered by the union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):
        start, stop = max(e["ts"], end), e["ts"] + e["dur"]
        if stop > start:
            busy += stop - start
        end = max(end, stop)
    return busy


def merged(events):
    """The union of the events' intervals as sorted disjoint (start, end)."""
    out = []
    for e in sorted(events, key=lambda e: e["ts"]):
        s, t = e["ts"], e["ts"] + e["dur"]
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


class Trace:
    """One profiler session's events, with the host-side window length."""

    def __init__(self, events, window_s: float, units: int):
        self.window_s = window_s
        self.units = units  # steps or images traced
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.host = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") in ("cpu_op", "user_annotation", "python_function")]
        launches = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                    "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = e
        self.launch_of = {id(e): launches.get(e.get("args", {}).get("correlation"))
                          for e in self.device}
        self.busy_s = union_us(self.device) / 1e6

    def ranges(self, match):
        """The host events whose name ``match`` accepts, merged by thread
        (nested ones into the outer): {tid: sorted disjoint [start, end]}."""
        out = defaultdict(list)
        for e in self.host:
            if match(e["name"]):
                out[e["tid"]].append(e)
        return {t: merged(v) for t, v in out.items()}

    def launched_in(self, match):
        """The device events launched inside a host range ``match`` accepts."""
        spans = self.ranges(match)
        starts = {t: [s for s, _ in v] for t, v in spans.items()}
        out = []
        for e in self.device:
            launch = self.launch_of[id(e)]
            if launch is None or launch["tid"] not in spans:
                continue
            v = spans[launch["tid"]]
            i = bisect.bisect_right(starts[launch["tid"]], launch["ts"]) - 1
            if i >= 0 and launch["ts"] <= v[i][1]:
                out.append(e)
        return out

    def device_ops(self, top: int = 10):
        """The device operations that took most time, by kernel name."""
        by = defaultdict(float)
        for e in self.device:
            by[kernel_name(e["name"])] += e["dur"] / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """Idle time of the device, by what the launching thread was doing:
        each gap between device operations is named after the innermost host
        op that covers its start on the thread that launched the operation
        ending the gap, and gaps are summed by name."""
        busy = merged(self.device)
        by_start = sorted(self.device, key=lambda e: e["ts"])
        firsts = [e["ts"] for e in by_start]
        host_by_tid = defaultdict(list)
        for e in self.host:
            host_by_tid[e["tid"]].append(e)
        stacks = {tid: _Nesting(v) for tid, v in host_by_tid.items()}
        by = defaultdict(float)
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            gap = (nxt - end) / 1e6
            e = by_start[bisect.bisect_left(firsts, nxt)]
            launch = self.launch_of[id(e)]
            name = "unattributed"
            if launch is not None and launch["tid"] in stacks:
                covering = stacks[launch["tid"]].covering(end)
                if covering:
                    inner = min(covering, key=lambda h: h["dur"])
                    outer = max((h for h in covering if h["cat"] == "user_annotation"),
                                key=lambda h: h["dur"], default=None)
                    name = inner["name"] if outer is None or outer is inner \
                        else f"{outer['name']} > {inner['name']}"
            by[name] += gap
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


class _Nesting:
    """One thread's host events, which nest as calls do, with each one's
    innermost enclosing event: the events that cover a time are the last
    one to start by then and those enclosing it, found without a scan."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda h: (h["ts"], -h["dur"]))
        self.starts = [h["ts"] for h in self.events]
        self.parent, stack = [], []
        for i, h in enumerate(self.events):
            while stack and _end(self.events[stack[-1]]) < h["ts"]:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def covering(self, t):
        """The events h with h["ts"] <= t <= its end."""
        out, i = [], bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            if _end(self.events[i]) >= t:
                out.append(self.events[i])
            i = self.parent[i]
        return out


def _end(h):
    return h["ts"] + h["dur"]


def profiled(fn, units: int, host_ops: bool, attempts: int = 3) -> Trace:
    """``fn`` under ``torch.profiler``; ``fn`` synchronises at its end.
    With ``host_ops`` the host's ops and ranges are recorded too, which
    slows the host several times over; without, only the CUDA activity
    (runtime calls and device operations). The trace is written to a
    temporary file, read back and deleted."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    for attempt in range(attempts):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            window_s = time.perf_counter() - t0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        trace = Trace(events, window_s, units)
        if trace.device:
            return trace
        print(f"profiler: no device event in session {attempt + 1}", file=sys.stderr, flush=True)
    raise RuntimeError("the profiler traced no operation on the device")
