"""One profiler window a traced run, and what is read from it.

The window covers a fixed number of the run's units.  It opens behind a
lead-in of four spin kernels and a sync: a profiler that drops the first
device records of a window drops those, and a window whose records hold no
spin kernel kept none at all (the card's profiler has lost whole windows in
long processes).  Each unit runs inside a ``record_function`` range named
``perfbench:<unit>``; a device activity belongs to the unit in whose range
it was launched (its runtime call, found by correlation id), else to the
unit in whose range it ran.

The trace is read from the profiler's Chrome trace export, whose event
categories (``kernel``, ``gpu_memcpy``, ``gpu_memset``, ``cuda_runtime``,
``user_annotation``, ``cpu_op``) are stable across PyTorch releases.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import numpy as np

LEAD_IN = "spin_kernel"           # torch.cuda._sleep's kernel
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
PREFIX = "perfbench:"


def lead_in(torch) -> None:
    for _ in range(4):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


class Profiler:
    """Profiles ``count`` units of a run: from unit ``first``, or, with
    ``after_s``, from the first unit that begins that many seconds into the
    window (a steady state)."""

    def __init__(self, torch, first: int, count: int, after_s: float | None = None):
        self.torch, self.first, self.count = torch, first, count
        self.after_s = after_s
        self.prof = None
        self.events: list | None = None

    @property
    def done(self) -> bool:
        return self.events is not None

    def before(self, i: int, elapsed: float = 0.0) -> None:
        if self.prof is None and not self.done and self.after_s is not None \
                and elapsed >= self.after_s:
            self.first, self.after_s = i, None
        if i == self.first and self.after_s is None and not self.done:
            from torch.profiler import ProfilerActivity, profile
            self.torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            lead_in(self.torch)

    def scope(self, i: int):
        if self.prof is None:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(f"{PREFIX}{i}")

    def after(self, i: int) -> None:
        if self.prof is not None and i == self.first + self.count - 1:
            self.torch.cuda.synchronize()
            self.prof.stop()
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    self.events = json.load(f).get("traceEvents", [])
            finally:
                os.unlink(path)
            self.prof = None

    def trace(self, units: list) -> "Trace | None":
        return None if self.events is None else parse(self.events, units)


class Trace:
    """The traced window: ``window_s`` from the first unit's range to the
    last's, ``busy_s`` the union of the device activities in it, and per
    traced unit its device seconds, by name."""

    def __init__(self, window: tuple, busy_s: float, per_unit: dict, ops: dict,
                 gaps: list):
        self.window_s = (window[1] - window[0]) / 1e6
        self.busy_s = busy_s
        self.per_unit = per_unit
        self._ops = ops
        self._gaps = gaps

    def device_ops(self, n: int) -> list:
        top = sorted(self._ops.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], s] for name, s in top]

    def idle_gaps(self, n: int) -> list:
        return [[name[:120], s] for name, s in self._gaps[:n]]

    def units(self) -> list[int]:
        return sorted(self.per_unit)

    def device_s(self, i: int, names: tuple = ()) -> float:
        """Device seconds of unit ``i``: of every activity, or of those whose
        name holds one of ``names``."""
        u = self.per_unit[i]
        if not names:
            return u["device_s"]
        return sum(s for k, s in u["by_name"].items() if any(n in k for n in names))


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def parse(events: list, units: list) -> Trace | None:
    """The Trace of a window's Chrome trace events; None where the window
    kept no device record (not even the lead-in's)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if not any(LEAD_IN in e.get("name", "") for e in dev):
        return None
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     int(e["name"][len(PREFIX):]))
                    for e in xs if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX))
    if not ranges:
        return None
    w0, w1 = ranges[0][0], max(r[1] for r in ranges)
    starts = [r[0] for r in ranges]

    def unit_at(t: float) -> int | None:
        k = bisect.bisect_right(starts, t) - 1
        return ranges[k][2] if k >= 0 and t <= ranges[k][1] else None

    launch = {}
    for e in xs:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
    per_unit = {r[2]: {"device_s": 0.0, "by_name": {}} for r in ranges}
    ops: dict = {}
    spans = []
    for e in dev:
        t, d = float(e["ts"]), float(e.get("dur", 0))
        if t + d < w0 or t > w1 or LEAD_IN in e["name"]:
            continue
        corr = e.get("args", {}).get("correlation")
        i = unit_at(launch.get(corr, t))
        if i is None:
            i = unit_at(t)
        s = d / 1e6
        ops[e["name"]] = ops.get(e["name"], 0.0) + s
        spans.append((max(t, w0), min(t + d, w1)))
        if i is not None:
            u = per_unit[i]
            u["device_s"] += s
            u["by_name"][e["name"]] = u["by_name"].get(e["name"], 0.0) + s
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = _gaps(busy, (w0, w1), xs, units, unit_at)
    return Trace((w0, w1), busy_s, per_unit, ops, gaps)


def _gaps(busy: list, window: tuple, xs: list, units: list, unit_at) -> list:
    """The device's idle time in the window, summed by what the host was
    doing at each gap's middle: the unit's label and the innermost host
    operation open then; the longest first."""
    edges = [window[0]] + [v for ab in busy for v in ab] + [window[1]]
    idle = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    idle = sorted(idle, key=lambda ab: ab[0] - ab[1])[:400]
    host = [e for e in xs if e.get("cat") in HOST_CATS
            and not e.get("name", "").startswith(PREFIX)]
    ts = np.array([float(e["ts"]) for e in host]) if host else np.zeros(0)
    end = ts + np.array([float(e.get("dur", 0)) for e in host]) if host else np.zeros(0)
    by: dict = {}
    for a, b in idle:
        m = (a + b) / 2
        i = unit_at(m)
        label = units[i].get("label", "unit") if i is not None and i < len(units) else "between units"
        inner = "host"
        if len(ts):
            cover = np.nonzero((ts <= m) & (end >= m))[0]
            if len(cover):
                inner = host[int(cover[np.argmin(end[cover] - ts[cover])])]["name"]
        key = f"{label} / {inner}"
        by[key] = by.get(key, 0.0) + (b - a) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])
