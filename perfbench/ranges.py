"""The program's own ranges in a traced window, and the device seconds each
one launched.

While a profiler records, the program's tracer (``repro_torch.core.trace``)
opens a ``record_function`` range ``repro:<name>`` with each of its spans,
on the span's own thread.  A device activity belongs to the innermost
``repro:`` range open on its launching thread at its launch (its runtime
call, found by correlation id, as ``devtrace.parse`` finds a unit), else,
without a launch record, to the innermost one open on any thread where it
ran.  That is self time: a kernel launched in ``rope`` inside ``qkv`` inside
``attention`` counts for ``rope``.  The seconds come from the device trace;
only the attribution comes from the program.  Units, the window and the
lead-in are those of ``devtrace.parse``.

A metric's reader is handed the parsed ``devtrace.Trace``, which keeps no
event.  The events stay on the ``devtrace.Profiler`` that took the window,
held in the frame that reads the metrics beside the Trace it made;
``of(run)`` finds them there, and reads None where it finds none.
"""
from __future__ import annotations

import bisect
import sys

from perfbench import devtrace

RANGE = "repro:"


class _Nest:
    """One thread's program ranges, nested: the innermost one open at a
    time is the last to start before it, or the nearest of that one's
    enclosing ranges still open."""

    def __init__(self, spans: list):
        spans = sorted(spans, key=lambda r: (r[0], -r[1]))
        self.t0 = [r[0] for r in spans]
        self.t1 = [r[1] for r in spans]
        self.name = [r[2] for r in spans]
        self.up, stack = [], []
        for k, (a, _, _) in enumerate(spans):
            while stack and self.t1[stack[-1]] < a:
                stack.pop()
            self.up.append(stack[-1] if stack else -1)
            stack.append(k)

    def at(self, t: float) -> tuple | None:
        """(start, name) of the innermost range open at ``t``, or None."""
        k = bisect.bisect_right(self.t0, t) - 1
        while k >= 0 and self.t1[k] < t:
            k = self.up[k]
        return (self.t0[k], self.name[k]) if k >= 0 else None


def _range_of(nests: dict, where, t: float) -> str | None:
    """The innermost program range open at ``t`` on thread ``where``, or on
    any thread (the latest to start) where ``where`` is None."""
    if where is not None:
        nest = nests.get(where)
        hit = nest.at(t) if nest is not None else None
        return hit[1] if hit else None
    hits = [h for h in (n.at(t) for n in nests.values()) if h]
    return max(hits)[1] if hits else None


def attribute(events: list) -> dict:
    """Each traced unit's device seconds by innermost program range,
    ``{unit: {"repro:<name>": seconds}}``, from a window's Chrome trace
    events; empty where the window holds no unit or no program range."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    units, by_thread = [], {}
    for e in xs:
        if e.get("cat") != "user_annotation":
            continue
        name, t = e.get("name", ""), float(e["ts"])
        if name.startswith(devtrace.PREFIX):
            units.append((t, t + float(e.get("dur", 0)), int(name[len(devtrace.PREFIX):])))
        elif name.startswith(RANGE):
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
                (t, t + float(e.get("dur", 0)), name))
    if not units or not by_thread:
        return {}
    units.sort()
    nests = {k: _Nest(v) for k, v in by_thread.items()}
    w0, w1 = units[0][0], max(u[1] for u in units)
    starts = [u[0] for u in units]

    def unit_at(t: float) -> int | None:
        k = bisect.bisect_right(starts, t) - 1
        return units[k][2] if k >= 0 and t <= units[k][1] else None

    launch = {}
    for e in xs:
        if e.get("cat") in devtrace.LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (float(e["ts"]), (e.get("pid"), e.get("tid")))
    out: dict = {}
    for e in xs:
        if e.get("cat") not in devtrace.DEVICE_CATS:
            continue
        t, d = float(e["ts"]), float(e.get("dur", 0))
        if t + d < w0 or t > w1 or devtrace.LEAD_IN in e.get("name", ""):
            continue
        at, where = launch.get(e.get("args", {}).get("correlation"), (t, None))
        i = unit_at(at)
        if i is None:
            i = unit_at(t)
        r = _range_of(nests, where, at) if i is not None else None
        if r is not None:
            by = out.setdefault(i, {})
            by[r] = by.get(r, 0.0) + d / 1e6
    return out


def events_behind(trace) -> list | None:
    """The Chrome trace events ``trace`` was parsed from: those of the
    ``devtrace.Profiler`` held in the nearest calling frame that also holds
    ``trace``; None where no frame holds both."""
    f = sys._getframe(1)
    while f is not None:
        held = list(f.f_locals.values())
        if any(v is trace for v in held):
            for v in held:
                if isinstance(v, devtrace.Profiler) and isinstance(v.events, list):
                    return v.events
        f = f.f_back
    return None


def of(run) -> dict | None:
    """``attribute`` of the run's traced window, read once a run; None
    without a traced window, its events or a program range in it."""
    if run.trace is None:
        return None
    if "program_ranges" not in run.__dict__:
        events = events_behind(run.trace)
        run.program_ranges = (attribute(events) or None) if events is not None else None
    return run.program_ranges


def seconds(run, name: str) -> dict | None:
    """Per traced unit, the device seconds launched in range ``name``
    (``repro:mlp``, ...); None where ``of(run)`` is None."""
    by = of(run)
    if by is None:
        return None
    return {i: by.get(i, {}).get(name, 0.0) for i in run.trace.units()}
