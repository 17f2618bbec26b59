#!/usr/bin/env python3
"""Host cost of one span site of ``repro_torch.core.trace``, in microseconds.

    PYTHONPATH=src python3 scripts/span_cost.py [--sites 200000] [--repeats 7]

Times ``with trace.scope("norm", "model"): pass`` (the model and kernel
sites' form) in three states: both off (the default path), the tracer on
(each span kept in a ring), and a torch profiler recording with the tracer
off (each span a ``record_function`` range only), beside the same loop
around a null context, whose cost is the ``with`` statement's own.  Prints
one line, ``RESULT {json}``: the median over the repeats of each state's
microseconds a site, and the off cost less the loop's.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import statistics
import time

from torch.profiler import ProfilerActivity, profile

from repro_torch.core import trace


def per_site(n: int) -> float:
    t0 = time.perf_counter()
    for _ in itertools.repeat(None, n):
        with trace.scope("norm", "model"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def per_loop(n: int) -> float:
    null = contextlib.nullcontext()
    t0 = time.perf_counter()
    for _ in itertools.repeat(None, n):
        with null:
            pass
    return (time.perf_counter() - t0) / n * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", type=int, default=200_000)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args()
    n, reps = args.sites, args.repeats
    trace.reset()
    trace.configure(None)
    out = {"loop_us": statistics.median(per_loop(n) for _ in range(reps)),
           "off_us": statistics.median(per_site(n) for _ in range(reps))}
    trace.configure(trace.Tracer(ring=1024, session_id="cost"))
    out["tracer_us"] = statistics.median(per_site(n) for _ in range(reps))
    trace.configure(None)
    m = max(1, n // 20)           # the profiler keeps every range it records
    with profile(activities=[ProfilerActivity.CPU]):
        out["profiler_us"] = statistics.median(per_site(m) for _ in range(reps))
    trace.reset()
    out["off_less_loop_us"] = out["off_us"] - out["loop_us"]
    print("RESULT " + json.dumps(out))


if __name__ == "__main__":
    main()
