"""One run of one cell: set-up, the measured window, the metrics, and the
check that decides ``correct``.

The harness is driven by data.  ``BENCHMARK.json`` names the cell; the cell
names its configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<mix>.json``); the mix's ``kind`` names the runner that drives
the program (``runners/<kind>.py``); the configuration names its plain
reference (``reference/<name>.py``); every metric is read by
``metrics/<metric>.py``; the limits of the cell's check sit in
``limits/<cell>.json``.  A new cell, configuration, mix or metric is a new
file and a new entry, and no existing file changes.

A runner module has ``setup(ctx) -> state`` (inputs and weights made from
the seed, the cell's shapes warmed), ``unit(state, i) -> dict`` (one
statement, batch or step of the window, timed by the harness), ``info(state)
-> dict``, ``payload(state) -> dict`` (what the check compares: the
program's outputs beside the inputs the benchmark made) and ``release(state)``
(frees the program's state before the reference runs).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
# top-level module names that may not be loaded once the window has closed:
# JAX and the JAX package the port was made from (compared whole, so
# ``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE_DIRS = {"TORCHINDUCTOR_CACHE_DIR": HERE / ".cache" / "inductor",
              "TRITON_CACHE_DIR": HERE / ".cache" / "triton"}


class RunError(RuntimeError):
    """A run that prints no result: it exits with ``code``."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise RunError(f"{path} is missing", 1)
    return load_json(path)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict | None


def cell(bench: dict, name: str) -> Cell:
    works = {w["name"]: w for w in bench["workloads"]}
    if name not in works:
        raise RunError(f"no workload {name!r} in BENCHMARK.json", 1)
    w = works[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return cell_of(name, ROOT / cfg["file"], w["traffic"], w["chips"])


def cell_of(name: str, config_file: Path, traffic: str, chips: int = 1) -> Cell:
    """The cell ``name`` of a configuration file and a traffic mix, with
    its limits where ``limits/<name>.json`` holds them."""
    limits = HERE / "limits" / f"{name}.json"
    return Cell(name, chips, load_json(config_file),
                load_json(HERE / "traffic" / f"{traffic}.json"),
                load_json(limits) if limits.exists() else None)


def metrics_for(bench: dict, name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace
    1): those that list the cell, or list no cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def load_path(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The module that reads ``metric``: ``metrics/<metric>.py``."""
    return load_path(HERE / "metrics" / f"{metric}.py",
                      "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def runner(kind: str):
    return importlib.import_module(f"perfbench.runners.{kind}")


def reference(name: str):
    return importlib.import_module(f"perfbench.reference.{name}")


def pin_caches() -> None:
    """Every compile cache in a fixed directory inside the checkout, so that
    only the first run of a checkout compiles, and inductor compiling in
    the run's own process: its pool of compile workers would be processes
    the run leaves behind, and load the host while the window runs.  Set
    before torch loads."""
    for var, path in CACHE_DIRS.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["TORCHINDUCTOR_COMPILE_THREADS"] = "1"


def forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def seed_ints(seed: int, n: int) -> list[int]:
    """``n`` independent 63-bit seeds drawn from ``--seed`` (any whole
    number)."""
    ss = np.random.SeedSequence(abs(int(seed)) * 2 + (seed < 0))
    words = ss.generate_state(2 * n, np.uint32).astype(np.uint64)
    return [int((words[2 * i] << np.uint64(31)) ^ words[2 * i + 1]) for i in range(n)]


def quantile(values, q: float) -> float:
    """The q-quantile with linear interpolation between order statistics."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


@dataclasses.dataclass
class Context:
    """What a runner is given: the cell's files, the seed, the device."""
    cell: Cell
    seed: int
    device: object
    trace: bool


@dataclasses.dataclass
class Run:
    """What a metric's reader is given."""
    cell: Cell
    units: list
    window_s: float
    setup_s: float
    info: dict
    trace: object          # devtrace.Trace of the traced window, or None
    peaks: dict | None     # cost.peaks of the card, or None
    all_units: list        # the window's units and any traced after it


def run_window(seconds: float, step, prof=None) -> tuple[list, float]:
    """Closed loop: unit after unit until ``seconds`` have passed; the
    window closes when the last unit begun in it completes, so a rate is
    all the work over all the time.  Unit times are seconds from the start
    of the window."""
    units = []
    start = time.perf_counter()
    end = start + seconds
    i = 0
    while True:
        if prof is not None:
            prof.before(i, time.perf_counter() - start)
        t0 = time.perf_counter()
        with prof.scope(i) if prof is not None else contextlib.nullcontext():
            rec = step(i)
        t1 = time.perf_counter()
        rec["t0"], rec["t1"] = t0 - start, t1 - start
        units.append(rec)
        if prof is not None:
            prof.after(i)
        i += 1
        if t1 >= end and (prof is None or prof.done):
            return units, t1 - start


def run_count(indices, step, prof) -> list:
    """The units ``indices`` one after another under ``prof``, timed as
    ``run_window`` times them (from the first unit's start)."""
    units, start = [], time.perf_counter()
    for i in indices:
        prof.before(i)
        t0 = time.perf_counter()
        with prof.scope(i):
            rec = step(i)
        t1 = time.perf_counter()
        rec["t0"], rec["t1"] = t0 - start, t1 - start
        units.append(rec)
        prof.after(i)
    return units


def card(torch, chips: int) -> tuple[str, str]:
    """(the card's name, its power limit) on a machine that holds ``chips``
    cards; a RunError without them."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RunError(f"the cell needs {chips} CUDA device(s); this machine has {have}", 2)
    kind = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        power = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        power = "unknown"
    return kind, power


def judge(readings: dict, limits: dict | None) -> tuple[bool, dict]:
    """Each number compared beside its limit; ``correct`` where every one is
    within.  A number without a limit cannot pass."""
    checks = {}
    for name in sorted(readings):
        value = readings[name]
        limit = None if limits is None else limits.get(name)
        checks[name] = {"value": value, "limit": limit}
    ok = bool(checks) and all(c["limit"] is not None and c["value"] is not None
                              and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device=None,
             require_card: bool = True, bench: dict | None = None,
             the_cell: Cell | None = None, t_start: float | None = None,
             control: bool = False) -> dict:
    """One run of the cell ``name``; returns the result line as a dict.
    ``require_card=False`` (the CPU tests) skips the look for a card and the
    device readings; ``control`` (``calibrate.py`` alone) also reads the
    control, the reference in the precision below the configuration's, on
    the same outputs' inputs, under ``out["control"]``."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    the_cell = cell(bench, name) if the_cell is None else the_cell
    import torch
    from . import cost, devtrace
    if require_card:
        kind, power = card(torch, the_cell.chips)
        device = torch.device("cuda", 0)
    else:
        kind, power, device = "cpu", "none", torch.device(device or "cpu")
    drive = runner(the_cell.traffic["kind"])
    ctx = Context(the_cell, seed, device, trace)
    t_ready = time.perf_counter()
    state = drive.setup(ctx)
    if require_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    # imports and the card's context, then the runner's inputs and warm-up
    setup_parts = {"imports_s": t_ready - t_start, "runner_s": setup_s - (t_ready - t_start)}

    k = int(the_cell.traffic["trace_units"])
    # the traced window: ``trace_units`` units from the middle of the window
    prof = devtrace.Profiler(torch, 0, k, after_s=seconds / 2) if trace and require_card else None
    units, window_s = run_window(seconds, lambda i: drive.unit(state, i), prof)
    tr, extra, windows = None, [], 0
    if prof is not None:
        tr, windows = prof.trace(units), 1
        if tr is None:
            # the profiler kept no device record of the window: take it once
            # more, over as many units after the window, which no end-to-end
            # metric reads
            n = len(units)
            prof = devtrace.Profiler(torch, n, k)
            extra = run_count(range(n, n + k), lambda i: drive.unit(state, i), prof)
            tr, windows = prof.trace(units + extra), 2
            if tr is None:
                raise RunError("the CUDA profiler kept no device record of the traced "
                               "window, twice", 4)
    peak = torch.cuda.max_memory_allocated() if require_card else 0
    # (a CPU test's process holds the JAX package the other tests compare with)
    found = forbidden_modules() if require_card else []
    if found:
        raise RunError(f"modules loaded that the port may not load: {found}", 3)
    info = drive.info(state)
    payload = drive.payload(state)
    drive.release(state)
    del state
    gc.collect()
    if require_card:
        torch.cuda.empty_cache()

    ref = reference(the_cell.config["reference"])
    readings = ref.readings(payload, the_cell.config, the_cell.traffic)
    low = ref.control(payload, the_cell.config, the_cell.traffic) if control else None
    correct, checks = judge(readings, the_cell.limits)

    run = Run(the_cell, units, window_s, setup_s, info, tr, cost.peaks(kind),
              units + extra)
    metrics = {}
    for m in metrics_for(bench, name, trace):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if require_card else "cpu", "kind": kind, "count": the_cell.chips,
           "memory_peak_bytes": int(peak)}
    # a unit that raises ends the run, which then prints no result
    out = {"correct": bool(correct), "attempted": len(units), "failed": 0,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(10), "idle_gaps": tr.idle_gaps(10)}
    by_label: dict = {}
    for u in units:
        by_label.setdefault(u["label"], []).append((u["t1"] - u["t0"]) * 1e3)
    # each kind of unit: [count, p10, p50, p90, max] of its host ms
    unit_ms = {k: [len(v), quantile(v, 0.1), quantile(v, 0.5), quantile(v, 0.9), max(v)]
               for k, v in by_label.items()}
    if windows:
        info = dict(info, profiler_windows=windows)
    out["info"] = dict(info, power_limit=power, seed=seed, window_s=window_s,
                       setup_s=setup_s, setup_parts=setup_parts, unit_ms=unit_ms)
    if low is not None:
        out["control"] = low
    out["checks"] = checks
    return out
