"""Statement tracing & metrics: where each statement's wall-clock went.

The paper's signature interaction model (§7) is piecemeal trial-and-error —
users iterate statement-by-statement and steer by what the last one cost.
``ExecStats`` already attributes recovery and residency *work* exactly
(counters, snapshot-delta per plan node); this module adds the missing
dimension: **time**, recorded as a span tree per statement,

    statement → plan prep (rewrite/fusion)
              → per-plan-node eval          (``schedule.node_scope`` labels)
                → dispatch_blocks           (caller thread)
                  → per-chunk pool tasks    (worker threads; parent span
                                             carried via ``config.propagate``)
                    → store spill / fault, retry backoff, injected faults
              → shuffle bucketize/exchange/local/gather phases
    service   → admission queue-wait + slot-hold per tenant

into a bounded per-session ring buffer, exported as Chrome trace-event JSON
(loadable in Perfetto — pool threads appear as named tracks, cross-thread
parent→child edges as flow arrows) and summarized by
``Session.explain_stats()`` / ``StatementHandle.profile()``.

The LM path opens spans too, through :func:`scope` (no session needed):
``prefill`` → ``embed``, ``block`` (``args``: layer index and kind) →
``norm``, ``attention`` → ``qkv`` → ``rope``, ``kernel:<entry>``
(``kernels.ops``), ``wo``; ``mlp``; ``unembed``; the serve engine's
``serve.admit`` / ``serve.step`` / ``serve.sync``; the compiled-UDF probes'
``jit_probe``.

**On the profiler's timeline.**  While a torch profiler records
(``torch.autograd.profiler._is_profiler_enabled``), every ``with``-shaped
span also opens ``record_function("repro:<name>")`` on its thread and closes
it with the span, so the span lies on the device trace's own clock and the
profiler's correlation ids tie each kernel launch to the innermost range
open at it.  With the profiler on and no tracer, span sites get
:data:`RANGES`, a tracer that opens the ranges and records nothing (no ring,
``recorded_total()`` unmoved).  Manual ``begin``/``end`` pairs mirror only
where asked (``mirror=True``: ``dispatch:<label>``, which begins and ends on
one thread); the service's backdated ``queue_wait`` / ``slot_hold`` and the
instants stay ring-only.  No range opens under a dispatch mode (``make_fx``,
fake tensors, ``launch.hlo_analysis``) or inside a ``torch.compile`` trace,
where a range would be an operator of the traced program.  The profiler's
callbacks are per thread: a pool thread's ranges are recorded only by a
profiler started with ``profile_all_threads``.

Design constraints (the reason this file is small and boring):

* **Disabled is a no-op.**  With the tracer and the profiler both off, a
  site costs one :func:`current` resolution and one bool read and allocates
  nothing (no span, no dict, no lock); ``tests/test_torch_spans.py``
  checks that, and ``PERF.md`` keeps the off cost of one site (a CPU
  microbenchmark) and the on cost measured on the card (yi-6b's prefill
  with ``REPRO_TRACE=1`` against unset).  The conftest autouse guards
  assert zero spans recorded in every non-``@pytest.mark.trace`` test, so
  tracing can never leak into the default path silently.
* **ExecStats stays the counter source of truth.**  Spans carry counter
  *deltas* computed by the executor's existing snapshot-delta mechanism
  (``Executor._attribute_store_delta``), so the span-attached deltas of one
  statement sum exactly to that statement's global ``ExecStats`` movement —
  asserted by ``tests/test_torch_trace.py``.
* **Bounded.**  The ring holds ``REPRO_TRACE_RING`` finished spans (default
  65536); old spans fall off the back.  Open spans are only tracked as a
  count (leak detection) — an exception unwinding a ``with`` scope closes
  its span with an ``error`` arg, so cancellation / executor shutdown can
  never leave spans open.

Enabling: ``REPRO_TRACE=1`` turns on a process-wide tracer; a path value
(``REPRO_TRACE=/tmp/t.json``) additionally exports the ring there at process
exit.  ``Session(trace=True)`` gives one session its own tracer (bounded
ring, independent of the process one), resolved through the session's
``config.SessionConfig`` exactly like the store / fault / retry knobs.
The export's ``otherData.clock`` states its clock: ``ts`` is
``perf_counter_ns`` in µs, and ``anchor`` pairs one ``perf_counter_ns``
reading with the ``time_ns`` taken beside it, so a span's wall time is
``ts·1000 − anchor.perf_counter_ns + anchor.time_ns`` — the profiler's
Chrome trace keeps wall time less its ``baseTimeNanoseconds``.

The metrics half: :class:`Metrics` is the one named-counter/gauge registry
shape shared by the serve tier (``serve.engine.ServeEngine.metrics``) and the
core tier (:func:`stats_metrics` projects an ``ExecStats`` into it), so both
export the same ``{"name": ..., "metrics": {...}}`` dict.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Iterator

import torch
from torch.autograd import profiler as _profiler

from . import config as _config
from .faults import env_int

__all__ = [
    "Span", "Tracer", "Metrics", "current", "live", "scope", "RANGES",
    "RANGE_PREFIX", "configure", "reset", "recorded_total", "ring_size", "stats_metrics",
    "export", "chrome_trace_events", "validate_chrome_trace",
]

_now = time.perf_counter_ns
# the ring's clock against wall time, read once (``Tracer.chrome_trace``)
_ANCHOR = {"perf_counter_ns": _now(), "time_ns": time.time_ns()}
RANGE_PREFIX = "repro:"


def _range_open(name: str):
    """A profiler range ``repro:<name>`` opened on this thread, or None
    where none may open: under a dispatch mode (``make_fx``, fake tensors,
    ``hlo_analysis``) or inside a ``torch.compile`` trace, where the range
    would be an operator of the traced program."""
    if torch._C._len_torch_dispatch_stack() or torch.compiler.is_compiling():
        return None
    rf = _profiler.record_function(RANGE_PREFIX + name)
    rf.__enter__()
    return rf


def _range_close(sp: "Span") -> None:
    if sp.range is not None:
        sp.range.__exit__(None, None, None)
        sp.range = None


def ring_size() -> int:
    """Bounded span-ring capacity (``REPRO_TRACE_RING``, default 65536)."""
    return env_int("REPRO_TRACE_RING", 65536, minimum=16)


# total spans/instants recorded by ANY tracer in this process — the conftest
# autouse guard asserts this does not move in non-@pytest.mark.trace tests
_TOTAL = 0
_TOTAL_LOCK = threading.Lock()


def recorded_total() -> int:
    return _TOTAL


class Span:
    """One finished (or in-flight) span.  ``args`` is attached by the
    instrumentation site — the executor stores its snapshot-delta counter
    dict here, which is what makes span deltas sum to ``ExecStats``."""

    __slots__ = ("id", "parent", "stmt", "name", "cat", "tid", "t0", "dur",
                 "args", "range")

    def __init__(self, sid: int, parent: int | None, stmt: int, name: str,
                 cat: str):
        self.id = sid
        self.parent = parent
        self.stmt = stmt
        self.name = name
        self.cat = cat
        self.tid = threading.current_thread().name
        self.t0 = _now()
        self.dur = 0
        self.args: dict | None = None
        self.range = None       # its open profiler range, if it mirrors one


class _SpanScope:
    """``with``-shaped span: installs the span as the current trace context
    (so children — including ones opened on pool threads via
    ``config.propagate`` — parent to it) and records it on exit.  An
    exception closes the span with an ``error`` arg instead of leaking it."""

    __slots__ = ("_tr", "span", "_tok")

    def __init__(self, tr: "Tracer", span: Span):
        self._tr = tr
        self.span = span

    def __enter__(self) -> Span:
        self._tok = _config._TRACE_CTX.set(self.span)
        return self.span

    def __exit__(self, et, ev, tb) -> bool:
        _config._TRACE_CTX.reset(self._tok)
        if et is not None:
            a = self.span.args
            self.span.args = dict(a) if a else {}
            self.span.args["error"] = et.__name__
        self._tr.end(self.span)
        return False


class Tracer:
    """Per-session (or process-wide) span recorder: a bounded ring of
    finished spans plus a statement-id allocator.  Thread-safe — spans are
    begun/ended from caller, pool-worker, background-executor, and admission
    threads concurrently."""

    def __init__(self, ring: int | None = None, session_id: str = "proc"):
        self.session_id = session_id
        self.events: collections.deque[Span] = collections.deque(
            maxlen=ring if ring is not None else ring_size())
        self._ids = itertools.count(1)
        self._stmts = itertools.count(1)
        self._open = 0
        self._lock = threading.Lock()
        self.last_stmt: int | None = None

    # -- statement ids --------------------------------------------------
    def next_stmt(self) -> int:
        s = next(self._stmts)
        self.last_stmt = s
        return s

    def open_spans(self) -> int:
        """Spans begun but not yet ended — 0 whenever no statement is
        actively running (cancellation and shutdown unwind their ``with``
        scopes, which close spans; asserted in tests/test_trace.py)."""
        return self._open

    # -- low-level begin/end (manual pairing; no contextvar mutation) ---
    def begin(self, name: str, cat: str = "span", *,
              parent: Span | None | object = _config._TRACE_UNSET,
              stmt: int | None = None, mirror: bool = False) -> Span:
        """A span begun now; ``end`` records it.  ``mirror``: while a
        profiler records, the span also opens its ``repro:`` range, which
        ``end`` closes — only for a pair that begins and ends on one
        thread."""
        if parent is _config._TRACE_UNSET:
            parent = _config.current_trace_ctx()
        pid = parent.id if isinstance(parent, Span) else None
        if stmt is None:
            stmt = parent.stmt if isinstance(parent, Span) else self.next_stmt()
        sp = Span(next(self._ids), pid, stmt, name, cat)
        if mirror and _profiler._is_profiler_enabled:
            sp.range = _range_open(name)
        with self._lock:
            self._open += 1
        return sp

    def end(self, sp: Span) -> None:
        global _TOTAL
        sp.dur = _now() - sp.t0
        _range_close(sp)
        with self._lock:
            self._open -= 1
            self.events.append(sp)
        with _TOTAL_LOCK:
            _TOTAL += 1

    # -- with-shaped API -------------------------------------------------
    def span(self, name: str, cat: str = "span", *, args: dict | None = None,
             parent: Span | None | object = _config._TRACE_UNSET,
             stmt: int | None = None) -> _SpanScope:
        sp = self.begin(name, cat, parent=parent, stmt=stmt, mirror=True)
        sp.args = args
        return _SpanScope(self, sp)

    def statement(self, name: str, *, stmt: int | None = None) -> _SpanScope:
        """Root span for one statement.  Called under an existing trace
        context (a statement evaluated *inside* another traced region) it
        degrades to a plain child span of the same statement."""
        parent = _config.current_trace_ctx()
        if stmt is None and parent is None:
            stmt = self.next_stmt()
        elif stmt is not None:
            self.last_stmt = stmt
        return self.span(name, "statement", parent=parent, stmt=stmt)

    def instant(self, name: str, cat: str = "instant", *,
                args: dict | None = None) -> None:
        """Zero-duration event (cache hits, injected faults): records where
        in the tree something happened without a begin/end pair."""
        global _TOTAL
        sp = self.begin(name, cat)
        sp.args = args
        sp.dur = 0
        with self._lock:
            self._open -= 1
            self.events.append(sp)
        with _TOTAL_LOCK:
            _TOTAL += 1

    # -- profiling / export ----------------------------------------------
    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self.events)

    def statements(self) -> list[int]:
        return sorted({s.stmt for s in self.snapshot()})

    def profile(self, stmt: int | None = None) -> dict:
        """Per-statement time attribution: where did the wall-clock go?
        Sums the statement's spans by category — per-node wall time with
        their counter deltas, dispatch/coalescing ratio, pool-task busy
        time, spill/fault/backoff stalls, queue wait — the numbers §7's
        trial-and-error loop steers by."""
        if stmt is None:
            stmt = self.last_stmt
        spans = [s for s in self.snapshot() if s.stmt == stmt]
        prof: dict[str, Any] = {
            "stmt": stmt, "session": self.session_id, "spans": len(spans),
            "wall_ns": sum(s.dur for s in spans if s.cat == "statement"),
            "plan_prep_ns": sum(s.dur for s in spans if s.cat == "prep"),
            "nodes": {}, "cache_hits": [], "faults_fired": [],
        }
        disp = [s for s in spans if s.cat == "dispatch"]
        chunks = [s for s in spans if s.cat == "task"]
        nd = sum((s.args or {}).get("chunks", 0) for s in disp)
        nb = sum((s.args or {}).get("blocks", 0) for s in disp)
        prof["dispatch"] = {
            "dispatches": nd, "dispatched_blocks": nb,
            "blocks_per_dispatch": round(nb / max(1, nd), 2),
            "dispatch_ns": sum(s.dur for s in disp),
            "task_busy_ns": sum(s.dur for s in chunks),
            "backoff_ns": sum(s.dur for s in spans if s.cat == "retry"),
            "retries": sum(1 for s in spans if s.cat == "retry"),
        }
        prof["store"] = {
            "spill_ns": sum(s.dur for s in spans if s.name == "spill"),
            "spills": sum(1 for s in spans if s.name == "spill"),
            "fault_ns": sum(s.dur for s in spans if s.name == "fault"),
            "faults": sum(1 for s in spans if s.name == "fault"),
        }
        prof["service"] = {
            "queue_wait_ns": sum(s.dur for s in spans
                                 if s.name == "queue_wait"),
            "slot_hold_ns": sum(s.dur for s in spans
                                if s.name == "slot_hold"),
        }
        for s in spans:
            if s.cat == "node":
                ent = prof["nodes"].setdefault(
                    s.name, {"wall_ns": 0, "count": 0, "counters": {}})
                ent["wall_ns"] += s.dur
                ent["count"] += 1
                for k, v in (s.args or {}).items():
                    if isinstance(v, int):
                        ent["counters"][k] = ent["counters"].get(k, 0) + v
            elif s.cat == "cache":
                prof["cache_hits"].append(s.name)
            elif s.cat == "fault":
                prof["faults_fired"].append(
                    {"kind": s.name, **(s.args or {})})
        return prof

    def counter_totals(self, stmt: int | None = None,
                       cats: tuple = ("node", "prep")) -> dict[str, int]:
        """Sum the span-attached counter deltas (the executor's
        snapshot-delta dicts) over one statement — by construction equal to
        the statement's global ``ExecStats`` movement for those counters."""
        spans = self.snapshot()
        if stmt is not None:
            spans = [s for s in spans if s.stmt == stmt]
        out: dict[str, int] = {}
        for s in spans:
            if s.cat in cats:
                for k, v in (s.args or {}).items():
                    if isinstance(v, int):
                        out[k] = out.get(k, 0) + v
        return out

    def chrome_trace(self) -> dict:
        return {"traceEvents": chrome_trace_events(self.snapshot()),
                "displayTimeUnit": "ms",
                "otherData": {"session": self.session_id,
                              "clock": {"ts": "perf_counter_ns / 1000",
                                        "anchor": dict(_ANCHOR)}}}

    def export(self, path: str) -> str:
        """Write the ring as Chrome trace-event JSON (open in Perfetto /
        chrome://tracing; pool threads are named tracks)."""
        doc = self.chrome_trace()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._lock:
            self.events.clear()


class _Ranges(Tracer):
    """The tracer a span site gets while a torch profiler records and no
    tracer is on: its spans open and close their ``repro:`` ranges and are
    kept nowhere (``recorded_total()`` does not move)."""

    def end(self, sp: Span) -> None:
        _range_close(sp)
        with self._lock:
            self._open -= 1

    def instant(self, name: str, cat: str = "instant", *,
                args: dict | None = None) -> None:
        pass


RANGES = _Ranges(ring=16, session_id="ranges")
_OFF = contextlib.nullcontext()


# =============================================================================
# Chrome trace-event projection
# =============================================================================
def chrome_trace_events(spans: list[Span]) -> list[dict]:
    """Project spans to the Chrome trace-event JSON array: one complete
    (``ph: X``) event per span on its thread's track, thread-name metadata
    events, instants as ``ph: i``, and flow arrows (``ph: s``/``f``) for
    parent→child edges that cross threads (dispatch → pool chunk)."""
    events: list[dict] = []
    tids: dict[str, int] = {}
    by_id: dict[int, Span] = {s.id: s for s in spans}

    def tid(name: str) -> int:
        t = tids.get(name)
        if t is None:
            t = tids[name] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": t, "args": {"name": name}})
        return t

    flows: set[int] = set()
    for s in spans:
        ev = {"name": s.name, "cat": s.cat, "pid": 1, "tid": tid(s.tid),
              "ts": s.t0 / 1000.0,
              "args": dict(s.args or {}, stmt=s.stmt, span=s.id)}
        if s.dur == 0 and s.cat in ("instant", "cache", "fault"):
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = s.dur / 1000.0
        events.append(ev)
        parent = by_id.get(s.parent) if s.parent is not None else None
        if parent is not None and parent.tid != s.tid:
            # cross-thread edge: draw a flow arrow parent → child
            if parent.id not in flows:
                flows.add(parent.id)
                events.append({"ph": "s", "id": parent.id, "name": "parent",
                               "cat": "flow", "pid": 1, "tid": tid(parent.tid),
                               "ts": parent.t0 / 1000.0})
            events.append({"ph": "f", "bp": "e", "id": parent.id,
                           "name": "parent", "cat": "flow", "pid": 1,
                           "tid": tid(s.tid), "ts": s.t0 / 1000.0})
    return events


_PHASES = {"X", "i", "M", "s", "f"}


def validate_chrome_trace(doc: dict) -> int:
    """Schema check for an exported trace (the CI trace smoke gates on it).
    Returns the number of events; raises ``ValueError`` on any violation."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must be an object with traceEvents")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(evs):
        for k in ("ph", "pid", "tid", "ts", "name") if ev.get("ph") != "M" \
                else ("ph", "pid", "tid", "name"):
            if k not in ev:
                raise ValueError(f"event {i} missing required key {k!r}")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")
        if ev["ph"] == "X":
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(f"event {i} (complete) needs dur >= 0")
        if ev["ph"] in ("s", "f") and "id" not in ev:
            raise ValueError(f"event {i} (flow) needs an id")
    return len(evs)


# =============================================================================
# resolution: active session's tracer → process override → REPRO_TRACE env
# =============================================================================
_UNSET = object()
_PROC: Tracer | None = None
_PROC_KEY: tuple | None = None      # (env value, ring) the tracer was built for
_OVERRIDE: Tracer | None | object = _UNSET
_PROC_LOCK = threading.Lock()


_TRACE_KEY = os.environ.encodekey("REPRO_TRACE")


def _trace_env() -> str:
    """``REPRO_TRACE`` ("" unset), looked up in ``os.environ``'s encoded
    store with the key encoded once, so the disabled path allocates nothing
    (``os.environ.get`` encodes the key anew each call)."""
    data = getattr(os.environ, "_data", None)
    if data is None:
        return os.environ.get("REPRO_TRACE", "")
    raw = data.get(_TRACE_KEY)
    return "" if raw is None else os.environ.decodevalue(raw)


def _process_tracer() -> Tracer | None:
    """The process-wide tracer per ``REPRO_TRACE`` (lazy; rebuilt when the
    env value changes — tests flip it).  A path-shaped value also registers
    an atexit export to that path."""
    global _PROC, _PROC_KEY
    raw = _trace_env()
    if raw in ("", "0"):
        return None
    key = (raw, ring_size())
    if _PROC is not None and _PROC_KEY == key:
        return _PROC
    with _PROC_LOCK:
        if _PROC is None or _PROC_KEY != key:
            _PROC = Tracer(session_id="proc")
            _PROC_KEY = key
            if raw not in ("1", "true", "on"):
                # path-shaped value: export the ring at process exit
                atexit.register(_atexit_export, _PROC, raw)
    return _PROC


def _atexit_export(tr: Tracer, path: str) -> None:
    try:
        tr.export(path)
    except OSError:
        pass


def current(cfg: Any = _UNSET) -> Tracer | None:
    """The tracer for the calling context, or None (tracing disabled — the
    production path: one contextvar read + an attribute check).  Resolution:
    active ``SessionConfig.trace`` → programmatic :func:`configure` override
    → ``REPRO_TRACE`` env.  Pass ``cfg`` when the caller already fetched
    ``config.current()`` (the dispatch hot path)."""
    if cfg is _UNSET:
        cfg = _config.current()
    if cfg is not None and cfg.trace is not None:
        return cfg.trace or None     # False/"" = explicitly off this session
    if _OVERRIDE is not _UNSET:
        return _OVERRIDE
    return _process_tracer()


def live(cfg: Any = _UNSET) -> Tracer | None:
    """The tracer a span site records through: :func:`current`, else
    :data:`RANGES` while a torch profiler records, else None (one bool read
    past ``current``)."""
    tr = current(cfg)
    if tr is None and _profiler._is_profiler_enabled:
        return RANGES
    return tr


def scope(name: str, cat: str = "span"):
    """A ``with`` span for code outside a session (the model, kernel and
    serve sites): the span of :func:`live`'s tracer, entered as the Span
    (set its ``args`` there), or a shared null context entered as None when
    neither the tracer nor the profiler is on — nothing is allocated."""
    tr = current()
    if tr is not None:
        return tr.span(name, cat)
    if _profiler._is_profiler_enabled:
        return RANGES.span(name, cat)
    return _OFF


def configure(tracer: Tracer | None) -> None:
    """Process-wide programmatic override (CI smokes, benches): sticky until
    :func:`reset`.  ``configure(None)`` forces tracing OFF regardless of
    ``REPRO_TRACE``."""
    global _OVERRIDE
    _OVERRIDE = tracer


def reset() -> None:
    """Clear the override and the cached process tracer (next use rebuilds
    from the environment)."""
    global _OVERRIDE, _PROC, _PROC_KEY
    _OVERRIDE = _UNSET
    with _PROC_LOCK:
        _PROC = None
        _PROC_KEY = None


def export(path: str) -> str | None:
    """Export the currently-resolved tracer's ring to ``path`` (None when
    tracing is disabled)."""
    tr = current()
    return tr.export(path) if tr is not None else None


# =============================================================================
# the metrics registry (shared export shape: serve tier + core tier)
# =============================================================================
class Metrics:
    """Named counters/gauges behind one export shape.  Dict-style access
    (``m["steps"] += 1``) keeps existing serve-tier call sites working;
    missing names read as 0 so counters need no pre-registration."""

    __slots__ = ("name", "_vals", "_lock")

    def __init__(self, name: str = "", **initial: float):
        self.name = name
        self._vals: dict[str, float] = dict(initial)
        self._lock = threading.Lock()

    def __getitem__(self, key: str) -> float:
        return self._vals.get(key, 0)

    def __setitem__(self, key: str, value: float) -> None:
        with self._lock:
            self._vals[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._vals

    def __iter__(self) -> Iterator[str]:
        return iter(dict(self._vals))

    def keys(self):
        """Mapping protocol — lets ``dict(metrics)`` snapshot the registry."""
        return self.as_dict().keys()

    def items(self):
        return self.as_dict().items()

    def inc(self, key: str, d: float = 1) -> None:
        with self._lock:
            self._vals[key] = self._vals.get(key, 0) + d

    def gauge(self, key: str, value: float) -> None:
        with self._lock:
            self._vals[key] = value

    def as_dict(self) -> dict[str, float]:
        with self._lock:
            return dict(self._vals)

    def export(self) -> dict:
        """The ONE export shape both tiers share (serve engine metrics and
        ``ExecStats`` projections serialize identically)."""
        return {"name": self.name, "metrics": self.as_dict()}

    def __repr__(self) -> str:
        return f"Metrics({self.name!r}, {self.as_dict()!r})"


def stats_metrics(stats: Any, name: str = "core") -> Metrics:
    """Project an ``ExecStats`` (or any object with int/float attributes,
    e.g. through a ``StatsTee``) into the shared registry shape."""
    m = Metrics(name)
    src = stats
    fields = getattr(type(src), "__dataclass_fields__", None)
    names = list(fields) if fields else [
        a for a in dir(src) if not a.startswith("_")]
    for a in names:
        v = getattr(src, a, None)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            m[a] = v
    return m
