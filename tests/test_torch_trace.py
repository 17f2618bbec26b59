"""The port's statement tracer and metrics against the JAX package's.

The cases of ``tests/test_trace.py`` on both packages with the same seeded
frames: the disabled tracer records nothing; span parenting survives the
hop to pool threads; every retry leaves one backoff span; cancellation and
shutdown close every span; the profile / explain surfaces; per-statement
counter deltas on spans sum exactly to the ``ExecStats`` movement, also
under a seeded chaos plan over a budget; the Chrome export validates; the
ring bounds retention; the metrics registry has one shape; the service
records its admission phases.  Where a run is deterministic the span tree
(names, categories, parents and counter deltas) equals the reference's.

No test here waits on a time window: cancellation and shutdown act only
after a block has signalled, through a ``threading.Event``, that it runs.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time

import numpy as np
import pytest

from torch_pairs import (BOTH, IDS, PORT, REF, frame, groupby_plan,
                         port_guards, reset_pools)

pytestmark = pytest.mark.trace
assert port_guards

_DELTA_KEYS = ("spills", "faults", "spilled_bytes", "checksum_failures",
               "recomputed_blocks", "budget_overruns", "faults_injected")


@pytest.fixture(autouse=True)
def clean_trace(monkeypatch):
    for knob in ("REPRO_TRACE", "REPRO_TRACE_RING", "REPRO_FAULT_PLAN",
                 "REPRO_FAULT_SEED", "REPRO_MEM_BUDGET", "REPRO_POOL_WORKERS"):
        monkeypatch.delenv(knob, raising=False)
    for P in BOTH:
        P.trace.reset()
        P.faults.reset()
    yield monkeypatch
    for P in BOTH:
        P.trace.reset()
        P.faults.reset()
    reset_pools()


def _f(P, n=120, seed=0):
    return frame(P, n, seed, strings=False)


def _plan(P, src, name="trace_scale"):
    return groupby_plan(P, src, name, xs="xs")


def _blocking_map(P, src, name, started, release):
    def fn(cols, frame):
        started.set()
        assert release.wait(30.0), "release never came"
        return dict(cols)

    return P.alg.Map(src, P.alg.Udf(name=name, fn=fn, deps=frozenset(["x"]),
                                    elementwise=True))


def _drain_open(tr, timeout=30.0):
    """Unwinding worker threads close their spans on their own threads;
    poll (no fixed sleep) until they have."""
    deadline = time.monotonic() + timeout
    while tr.open_spans() and time.monotonic() < deadline:
        time.sleep(0.01)
    return tr.open_spans()


def _tree(tr) -> list:
    """A traced run's spans without times or ids: (name, cat, the parent's
    name, args minus times and the store's process-wide block ids),
    sorted."""
    spans = tr.snapshot()
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        parent = by_id[s.parent].name if s.parent in by_id else None
        args = {k: v for k, v in (s.args or {}).items()
                if not k.endswith("_ns")
                and not (s.cat == "store" and k == "block")}
        out.append((str(s.name), str(s.cat), str(parent),
                    repr(sorted(args.items()))))
    return sorted(out)


# =============================================================================
# disabled path: a true no-op
# =============================================================================
@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_disabled_records_nothing(P):
    before = P.trace.recorded_total()
    assert P.trace.current() is None
    s = P.Session(mode=P.EvalMode.LAZY, **P.kw)
    try:
        src = s.register_frame(_f(P, 200, seed=1), row_parts=4)
        assert s.collect(_plan(P, src)).nrows > 0
        assert s.tracer is None
        assert s.explain_stats()["traced"] is False
    finally:
        s.close()
    assert P.trace.recorded_total() == before


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_session_trace_false_forces_off(P, clean_trace):
    clean_trace.setenv("REPRO_TRACE", "1")
    P.trace.reset()
    assert isinstance(P.trace.current(), P.trace.Tracer)
    s = P.Session(mode=P.EvalMode.LAZY, trace=False, **P.kw)
    try:
        assert s.tracer is None
    finally:
        s.close()


# =============================================================================
# span parenting: plan → dispatch → pool-thread chunks
# =============================================================================
def _parenting(P):
    tr = P.trace.Tracer(session_id="t")
    P.trace.configure(tr)
    try:
        with P.schedule.node_scope("parenting"):
            out = P.schedule.dispatch_blocks(lambda x: x * 2, list(range(16)))
        assert out == [i * 2 for i in range(16)]
    finally:
        P.trace.reset()
    spans = tr.snapshot()
    disp = [s for s in spans if s.cat == "dispatch"]
    chunks = [s for s in spans if s.cat == "task"]
    assert len(disp) == 1 and chunks
    assert disp[0].args["blocks"] == 16
    assert disp[0].args["chunks"] == len(chunks)
    for c in chunks:
        assert c.parent == disp[0].id and c.stmt == disp[0].stmt
    assert {c.tid for c in chunks} != {disp[0].tid}
    assert sum(c.args["blocks"] for c in chunks) == 16
    assert tr.open_spans() == 0
    return _tree(tr)


def test_span_parenting_across_pool_threads(clean_trace):
    clean_trace.setenv("REPRO_POOL_WORKERS", "2")
    reset_pools()
    assert _parenting(PORT) == _parenting(REF)


def _backoff(P, mp):
    ref = P.schedule.dispatch_blocks(lambda x: x * 2, list(range(16)))
    mp.setenv("REPRO_FAULT_PLAN", "worker:0.5")
    mp.setenv("REPRO_FAULT_SEED", "3")
    tr = P.trace.Tracer(session_id="t")
    P.trace.configure(tr)
    st = P.ExecStats()
    try:
        got = P.schedule.dispatch_blocks(lambda x: x * 2, list(range(16)),
                                         stats=st)
    finally:
        P.trace.reset()
        mp.delenv("REPRO_FAULT_PLAN")
    assert got == ref and st.retries > 0
    retries = [s for s in tr.snapshot() if s.cat == "retry"]
    assert len(retries) == st.retries
    assert len({s.stmt for s in tr.snapshot()}) == 1
    for r in retries:
        assert r.args["attempt"] >= 1 and "block" in r.args
    assert tr.open_spans() == 0
    return st.retries, sorted((r.args["block"], r.args["attempt"])
                              for r in retries)


def test_failed_chunk_split_retry_records_backoff_spans(clean_trace):
    clean_trace.setenv("REPRO_POOL_WORKERS", "2")
    clean_trace.setenv("REPRO_RETRY_BACKOFF_MS", "1")
    reset_pools()
    assert _backoff(PORT, clean_trace) == _backoff(REF, clean_trace)


# =============================================================================
# cancellation / shutdown: spans never leak open
# =============================================================================
@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_cancellation_closes_open_spans(P, clean_trace):
    clean_trace.setenv("REPRO_POOL_WORKERS", "2")
    reset_pools()
    s = P.Session(mode=P.EvalMode.LAZY, trace=True, **P.kw)
    tr = s.tracer
    started, release = threading.Event(), threading.Event()
    try:
        src = s.register_frame(_f(P, 64, seed=4), row_parts=8)
        h = s.submit(_blocking_map(P, src, "trace_cancel", started, release))
        assert started.wait(30.0)
        h.cancel()
        release.set()
        with pytest.raises(P.faults.StatementCancelled):
            h.result(timeout=30.0)
        assert _drain_open(tr) == 0
        errs = [sp for sp in tr.snapshot() if sp.args and "error" in sp.args]
        assert any("Cancel" in sp.args["error"] for sp in errs)
    finally:
        release.set()
        s.close()


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_executor_shutdown_mid_statement_closes_spans(P):
    s = P.Session(mode=P.EvalMode.LAZY, trace=True, **P.kw)
    tr = s.tracer
    started, release = threading.Event(), threading.Event()
    src = s.register_frame(_f(P, 48, seed=6), row_parts=4)
    s.submit(_blocking_map(P, src, "trace_close", started, release))
    assert started.wait(30.0)
    try:
        s.close()
    finally:
        release.set()
    assert _drain_open(tr) == 0


# =============================================================================
# profile / explain surfaces
# =============================================================================
def _profile(P):
    s = P.Session(mode=P.EvalMode.LAZY, trace=True, **P.kw)
    try:
        src = s.register_frame(_f(P, 300, seed=7), row_parts=4)
        h = s.submit(_plan(P, src, "trace_prof"))
        h.result(timeout=30.0)
        prof = h.profile()
        assert prof is not None and prof["stmt"] == h.stmt_id
        assert prof["wall_ns"] > 0 and prof["spans"] > 0
        assert prof["nodes"]
        assert prof["dispatch"]["dispatched_blocks"] > 0
        ex = s.explain_stats(h.stmt_id)
        assert ex["traced"] is True and ex["profile"]["stmt"] == h.stmt_id
        assert ex["stats"]["metrics"]["evaluated_nodes"] > 0
        assert ex["stats"]["metrics"]["node_wall_ns"] > 0
        assert s.stats.plan_prep_ns >= 0
        return (sorted(prof["nodes"]) if isinstance(prof["nodes"], dict)
                else len(prof["nodes"]),
                {k: v for k, v in prof["dispatch"].items()
                 if not k.endswith("_ns")},
                ex["stats"]["metrics"]["evaluated_nodes"])
    finally:
        s.close()


def test_statement_profile_and_explain_stats():
    assert _profile(PORT) == _profile(REF)


def _chaos_deltas(P, path):
    n = 50_000
    data = {"a": np.arange(n, dtype=np.float64).tolist(),
            "b": (np.arange(n) % 97).astype(np.float64).tolist()}
    s = P.Session(mode=P.EvalMode.LAZY, trace=True,
                  mem_budget_bytes=n * 8 // 2, spill_dir=str(path),
                  fault_plan="worker:0.2,corrupt:0.5,enospc:0.5",
                  fault_seed=7, **P.kw)
    try:
        df = P.api.from_pydict(data, session=s)
        q = df[df["a"] > 1000.0].groupby("b").agg({"a": ["sum", "mean"]})
        st0 = dataclasses.replace(s.stats)
        res = q.collect().to_pydict()
        st1, tr = s.stats, s.tracer
        assert tr.open_spans() == 0
        totals = tr.counter_totals(tr.last_stmt)
        for k in _DELTA_KEYS:
            assert totals.get(k, 0) == getattr(st1, k) - getattr(st0, k), k
        assert st1.spills > st0.spills
        return res
    finally:
        s.close()


@pytest.mark.spill
def test_counter_deltas_sum_exactly_under_chaos(tmp_path):
    ref = _chaos_deltas(REF, tmp_path / "ref")
    got = _chaos_deltas(PORT, tmp_path / "port")
    assert got.keys() == ref.keys()
    assert got["b"] == ref["b"]
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6)
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == []


def _deterministic_tree(P, path):
    """One worker, a budget, no chaos: the span tree is a function of the
    plan alone."""
    s = P.Session(mode=P.EvalMode.LAZY, trace=True, mem_budget_bytes=3000,
                  spill_dir=str(path), **P.kw)
    try:
        src = s.register_frame(_f(P, 800, seed=3), row_parts=4)
        st0 = dataclasses.replace(s.stats)
        s.collect(_plan(P, src, "trace_det"))
        tr = s.tracer
        totals = tr.counter_totals(tr.last_stmt)
        for k in _DELTA_KEYS:
            assert totals.get(k, 0) == getattr(s.stats, k) - getattr(st0, k)
        assert totals.get("spills", 0) > 0
        return _tree(tr), totals
    finally:
        s.close()


@pytest.mark.spill
def test_span_tree_and_deltas_equal_reference(clean_trace, tmp_path):
    clean_trace.setenv("REPRO_POOL_WORKERS", "1")
    reset_pools()
    ref_tree, ref_totals = _deterministic_tree(REF, tmp_path / "ref")
    tree, totals = _deterministic_tree(PORT, tmp_path / "port")
    assert totals == ref_totals
    assert [t for t in tree if t not in ref_tree] == []
    assert [t for t in ref_tree if t not in tree] == []
    assert tree == ref_tree


# =============================================================================
# Chrome trace export
# =============================================================================
@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_chrome_export_validates_and_names_threads(P, clean_trace, tmp_path):
    clean_trace.setenv("REPRO_POOL_WORKERS", "2")
    reset_pools()
    s = P.Session(mode=P.EvalMode.LAZY, trace=True, **P.kw)
    try:
        src = s.register_frame(_f(P, 300, seed=8), row_parts=4)
        assert s.collect(_plan(P, src, "trace_export")).nrows > 0
        path = s.trace_json(str(tmp_path / "trace.json"))
        with open(path) as fh:
            doc = json.load(fh)
    finally:
        s.close()
    n = P.trace.validate_chrome_trace(doc)
    assert n == len(doc["traceEvents"]) and n > 0
    assert {"X", "M"} <= {e["ph"] for e in doc["traceEvents"]}
    names = [e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"]
    assert names and all(isinstance(x, str) and x for x in names)
    assert all(isinstance(e["ts"], (int, float)) and e["dur"] >= 0
               for e in doc["traceEvents"] if e["ph"] == "X")


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_chrome_validation_rejects_malformed(P):
    with pytest.raises(ValueError):
        P.trace.validate_chrome_trace({"no": "events"})
    with pytest.raises(ValueError):
        P.trace.validate_chrome_trace(
            {"traceEvents": [{"ph": "X", "name": "x"}]})
    with pytest.raises(ValueError):
        P.trace.validate_chrome_trace(
            {"traceEvents": [{"ph": "?", "name": "x", "pid": 1, "tid": 1,
                              "ts": 0}]})


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_ring_buffer_bounds_retention(P):
    tr = P.trace.Tracer(ring=4, session_id="ring")
    before = P.trace.recorded_total()
    for i in range(10):
        tr.instant(f"e{i}")
    assert len(tr.snapshot()) == 4
    assert P.trace.recorded_total() == before + 10
    assert tr.open_spans() == 0


# =============================================================================
# metrics registry (one shape: core ExecStats + serve engine)
# =============================================================================
def test_metrics_registry_shape_and_serve_unification():
    from repro_torch.serve import engine as serve_engine
    exports = []
    for P in BOTH:
        m = P.trace.Metrics("m", steps=0)
        m.inc("steps")
        m["tokens_out"] = 3
        m.gauge("depth", 7)
        assert m["steps"] == 1 and m["missing"] == 0
        assert dict(m) == {"steps": 1, "tokens_out": 3, "depth": 7}
        st = P.ExecStats()
        st.evaluated_nodes = 5
        proj = P.trace.stats_metrics(st)
        assert set(proj.export()) == set(m.export())
        assert proj["evaluated_nodes"] == 5
        exports.append((m.export(), proj.export()))
    assert exports[1] == exports[0]
    assert serve_engine.Metrics is PORT.trace.Metrics


# =============================================================================
# service: admission phases + per-tenant attribution
# =============================================================================
def _tenants(P):
    with P.QueryService(background_workers=2, **P.kw) as svc:
        busy = svc.session(mode=P.EvalMode.LAZY)
        idle = svc.session(mode=P.EvalMode.LAZY)
        src = busy.register_frame(_f(P, 400, seed=9), row_parts=4)
        busy.submit(_plan(P, src, "trace_tenant")).result(timeout=30.0)
        rows = svc.tenant_report()
        by_sid = {r["session"]: r for r in rows}
        bid = busy.config.session_id
        assert by_sid[bid]["evaluated_nodes"] > 0
        assert by_sid[bid]["node_wall_ns"] > 0
        assert by_sid[bid]["slot_hold_ns"] > 0
        assert by_sid[bid]["queue_wait_ns"] >= 0
        assert by_sid[idle.config.session_id]["evaluated_nodes"] == 0
        assert rows[0]["session"] == bid
        assert sum(r["slot_hold_ns"] for r in rows) == svc.stats.slot_hold_ns
        assert sum(r["node_wall_ns"] for r in rows) == svc.stats.node_wall_ns
        return [{k: v for k, v in r.items() if not k.endswith("_ns")}
                for r in rows]


def test_service_tenant_report_and_admission_phases():
    assert _tenants(PORT) == _tenants(REF)


def _admission_spans(P):
    with P.QueryService(background_workers=2, **P.kw) as svc:
        tr = P.trace.Tracer(session_id="tenant")
        s = svc.session(mode=P.EvalMode.LAZY, trace=tr)
        src = s.register_frame(_f(P, 200, seed=11), row_parts=4)
        h = s.submit(_plan(P, src, "trace_admit"))
        h.result(timeout=30.0)
        assert _drain_open(tr) == 0
        names = collections.Counter(sp.name for sp in tr.snapshot())
        assert names["queue_wait"] and names["slot_hold"]
        assert tr.profile(h.stmt_id)["service"]["slot_hold_ns"] > 0
        return names["queue_wait"], names["slot_hold"]


def test_service_traced_statement_records_admission_spans():
    assert _admission_spans(PORT) == _admission_spans(REF)
