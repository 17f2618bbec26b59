"""The port's session-scoped config and multi-tenant query service against
the JAX package's.

The cases of ``tests/test_service.py`` on both packages with the same
seeded frames: session-scoped fault plans and retry knobs, a private
budget that never touches the process store, the async surface
(cancellation, typed close errors), the close-aware default session, the
zero-row progressive aggregate, and the ``QueryService``: cross-session
reuse, per-session ``ExecStats`` summing exactly to the global stats, one
budget shared by every tenant, admission caps, a 16-tenant concurrent
differential and close semantics.  Results are bit-equal to the
reference's; counters are equal where the reference's run is
deterministic.

No test here waits on a time window: a statement that must still be
running when it is cancelled (or when its service closes) blocks its
blocks on a ``threading.Event``, and the test acts only after a block has
signalled that it started.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest
import torch

from torch_pairs import (BOTH, IDS, PORT, REF, frame, groupby_plan,
                         port_guards, reset_pools)

assert port_guards


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in ("REPRO_FAULT_PLAN", "REPRO_FAULT_SEED", "REPRO_MEM_BUDGET"):
        monkeypatch.delenv(knob, raising=False)
    for P in BOTH:
        P.faults.reset()
    yield monkeypatch
    for P in BOTH:
        P.faults.reset()


def _f(P, n=120, seed=0):
    return frame(P, n, seed, strings=False)


def _blocking_map(P, src, name, started=None, release=None):
    """MAP x + 1 whose blocks signal ``started`` and wait for ``release``."""
    def fn(cols, frame):
        if started is not None:
            started.set()
        if release is not None:
            assert release.wait(30.0), "release never came"
        out = dict(cols)
        c = cols["x"]
        out["x"] = P.Column(c.data + 1.0, P.Domain.FLOAT, c.mask, None)
        return out

    return P.alg.Map(src, P.alg.Udf(name=name, fn=fn, deps=frozenset(["x"]),
                                    elementwise=True))


# =============================================================================
# session-scoped config: no cross-tenant contamination
# =============================================================================
def _fault_scoped(P):
    poisoned = P.Session(mode=P.EvalMode.LAZY, task_retries=0,
                         fault_plan="worker:1.0!", fault_seed=3, **P.kw)
    clean = P.Session(mode=P.EvalMode.LAZY, **P.kw)
    try:
        f = _f(P, seed=1)
        with pytest.raises(P.faults.TaskError):
            poisoned.collect(groupby_plan(
                P, poisoned.register_frame(f, row_parts=4), "svc_scale"))
        out = clean.collect(groupby_plan(
            P, clean.register_frame(f, row_parts=4), "svc_scale"))
        assert clean.executor.stats.faults_injected == 0
        assert poisoned.executor.stats.task_failures > 0
        assert not P.faults.active()
        return out.to_pydict()
    finally:
        poisoned.close()
        clean.close()


def test_fault_plan_is_session_scoped():
    assert _fault_scoped(PORT) == _fault_scoped(REF)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_retry_knobs_are_session_scoped(P):
    s = P.Session(mode=P.EvalMode.LAZY, task_retries=7, retry_backoff_ms=0,
                  **P.kw)
    try:
        base = P.schedule.task_retries()
        with P.config.scope(s.config):
            assert P.schedule.task_retries() == 7
        assert P.schedule.task_retries() == base
    finally:
        s.close()


def _private_budget(P, path):
    before = P.store.get_store().stats.spills
    s = P.Session(mode=P.EvalMode.LAZY, mem_budget_bytes=4096,
                  spill_dir=str(path), **P.kw)
    try:
        src = s.register_frame(_f(P, 4000, seed=2), row_parts=8)
        out = s.collect(groupby_plan(P, src, "svc_scale"))
        assert s.executor.stats.spills > 0 and s.executor.stats.faults > 0
        assert P.store.get_store().stats.spills == before
        return out.to_pydict()
    finally:
        s.close()


def test_private_budget_does_not_touch_process_store(tmp_path):
    """No ``spill`` marker: both packages' process-store guards must see
    nothing, and close() drops every spill file."""
    ref = _private_budget(REF, tmp_path / "ref")
    assert _private_budget(PORT, tmp_path / "port") == ref
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == []


# =============================================================================
# async surface: cancellation + typed close errors
# =============================================================================
def _cancel_then_rerun(P):
    s = P.Session(mode=P.EvalMode.LAZY, **P.kw)
    try:
        started, release = threading.Event(), threading.Event()
        src = s.register_frame(_f(P, 64, seed=4), row_parts=8)
        node = _blocking_map(P, src, "svc_cancel", started, release)
        h = s.submit(node)
        assert started.wait(30.0)            # a block is running now
        h.cancel()
        release.set()
        with pytest.raises(P.faults.StatementCancelled):
            h.result(timeout=30.0)
        assert h.cancelled
        out = s.collect(node).to_pydict()    # the rerun: no partial state
    finally:
        s.close()
    ref = P.Session(mode=P.EvalMode.LAZY, **P.kw)
    try:
        rsrc = ref.register_frame(_f(P, 64, seed=4), row_parts=8)
        expect = ref.collect(_blocking_map(P, rsrc, "svc_cancel_ref")
                             ).to_pydict()
    finally:
        ref.close()
    assert out == expect
    return out


def test_cancel_mid_statement_then_rerun_is_bit_identical(_clean):
    """Two pool workers and eight blocks: the blocks after the first two
    reach a dispatch boundary after the cancel, whatever the load."""
    _clean.setenv("REPRO_POOL_WORKERS", "2")
    reset_pools()
    try:
        assert _cancel_then_rerun(PORT) == _cancel_then_rerun(REF)
    finally:
        reset_pools()


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_collect_after_close_raises_typed_error(P):
    s = P.Session(mode=P.EvalMode.LAZY, **P.kw)
    node = groupby_plan(P, s.register_frame(_f(P, seed=5), row_parts=4),
                        "svc_scale")
    s.close()
    with pytest.raises(P.faults.ExecutorClosedError):
        s.collect(node)
    with pytest.raises(P.faults.ExecutorClosedError):
        s.submit(node)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_collect_racing_close_fails_typed_not_hang(P):
    """A collect that joins an in-flight statement (or arrives after the
    close) raises the typed error promptly, in either order."""
    s = P.Session(mode=P.EvalMode.LAZY, **P.kw)
    started, release = threading.Event(), threading.Event()
    node = _blocking_map(P, s.register_frame(_f(P, 48, seed=6), row_parts=4),
                         "svc_race_close", started, release)
    s.submit(node)
    assert started.wait(30.0)
    errs: list = []

    def join():
        try:
            s.collect(node)
            errs.append(None)
        except BaseException as e:       # noqa: BLE001 - recorded for assert
            errs.append(e)

    t = threading.Thread(target=join)
    t.start()
    try:
        s.close()
        t.join(timeout=30.0)
        assert not t.is_alive(), "collect hung across close()"
        assert len(errs) == 1
        assert isinstance(errs[0], P.faults.ExecutorClosedError)
    finally:
        release.set()


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_get_session_singleton_is_race_free_and_close_aware(P):
    from importlib import import_module
    sess = import_module(P.core.__name__ + ".session")
    P.core.set_session(P.Session(mode=P.EvalMode.LAZY, **P.kw)).close()
    got: list = []
    barrier = threading.Barrier(8)

    def grab():
        barrier.wait()
        got.append(sess.get_session(**P.kw))

    threads = [threading.Thread(target=grab) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len({id(s) for s in got}) == 1
    s = got[0]
    s.close()
    s2 = sess.get_session(**P.kw)
    try:
        assert s2 is not s and not s2._closed
    finally:
        s2.close()


# =============================================================================
# zero-block progressive aggregate terminates
# =============================================================================
@pytest.mark.parametrize("func", ["sum", "count", "mean"])
def test_zero_row_progressive_aggregate_terminates(func):
    got = {}
    for P in BOTH:
        empty = P.Frame([P.Column(P.arr(np.zeros(0, dtype=np.float64)),
                                  P.Domain.FLOAT)],
                        P.RangeLabels(0), P.labels(["x"]))
        ests = list(P.approx.progressive_aggregate(
            P.PF.from_frame(empty, 1, 1), "x", func))
        assert len(ests) == 1 and ests[0].final
        got[P.name] = repr(ests)             # NaN-safe equality
    assert got["port"] == got["ref"]


def test_all_null_progressive_mean_is_nan():
    for P in BOTH:
        x = P.Column(P.arr(np.zeros(8, dtype=np.float64)), P.Domain.FLOAT,
                     P.arr(np.zeros(8, dtype=bool)))
        f = P.Frame([x], P.RangeLabels(8), P.labels(["x"]))
        final = [e for e in P.approx.progressive_aggregate(
            P.PF.from_frame(f, 2, 1), "x", "mean") if e.final]
        assert len(final) == 1 and final[0].value != final[0].value


# =============================================================================
# QueryService: shared budget, admission, MQO, attribution
# =============================================================================
def test_service_without_a_device_targets_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.QueryService()


def _mqo(P):
    with P.QueryService(background_workers=2, **P.kw) as svc:
        shared = svc.register_frame(_f(P, 300, seed=7), row_parts=4)
        a = svc.session(mode=P.EvalMode.LAZY)
        b = svc.session(mode=P.EvalMode.LAZY)
        node = groupby_plan(P, shared, "svc_mqo")
        ra = a.collect(node).to_pydict()
        hits0 = svc.stats.cache_hits
        rb = b.collect(node).to_pydict()
        assert rb == ra
        assert svc.stats.cache_hits > hits0
        return ra, svc.stats.cache_hits - hits0


def test_service_cross_session_mqo_on_shared_table():
    assert _mqo(PORT) == _mqo(REF)


def _stats_sum(P):
    with P.QueryService(background_workers=2, **P.kw) as svc:
        sessions = [svc.session(mode=P.EvalMode.LAZY) for _ in range(3)]
        outs = []
        for i, s in enumerate(sessions):
            src = s.register_frame(_f(P, 200, seed=10 + i), row_parts=4)
            outs.append(s.collect(groupby_plan(P, src, f"svc_attr{i}",
                                               scale=1.0 + i)).to_pydict())
            assert s.stats.evaluated_nodes > 0
        for fld in dataclasses.fields(type(svc.stats)):
            if fld.name == "peak_resident_bytes":
                continue                     # a gauge: max, not additive
            total = getattr(svc.stats, fld.name)
            assert sum(getattr(s.stats, fld.name) for s in sessions) == total, \
                fld.name
        return outs, [s.stats.evaluated_nodes for s in sessions]


def test_service_per_session_stats_sum_to_global():
    assert _stats_sum(PORT) == _stats_sum(REF)


def _shared_budget(P, path):
    with P.QueryService(background_workers=2, mem_budget_bytes=4096,
                        spill_dir=str(path), **P.kw) as svc:
        a = svc.session(mode=P.EvalMode.LAZY)
        b = svc.session(mode=P.EvalMode.LAZY)
        sa = a.register_frame(_f(P, 4000, seed=12), row_parts=8)
        sb = b.register_frame(_f(P, 4000, seed=13), row_parts=8)
        ra = a.collect(groupby_plan(P, sa, "svc_budget_a")).to_pydict()
        rb = b.collect(groupby_plan(P, sb, "svc_budget_b")).to_pydict()
        assert svc.stats.spills > 0
        assert a.stats.spills + b.stats.spills == svc.stats.spills
        assert a.stats.spills > 0 and b.stats.spills > 0
        assert a.stats.faults + b.stats.faults == svc.stats.faults
        assert P.store.get_store().stats.spills == 0
    assert [p for p in path.rglob("*") if p.is_file()] == []
    return ra, rb


def test_service_shared_budget_attributes_spills_per_session(tmp_path):
    assert _shared_budget(PORT, tmp_path / "port") == _shared_budget(
        REF, tmp_path / "ref")


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_service_admission_respects_cap_and_fairness(P):
    """Per-session ``max_inflight`` bounds admitted statements: while a's
    first statement holds its only slot, its backlog stays queued and b's
    statement is admitted past it; everything completes."""
    with P.QueryService(background_workers=2, admission_slots=2,
                        **P.kw) as svc:
        shared = svc.register_frame(_f(P, 40, seed=14), row_parts=2)
        a = svc.session(mode=P.EvalMode.LAZY, max_inflight=1)
        b = svc.session(mode=P.EvalMode.LAZY, max_inflight=1)
        a_started, b_started = threading.Event(), threading.Event()
        release = threading.Event()
        ha = [a.submit(_blocking_map(P, shared, "svc_admit_a0", a_started,
                                     release))]
        assert a_started.wait(30.0)
        ha += [a.submit(_blocking_map(P, shared, f"svc_admit_a{i}"))
               for i in (1, 2)]
        hb = b.submit(_blocking_map(P, shared, "svc_admit_b0", b_started))
        assert b_started.wait(30.0)          # admitted past a's backlog
        assert svc.admission.queued() == 2   # a1, a2 wait for a's slot
        release.set()
        outs = [h.result(timeout=30.0).to_frame().to_pydict()
                for h in ha + [hb]]
        assert outs[0] == outs[1] == outs[2] == outs[3]


def _sixteen(P):
    n_sessions = 16
    frames = [_f(P, 240, seed=20 + i) for i in range(n_sessions)]
    expected = []
    for i in range(n_sessions):
        ref = P.Session(mode=P.EvalMode.LAZY, **P.kw)
        try:
            src = ref.register_frame(frames[i], row_parts=4)
            expected.append(ref.collect(groupby_plan(
                P, src, f"svc_diff{i}", scale=1.0 + (i % 4))).to_pydict())
        finally:
            ref.close()
    with P.QueryService(background_workers=2, **P.kw) as svc:
        sessions = [svc.session(mode=P.EvalMode.OPPORTUNISTIC,
                                task_retries=(i % 3),
                                shuffle_buckets=2 + (i % 3))
                    for i in range(n_sessions)]
        results: dict = {}
        errors: list = []

        def run(i, s):
            try:
                src = s.register_frame(frames[i], row_parts=4)
                node = s.statement(groupby_plan(P, src, f"svc_diff{i}",
                                                scale=1.0 + (i % 4)))
                results[i] = s.collect(node).to_pydict()
            except BaseException as e:   # noqa: BLE001 - surfaced below
                errors.append((i, e))

        threads = [threading.Thread(target=run, args=(i, s))
                   for i, s in enumerate(sessions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert errors == []
        for i in range(n_sessions):
            assert results[i] == expected[i], f"session {i} diverged"
        assert sum(s.stats.evaluated_nodes for s in sessions) == \
            svc.stats.evaluated_nodes
    return expected


def test_service_sixteen_session_concurrent_differential():
    """16 tenants with their own knobs run concurrently on one service;
    each result is bit-identical to its serial isolated run and to the
    reference's."""
    assert _sixteen(PORT) == _sixteen(REF)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_service_close_fails_queued_statements_typed(P):
    svc = P.QueryService(background_workers=1, admission_slots=1, **P.kw)
    started, release = threading.Event(), threading.Event()
    try:
        shared = svc.register_frame(_f(P, 40, seed=15), row_parts=2)
        s = svc.session(mode=P.EvalMode.LAZY, max_inflight=1)
        h1 = s.submit(_blocking_map(P, shared, "svc_close_q0", started,
                                    release))
        assert started.wait(30.0)
        h2 = s.submit(_blocking_map(P, shared, "svc_close_q1"))
        assert svc.admission.queued() == 1  # behind h1 (cap 1)
        svc.close()
        with pytest.raises((P.faults.ExecutorClosedError,
                            P.faults.StatementCancelled)):
            h2.result(timeout=30.0)
    finally:
        release.set()
        svc.close()
    try:
        h1.result(timeout=30.0)
    except (P.faults.ExecutorClosedError, P.faults.StatementCancelled):
        pass
