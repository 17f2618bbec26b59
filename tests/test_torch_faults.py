"""The port's fault-tolerance layer against the JAX package's.

The cases of ``tests/test_faults.py`` on both packages with the same seeds:
the shared env parser, the fault-plan grammar and its pure draws, the
dispatch retry policy (only transient errors retry; a failed coalesced chunk
splits until the one poison block is isolated), spill integrity (corrupt,
missing and orphan spill files, a fault after shutdown), graceful
degradation (ENOSPC, the spill-dir failover list, a failed unlink), a CSV
that changes mid-ingest, and the chaos differentials across grids and over
the 4x-budget pipeline.  Results are bit-identical to the reference's
fault-free run; where a run is deterministic (dispatch of plain values, no
store) the recovery counters equal the reference's too, and under chaos
``ExecStats`` equals what the port's store and fault plan recorded.
"""
from __future__ import annotations

import gc
import os
import threading
import warnings

import pytest

from torch_pairs import (BOTH, IDS, PORT, REF, frame, pipeline_plan,
                         port_guards, reset_pools, reset_stores, write_csv)

pytestmark = pytest.mark.spill
assert port_guards

_KNOBS = ("REPRO_FAULT_PLAN", "REPRO_FAULT_SEED", "REPRO_FAULT_SLOW_MS",
          "REPRO_TASK_RETRIES", "REPRO_TASK_TIMEOUT_MS",
          "REPRO_RETRY_BACKOFF_MS", "REPRO_MEM_BUDGET", "REPRO_POOL_WORKERS")


def _reset_all():
    for P in BOTH:
        P.faults.reset()
        P.schedule.configure_retries(clear=True)
    reset_stores()


@pytest.fixture(autouse=True)
def _fault_counters():
    for P in BOTH:
        P.faults.reset()
    yield
    for P in BOTH:
        P.faults.reset()


@pytest.fixture
def chaos(monkeypatch, tmp_path):
    for knob in _KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("REPRO_SPILL_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_RETRY_BACKOFF_MS", "1")
    _reset_all()
    yield monkeypatch
    _reset_all()
    reset_pools()


def _workers(mp, n):
    mp.setenv("REPRO_POOL_WORKERS", str(n))
    reset_pools()


def _budget(mp, nbytes):
    mp.setenv("REPRO_MEM_BUDGET", str(nbytes))
    reset_stores()


# =============================================================================
# the shared env parser
# =============================================================================
@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_env_int_malformed_warns_once_and_falls_back(P, chaos):
    knob = f"REPRO_TEST_BOGUS_KNOB_{P.name.upper()}"
    chaos.setenv(knob, "not-an-int")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert P.faults.env_int(knob, 7) == 7
        assert P.faults.env_int(knob, 7) == 7
    hits = [x for x in w if knob in str(x.message)]
    assert len(hits) == 1 and issubclass(hits[0].category, RuntimeWarning)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_env_int_minimum_and_defaults(P, chaos):
    chaos.setenv("REPRO_TEST_NEG_KNOB", "-5")
    assert P.faults.env_int("REPRO_TEST_NEG_KNOB", 3, minimum=0) == 0
    assert P.faults.env_int("REPRO_TEST_UNSET_KNOB", 42) == 42


def test_malformed_mem_budget_warns_not_silently_zero(chaos):
    chaos.setenv("REPRO_MEM_BUDGET", "lots")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert PORT.store._env_budget() == 0
    assert any("REPRO_MEM_BUDGET" in str(x.message) for x in w)


# =============================================================================
# the plan: grammar + deterministic draws
# =============================================================================
def test_fault_plan_grammar_and_draws_equal_reference():
    for P in BOTH:
        p = P.faults.FaultPlan("worker:0.1, corrupt@blk3:1.0!, enospc:0.5",
                               seed=1)
        assert p.match("corrupt", "spill_read/blk3/orphan", recoverable=False)
        assert not p.match("corrupt", "spill_read/blk4/orphan",
                           recoverable=False)
        for bad in ("worker", "bogus:0.5", "worker:abc", "worker@x"):
            with pytest.raises(ValueError):
                P.faults.FaultPlan(bad)
    addrs = [f"dispatch/node=map/blk={b}/try={t}" for b in range(16)
             for t in range(3)] + [f"spill_read/blk{b}/lineage"
                                   for b in range(16)]
    for seed in (0, 7, 11):
        for kind in ("worker", "slow", "corrupt", "missing", "enospc"):
            got = [PORT.faults._draw(seed, kind, a) for a in addrs]
            assert got == [REF.faults._draw(seed, kind, a) for a in addrs]
            assert all(0.0 <= d < 1.0 for d in got)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_nonsticky_rules_fire_once_and_spare_orphans(P):
    p1 = P.faults.FaultPlan("worker:1.0", seed=7)
    assert p1.match("worker", "x", attempt=0)
    assert not p1.match("worker", "x", attempt=1)
    assert not P.faults.FaultPlan("worker:0.0", seed=7).match(
        "worker", "x", attempt=0)
    p = P.faults.FaultPlan("corrupt:1.0", seed=0)
    assert p.match("corrupt", "spill_read/blk1/lineage", recoverable=True)
    assert not p.match("corrupt", "spill_read/blk1/orphan", recoverable=False)
    assert P.faults.FaultPlan("corrupt:1.0!", seed=0).match(
        "corrupt", "spill_read/blk1/orphan", recoverable=False)


# =============================================================================
# dispatch retry policy
# =============================================================================
def _transient(P, mp):
    ref = P.schedule.dispatch_blocks(lambda x: x * 2, list(range(16)))
    mp.setenv("REPRO_FAULT_PLAN", "worker:0.5")
    mp.setenv("REPRO_FAULT_SEED", "3")
    st = P.ExecStats()
    try:
        got = P.schedule.dispatch_blocks(lambda x: x * 2, list(range(16)),
                                         stats=st)
        assert got == ref
        return (got, P.faults.injected_total(), st.retries,
                st.task_failures, P.faults.injected_snapshot())
    finally:
        mp.delenv("REPRO_FAULT_PLAN")


def test_transient_worker_faults_recovered_by_retry(chaos):
    _workers(chaos, 2)
    ref = _transient(REF, chaos)
    got = _transient(PORT, chaos)
    assert got == ref                       # same draws, same recovery
    assert got[1] > 0 and got[2] > 0 and got[3] == got[2]


def _poison(P, mp):
    mp.setenv("REPRO_FAULT_PLAN", "worker@blk=2/:1.0!")
    st = P.ExecStats()
    try:
        with P.schedule.node_scope("probe"):
            with pytest.raises(P.faults.TaskError) as ei:
                P.schedule.dispatch_blocks(lambda x: x, list(range(6)),
                                           stats=st)
    finally:
        mp.delenv("REPRO_FAULT_PLAN")
    e = ei.value
    assert e.node == "probe" and e.block == 2
    assert e.attempts == P.schedule.task_retries() + 1
    assert isinstance(e.cause, P.faults.InjectedWorkerError)
    assert "probe" in str(e) and "block=2" in str(e)
    assert st.task_failures == e.attempts and st.retries == e.attempts - 1
    return e.attempts, st.retries, st.task_failures, str(e)


def test_poison_block_isolated_with_provenance(chaos):
    _workers(chaos, 2)
    assert _poison(PORT, chaos) == _poison(REF, chaos)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_deterministic_errors_propagate_unchanged(P, chaos):
    st = P.ExecStats()

    def boom(x):
        raise ValueError("bad value, not transient")

    with pytest.raises(ValueError, match="not transient"):
        P.schedule.dispatch_blocks(boom, [1, 2, 3], stats=st)
    assert st.retries == 0
    assert not P.faults.is_retryable(ValueError("x"))
    assert P.faults.is_retryable(OSError("x"))
    assert P.faults.is_retryable(TimeoutError())
    assert not P.faults.is_retryable(P.faults.TaskError("x"))


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_retries_zero_fails_fast(P, chaos):
    chaos.setenv("REPRO_TASK_RETRIES", "0")
    chaos.setenv("REPRO_FAULT_PLAN", "worker@blk=1/:1.0!")
    with pytest.raises(P.faults.TaskError) as ei:
        P.schedule.dispatch_blocks(lambda x: x, [10, 11, 12])
    assert ei.value.attempts == 1


def test_slow_tasks_complete_and_deadline_is_typed(chaos):
    """Slow tasks alone complete; a deadline below an injected delay fails
    typed.  The deadline (40 ms) sits far below the delay (2 s), so the
    outcome does not depend on load."""
    _workers(chaos, 2)
    chaos.setenv("REPRO_FAULT_PLAN", "slow:1.0")
    chaos.setenv("REPRO_FAULT_SLOW_MS", "1")
    assert PORT.schedule.dispatch_blocks(lambda x: x + 1, list(range(8))) \
        == list(range(1, 9))
    chaos.setenv("REPRO_FAULT_SLOW_MS", "2000")
    chaos.setenv("REPRO_TASK_TIMEOUT_MS", "40")
    with PORT.schedule.node_scope("slowpoke"):
        with pytest.raises(PORT.faults.TaskError) as ei:
            PORT.schedule.dispatch_blocks(lambda x: x + 1, [0, 1])
    assert ei.value.kind == "timeout" and ei.value.node == "slowpoke"


def test_kill_pool_worker_mid_dispatch_recovers(chaos):
    """``reset_pool()`` under an in-flight dispatch models losing the
    worker set: the dispatch completes, and the rebuilt pool serves later
    dispatches with injected worker deaths recovered by retry."""
    _workers(chaos, 2)
    started, release = threading.Event(), threading.Event()

    def fn(i):
        started.set()
        release.wait(10)
        return i * 3

    out: dict = {}
    t = threading.Thread(target=lambda: out.update(
        r=PORT.schedule.dispatch_blocks(fn, list(range(8)))))
    t.start()
    assert started.wait(10)
    PORT.schedule.reset_pool()
    release.set()
    t.join(30)
    assert not t.is_alive()
    assert out.get("r") == [i * 3 for i in range(8)]
    chaos.setenv("REPRO_FAULT_PLAN", "worker:1.0")
    st = PORT.ExecStats()
    assert PORT.schedule.dispatch_blocks(lambda x: -x, [1, 2, 3], stats=st) \
        == [-1, -2, -3]
    assert st.retries == 3


# =============================================================================
# spill integrity: corrupt / missing / orphan / closed store
# =============================================================================
def _spill_out(P, h, filler_seeds=(91, 92)):
    keep = [P.store.as_handle(frame(P, 200, seed=s, strings=False))
            for s in filler_seeds]
    assert not h.is_resident
    return keep


def _flip_middle_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _corrupt_recompute(P, mp):
    src = frame(P, 200, seed=1, strings=False)
    _budget(mp, src.nbytes() + 16)
    hsrc = P.store.as_handle(src)

    def produce():
        f = hsrc.frame()
        return P.Frame([P.Column(f.columns[1].data * 2.0, P.Domain.FLOAT)],
                       P.RangeLabels(f.nrows), P.labels(["x2"]))

    h = P.store.as_handle(produce(), recompute=produce)
    ref = h.frame().to_pydict()
    keep = _spill_out(P, h)
    _flip_middle_byte(h._rec.path)
    st = P.store.get_store().stats
    assert h.frame().to_pydict() == ref
    assert st.checksum_failures == 1 and st.recomputed_blocks == 1
    keep2 = _spill_out(P, h, filler_seeds=(93, 94))
    assert h.frame().to_pydict() == ref
    del keep, keep2
    return ref, tuple(getattr(st, k) for k in st.__slots__)


def test_corrupt_spill_recomputed_from_lineage(chaos):
    assert _corrupt_recompute(PORT, chaos) == _corrupt_recompute(REF, chaos)


def _missing_recompute(P, mp):
    src = frame(P, 200, seed=2, strings=False)
    _budget(mp, src.nbytes() + 16)
    h = P.store.as_handle(src, recompute=lambda: frame(P, 200, seed=2,
                                                       strings=False))
    ref = src.to_pydict()
    keep = _spill_out(P, h)
    os.unlink(h._rec.path)
    st = P.store.get_store().stats
    assert h.frame().to_pydict() == ref
    assert st.checksum_failures == 1 and st.recomputed_blocks == 1
    del keep
    return ref, tuple(getattr(st, k) for k in st.__slots__)


def test_missing_spill_recomputed_from_lineage(chaos):
    assert _missing_recompute(PORT, chaos) == _missing_recompute(REF, chaos)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_corrupt_orphan_spill_raises_typed_error(P, chaos):
    src = frame(P, 200, seed=3, strings=False)
    _budget(chaos, src.nbytes() + 16)
    h = P.store.as_handle(src)
    keep = _spill_out(P, h)
    with open(h._rec.path, "r+b") as f:
        f.seek(os.path.getsize(h._rec.path) // 2)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(P.faults.SpillIntegrityError,
                       match="no recorded producer"):
        h.frame()
    assert P.store.get_store().stats.checksum_failures == 1
    del keep


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_fault_after_shutdown_raises_store_closed(P, chaos):
    src = frame(P, 200, seed=4, strings=False)
    _budget(chaos, src.nbytes() + 16)
    h = P.store.as_handle(src)
    keep = _spill_out(P, h)
    P.store.reset_store()
    with pytest.raises(P.faults.StoreClosedError) as ei:
        h.frame()
    msg = str(ei.value)
    assert f"block id {h._id}" in msg
    assert "shutdown" in msg and ".py:" in msg
    assert isinstance(ei.value, RuntimeError) and "spill" in msg
    del keep


# =============================================================================
# graceful degradation under resource exhaustion
# =============================================================================
def _enospc(P, mp):
    _budget(mp, frame(P, 200, strings=False).nbytes() + 16)
    h1 = P.store.as_handle(frame(P, 200, seed=1, strings=False))
    h2 = P.store.as_handle(frame(P, 200, seed=2, strings=False))
    st = P.store.get_store().stats
    assert h1.is_resident and h2.is_resident
    assert st.budget_overruns > 0 and st.spills == 0
    assert st.resident_bytes > P.store.get_store().budget
    assert h1.frame().to_pydict() == frame(P, 200, seed=1,
                                           strings=False).to_pydict()
    return tuple(getattr(st, k) for k in st.__slots__)


def test_enospc_keeps_victim_resident_and_counts_overrun(chaos):
    chaos.setenv("REPRO_FAULT_PLAN", "enospc:1.0")
    assert _enospc(PORT, chaos) == _enospc(REF, chaos)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_spill_dir_failover_list(P, chaos, tmp_path):
    bad, good = tmp_path / "full-disk", tmp_path / "overflow"
    bad.mkdir()
    good.mkdir()
    chaos.setenv("REPRO_SPILL_DIR", f"{bad}{os.pathsep}{good}")
    chaos.setenv("REPRO_FAULT_PLAN", "enospc@dir0:1.0")
    _budget(chaos, frame(P, 200, strings=False).nbytes() + 16)
    h1 = P.store.as_handle(frame(P, 200, seed=1, strings=False))
    h2 = P.store.as_handle(frame(P, 200, seed=2, strings=False))
    assert not h1.is_resident
    assert P.store.get_store().stats.spills == 1
    assert not any(bad.rglob("blk*.npz"))
    assert any(good.rglob("blk*.npz"))
    assert h1.frame().to_pydict() == frame(P, 200, seed=1,
                                           strings=False).to_pydict()
    del h2


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_reap_unlink_failure_counts_leak(P, chaos):
    _budget(chaos, frame(P, 200, strings=False).nbytes() + 16)
    h1 = P.store.as_handle(frame(P, 200, seed=1, strings=False))
    h2 = P.store.as_handle(frame(P, 200, seed=2, strings=False))
    assert not h1.is_resident
    st = P.store.get_store().stats
    real_unlink = os.unlink

    def deny(p, *a, **k):
        if "repro-spill-" in str(p):
            raise PermissionError(13, "Permission denied", str(p))
        return real_unlink(p, *a, **k)

    chaos.setattr(os, "unlink", deny)
    del h1
    gc.collect()
    assert st.leaked_spill_files == 1
    chaos.setattr(os, "unlink", real_unlink)
    del h2


# =============================================================================
# read_csv: file changed between planning and tokenization
# =============================================================================
@pytest.mark.parametrize("change", ["truncated", "grew"])
def test_read_csv_file_changed_mid_ingest(chaos, tmp_path, change):
    csv = tmp_path / "racy.csv"
    write_csv(csv, 2000, strings=False)
    orig = PORT.api._csv_chunk_ranges

    def plan_then_change(path, sep):
        header, ranges = orig(path, sep)
        if change == "truncated":
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) - 123)
        else:
            with open(path, "ab") as f:
                f.write(b"9,9,9.0\n")
        return header, ranges

    chaos.setattr(PORT.api, "_csv_chunk_ranges", plan_then_change)
    s = PORT.Session(mode=PORT.EvalMode.LAZY, **PORT.kw)
    try:
        with pytest.raises(PORT.faults.IngestError, match=change):
            PORT.api.read_csv(str(csv), session=s)
    finally:
        s.close()


# =============================================================================
# chaos differential: fault plans × grids, bit-identical + attributed
# =============================================================================
def _grid_run(P, rp):
    f = frame(P, 4000, seed=7, strings=False)
    ex = P.Executor({"f": P.PF.from_frame(f, row_parts=rp)}, optimize=True)
    out = ex.evaluate(pipeline_plan(P, P.alg.Source("f", 4000, 2),
                                    "faults_sweep_scale"))
    return out.to_frame().to_pydict(), ex.stats


@pytest.mark.parametrize("grid", [1, None, "4w"])
def test_worker_chaos_differential_across_grids(grid, chaos):
    _workers(chaos, 2)
    w = PORT.schedule.pool_width()
    rp = {1: 1, None: w, "4w": 4 * w}[grid]
    ref, st_ref = _grid_run(REF, rp)
    base, st0 = _grid_run(PORT, rp)
    assert base == ref
    assert st0.faults_injected == 0 and st0.retries == 0
    chaos.setenv("REPRO_FAULT_PLAN", "worker:0.4,slow:0.2")
    chaos.setenv("REPRO_FAULT_SEED", "11")
    chaos.setenv("REPRO_FAULT_SLOW_MS", "1")
    got, st = _grid_run(PORT, rp)
    assert got == ref
    assert st.faults_injected > 0
    assert st.retries > 0 and st.task_failures == st.retries
    rgot, rst = _grid_run(REF, rp)
    assert rgot == ref
    # the draws are pure per (kind, address), and dispatch addresses hold no
    # block ids, so both packages inject and retry exactly the same
    assert (st.faults_injected, st.retries, st.task_failures) == (
        rst.faults_injected, rst.retries, rst.task_failures)


def _acceptance_run(P, csv, inject):
    s = P.Session(mode=P.EvalMode.LAZY, **P.kw)
    try:
        df = P.api.read_csv(str(csv), session=s)
        total = s.frames["frame_0"].nbytes()
        df["y"] = df["x"] * 2.0 + 1.0
        out = (df[df["v"] > 10].groupby("k")
               .agg({"y": "sum", "x": "mean"}).drop_duplicates())
        if inject:
            P.faults.configure(
                plan="worker:0.3,slow:0.1,corrupt:0.5,missing:0.3,enospc:0.4",
                seed=5)
        pf = s.executor.evaluate(out._node)
        fired = P.faults.injected_snapshot()
        injected = P.faults.injected_total()
        P.faults.reset()
        return (pf.to_frame().to_pydict(), total, s.executor.stats, fired,
                injected)
    finally:
        s.close()


def test_acceptance_all_fault_classes_4x_budget_pipeline(chaos, tmp_path):
    """A seeded plan injecting every fault class into the 4x-budget
    groupby + dedup pipeline completes bit-identical to the reference's
    fault-free run, with every retry / recompute / overrun attributed."""
    _workers(chaos, 2)
    csv = tmp_path / "big.csv"
    write_csv(csv, 20_000, strings=False)
    ref, total, st_ref, _, _ = _acceptance_run(REF, csv, False)
    base, ptotal, st0, _, _ = _acceptance_run(PORT, csv, False)
    assert base == ref and ptotal == total
    assert st0.spills == 0 and st0.faults_injected == 0

    _budget(chaos, total // 4)
    chaos.setenv("REPRO_FAULT_SLOW_MS", "1")
    got, _, st, fired, injected = _acceptance_run(PORT, csv, True)
    assert got == ref
    assert fired.get("worker", 0) >= 1
    assert fired.get("corrupt", 0) + fired.get("missing", 0) >= 1
    assert fired.get("enospc", 0) >= 1
    store_stats = PORT.store.get_store().stats
    assert st.retries > 0 and st.task_failures >= st.retries
    assert st.checksum_failures == store_stats.checksum_failures > 0
    assert st.recomputed_blocks == store_stats.recomputed_blocks > 0
    assert st.budget_overruns == store_stats.budget_overruns > 0
    assert st.faults_injected == injected > 0
    assert store_stats.leaked_spill_files == 0


def test_zero_fault_run_stays_clean(chaos):
    """With injection off the whole layer is inert."""
    _workers(chaos, 2)
    for P in BOTH:
        f = frame(P, 2000, seed=5, strings=False)
        ex = P.Executor({"f": P.PF.from_frame(f, row_parts=4)}, optimize=True)
        out = ex.evaluate(pipeline_plan(P, P.alg.Source("f", 2000, 2),
                                        "faults_clean"))
        assert out.nrows > 0 and not P.faults.active()
        assert ex.stats.faults_injected == ex.stats.retries == 0
        assert ex.stats.task_failures == ex.stats.checksum_failures == 0


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_session_knobs_configure_retries_and_plan(P, chaos):
    """Session knobs are session-scoped: they hold inside the session's
    config scope and leave the process defaults untouched."""
    base = P.schedule.task_retries()
    s = P.Session(mode=P.EvalMode.LAZY, task_retries=5, retry_backoff_ms=0,
                  task_timeout_ms=0, fault_plan="worker:0.0", fault_seed=9,
                  **P.kw)
    try:
        with P.config.scope(s.config):
            assert P.schedule.task_retries() == 5
            assert P.schedule.retry_backoff_ms() == 0
            assert P.faults.active()
            p = P.faults._plan()
            assert p is not None and p.seed == 9
        assert P.schedule.task_retries() == base
        assert not P.faults.active() and P.faults._plan() is None
    finally:
        s.close()
