"""Evaluation engine: eager / lazy / opportunistic execution (paper §6.1).

* **eager**       — pandas semantics: each statement fully evaluated on
                    construction (the paper-faithful baseline).
* **lazy**        — Spark semantics: nothing runs until the user inspects.
* **opportunistic** — the paper's §6.1.1 middle ground: control returns
                    immediately, the plan is *scheduled in the background*
                    during "think time"; an inspect prioritizes that plan
                    (and is usually a cache hit by then).

Also implements:
* prefix computation (§6.1.2): ``head(k)`` on prefix-safe plans evaluates only
  enough *input row blocks* to produce k output rows (progressive doubling for
  selective plans), instead of the whole frame;
* materialization & reuse (§6.2.2): every evaluated sub-plan lands in a
  budget-bounded cache keyed by structural plan hash; the eviction policy
  maximizes saved-compute density (cost × hits / bytes) — the PTIME-optimal
  policy of Helix [69] approximated greedily;
* multi-query sharing (§6.2.1): common sub-expressions across concurrently
  scheduled statements dedupe through the cache *and* through an in-flight
  table, so a sub-plan running in the background is joined, never recomputed;
* pipeline fusion (§5): after rule rewriting, maximal chains of row-local
  operators collapse into ``FusedPipeline`` groups and fuse through blocking
  operators (``rewrite.fuse_pipelines``), each evaluated as one physical
  sweep with a single cache entry — ``ExecStats.fused_groups`` /
  ``fused_stage_ops`` attribute the win.
"""
from __future__ import annotations

import concurrent.futures as _fut
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from . import algebra as alg
from . import physical, rewrite
from .frame import Frame
from .partition import PartitionedFrame, default_grid
from . import config as _config
from . import faults as _faults
from . import trace as _trace
from .faults import ExecutorClosedError, StatementCancelled
from .schedule import node_scope, stats_scope
from .store import get_store

__all__ = ["Executor", "CacheEntry", "ExecStats", "StatsTee"]


@dataclass
class CacheEntry:
    result: PartitionedFrame
    cost_s: float          # wall time it took to produce
    nbytes: int
    hits: int = 0
    created: float = field(default_factory=time.monotonic)

    def benefit_density(self) -> float:
        return (self.cost_s * (1 + self.hits)) / max(1, self.nbytes)


@dataclass
class ExecStats:
    """Counter semantics (one source of truth — mirrors ``rewrite.FusionStats``,
    asserted in tests and benches):

      * ``fused_groups``          — FusedPipeline nodes in final plans;
      * ``barrier_fused_groups``  — barrier-fused nodes (FusedGroupBy /
                                    FusedSort / FusedJoin / FusedWindow);
      * ``producer_stage_ops``    — operator nodes absorbed as producer stages
                                    of a barrier node (GROUPBY pre-aggregation
                                    sweep, WINDOW pre-stages);
      * ``consumer_stage_ops``    — operator nodes absorbed as consumer stages
                                    (SORT/JOIN post-gather chain, WINDOW
                                    post-stages);
      * ``fused_stage_ops``       — operator nodes absorbed into ANY fused
                                    construct.  Invariant::

                                      fused_stage_ops ==
                                          (ops in FusedPipeline groups)
                                          + producer_stage_ops
                                          + consumer_stage_ops

      * ``gather_rows``           — payload rows gathered / materialized by
                                    SORT/JOIN/DIFFERENCE/DROP-DUPLICATES
                                    result materialization (fused-consumer
                                    paths gather strictly fewer rows than
                                    unfused ones under selective chains);
      * ``dedup_blocks``          — key-extraction programs DIFFERENCE /
                                    DROP-DUPLICATES ran (both inputs, for
                                    DIFFERENCE): per-partition on the
                                    block-parallel path, 1 (dedup) / 2
                                    (difference) whole-frame programs on the
                                    ``REPRO_BLOCK_DEDUP=0`` serial path — the
                                    count vs the partition count shows which
                                    path ran;
      * ``dedup_key_rows``        — rows those key-extraction programs keyed
                                    (== input rows after any absorbed
                                    producer chain);
      * ``dispatches``            — pool tasks submitted on this executor's
                                    behalf (``schedule.dispatch_blocks``);
      * ``dispatched_blocks``     — blocks those tasks covered.  With block
                                    coalescing ``dispatches`` grows with the
                                    *worker* count while ``dispatched_blocks``
                                    grows with the *partition* count — their
                                    ratio ``blocks_per_dispatch`` attributes
                                    the coalescing win;
      * ``spills`` / ``faults``   — block-store residency transitions
                                    (``core.store``) that happened while this
                                    executor's plan nodes ran: blocks written
                                    to disk under ``REPRO_MEM_BUDGET``
                                    pressure / loaded back on demand.  With
                                    the default budget 0 both MUST stay 0 —
                                    every pre-existing suite asserts that
                                    (tests/conftest.py), so residency can
                                    never regress silently;
      * ``spilled_bytes``         — payload bytes those spills wrote;
      * ``peak_resident_bytes``   — the store's resident high-water mark over
                                    this executor's evaluations (0 when the
                                    store is unbudgeted — nothing is
                                    tracked).  The out-of-core invariant is
                                    peak ≤ budget + one in-flight block per
                                    pool worker.

    Fault-tolerance counters — a statement either completes
    bit-identical to its fault-free run or raises ONE typed error
    (``faults.TaskError`` / ``SpillIntegrityError`` / ``StoreClosedError``),
    and everything the recovery machinery did is attributed here, per plan
    node, by the same scope/snapshot-delta mechanism as the counters above:

      * ``retries``               — block-task retry attempts the dispatch
                                    layer spent on transient failures
                                    (``REPRO_TASK_RETRIES``);
      * ``task_failures``         — block/chunk task failures observed
                                    (each retry that itself fails counts
                                    again; ≥ ``retries`` on a run that
                                    ultimately raised);
      * ``checksum_failures``     — spill files that failed CRC32
                                    verification or were missing on fault;
      * ``recomputed_blocks``     — blocks rebuilt from their recorded
                                    producer after an integrity failure;
      * ``budget_overruns``       — spill writes abandoned (ENOSPC on every
                                    ``REPRO_SPILL_DIR`` entry): the victim
                                    stayed resident, over budget, rather
                                    than failing the statement;
      * ``faults_injected``       — faults the deterministic chaos plan
                                    (``REPRO_FAULT_PLAN``) actually fired
                                    during this executor's evaluations; 0
                                    whenever injection is disabled.

    Shuffle/exchange counters (``core/shuffle.py``) — grace-hash JOIN
    and sample-sort SORT attribute their exchange here; all three stay 0 under
    ``REPRO_SHUFFLE=0`` (the serial oracle) and for cross joins (which need
    no exchange):

      * ``shuffle_buckets``       — bucket frames the exchange registered:
                                    2·B per hash join (one per side per
                                    bucket), B per sample-sort;
      * ``shuffle_bytes``         — key-frame payload bytes exchanged —
                                    exactly ``rows × (n_keys + 1) × 8``
                                    (float64 keys + int64 global position)
                                    summed over bucket frames; the payload
                                    itself never moves through the exchange;
      * ``skew_splits``           — extra local tasks created by splitting
                                    oversized buckets
                                    (``REPRO_SHUFFLE_SKEW_FACTOR``): an
                                    oversized join bucket splits its larger
                                    side, an oversized sort bucket range-
                                    refines; 0 on balanced keys.

    Timing counters (``core.trace``) — wall-clock attribution in
    nanoseconds, always on (one ``perf_counter_ns`` pair per window; the
    span *tree* itself only exists under ``REPRO_TRACE``/``Session(trace=)``):

      * ``node_wall_ns``          — time inside physical node programs (each
                                    node's own run window; children are timed
                                    in their own windows, never double-
                                    counted);
      * ``plan_prep_ns``          — time in plan preparation (rewrite +
                                    fusion) per statement;
      * ``queue_wait_ns``         — time async statements waited in the
                                    admission queue (``core.service``) before
                                    getting an inflight slot;
      * ``slot_hold_ns``          — time admitted statements held their slot
                                    (queue_wait + slot_hold ≈ the tenant's
                                    pool pressure: ``QueryService.
                                    tenant_report`` ranks sessions by these).
    """

    evaluated_nodes: int = 0
    cache_hits: int = 0
    inflight_joins: int = 0
    prefix_evals: int = 0
    rewrites_applied: int = 0
    background_tasks: int = 0
    fused_groups: int = 0
    fused_stage_ops: int = 0
    barrier_fused_groups: int = 0
    producer_stage_ops: int = 0
    consumer_stage_ops: int = 0
    gather_rows: int = 0
    dedup_blocks: int = 0
    dedup_key_rows: int = 0
    dispatches: int = 0
    dispatched_blocks: int = 0
    spills: int = 0
    faults: int = 0
    spilled_bytes: int = 0
    peak_resident_bytes: int = 0
    retries: int = 0
    task_failures: int = 0
    checksum_failures: int = 0
    recomputed_blocks: int = 0
    budget_overruns: int = 0
    faults_injected: int = 0
    shuffle_buckets: int = 0
    shuffle_bytes: int = 0
    skew_splits: int = 0
    node_wall_ns: int = 0
    plan_prep_ns: int = 0
    queue_wait_ns: int = 0
    slot_hold_ns: int = 0

    @property
    def blocks_per_dispatch(self) -> float:
        return self.dispatched_blocks / max(1, self.dispatches)


_TEE_LOCK = threading.Lock()


class StatsTee:
    """Duck-typed ``ExecStats`` writer that mirrors every counter mutation
    onto several targets — the executor's global stats plus the active
    session's per-session stats (``config.SessionConfig.stats``), used when
    many service sessions share one executor (``core.service``).

    Counter sites write ``st.counter += n``; ``__setattr__`` recovers the
    delta against the primary target under one process-wide lock and applies
    it to EVERY target, so a concurrent session sees exactly its own work
    while the global counters stay the sum of the per-session ones (lost
    updates under contention hit all targets identically, preserving the sum
    invariant).  Reads come from the primary (global) target.  Non-additive
    gauges (``peak_resident_bytes``) must not be assigned through the tee —
    ``Executor._attribute_store_delta`` handles them explicitly per target."""

    __slots__ = ("_targets",)

    def __init__(self, *targets: ExecStats):
        object.__setattr__(self, "_targets", targets)

    def __getattr__(self, name: str):
        return getattr(self._targets[0], name)

    def __setattr__(self, name: str, value) -> None:
        ts = self._targets
        with _TEE_LOCK:
            delta = value - getattr(ts[0], name)
            for t in ts:
                setattr(t, name, getattr(t, name) + delta)


class Executor:
    def __init__(self, frame_store: dict[str, PartitionedFrame], *,
                 cache_budget_bytes: int = 1 << 30, optimize: bool = True,
                 background_workers: int = 2):
        self.frames = frame_store
        self.cache: dict[tuple, CacheEntry] = {}
        self.cache_budget = cache_budget_bytes
        self.optimize = optimize
        self.stats = ExecStats()
        self._closed = False
        self._lock = threading.Lock()
        self._inflight: dict[tuple, _fut.Future] = {}
        # plan keys already counted in fusion stats (bounded FIFO: stats-only
        # bookkeeping must not grow with the life of a session)
        self._fused_seen: dict[tuple, None] = {}
        self._memo_max = 4096
        # session statement history (MQO-aware fusion boundaries, §6.2.1):
        # candidate barrier key (a statement's optimized or prepared form) →
        # the statement's prepared key.  A candidate is a fusion barrier only
        # while its prepared result is materialized (cache) or in flight.
        self._history: dict[tuple, tuple] = {}
        self._history_max = 2048
        # optimized-plan key → (active history snapshot, fused plan), so
        # re-evaluating a cached statement does not pay the fusion walk again
        # (bounded FIFO); the snapshot guards against stale fusion when a
        # history statement's materialization status changes
        self._fuse_memo: dict[tuple, tuple[frozenset, alg.Node]] = {}
        # raw-plan key → optimized plan: the fluent API prepares AND records
        # every statement, so the fixpoint rewrite walk must not run twice
        # per plan (bounded FIFO; sources are append-only so schemas are
        # stable).  Also keeps stats.rewrites_applied at once per plan.
        self._opt_memo: dict[tuple, alg.Node] = {}
        self._bg = _fut.ThreadPoolExecutor(max_workers=background_workers,
                                           thread_name_prefix="repro-bg")

    def _stats(self) -> Any:
        """Stats sink for the calling context: the executor's global counters,
        teed into the active session's per-session ``ExecStats`` when one is
        installed (multi-session attribution under a ``QueryService``)."""
        cfg = _config.current()
        ss = cfg.stats if cfg is not None else None
        if ss is None or ss is self.stats:
            return self.stats
        return StatsTee(self.stats, ss)

    def _require_open(self) -> None:
        if self._closed:
            raise ExecutorClosedError(
                "executor is shut down — the owning session/service was closed")

    # ------------------------------------------------------------------
    # plan optimization entry
    # ------------------------------------------------------------------
    def _source_columns(self, frame_id: str) -> list | None:
        pf = self.frames.get(frame_id)
        if pf is None:
            return None
        return pf.parts[0][0].col_labels.to_list() if pf.col_parts == 1 else (
            pf.repartition(col_parts=1).parts[0][0].col_labels.to_list())

    def optimized(self, node: alg.Node) -> alg.Node:
        if not self.optimize:
            return node
        key = node.cache_key()
        with self._lock:
            hit = self._opt_memo.get(key)
        if hit is not None:
            return hit
        out = rewrite.optimize(node, self._source_columns)
        if out is not node:
            self._stats().rewrites_applied += 1
        with self._lock:
            while len(self._opt_memo) >= self._memo_max:
                self._opt_memo.pop(next(iter(self._opt_memo)))
            self._opt_memo[key] = out
        return out

    def fused(self, node: alg.Node) -> alg.Node:
        """Fusion pass (paper §5 pipelining + barrier fusion): collapse
        row-local chains into FusedPipeline groups and fuse them through
        blocking-operator boundaries — one physical sweep and one cache entry
        each.  Disabled together with ``optimize`` so the per-node path stays
        available as the comparison baseline."""
        if not self.optimize:
            return node
        st = self._stats()
        in_key = node.cache_key()
        with self._lock:
            hit = self._fuse_memo.get(in_key)
            history = frozenset(
                k for k, prep in self._history.items()
                if prep in self.cache or prep in self._inflight)
        if hit is not None and hit[0] == history:
            return hit[1]
        out, fs = rewrite.fuse_pipelines(node, history)
        with self._lock:
            while len(self._fuse_memo) >= self._memo_max:
                self._fuse_memo.pop(next(iter(self._fuse_memo)))
            self._fuse_memo[in_key] = (history, out)
            if fs.groups or fs.barrier_groups:
                # count each distinct plan once: re-evaluating a cached plan
                # is not new fusion work
                key = out.cache_key()
                if key not in self._fused_seen:
                    while len(self._fused_seen) >= self._memo_max:
                        self._fused_seen.pop(next(iter(self._fused_seen)))
                    self._fused_seen[key] = None
                    st.fused_groups += fs.groups
                    st.fused_stage_ops += fs.fused_ops
                    st.barrier_fused_groups += fs.barrier_groups
                    st.producer_stage_ops += fs.producer_ops
                    st.consumer_stage_ops += fs.consumer_ops
        return out

    def note_statement(self, node: alg.Node) -> None:
        """Record a session statement in the fusion history (MQO §6.2.1):
        while this statement's result is materialized (or in flight), later
        plans refuse to absorb its sub-plan into a bigger fused group, so the
        cached result keeps serving as a shared prefix.  Fusion is
        deterministic, so the split sub-plan re-fuses to this statement's
        prepared cache key.  Call AFTER the statement is prepared/submitted —
        a statement must not act as a fusion barrier against itself."""
        if not self.optimize:
            return
        opt = self.optimized(node)
        prep_key = self.fused(opt).cache_key()
        with self._lock:
            for k in (opt.cache_key(), prep_key):
                if k not in self._history:
                    while len(self._history) >= self._history_max:
                        self._history.pop(next(iter(self._history)))
                    self._history[k] = prep_key

    def _prepared(self, node: alg.Node) -> alg.Node:
        return self.fused(self.optimized(node))

    # ------------------------------------------------------------------
    # synchronous evaluation (with cache + in-flight dedupe)
    # ------------------------------------------------------------------
    def evaluate(self, node: alg.Node, *,
                 stmt: int | None = None) -> PartitionedFrame:
        # plan preparation can touch the store too (schema inference
        # resolves a source block, which may fault a spilled one back in) —
        # attribute that residency work here so statement execution accounts
        # for EVERY spill/fault/recompute, not just the per-node windows
        self._require_open()
        tr = _trace.live()
        st = self._stats()
        s0 = get_store().stats.snapshot()
        f0 = _faults.injected_total()
        if tr is None:
            tp0 = time.perf_counter_ns()
            prepared = self._prepared(node)
            st.plan_prep_ns += time.perf_counter_ns() - tp0
            self._attribute_store_delta(s0, f0)
            return self._eval(prepared)
        with tr.statement(f"statement:{node.op}", stmt=stmt):
            tp0 = time.perf_counter_ns()
            with tr.span("plan_prep", "prep") as sp:
                prepared = self._prepared(node)
                sp.args = self._attribute_store_delta(s0, f0, want_delta=True)
            st.plan_prep_ns += time.perf_counter_ns() - tp0
            return self._eval(prepared)

    def _attribute_store_delta(self, s0, f0,
                               want_delta: bool = False) -> dict | None:
        """Fold the store/fault counter movement since snapshot ``s0`` /
        injected-count ``f0`` into this executor's ``ExecStats`` — and into
        the active session's per-session stats when one is installed, so
        multi-tenant attribution sums to the global counters.

        ``want_delta=True`` (traced runs) additionally returns the delta as a
        dict, which the caller attaches to the window's span — spans carry
        exactly the counters ExecStats was credited with, which is why a
        statement's span-attached deltas sum to its global ExecStats movement
        (asserted by ``tests/test_torch_trace.py``)."""
        s1 = get_store().stats.snapshot()
        df = _faults.injected_total() - f0
        cfg = _config.current()
        ss = cfg.stats if cfg is not None else None
        targets = ((self.stats,) if ss is None or ss is self.stats
                   else (self.stats, ss))
        with _TEE_LOCK:
            for t in targets:
                t.spills += s1[0] - s0[0]
                t.faults += s1[1] - s0[1]
                t.spilled_bytes += s1[2] - s0[2]
                t.checksum_failures += s1[4] - s0[4]
                t.recomputed_blocks += s1[5] - s0[5]
                t.budget_overruns += s1[6] - s0[6]
                t.faults_injected += df
                # peak is attributed only when this window raised the store's
                # high-water mark — a fresh executor must not inherit an
                # earlier session's peak from the process-wide gauge
                if s1[3] > s0[3] and s1[3] > t.peak_resident_bytes:
                    t.peak_resident_bytes = s1[3]
        if not want_delta:
            return None
        return {"spills": s1[0] - s0[0], "faults": s1[1] - s0[1],
                "spilled_bytes": s1[2] - s0[2],
                "checksum_failures": s1[4] - s0[4],
                "recomputed_blocks": s1[5] - s0[5],
                "budget_overruns": s1[6] - s0[6],
                "faults_injected": df}

    def _hit_event(self, node: alg.Node, *, inflight: bool = False) -> None:
        """Cache-hit provenance for traced statements: an instant event names
        the plan node a cached (or in-flight) result served, so ``profile()``
        can say which sub-plans the MQO layer reused.  No-op untraced."""
        tr = _trace.current()
        if tr is not None:
            kind = "inflight_join" if inflight else "cache_hit"
            tr.instant(f"{kind}:{node.op}", "cache")

    def _join(self, fut: _fut.Future, node: alg.Node) -> PartitionedFrame:
        """Join another statement's in-flight evaluation.  If that producer
        was *cancelled* (its session's CancelToken fired) the cancellation
        must not leak into us — re-evaluate the sub-plan ourselves.  A
        producer that failed for any other reason (including the executor
        shutting down) propagates its typed error."""
        try:
            return fut.result()
        except StatementCancelled:
            return self._eval(node)

    def _eval(self, node: alg.Node) -> PartitionedFrame:
        self._require_open()
        st = self._stats()
        key = node.cache_key()
        # cache and in-flight are consulted under ONE lock hold (a split
        # would let a finishing thread fill the cache AND retire its future
        # between our two looks — re-evaluating the whole plan); the store
        # benefit stamp runs outside the lock
        with self._lock:
            ent = self.cache.get(key)
            fut = None
            if ent is not None:
                ent.hits += 1
                st.cache_hits += 1
            else:
                fut = self._inflight.get(key)
        if ent is not None:
            self._hit_event(node)
            self._sync_store_benefit(ent)
            return ent.result
        if fut is not None:
            st.inflight_joins += 1
            self._hit_event(node, inflight=True)
            return self._join(fut, node)

        promise: _fut.Future = _fut.Future()
        with self._lock:
            # double-check under lock: cache → in-flight → register, atomic
            ent = self.cache.get(key)
            fut = None
            if ent is not None:
                ent.hits += 1
                st.cache_hits += 1
            else:
                existing = self._inflight.get(key)
                if existing is not None:
                    fut = existing
                else:
                    self._inflight[key] = promise
        if ent is not None:
            self._hit_event(node)
            self._sync_store_benefit(ent)   # same policy as the fast path
            return ent.result
        if fut is not None:
            st.inflight_joins += 1
            self._hit_event(node, inflight=True)
            return self._join(fut, node)

        try:
            t0 = time.monotonic()
            if node.op == "source":
                result = self.frames[node.params["frame_id"]]
            else:
                inputs = [self._eval(c) for c in node.children]
                # attribute block-store residency work (spills written /
                # faults served while THIS node's physical program ran) by
                # snapshot delta — faults happen on pool worker threads, so
                # the contextvar scope can't see them
                s0 = get_store().stats.snapshot()
                f0 = _faults.injected_total()
                tr = _trace.live()
                tn0 = time.perf_counter_ns()
                if tr is None:
                    with stats_scope(st), node_scope(node.op):
                        result = physical.run_node(node, inputs, st)
                    self._attribute_store_delta(s0, f0)
                else:
                    # children were evaluated above, in their own windows, so
                    # this span's duration and counter delta are exactly this
                    # node's own work — per-statement spans partition the
                    # statement's ExecStats movement
                    with tr.span(f"eval:{node.op}", "node") as span:
                        with stats_scope(st), node_scope(node.op):
                            result = physical.run_node(node, inputs, st)
                        span.args = self._attribute_store_delta(
                            s0, f0, want_delta=True)
                st.node_wall_ns += time.perf_counter_ns() - tn0
            dt = time.monotonic() - t0
            st.evaluated_nodes += 1
            self._store(key, result, dt)
            try:
                promise.set_result(result)
            except _fut.InvalidStateError:
                pass   # shutdown() failed this promise first; our own
                       # caller still gets the computed result
            return result
        except BaseException as e:
            try:
                promise.set_exception(e)
            except _fut.InvalidStateError:
                pass
            raise
        finally:
            with self._lock:
                self._inflight.pop(key, None)

    # ------------------------------------------------------------------
    # materialization cache with benefit-density eviction (§6.2.2)
    # ------------------------------------------------------------------
    def _store(self, key: tuple, result: PartitionedFrame, cost_s: float) -> None:
        try:
            nbytes = result.nbytes()
        except Exception:
            nbytes = 1
        with self._lock:
            ent = CacheEntry(result, cost_s, nbytes)
            self.cache[key] = ent
            total = sum(e.nbytes for e in self.cache.values())
            if total > self.cache_budget:
                # evict lowest benefit-density first; never evict sources
                victims = sorted(self.cache.items(), key=lambda kv: kv[1].benefit_density())
                for k, e in victims:
                    if total <= self.cache_budget:
                        break
                    if k[0] == "source":
                        continue
                    del self.cache[k]
                    total -= e.nbytes
        self._sync_store_benefit(ent)

    def _sync_store_benefit(self, ent: CacheEntry) -> None:
        """Unified budget (§6.2.2 + out-of-core store): stamp a cached
        result's block handles with the entry's benefit density, so the
        block store's eviction — which charges cached sub-plans and live
        partitions against ONE ``REPRO_MEM_BUDGET`` — spills low-value
        working blocks (benefit 0) before it spills reusable cached
        results.  Hits raise the density, so a hot entry's blocks climb the
        residency order over time."""
        if not get_store().active:
            return
        b = ent.benefit_density()
        for row in ent.result.handles:
            for h in row:
                if b > h.benefit:
                    h.benefit = b

    def cache_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self.cache.values())

    # ------------------------------------------------------------------
    # opportunistic background scheduling (§6.1.1)
    # ------------------------------------------------------------------
    def submit(self, node: alg.Node, *,
               cancel: _config.CancelToken | None = None,
               stmt: int | None = None) -> _fut.Future:
        """Schedule evaluation in the background; returns a future.  The
        user-facing handle keeps composing; an inspect call joins it.

        The caller's session config scope is captured HERE and re-installed
        on the background thread (contextvars are per-thread, so they do not
        cross ``ThreadPoolExecutor.submit`` by themselves).  ``cancel`` makes
        the background run cancellable at the next dispatch boundary — the
        run raises the typed ``faults.StatementCancelled``.  ``stmt`` is the
        trace statement id allocated at submission time (``Session.submit`` /
        the admission controller), so the plan-prep span here, the queue-wait
        span, and the statement span opened on the background thread all land
        in one per-statement tree."""
        self._require_open()
        tr = _trace.live()
        st = self._stats()
        tp0 = time.perf_counter_ns()
        if tr is None:
            node = self._prepared(node)
        else:
            if stmt is None:
                stmt = tr.next_stmt()
            s0 = get_store().stats.snapshot()
            f0 = _faults.injected_total()
            with tr.span("plan_prep", "prep", stmt=stmt) as sp:
                node = self._prepared(node)
                sp.args = self._attribute_store_delta(s0, f0, want_delta=True)
        st.plan_prep_ns += time.perf_counter_ns() - tp0
        st.background_tasks += 1
        cfg = _config.current()
        if cancel is None:
            cancel = _config.current_cancel()

        def run() -> PartitionedFrame:
            with _config.propagate(cfg, cancel):
                if tr is None:
                    return self._eval(node)
                with tr.statement(f"statement:{node.op}", stmt=stmt):
                    return self._eval(node)

        return self._bg.submit(run)

    # ------------------------------------------------------------------
    # prefix computation (§6.1.2)
    # ------------------------------------------------------------------
    def evaluate_prefix(self, node: alg.Node, k: int) -> PartitionedFrame:
        """Produce (at least) the first k result rows cheaply when legal."""
        self._require_open()
        node = self._prepared(node)
        key = node.cache_key()
        with self._lock:
            ent = self.cache.get(key)
        if ent is not None:  # full result already known
            ent.hits += 1
            return _head(ent.result, k)
        if not alg.prefix_safe(node):
            return _head(self._eval(node), k)

        self._stats().prefix_evals += 1
        src = next(n for n in node.walk() if n.op == "source")
        total = self.frames[src.params["frame_id"]].nrows
        take = max(k, 4096)
        while True:
            pref = self._eval_with_source_prefix(node, src, min(take, total))
            if pref.nrows >= k or take >= total:
                return _head(pref, k)
            take *= 4   # selective plans: geometric back-off

    def _eval_with_source_prefix(self, node: alg.Node, src: alg.Source, k: int) -> PartitionedFrame:
        def substitute(n: alg.Node) -> alg.Node:
            if n is src or n == src:
                return alg.Limit(n, k, tail=False)
            return rewrite.rebuild(n, [substitute(c) for c in n.children])
        return self._eval(substitute(node))

    def shutdown(self):
        """Close the executor: new work is refused (``ExecutorClosedError``)
        and every in-flight promise that has not resolved yet is FAILED with
        the same typed error instead of being abandoned — a ``collect``
        racing a ``close`` raises immediately, it never blocks on a future
        nobody will complete.  (A producer thread that finishes anyway hits
        ``InvalidStateError`` on its own ``set_result`` and ignores it.)
        Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = [f for f in self._inflight.values() if not f.done()]
        err = ExecutorClosedError("executor shut down with statements in flight")
        for f in pending:
            try:
                f.set_exception(err)
            except _fut.InvalidStateError:
                pass   # producer resolved it between our look and now — fine
        self._bg.shutdown(wait=False, cancel_futures=True)


def _head(pf: PartitionedFrame, k: int) -> PartitionedFrame:
    return PartitionedFrame.from_frame(pf.prefix(k).to_frame().head(k))
