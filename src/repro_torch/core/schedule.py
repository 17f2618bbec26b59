"""Adaptive block scheduling: the layer between the physical operators and
the shared thread pool (ROADMAP: "Pool scheduling when partitions ≫ cores").

The paper (§4.2) picks a partitioning scheme per operation; this module makes
the *runtime* side of that choice adaptive in two ways:

1. **Coalesced dispatch** — :func:`dispatch_blocks` is the single entry point
   through which per-block work reaches the pool.  When the number of blocks
   exceeds the worker count, several contiguous blocks are chunked into ONE
   pool task (a worker runs them back-to-back), so a 256-partition grid on a
   4-worker pool costs ~8 pool dispatches instead of 256.  Results are always
   returned in block order, and each block is still processed independently —
   coalescing is bit-identical to per-block dispatch by construction (asserted
   property-style in ``tests/test_scheduling.py``).

2. **Plan-time grid sizing** — :func:`pool_width` is the one source of truth
   for the configured parallelism (``partition.default_grid`` sizes new grids
   from it instead of ``os.cpu_count()``), and :func:`preferred_row_parts`
   adapts a blocking operator's working grid to the worker set using the
   per-operator preference recorded on the plan node by
   ``rewrite.fuse_pipelines`` (GROUPBY partial programs and DIFFERENCE /
   DROP-DUPLICATES key extraction want blocks ≈ workers; WINDOW carry chains
   want fewer seams).

Dispatches inside a plan-node evaluation are attributed to the executor's
``ExecStats`` through :class:`stats_scope` (``dispatches`` /
``dispatched_blocks`` / ``blocks_per_dispatch``); the block-parallel
DIFFERENCE / DROP-DUPLICATES paths additionally report ``dedup_blocks`` and
``dedup_key_rows`` (blocks and rows their per-block key extraction covered)
so the scheduling win of the dedup grid preference is attributable.

Every dispatch — including a single-block workload — runs on the pool, so
exception provenance and thread-local device state are independent of the
partition count (a single-partition frame used to run inline on the caller
thread while a two-partition frame ran on pool workers).  The only inline
path left is the nested-dispatch guard: a call *from* a pool worker runs its
blocks in place rather than deadlocking on its own pool.

3. **Residency-aware ordering** — when the block store (``core.store``) is
   budget-governed, some of a dispatch's blocks may be spilled to disk.
   :func:`dispatch_blocks` orders the pool tasks so chunks of *resident*
   blocks run first: their compute overlaps the disk faults of the spilled
   tail (which happen inside the worker task that needs the block, never on
   the caller thread).  Results are scattered back to block order, so the
   reordering is invisible — bit-identical by the same per-block-independence
   argument as coalescing.

Environment knobs (the one table — referenced from ROADMAP.md)
--------------------------------------------------------------
=========================  ==================================================
``REPRO_POOL_WORKERS``     worker threads in the shared pool; also the width
                           all grid-sizing decisions consult (default: CPU
                           count)
``REPRO_COALESCE``         ``0`` disables coalescing — one pool task per
                           block, the pre-scheduling behavior (benchmark
                           baseline)
``REPRO_COALESCE_FACTOR``  pool tasks per worker when coalescing (default 2:
                           a little slack so an unlucky chunk can't serialize
                           the whole stage behind one worker)
``REPRO_ADAPT_GRID``       ``0`` disables plan-time grid adaptation —
                           blocking operators keep the incoming row grid no
                           matter how far it oversubscribes the pool
``REPRO_JIT_UDFS``         ``0`` runs map and predicate runs eagerly, any
                           other value as compiled programs (``torch.compile``
                           on inductor, probed bit for bit against eager on a
                           chain's first block); unset: compiled on a CUDA
                           block, eager on a CPU block
                           (``physical._jit_udfs_enabled``)
``REPRO_BLOCK_DEDUP``      ``0`` routes DIFFERENCE / DROP-DUPLICATES through
                           the serial whole-frame seed path (baseline /
                           equivalence oracle; ``physical``)
``REPRO_SHUFFLE``          ``0`` routes JOIN / SORT through the serial
                           whole-frame seed path instead of the grace-hash /
                           sample-sort exchange (baseline / bit-identity
                           oracle; ``core.shuffle``)
``REPRO_SHUFFLE_BUCKETS``  pins the exchange bucket count (default 0 = auto:
                           pool width × coalesce factor, raised so one
                           bucket's key frame fits ``budget_max_block_bytes``
                           under ``REPRO_MEM_BUDGET``)
``REPRO_SHUFFLE_SKEW_FACTOR`` a bucket holding more than this × the mean
                           bucket rows splits into part-tasks instead of
                           OOMing one worker (default 4; counted in
                           ``ExecStats.skew_splits``)
``REPRO_MEM_BUDGET``       byte budget for resident partition blocks +
                           cached sub-plan results (``core.store``); ``0``
                           (default) = unlimited, fully-resident fast path.
                           Over budget, blocks spill to disk and fault back
                           on demand
``REPRO_SPILL_DIR``        ``os.pathsep``-separated *failover list* of
                           directories under which the block store creates
                           its spill directories (default: the system
                           tempdir).  A spill write that fails with OSError
                           (ENOSPC, read-only mount) fails over to the next
                           entry; when every entry is exhausted the victim
                           stays resident and ``budget_overruns`` is counted
``REPRO_CSV_STREAM``       ``0`` routes ``api.read_csv`` through the serial
                           seed parser (baseline / equivalence oracle)
``REPRO_CSV_CHUNK_BYTES``  target byte size of a streaming-ingest CSV chunk
                           (default: sized from pool width and mem budget)
``REPRO_TASK_RETRIES``     bounded retries per block task for *transient*
                           failures — injected worker faults, OSError,
                           TimeoutError, ConnectionError (default 2; ``0``
                           disables the retry machinery entirely).
                           Deterministic errors (ValueError, ...) are never
                           retried and propagate unchanged
``REPRO_RETRY_BACKOFF_MS`` base backoff between retry attempts, doubling per
                           attempt (default 5)
``REPRO_TASK_TIMEOUT_MS``  per-dispatch deadline; a dispatch that blows it
                           raises ``TaskError`` with ``kind="timeout"``
                           (default 0 = no deadline)
``REPRO_FAULT_PLAN``       deterministic fault-injection plan (``core.faults``):
                           comma-separated ``kind[@addr_substr]:rate[!]``
                           rules, kinds ``worker`` / ``slow`` / ``corrupt`` /
                           ``missing`` / ``enospc``; ``!`` = sticky (fires on
                           retries / lineage-less reads too).  Empty
                           (default) = no injection, zero overhead
``REPRO_FAULT_SEED``       seed for the plan's per-address uniform draws
                           (default 0; same plan + seed + address ⇒ same
                           decision)
``REPRO_FAULT_SLOW_MS``    sleep injected by a ``slow`` fault rule
                           (default 25)
``REPRO_MAX_INFLIGHT``     per-session bound on concurrently *admitted*
                           async statements under a ``core.service``
                           ``QueryService`` (default 2); excess submissions
                           queue in the admission controller
                           (FIFO-with-aging) until a slot frees
``REPRO_TRACE``            statement tracing (``core.trace``): ``1`` records
                           per-statement span trees (plan prep → node eval →
                           dispatch → pool chunk → spill/fault/backoff) into
                           a bounded process-wide ring; a *path* value also
                           exports Chrome trace-event JSON there at process
                           exit (open in Perfetto).  Default off — the
                           disabled path allocates no spans (its cost a
                           site is in ``PERF.md``)
``REPRO_TRACE_RING``       finished-span ring capacity per tracer (default
                           65536; the oldest spans fall off the back)
=========================  ==================================================

Session-scoped override semantics (``core.config``): every knob in the
store / retry / fault / shuffle groups above can also be set per ``Session``
(``Session(task_retries=..., fault_plan=..., mem_budget_bytes=...)``).  Those
values live in a ``config.SessionConfig`` carried in a contextvar that the
session installs around each statement and this module propagates into pool
workers — they shadow the process-wide ``configure*()`` overrides and the
``REPRO_*`` env values *inside that session only*.  Resolution order for
every knob: active session config → process ``configure()`` override →
``REPRO_*`` env → default.  Env knobs therefore remain process defaults; a
second session can no longer clobber the first session's configuration.

Failure semantics: a dispatched statement either completes **bit-identical**
to the fault-free run (transient failures retried with exponential backoff;
a failed coalesced chunk split and retried per block, isolating one poison
block) or raises ONE typed ``faults.TaskError`` carrying full provenance —
plan node, block index, attempt count, and the underlying cause.
"""
from __future__ import annotations

import concurrent.futures as _fut
import contextvars
import os
import threading
import time
from typing import Callable, Sequence

from . import config as _config
from . import faults as _faults
from . import trace as _trace
from .faults import StatementCancelled, TaskError, env_int, is_retryable

__all__ = [
    "get_pool", "pool_width", "reset_pool", "dispatch_blocks",
    "coalesce_factor", "preferred_row_parts", "output_row_parts",
    "budget_max_block_bytes", "stats_scope", "node_scope", "GRID_PREFS",
    "task_retries", "retry_backoff_ms", "task_timeout_ms", "max_inflight",
    "configure_retries",
]

# Per-operator grid preferences (paper §4.2: the partitioning scheme is
# chosen per operation).  ``rewrite.fuse_pipelines`` records these on
# barrier-fused plan nodes and the physical layer resolves them — for both
# fused and unfused paths, so the two always agree on seam placement — via
# :func:`preferred_row_parts`:
#   * GROUPBY partial-aggregation programs want blocks ≈ workers (fewer
#     per-block programs to dispatch and fewer partials to combine);
#   * WINDOW carry chains want fewer seams (every partition boundary costs a
#     carry composition);
#   * DIFFERENCE / DROP-DUPLICATES key extraction wants blocks ≈ workers —
#     each worker builds a couple of per-block key matrices and the joint
#     host factorization concatenates that many pieces instead of hundreds;
#   * JOIN / SORT (``core.shuffle``) bucketize per block, so the same
#     blocks ≈ workers preference bounds both the exchange fan-out and the
#     number of per-block key frames a bucket concat touches.
GRID_PREFS: dict[str, str] = {
    "fused_groupby": "workers",
    "groupby": "workers",
    "fused_window": "few_seams",
    "window": "few_seams",
    "fused_difference": "workers",
    "difference": "workers",
    "fused_drop_duplicates": "workers",
    "drop_duplicates": "workers",
    "fused_join": "workers",
    "join": "workers",
    "fused_sort": "workers",
    "sort": "workers",
}

# Pool workers are named with this prefix; the nested-dispatch guard keys on
# it.  Distinct from the executor's background pool ("repro-bg"), whose
# threads legitimately dispatch block work here.
_WORKER_PREFIX = "repro-pool"

_POOL: _fut.ThreadPoolExecutor | None = None
_POOL_WIDTH: int | None = None
_POOL_LOCK = threading.Lock()


def pool_width() -> int:
    """The configured pool parallelism — the width every grid-sizing decision
    consults.  Once the pool exists this is its actual worker count; before
    that, the width the pool *would* be built with (``REPRO_POOL_WORKERS``,
    else CPU count)."""
    if _POOL_WIDTH is not None:
        return _POOL_WIDTH
    return max(1, int(os.environ.get("REPRO_POOL_WORKERS",
                                     str(os.cpu_count() or 4))))


def get_pool() -> _fut.ThreadPoolExecutor:
    global _POOL, _POOL_WIDTH
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                width = pool_width()
                _POOL = _fut.ThreadPoolExecutor(
                    max_workers=width, thread_name_prefix=_WORKER_PREFIX)
                _POOL_WIDTH = width
    return _POOL


def reset_pool() -> None:
    """Drop the shared pool so the next use rebuilds it from the current
    environment (tests that change ``REPRO_POOL_WORKERS``).  In-flight tasks
    finish on the old pool's threads."""
    global _POOL, _POOL_WIDTH
    with _POOL_LOCK:
        if _POOL is not None:
            _POOL.shutdown(wait=False)
        _POOL = None
        _POOL_WIDTH = None


def coalesce_factor() -> int:
    return env_int("REPRO_COALESCE_FACTOR", 2, minimum=1)


# ---------------------------------------------------------------------------
# retry / deadline policy (fault tolerance)
# ---------------------------------------------------------------------------
_RETRIES_OVERRIDE: int | None = None
_BACKOFF_OVERRIDE: int | None = None
_TIMEOUT_OVERRIDE: int | None = None


def task_retries() -> int:
    """Bounded retries per block task for transient failures (injected
    worker faults, OSError, TimeoutError, ConnectionError).  0 disables.
    Session-scoped resolution: active ``SessionConfig`` → process override →
    ``REPRO_TASK_RETRIES``."""
    cfg = _config.current()
    if cfg is not None and cfg.task_retries is not None:
        return max(0, cfg.task_retries)
    if _RETRIES_OVERRIDE is not None:
        return _RETRIES_OVERRIDE
    return env_int("REPRO_TASK_RETRIES", 2, minimum=0)


def retry_backoff_ms() -> int:
    """Base backoff between retry attempts; doubles per attempt."""
    cfg = _config.current()
    if cfg is not None and cfg.retry_backoff_ms is not None:
        return max(0, cfg.retry_backoff_ms)
    if _BACKOFF_OVERRIDE is not None:
        return _BACKOFF_OVERRIDE
    return env_int("REPRO_RETRY_BACKOFF_MS", 5, minimum=0)


def task_timeout_ms() -> int:
    """Per-dispatch deadline (0 = none).  A dispatch that blows it raises
    ``TaskError`` with ``kind="timeout"``."""
    cfg = _config.current()
    if cfg is not None and cfg.task_timeout_ms is not None:
        return max(0, cfg.task_timeout_ms)
    if _TIMEOUT_OVERRIDE is not None:
        return _TIMEOUT_OVERRIDE
    return env_int("REPRO_TASK_TIMEOUT_MS", 0, minimum=0)


def max_inflight() -> int:
    """Per-session bound on concurrently *admitted* async statements under a
    ``core.service.QueryService`` (excess submissions queue in the admission
    controller until a slot frees).  Session-scoped resolution: active
    ``SessionConfig`` → ``REPRO_MAX_INFLIGHT`` (default 2)."""
    cfg = _config.current()
    if cfg is not None and cfg.max_inflight is not None:
        return max(1, cfg.max_inflight)
    return env_int("REPRO_MAX_INFLIGHT", 2, minimum=1)


def configure_retries(retries: int | None = None,
                      timeout_ms: int | None = None,
                      backoff_ms: int | None = None,
                      *, clear: bool = False) -> None:
    """Process-wide programmatic override of the retry/deadline env knobs.
    Sticky until ``clear=True``.  ``Session(task_retries=...)`` no longer
    calls this — its values are session-scoped (``config.SessionConfig``)
    and shadow this override only inside that session's statements."""
    global _RETRIES_OVERRIDE, _TIMEOUT_OVERRIDE, _BACKOFF_OVERRIDE
    if clear:
        _RETRIES_OVERRIDE = _TIMEOUT_OVERRIDE = _BACKOFF_OVERRIDE = None
    if retries is not None:
        _RETRIES_OVERRIDE = max(0, int(retries))
    if timeout_ms is not None:
        _TIMEOUT_OVERRIDE = max(0, int(timeout_ms))
    if backoff_ms is not None:
        _BACKOFF_OVERRIDE = max(0, int(backoff_ms))


def _coalesce_enabled() -> bool:
    return os.environ.get("REPRO_COALESCE", "") != "0"


def _adapt_enabled() -> bool:
    return os.environ.get("REPRO_ADAPT_GRID", "") != "0"


def _in_worker() -> bool:
    return threading.current_thread().name.startswith(_WORKER_PREFIX)


# ---------------------------------------------------------------------------
# dispatch-stats attribution: the executor installs its ExecStats for the
# duration of a plan-node evaluation; dispatch_blocks increments whatever is
# installed on the calling thread (contextvars are thread-local, so
# concurrent executors don't cross-attribute).
# ---------------------------------------------------------------------------
_STATS: contextvars.ContextVar = contextvars.ContextVar(
    "repro-sched-stats", default=None)


class stats_scope:
    """Context manager: attribute pool dispatches inside the scope to
    ``stats`` (duck-typed ``ExecStats`` — needs ``dispatches`` and
    ``dispatched_blocks`` int attributes)."""

    def __init__(self, stats):
        self._stats = stats
        self._token = None

    def __enter__(self):
        self._token = _STATS.set(self._stats)
        return self._stats

    def __exit__(self, *exc):
        _STATS.reset(self._token)
        return False


# the plan-node label of the evaluation a dispatch belongs to — provenance
# for TaskError and the fault-injection dispatch addresses.  Installed by
# the executor around each node evaluation (like stats_scope).
_NODE: contextvars.ContextVar = contextvars.ContextVar(
    "repro-sched-node", default=None)


class node_scope:
    """Context manager: label dispatches inside the scope with the plan
    node's operator name (TaskError provenance + fault addresses)."""

    def __init__(self, label: str):
        self._label = label
        self._token = None

    def __enter__(self):
        self._token = _NODE.set(self._label)
        return self._label

    def __exit__(self, *exc):
        _NODE.reset(self._token)
        return False


# retry/failure counters are bumped from pool-worker threads, so the stats
# object can't rely on the single-threaded += the other counters use
_BUMP_LOCK = threading.Lock()


def _bump(st, name: str, d: int = 1) -> None:
    if st is not None and hasattr(st, name):
        with _BUMP_LOCK:
            setattr(st, name, getattr(st, name) + d)


def _check_cancel(cancel, label: str) -> None:
    """Cooperative cancellation check between block tasks (the cancel token
    travels with the dispatch via ``config.propagate``)."""
    if cancel is not None and cancel.cancelled:
        raise StatementCancelled(
            "statement cancelled at a dispatch boundary", node=label)


def _run_one(fn: Callable, x, bi: int, retries: int, backoff_ms: int,
             label: str, st, chaos: bool, cancel=None):
    """One block task under the retry policy: transient failures retry with
    exponential backoff up to ``retries`` times, then surface as TaskError
    with full provenance; deterministic errors propagate unchanged on the
    first attempt."""
    attempt = 0
    while True:
        _check_cancel(cancel, label)
        try:
            if chaos:
                _faults.fault_point(
                    f"dispatch/node={label}/blk={bi}/try={attempt}",
                    attempt=attempt)
            return fn(x)
        except Exception as e:
            if not is_retryable(e):
                raise
            _bump(st, "task_failures")
            if attempt >= retries:
                raise TaskError(
                    "block task failed past the retry budget",
                    node=label, block=bi, attempts=attempt + 1,
                    cause=e) from e
            _bump(st, "retries")
            if backoff_ms > 0:
                delay = backoff_ms * (1 << attempt) / 1000.0
                tr = _trace.live()
                if tr is not None:
                    # the backoff sleep is attributable stall time: record it
                    # as a span so profile() can say how long retries idled
                    with tr.span("backoff", "retry",
                                 args={"node": label, "block": bi,
                                       "attempt": attempt + 1}):
                        time.sleep(delay)
                else:
                    time.sleep(delay)
            attempt += 1


def _chunk_sizes(n: int, tasks: int) -> list[int]:
    tasks = max(1, min(tasks, n))
    base, rem = divmod(n, tasks)
    return [base + (1 if i < rem else 0) for i in range(tasks)]


def _spilled(item) -> bool:
    """True for a dispatch item that is (or carries, under any nesting of
    leading tuple elements) a spilled store block — duck-typed on
    ``is_resident`` so this module needs no store import.  Unwrapping
    nested tuples matters: several dispatch sites pack the handle as
    ``((handle, meta...), extra...)``."""
    while isinstance(item, tuple) and item:
        item = item[0]
    r = getattr(item, "is_resident", None)
    return r is not None and not r


def dispatch_blocks(fn: Callable, blocks: Sequence, stats=None, *,
                    attribute: bool = True) -> list:
    """Run ``fn`` over every block on the shared pool; ordered results.

    The single dispatch entry point for per-block work.  When
    ``len(blocks)`` exceeds ``pool_width() × coalesce_factor()``, contiguous
    blocks are chunked into one pool task each (block coalescing); otherwise
    one task per block.  Either way each block is processed independently in
    block order, so the result is bit-identical to per-block dispatch.

    Residency-aware: when some blocks are store handles that are currently
    spilled, the dispatch *order* moves resident blocks to the front (their
    compute overlaps the spilled blocks' disk faults, which the workers pay
    inside their own tasks); results are scattered back so the caller always
    sees block order.

    ``stats`` (or the executor's installed :class:`stats_scope`) receives
    ``dispatches`` (pool tasks submitted) and ``dispatched_blocks`` (blocks
    they covered) — ``blocks_per_dispatch`` attributes the coalescing win.
    ``attribute=False`` opts a call out of those counters: pool work whose
    items are NOT row blocks (e.g. per-column factorization tasks) would
    otherwise skew the row-block scheduling ratios.

    Fault tolerance: transient failures (injected worker faults, OSError,
    TimeoutError, ConnectionError) retry with exponential backoff up to
    ``REPRO_TASK_RETRIES`` times.  A failed *coalesced* chunk is split and
    retried per block, so one poison block is isolated and reported — with
    plan node, block index, and attempt count — via ``faults.TaskError``.
    Deterministic errors propagate unchanged on the first attempt.  With
    ``REPRO_TASK_TIMEOUT_MS`` set, the whole dispatch runs under a deadline
    and raises ``TaskError(kind="timeout")`` when it blows it.
    """
    items = list(blocks)
    n = len(items)
    if n == 0:
        return []
    st = stats if stats is not None else (_STATS.get() if attribute else None)

    # resident blocks first (stable within each class, so the permutation is
    # deterministic given the residency snapshot); identity when nothing is
    # spilled — the common fully-resident case costs one any() sweep
    perm: list[int] | None = None
    if n > 1 and any(_spilled(x) for x in items):
        perm = sorted(range(n), key=lambda i: _spilled(items[i]))
        items = [items[i] for i in perm]
    idxs: Sequence[int] = perm if perm is not None else range(n)

    target = pool_width() * coalesce_factor()
    if not _coalesce_enabled() or n <= target:
        chunks = [([x], [bi]) for x, bi in zip(items, idxs)]
    else:
        chunks, off = [], 0
        for size in _chunk_sizes(n, target):
            chunks.append((items[off:off + size], list(idxs[off:off + size])))
            off += size
    if st is not None:
        st.dispatches += len(chunks)
        st.dispatched_blocks += n

    retries = task_retries()
    backoff = retry_backoff_ms()
    timeout = task_timeout_ms()
    chaos = _faults.active()
    guarded = chaos or retries > 0
    label = _NODE.get() or "?"
    # session scope travels with the dispatch: the knob accessors above ran
    # on the caller thread (where the session's contextvar config is
    # installed); the per-block fn may consult the store / fault plan from a
    # POOL thread, so the config — and the statement's cancel token — are
    # captured here and re-installed inside every pool task
    cfg = _config.current()
    cancel = _config.current_cancel()
    _check_cancel(cancel, label)
    # tracing (off = None: no span allocation anywhere below).  The dispatch
    # span is begun here on the caller thread and travels to the pool workers
    # via config.propagate, so every chunk span parents to it even though the
    # two run on different threads.
    tr = _trace.live(cfg)
    dsp = None
    if tr is not None:
        # begun and ended on this thread: its profiler range mirrors it
        dsp = tr.begin(f"dispatch:{label}", "dispatch", mirror=True)
        dsp.args = {"blocks": n, "chunks": len(chunks)}

    def chunk_body(chunk, cidx) -> list:
        if not guarded:
            if cancel is None:
                return [fn(x) for x in chunk]
            out = []
            for x in chunk:
                _check_cancel(cancel, label)
                out.append(fn(x))
            return out
        if not chaos:
            # hot path: one try around the plain loop — the per-block
            # retry machinery is only paid when something actually failed
            try:
                out = []
                for x in chunk:
                    _check_cancel(cancel, label)
                    out.append(fn(x))
                return out
            except Exception as e:
                if not is_retryable(e):
                    raise
                _bump(st, "task_failures")
        # chaos run, or a coalesced chunk hit a transient failure: split
        # and run per block so one poison block is isolated (fn is pure,
        # so re-running the chunk's other blocks is bit-identical)
        return [_run_one(fn, x, bi, retries, backoff, label, st, chaos,
                         cancel)
                for x, bi in zip(chunk, cidx)]

    def run_chunk(chunk_and_idxs) -> list:
        chunk, cidx = chunk_and_idxs
        with _config.propagate(cfg, cancel, dsp):
            if tr is None:
                return chunk_body(chunk, cidx)
            with tr.span(f"chunk:{label}", "task",
                         args={"blocks": len(cidx), "first_block": cidx[0]}):
                return chunk_body(chunk, cidx)

    try:
        out = _collect_dispatch(run_chunk, chunks, items, idxs, fn, retries,
                                backoff, timeout, label, st, chaos, guarded,
                                cancel)
    finally:
        if dsp is not None:
            tr.end(dsp)
    if perm is not None:
        restored: list = [None] * n
        for pos, orig in enumerate(perm):
            restored[orig] = out[pos]
        return restored
    return out


def _collect_dispatch(run_chunk, chunks, items, idxs, fn, retries, backoff,
                      timeout, label, st, chaos, guarded, cancel) -> list:
    """The placement half of :func:`dispatch_blocks`: inline (nested from a
    pool worker), deadline, or chunk-by-chunk submission with pool-loss
    recovery and fail-fast sibling drain.  Split out so the dispatch span
    brackets exactly this region."""
    if _in_worker():
        # nested dispatch from a pool worker: run inline — queueing behind
        # ourselves on a saturated pool would deadlock
        if guarded:
            out = [_run_one(fn, x, bi, retries, backoff, label, st, chaos,
                            cancel)
                   for x, bi in zip(items, idxs)]
        else:
            out = []
            for x in items:
                _check_cancel(cancel, label)
                out.append(fn(x))
    elif timeout > 0:
        pool = get_pool()
        deadline = time.monotonic() + timeout / 1000.0
        futs = [pool.submit(run_chunk, c) for c in chunks]
        out = []
        try:
            for fu in futs:
                rem = deadline - time.monotonic()
                try:
                    out.extend(fu.result(timeout=max(rem, 0.0)))
                except (_fut.TimeoutError, TimeoutError):
                    raise TaskError(
                        f"dispatch blew its {timeout}ms deadline",
                        node=label, attempts=1, kind="timeout") from None
        finally:
            for fu in futs:
                fu.cancel()
    else:
        # submit chunk-by-chunk so losing the shared pool mid-dispatch
        # (reset_pool() under an in-flight dispatch — the worker-loss
        # recovery path) is survivable: futures already submitted finish on
        # the old pool's threads; the rest move to the rebuilt pool, and if
        # that one dies too they run on the caller thread.  run_chunk is
        # pure, so any placement is bit-identical.
        pool = get_pool()
        rebuilt = False
        futs: list = []
        for c in chunks:
            fu = None
            while True:
                try:
                    fu = pool.submit(run_chunk, c)
                    break
                except RuntimeError as e:
                    if "shutdown" not in str(e).lower():
                        raise
                    if rebuilt:
                        break           # second loss: run inline below
                    pool = get_pool()   # pool was reset under us
                    rebuilt = True
            futs.append((fu, c))
        out = []
        first_err: BaseException | None = None
        for fu, c in futs:
            if first_err is not None:
                # fail-fast with DETERMINISTIC teardown: a failed chunk must
                # not leave sibling tasks running past this dispatch — their
                # store/fault work would be misattributed to whatever
                # statement (possibly another session's) runs next.  Cancel
                # what hasn't started and drain what has, then raise.
                if fu is not None:
                    fu.cancel()
                    try:
                        fu.result()
                    except BaseException:
                        pass
                continue
            try:
                out.extend(fu.result() if fu is not None else run_chunk(c))
            except BaseException as e:
                first_err = e
        if first_err is not None:
            raise first_err
    return out


# ---------------------------------------------------------------------------
# plan-time grid sizing
# ---------------------------------------------------------------------------
def budget_max_block_bytes() -> int:
    """Largest working block the memory budget tolerates, or 0 when the
    store is unbudgeted.  Sized so that every pool worker can hold one input
    block pinned AND register one output block while the resident set still
    fits the budget: budget // (2·workers + 2), the +2 leaving room for one
    in-flight fault reservation.  This is the out-of-core invariant behind
    ``peak_resident_bytes ≤ budget + one block``."""
    from .store import get_store
    b = get_store().budget
    if b <= 0:
        return 0
    return max(1, b // (2 * pool_width() + 2))


def preferred_row_parts(nblocks: int, prefer: str | None = "workers",
                        total_bytes: int | None = None) -> int:
    """The row grid a blocking operator should work over, given ``nblocks``
    incoming row partitions and its recorded preference:

    * ``"workers"`` (GROUPBY partial programs): blocks ≈ workers ×
      coalesce-factor — each worker gets a couple of per-block programs and
      the combine folds that many partials instead of hundreds;
    * ``"few_seams"`` (WINDOW carry chains): blocks == workers — every seam
      costs a carry composition, so don't make more seams than there are
      workers to hide them behind;
    * ``None``: keep the incoming grid.

    Only *coarsens*, and only when the incoming grid oversubscribes the target
    by more than 2× — mild oversubscription is already absorbed by coalesced
    dispatch, and regrouping copies row segments, which should only be paid
    when it retires many per-block programs.  Fused and unfused paths consult
    the same preference, so plan equivalence is preserved (both sides see the
    same seams).

    ``total_bytes`` (handle metadata — callers pass ``pf.nbytes()``) makes
    the decision budget-aware: under ``REPRO_MEM_BUDGET`` the coarsening
    never builds blocks larger than :func:`budget_max_block_bytes`, so the
    pinned working set of a fully busy pool stays inside the budget and
    blocks remain spillable units.  With the default budget 0 the floor is
    inert and the decision is byte-blind, exactly as before.
    """
    if prefer is None or not _adapt_enabled() or nblocks <= 1:
        return nblocks
    width = pool_width()
    target = width if prefer == "few_seams" else width * coalesce_factor()
    if total_bytes:
        mb = budget_max_block_bytes()
        if mb:
            floor = -(-total_bytes // mb)        # ceil
            if floor > target:
                target = min(nblocks, floor)
    return nblocks if nblocks <= 2 * target else target


def output_row_parts(nrows: int, *, min_block_rows: int = 4096) -> int:
    """Row grid for a blocking operator's *output* (SORT/JOIN/... materialize
    a fresh frame): bounded by the pool width, with the same minimum block
    height as ``partition.default_grid`` so small results stay
    single-partition exactly as before."""
    if not _adapt_enabled():
        return 1
    return max(1, min(pool_width(), nrows // max(1, min_block_rows)))
