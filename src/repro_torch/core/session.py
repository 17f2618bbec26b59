"""Session model (paper §3.5 Workflow Definitions + §6).

A *session* owns the frame store, the executor (with its reuse cache), the
evaluation mode, and statement bookkeeping.  Statements create plan nodes;
queries are the DAGs those statements compose; the session-level machinery
(§6) — opportunistic scheduling, multi-query sharing, materialization reuse —
lives in the executor and is configured here.

Multi-tenancy (ROADMAP serving tier): a session's store / retry / fault /
shuffle knobs are **session-scoped** — they live in a ``config.SessionConfig``
installed (contextvar) around every statement, never in process-wide state —
so two concurrent sessions with different knobs cannot clobber each other.
The ``REPRO_*`` env knobs and the modules' ``configure()`` functions remain
the *process defaults* a knob-less session inherits.

Async surface (§6.1.1): under OPPORTUNISTIC mode every statement is scheduled
in the background and carries a cancellable :class:`StatementHandle`
(``node.handle``); :meth:`Session.submit` is the explicit async entry point in
any mode.  Cancellation is cooperative — the run stops at the next dispatch
boundary with the typed ``faults.StatementCancelled`` — and a ``collect``
racing a ``close`` raises ``faults.ExecutorClosedError`` instead of hanging.

Sessions can also be *service-managed* (``core.service.QueryService``): the
service owns ONE executor / frame store / byte budget shared by all tenant
sessions, and each tenant session contributes its ``SessionConfig`` (with a
per-session ``ExecStats`` attribution target) instead of owning an executor.
"""
from __future__ import annotations

import concurrent.futures as _fut
import itertools
import threading
from typing import Any

from . import algebra as alg
from . import config as _config
from . import store as block_store
from . import trace as _trace
from .config import CancelToken, SessionConfig
from .dtypes import resolve_device
from .executor import ExecStats, Executor
from .faults import ExecutorClosedError, StatementCancelled
from .frame import Frame
from .partition import PartitionedFrame, default_grid

__all__ = ["Session", "EvalMode", "StatementHandle", "get_session",
           "set_session"]


class EvalMode:
    EAGER = "eager"                  # pandas semantics (paper-faithful baseline)
    LAZY = "lazy"                    # Spark semantics
    OPPORTUNISTIC = "opportunistic"  # §6.1.1 — background compute in think time


class StatementHandle:
    """Grip on one asynchronously submitted statement (§6.1.1 async surface).

    ``cancel()`` requests cooperative cancellation: the background run stops
    at its next dispatch boundary (block kernels are pure, so a cancelled
    statement never leaves partial state — a later re-run is bit-identical).
    ``result()`` joins the run and raises the run's typed error:
    ``faults.StatementCancelled`` after a cancel, ``faults.ExecutorClosedError``
    when the owning session/service was closed while the statement was in
    flight.

    Traced sessions: the handle carries its trace statement id, so
    :meth:`profile` answers *where this statement's wall-clock went* (per-node
    time with counter deltas, dispatch/coalescing ratio, spill/retry/queue
    stalls, cache-hit provenance) once the run is done."""

    __slots__ = ("node", "token", "_future", "stmt_id", "_tracer")

    def __init__(self, node: alg.Node, token: CancelToken,
                 future: _fut.Future, *, stmt: int | None = None,
                 tracer: Any | None = None):
        self.node = node
        self.token = token
        self._future = future
        self.stmt_id = stmt
        self._tracer = tracer

    def profile(self) -> dict | None:
        """Per-statement time attribution (``trace.Tracer.profile``), or
        None when the owning session is untraced."""
        if self._tracer is None or self.stmt_id is None:
            return None
        return self._tracer.profile(self.stmt_id)

    def cancel(self) -> None:
        """Request cancellation (cooperative; a statement that already
        finished is unaffected and its cached result stays valid)."""
        self.token.cancel()

    @property
    def cancelled(self) -> bool:
        return self.token.cancelled

    def done(self) -> bool:
        return self._future.done()

    def result(self, timeout: float | None = None) -> PartitionedFrame:
        try:
            return self._future.result(timeout)
        except _fut.CancelledError:
            # the pool dropped the queued task before it ever started
            # (executor shutdown with cancel_futures=True)
            if self.token.cancelled:
                raise StatementCancelled(
                    "statement cancelled before it started") from None
            raise ExecutorClosedError(
                "executor shut down before this statement started") from None

    def exception(self, timeout: float | None = None) -> BaseException | None:
        try:
            return self._future.exception(timeout)
        except _fut.CancelledError:
            if self.token.cancelled:
                return StatementCancelled("statement cancelled before it started")
            return ExecutorClosedError(
                "executor shut down before this statement started")

    def __repr__(self) -> str:
        state = ("cancelled" if self.token.cancelled
                 else "done" if self._future.done() else "running")
        return f"StatementHandle({self.node.op}, {state})"


_SESSION_IDS = itertools.count()


class Session:
    def __init__(self, *, mode: str = EvalMode.OPPORTUNISTIC,
                 cache_budget_bytes: int = 1 << 30, optimize: bool = True,
                 default_row_parts: int | None = None,
                 mem_budget_bytes: int | None = None,
                 spill_dir: str | None = None,
                 task_retries: int | None = None,
                 task_timeout_ms: int | None = None,
                 retry_backoff_ms: int | None = None,
                 fault_plan: str | None = None,
                 fault_seed: int | None = None,
                 shuffle_buckets: int | None = None,
                 shuffle_skew_factor: int | None = None,
                 max_inflight: int | None = None,
                 trace: Any = None,
                 device: Any = None,
                 _service: Any | None = None,
                 _executor: Executor | None = None,
                 _frames: dict[str, PartitionedFrame] | None = None,
                 _store: Any | None = None,
                 _session_id: str | None = None):
        # the device every frame this session ingests lands on: CUDA unless
        # the caller passes another (device="cpu"); no GPU → raise
        self.device = resolve_device(device)
        sid = _session_id or f"s{next(_SESSION_IDS)}"
        # every knob is SESSION-scoped: it lives in this config, which is
        # installed (contextvar) around each statement — never written into
        # process-wide state, so concurrent sessions cannot clobber each
        # other.  None fields inherit the process default (programmatic
        # configure() override, else the REPRO_* env knob) — see the table
        # in core/schedule.py.
        self._private_store = None
        store = _store
        if store is None and (mem_budget_bytes is not None
                              or spill_dir is not None):
            # session-PRIVATE out-of-core store: this session's frames and
            # cached sub-plans charge against its own budget and spill into
            # its own directory, torn down on close()
            store = self._private_store = block_store.BlockStore(
                mem_budget_bytes or 0, spill_dir)
        # trace=True builds a session-private tracer (bounded span ring);
        # trace=False pins tracing OFF for this session even under a
        # process-wide REPRO_TRACE; None inherits the process default
        if trace is True:
            trace = _trace.Tracer(session_id=sid)
        self.config = SessionConfig(
            session_id=sid, store=store,
            task_retries=task_retries, task_timeout_ms=task_timeout_ms,
            retry_backoff_ms=retry_backoff_ms,
            fault_plan=fault_plan, fault_seed=fault_seed,
            shuffle_buckets=shuffle_buckets,
            shuffle_skew_factor=shuffle_skew_factor,
            stats=ExecStats() if _executor is not None else None,
            max_inflight=max_inflight, trace=trace)
        self.mode = mode
        self.service = _service
        self._closed = False
        if _executor is not None:
            # service-managed: share the service's executor + frame store
            # (cross-session MQO and one cache); fid prefix keeps tenants'
            # source tables distinct
            self.frames = _frames if _frames is not None else _executor.frames
            self.executor = _executor
            self._fid_prefix = f"{sid}_"
        else:
            self.frames = {}
            self.executor = Executor(self.frames,
                                     cache_budget_bytes=cache_budget_bytes,
                                     optimize=optimize)
            self._fid_prefix = ""
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self.default_row_parts = default_row_parts
        self.statements: list[alg.Node] = []   # session history (§3.5)

    @property
    def stats(self) -> ExecStats:
        """This session's attribution target: the per-session stats under a
        shared service executor, else the owned executor's globals."""
        return self.config.stats or self.executor.stats

    def _require_open(self) -> None:
        if self._closed:
            raise ExecutorClosedError(
                f"session {self.config.session_id} is closed")

    # ------------------------------------------------------------------
    def register_frame(self, frame: Frame | PartitionedFrame,
                       row_parts: int | None = None, col_parts: int = 1) -> alg.Source:
        """Ingest a materialized frame; returns its Source node."""
        self._require_open()
        with _config.scope(self.config):
            if isinstance(frame, Frame):
                rp = row_parts or self.default_row_parts
                if rp is None:
                    rp, col_parts = default_grid(frame.nrows, frame.ncols)
                pf = PartitionedFrame.from_frame(frame, rp, col_parts)
            else:
                pf = frame
            fid = f"{self._fid_prefix}frame_{next(self._ids)}"
            with self._lock:
                self.frames[fid] = pf
            return alg.Source(fid, nrows=pf.nrows, ncols=pf.ncols)

    # ------------------------------------------------------------------
    def statement(self, node: alg.Node) -> alg.Node:
        """Record a statement; under opportunistic mode, schedule it now —
        the background work the user gets for free during think time.  The
        scheduled run is cancellable: the returned node carries a
        :class:`StatementHandle` as ``node.handle``."""
        self._require_open()
        self.statements.append(node)
        with _config.scope(self.config):
            if self.mode == EvalMode.OPPORTUNISTIC:
                node.handle = self._submit_scoped(node)
            elif self.mode == EvalMode.EAGER:
                self.executor.evaluate(node)
            # AFTER preparation: this statement becomes an MQO fusion boundary
            # for *later* plans (§6.2.1), never a barrier against its own
            # fusion
            self.executor.note_statement(node)
        return node

    def submit(self, node: alg.Node) -> StatementHandle:
        """Async statement submission (any mode): schedule ``node`` in the
        background and return its cancellable :class:`StatementHandle`."""
        self._require_open()
        self.statements.append(node)
        with _config.scope(self.config):
            handle = self._submit_scoped(node)
            self.executor.note_statement(node)
        return handle

    def _submit_scoped(self, node: alg.Node) -> StatementHandle:
        if self.service is not None:
            return self.service._submit(self, node)
        token = CancelToken()
        tr = _trace.current()
        stmt = tr.next_stmt() if tr is not None else None
        fut = self.executor.submit(node, cancel=token, stmt=stmt)
        return StatementHandle(node, token, fut, stmt=stmt, tracer=tr)

    def collect(self, node: alg.Node) -> Frame:
        self._require_open()
        with _config.scope(self.config):
            return self.executor.evaluate(node).to_frame()

    def head(self, node: alg.Node, k: int = 5) -> Frame:
        self._require_open()
        with _config.scope(self.config):
            return self.executor.evaluate_prefix(node, k).to_frame().head(k)

    def tail(self, node: alg.Node, k: int = 5) -> Frame:
        self._require_open()
        with _config.scope(self.config):
            return self.executor.evaluate(alg.Limit(node, k, tail=True)).to_frame()

    # ------------------------------------------------------------------
    # observability surfaces (core.trace)
    # ------------------------------------------------------------------
    @property
    def tracer(self) -> Any | None:
        """This session's resolved tracer: its private one
        (``Session(trace=True)``), else the process tracer (``REPRO_TRACE``),
        else None — the same resolution every instrumentation site uses."""
        with _config.scope(self.config):
            return _trace.current()

    def trace_json(self, path: str) -> str | None:
        """Export this session's span ring as Chrome trace-event JSON (open
        in Perfetto / chrome://tracing; pool threads appear as named tracks,
        cross-thread span parentage as flow arrows).  Returns the path, or
        None when the session is untraced."""
        tr = self.tracer
        return tr.export(path) if tr is not None else None

    def explain_stats(self, stmt: int | None = None) -> dict:
        """Where did the time go?  This session's counter totals
        (``ExecStats`` projected through the shared metrics shape) plus — for
        traced sessions — the per-statement profile of ``stmt`` (default:
        the most recent statement): per-node wall time with counter deltas,
        dispatch/coalescing ratio, spill/retry/queue attribution, and
        cache-hit provenance."""
        tr = self.tracer
        out = {
            "session": self.config.session_id,
            "stats": _trace.stats_metrics(
                self.stats, name=self.config.session_id).export(),
            "traced": tr is not None,
        }
        if tr is not None:
            out["statements"] = tr.statements()
            out["profile"] = tr.profile(stmt)
        return out

    def close(self):
        """Tear the session down: in-flight statements FAIL with the typed
        ``faults.ExecutorClosedError`` (they are never silently abandoned),
        the session-private store (if any) drops its spill files, and the
        default-session slot is vacated if this session held it.
        Idempotent."""
        global _DEFAULT
        if self._closed:
            return
        self._closed = True
        if self.service is not None:
            # shared executor/store belong to the service — only detach
            self.service._session_closed(self)
        else:
            self.executor.shutdown()
            self.frames.clear()
        if self._private_store is not None:
            self._private_store.shutdown()
        with _DEFAULT_LOCK:
            if _DEFAULT is self:
                _DEFAULT = None


_DEFAULT: Session | None = None
_DEFAULT_LOCK = threading.Lock()


def get_session(device: Any = None) -> Session:
    """The process default session, created on first use (on ``device``,
    CUDA by default).  Thread-safe (double-checked under a lock) and
    close-aware: a closed default is replaced, never handed out again."""
    global _DEFAULT
    s = _DEFAULT
    if s is not None and not s._closed:
        return s
    with _DEFAULT_LOCK:
        if _DEFAULT is None or _DEFAULT._closed:
            _DEFAULT = Session(device=device)
        return _DEFAULT


def set_session(s: Session) -> Session:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = s
    return s
