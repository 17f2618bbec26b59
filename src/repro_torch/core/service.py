"""Concurrent multi-session query service (ROADMAP serving tier; paper §6).

One :class:`QueryService` hosts many tenant :class:`~.session.Session`\\ s
over **shared** engine state:

* ONE executor — so the materialization cache, the in-flight dedupe table,
  and the statement history (§6.2 multi-query sharing) work *across*
  sessions: two tenants scanning the same shared table share one cache
  entry, and a sub-plan one tenant is computing is joined by another, never
  recomputed;
* ONE frame store — tenant tables are namespaced by a per-session frame-id
  prefix, while :meth:`QueryService.register_frame` publishes shared source
  tables every tenant addresses by the same id (the cross-session MQO seam);
* ONE optional byte budget — a service-level ``BlockStore`` all tenants
  charge against (``mem_budget_bytes``), with per-session attribution of the
  spill/fault work in each session's ``ExecStats`` (``executor.StatsTee``);
* an **admission controller** — async statement submissions are *admitted*
  into the shared background pool under a global slot bound and a
  per-session in-flight cap (``REPRO_MAX_INFLIGHT`` /
  ``Session(max_inflight=...)``), with FIFO-with-aging selection: a session
  with fewer running statements goes first (fairness), and a ticket's
  priority improves as it ages so a busy tenant's backlog cannot starve.

Isolation is config-level, not data-level: each tenant session carries its
own ``config.SessionConfig`` (retry / fault / shuffle knobs, per-session
stats), installed around its statements, so tenants with different knobs
coexist in one process without clobbering each other — the bug the
session-scoped config layer exists to fix.

Every tenant session runs on the service's device (CUDA unless the caller
passes ``device="cpu"``); a budgeted service's store counts the device bytes
of its resident blocks.
"""
from __future__ import annotations

import concurrent.futures as _fut
import itertools
import threading
import time
from typing import Any

from . import algebra as alg
from . import config as _config
from . import schedule as _schedule
from . import store as block_store
from . import trace as _trace
from .config import CancelToken, SessionConfig
from .dtypes import resolve_device
from .executor import ExecStats, Executor
from .faults import ExecutorClosedError, StatementCancelled
from .frame import Frame
from .partition import PartitionedFrame, default_grid
from .session import EvalMode, Session, StatementHandle, _same_device

__all__ = ["QueryService", "AdmissionController"]

# a queued ticket's effective priority improves by one "running statement"
# per this many seconds of waiting — the aging half of FIFO-with-aging
_AGING_S = 0.25


class _Ticket:
    __slots__ = ("seq", "sid", "node", "cfg", "token", "promise", "cap",
                 "enqueued", "admitted", "stmt")

    def __init__(self, seq: int, sid: str, node: alg.Node, cfg: SessionConfig,
                 token: "_TicketToken", promise: _fut.Future, cap: int,
                 stmt: int | None = None):
        self.seq = seq
        self.sid = sid
        self.node = node
        self.cfg = cfg
        self.token = token
        self.promise = promise
        self.cap = cap
        self.enqueued = time.monotonic()
        self.admitted = self.enqueued
        # trace statement id, allocated at submission so the queue-wait span,
        # the plan-prep span, and the statement span share one tree
        self.stmt = stmt


class _TicketToken(CancelToken):
    """Cancel token that also pulls its still-queued ticket out of the
    admission queue — a cancelled statement that was never admitted fails
    promptly with ``StatementCancelled`` instead of waiting for a slot."""

    __slots__ = ("_ctl", "_ticket")

    def __init__(self, ctl: "AdmissionController"):
        super().__init__()
        self._ctl = ctl
        self._ticket = None

    def cancel(self) -> None:
        super().cancel()
        t = self._ticket
        if t is not None:
            self._ctl._cancelled(t)


class AdmissionController:
    """Bounded, fair admission of async statements into a shared executor.

    * global bound: at most ``slots`` statements admitted (running) at once —
      matching the executor's background pool width, so admitted work never
      queues invisibly inside the pool;
    * per-session bound: at most ``ticket.cap`` (``schedule.max_inflight()``,
      resolved per session) admitted per tenant;
    * selection: among eligible tickets, minimize
      ``(running[session] - age / 0.25s, seq)`` — FIFO within a session,
      fewest-running-first across sessions, with aging so no eligible ticket
      waits unboundedly behind fresher ones.
    """

    def __init__(self, executor: Executor, slots: int):
        self._executor = executor
        self._slots = max(1, slots)
        self._cond = threading.Condition()
        self._queue: list[_Ticket] = []
        self._running: dict[str, int] = {}
        self._running_total = 0
        self._seq = itertools.count()
        self._closed = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="repro-admit", daemon=True)
        self._thread.start()

    # -- submission ----------------------------------------------------
    def submit(self, session: Session, node: alg.Node) -> StatementHandle:
        """Enqueue a statement for admission; returns its handle at once.
        Runs inside the session's config scope (``Session`` installs it), so
        the per-session cap resolves against that session's knobs."""
        cfg = _config.current() or session.config
        cap = _schedule.max_inflight()
        token = _TicketToken(self)
        promise: _fut.Future = _fut.Future()
        tr = _trace.current(cfg)
        stmt = tr.next_stmt() if tr is not None else None
        t = _Ticket(next(self._seq), session.config.session_id, node, cfg,
                    token, promise, cap, stmt)
        token._ticket = t
        with self._cond:
            if self._closed:
                raise ExecutorClosedError("query service is closed")
            self._queue.append(t)
            self._cond.notify_all()
        return StatementHandle(node, token, promise, stmt=stmt, tracer=tr)

    # -- dispatcher ----------------------------------------------------
    def _pick_locked(self) -> _Ticket | None:
        if self._running_total >= self._slots:
            return None
        eligible = [t for t in self._queue
                    if self._running.get(t.sid, 0) < t.cap]
        if not eligible:
            return None
        now = time.monotonic()
        return min(eligible, key=lambda t: (
            self._running.get(t.sid, 0) - (now - t.enqueued) / _AGING_S,
            t.seq))

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                t = None
                while t is None:
                    if self._closed:
                        return
                    # fail cancelled tickets while they are still queued
                    for c in [q for q in self._queue if q.token.cancelled]:
                        self._queue.remove(c)
                        self._fail(c, StatementCancelled(
                            "statement cancelled while queued for admission"))
                    t = self._pick_locked()
                    if t is None:
                        self._cond.wait(timeout=0.1)
                self._queue.remove(t)
                self._running[t.sid] = self._running.get(t.sid, 0) + 1
                self._running_total += 1
            self._launch(t)

    def _launch(self, t: _Ticket) -> None:
        t.admitted = time.monotonic()
        try:
            with _config.scope(t.cfg):
                self._note_phase(t, "queue_wait",
                                 int((t.admitted - t.enqueued) * 1e9))
                fut = self._executor.submit(t.node, cancel=t.token,
                                            stmt=t.stmt)
        except BaseException as e:
            self._release(t)
            self._fail(t, e)
            return

        def _done(f: _fut.Future, t: _Ticket = t) -> None:
            self._release(t)
            try:
                r = f.result()
            except _fut.CancelledError:
                self._fail(t, StatementCancelled(
                    "statement cancelled before it started")
                    if t.token.cancelled else ExecutorClosedError(
                        "executor shut down before this statement started"))
            except BaseException as e:
                self._fail(t, e)
            else:
                try:
                    t.promise.set_result(r)
                except _fut.InvalidStateError:
                    pass

        fut.add_done_callback(_done)

    @staticmethod
    def _fail(t: _Ticket, err: BaseException) -> None:
        try:
            t.promise.set_exception(err)
        except _fut.InvalidStateError:
            pass    # shutdown / cancel raced us — the promise already failed

    def _note_phase(self, t: _Ticket, name: str, dur_ns: int) -> None:
        """Attribute an admission phase (queue wait / slot hold) to the
        tenant: bump the timing counter through the executor's stats tee
        (global + this session's ``ExecStats``, under the ticket's config
        scope) and, when the session is traced, record a span of the elapsed
        duration — backdated, since the phase just ended."""
        st = self._executor._stats()
        setattr(st, f"{name}_ns", getattr(st, f"{name}_ns") + dur_ns)
        tr = _trace.current()
        if tr is not None:
            sp = tr.begin(name, "service", parent=None, stmt=t.stmt)
            sp.t0 -= dur_ns
            sp.args = {"session": t.sid}
            tr.end(sp)

    def _release(self, t: _Ticket) -> None:
        with _config.scope(t.cfg):
            self._note_phase(t, "slot_hold",
                             int((time.monotonic() - t.admitted) * 1e9))
        with self._cond:
            self._running[t.sid] = self._running.get(t.sid, 1) - 1
            self._running_total -= 1
            self._cond.notify_all()

    # -- cancellation / teardown ---------------------------------------
    def _cancelled(self, t: _Ticket) -> None:
        with self._cond:
            if t in self._queue:
                self._queue.remove(t)
                self._fail(t, StatementCancelled(
                    "statement cancelled while queued for admission"))
            self._cond.notify_all()

    def drop_session(self, sid: str) -> None:
        """Fail every queued ticket of a closing session with the typed
        closed error (admitted statements run to completion — their promises
        resolve normally)."""
        with self._cond:
            for t in [q for q in self._queue if q.sid == sid]:
                self._queue.remove(t)
                self._fail(t, ExecutorClosedError(
                    f"session {sid} closed with statements queued"))
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            queued, self._queue = self._queue, []
            self._cond.notify_all()
        for t in queued:
            self._fail(t, ExecutorClosedError(
                "query service shut down with statements queued"))
        self._thread.join(timeout=2.0)

    def queued(self) -> int:
        with self._cond:
            return len(self._queue)


class QueryService:
    """Multi-tenant query service: shared executor / frame store / byte
    budget, per-session config isolation, admission-controlled async
    statement execution.  See the module docstring."""

    def __init__(self, *, mem_budget_bytes: int | None = None,
                 spill_dir: str | None = None,
                 cache_budget_bytes: int = 1 << 30, optimize: bool = True,
                 background_workers: int = 2,
                 admission_slots: int | None = None,
                 device: Any = None):
        self.device = resolve_device(device)
        self.frames: dict[str, PartitionedFrame] = {}
        self.executor = Executor(self.frames,
                                 cache_budget_bytes=cache_budget_bytes,
                                 optimize=optimize,
                                 background_workers=background_workers)
        self.store = None
        if mem_budget_bytes is not None or spill_dir is not None:
            # ONE budget charged across every tenant (shared-budget
            # multi-tenancy); per-session spill/fault attribution happens in
            # each session's ExecStats via the executor's stats tee
            self.store = block_store.BlockStore(mem_budget_bytes or 0,
                                                spill_dir)
        self.config = SessionConfig(session_id="svc", store=self.store)
        self.admission = AdmissionController(
            self.executor, slots=admission_slots or background_workers)
        self._sessions: dict[str, Session] = {}
        self._sids = itertools.count()
        self._fids = itertools.count()
        self._lock = threading.Lock()
        self._closed = False

    def _require_open(self) -> None:
        if self._closed:
            raise ExecutorClosedError("query service is closed")

    # ------------------------------------------------------------------
    def session(self, *, mode: str = EvalMode.OPPORTUNISTIC,
                default_row_parts: int | None = None,
                task_retries: int | None = None,
                task_timeout_ms: int | None = None,
                retry_backoff_ms: int | None = None,
                fault_plan: str | None = None,
                fault_seed: int | None = None,
                shuffle_buckets: int | None = None,
                shuffle_skew_factor: int | None = None,
                max_inflight: int | None = None,
                trace: Any = None,
                session_id: str | None = None) -> Session:
        """Open a tenant session.  Knobs are session-scoped — they shadow the
        process defaults inside this session's statements only.  ``trace``
        (True, or a ``trace.Tracer``) gives the tenant its own span ring —
        ``Session.trace_json`` / ``explain_stats`` / handle ``profile`` then
        cover exactly that tenant's statements."""
        self._require_open()
        sid = session_id or f"t{next(self._sids)}"
        s = Session(mode=mode, default_row_parts=default_row_parts,
                    task_retries=task_retries, task_timeout_ms=task_timeout_ms,
                    retry_backoff_ms=retry_backoff_ms,
                    fault_plan=fault_plan, fault_seed=fault_seed,
                    shuffle_buckets=shuffle_buckets,
                    shuffle_skew_factor=shuffle_skew_factor,
                    max_inflight=max_inflight, trace=trace,
                    device=self.device,
                    _service=self, _executor=self.executor,
                    _frames=self.frames, _store=self.store, _session_id=sid)
        with self._lock:
            self._sessions[sid] = s
        return s

    def register_frame(self, frame: Frame | PartitionedFrame,
                       row_parts: int | None = None,
                       col_parts: int = 1) -> alg.Source:
        """Publish a SHARED source table: every tenant addresses it by the
        same frame id, so their plans over it share cache keys — the seam
        cross-session MQO (shared cache entries, in-flight joins) runs
        through.  A Frame on another device than the service's lands on
        the service's, one block at a time."""
        self._require_open()
        with _config.scope(self.config):
            if isinstance(frame, Frame):
                if row_parts is None:
                    row_parts, col_parts = default_grid(frame.nrows,
                                                        frame.ncols)
                moved = not _same_device(frame.device, self.device)
                pf = PartitionedFrame.from_frame(
                    frame, row_parts, col_parts,
                    device=self.device if moved else None)
            else:
                pf = frame
            fid = f"shared_{next(self._fids)}"
            with self._lock:
                self.frames[fid] = pf
            return alg.Source(fid, nrows=pf.nrows, ncols=pf.ncols)

    # ------------------------------------------------------------------
    def _submit(self, session: Session, node: alg.Node) -> StatementHandle:
        self._require_open()
        return self.admission.submit(session, node)

    def _session_closed(self, session: Session) -> None:
        sid = session.config.session_id
        self.admission.drop_session(sid)
        prefix = f"{sid}_"
        with self._lock:
            self._sessions.pop(sid, None)
            for fid in [f for f in self.frames if f.startswith(prefix)]:
                self.frames.pop(fid, None)

    # ------------------------------------------------------------------
    @property
    def stats(self) -> ExecStats:
        """Global (cross-tenant) counters; each session's share is in
        ``session.stats`` and the per-session shares sum to these."""
        return self.executor.stats

    def session_stats(self) -> dict[str, ExecStats]:
        with self._lock:
            return {sid: s.stats for sid, s in self._sessions.items()}

    def tenant_report(self) -> list[dict]:
        """Which session is burning the pool: per-tenant timing gauges
        (node wall time, plan prep, admission queue wait, slot hold) plus the
        work counters behind them, sorted by pool pressure (slot hold + node
        wall) descending.  The per-tenant numbers come from each session's
        ``ExecStats`` — the same tee the counter attribution uses — so they
        sum to the service-global stats like every other counter."""
        with self._lock:
            items = list(self._sessions.items())
        rows = []
        for sid, s in items:
            st = s.stats
            rows.append({
                "session": sid,
                "node_wall_ns": st.node_wall_ns,
                "plan_prep_ns": st.plan_prep_ns,
                "queue_wait_ns": st.queue_wait_ns,
                "slot_hold_ns": st.slot_hold_ns,
                "evaluated_nodes": st.evaluated_nodes,
                "dispatches": st.dispatches,
                "dispatched_blocks": st.dispatched_blocks,
                "spills": st.spills,
                "faults": st.faults,
                "retries": st.retries,
            })
        rows.sort(key=lambda r: r["slot_hold_ns"] + r["node_wall_ns"],
                  reverse=True)
        return rows

    def close(self) -> None:
        """Shut the service down: queued admissions and in-flight statements
        fail with the typed ``ExecutorClosedError`` (never a hang), tenant
        sessions close, and the shared store drops its spill files.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        with self._lock:
            sessions = list(self._sessions.values())
        for s in sessions:
            s.close()
        self.admission.close()
        self.executor.shutdown()
        if self.store is not None:
            self.store.shutdown()
        self.frames.clear()

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
