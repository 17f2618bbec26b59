"""Session-scoped configuration (the multi-tenancy seam, ROADMAP serving tier).

Before this module, ``Session.__init__`` *mutated process-wide state* to apply
its store / retry / fault / shuffle knobs (``store.configure``,
``schedule.configure_retries``, ``faults.configure``, ``shuffle.configure``) —
so a second concurrent ``Session`` silently clobbered the first session's
configuration: a correctness bug once two tenants share one process.

The fix is a :class:`SessionConfig` carried in a **contextvar**: each session
installs its config around every statement (and the scheduling layer
propagates it into pool-worker and background-executor threads, which have
their own contextvar storage), and the knob *accessors* in ``schedule`` /
``faults`` / ``store`` / ``shuffle`` consult the active config FIRST, falling
back to the process-wide programmatic overrides and then the ``REPRO_*``
environment knobs.  Env knobs therefore stay process defaults; per-session
values never leak across sessions.

Resolution order for every knob::

    active SessionConfig  →  process-wide configure() override  →  REPRO_* env

Cancellation rides the same channel: a :class:`CancelToken` installed via
:func:`propagate` is checked by ``schedule.dispatch_blocks`` between block
tasks, so an async statement can be cancelled at the next dispatch boundary
(raising the typed ``faults.StatementCancelled``).

This module sits below every other ``core`` module (stdlib-only imports), so
``faults`` / ``schedule`` / ``store`` / ``shuffle`` can all consult it without
import cycles.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
from typing import Any, Iterator

__all__ = [
    "SessionConfig", "CancelToken", "current", "current_cancel",
    "current_trace_ctx", "scope", "propagate",
]


@dataclasses.dataclass
class SessionConfig:
    """One session's knob overrides.  ``None`` means "inherit the process
    default" (the programmatic ``configure()`` override if set, else the
    ``REPRO_*`` env knob) — so a knob-less session behaves exactly like the
    single-tenant engine.

    ``store`` is the session's block store when it has a *private* one
    (``Session(mem_budget_bytes=...)``) or the **shared** service store under
    a ``QueryService`` (one byte budget charged across all tenants); ``None``
    routes to the process-wide singleton.

    ``stats`` is the per-session ``ExecStats`` attribution target for
    service-managed sessions sharing one executor: execution windows write
    each counter delta to BOTH the executor's global stats and this object
    (``executor.StatsTee``), so per-session attribution always sums to the
    global counters.
    """

    session_id: str = "s0"
    store: Any | None = None
    task_retries: int | None = None
    task_timeout_ms: int | None = None
    retry_backoff_ms: int | None = None
    fault_plan: str | None = None
    fault_seed: int | None = None
    shuffle_buckets: int | None = None
    shuffle_skew_factor: int | None = None
    stats: Any | None = None
    max_inflight: int | None = None
    # session tracer (trace.Tracer) — None inherits the process default
    # (REPRO_TRACE); False forces tracing off for this session
    trace: Any | None = None
    # compiled FaultPlan cache (faults._plan fills it; never hashed/compared)
    _plan_cache: Any | None = dataclasses.field(
        default=None, repr=False, compare=False)


class CancelToken:
    """Cooperative cancellation grip for one async statement.  Setting it
    makes the next dispatch boundary raise ``faults.StatementCancelled``;
    work already inside a block kernel finishes that block first (kernels
    are pure, so a cancelled statement never leaves partial state)."""

    __slots__ = ("_event",)

    def __init__(self):
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def __repr__(self) -> str:
        return f"CancelToken({'cancelled' if self.cancelled else 'live'})"


_ACTIVE: contextvars.ContextVar[SessionConfig | None] = contextvars.ContextVar(
    "repro-session-config", default=None)
_CANCEL: contextvars.ContextVar[CancelToken | None] = contextvars.ContextVar(
    "repro-cancel-token", default=None)
# current trace span (trace.Span) — the parent for spans opened below it;
# propagate() carries it onto pool-worker threads so chunk spans parent to
# the dispatch span that submitted them
_TRACE_CTX: contextvars.ContextVar[Any | None] = contextvars.ContextVar(
    "repro-trace-ctx", default=None)
_TRACE_UNSET = object()


def current() -> SessionConfig | None:
    """The active session's config on this thread (None = single-tenant /
    process defaults)."""
    return _ACTIVE.get()


def current_cancel() -> CancelToken | None:
    """The active statement's cancellation token on this thread, if any."""
    return _CANCEL.get()


def current_trace_ctx() -> Any | None:
    """The current trace span on this thread (parent for new spans), if
    tracing is active; None otherwise."""
    return _TRACE_CTX.get()


@contextlib.contextmanager
def scope(cfg: SessionConfig | None) -> Iterator[SessionConfig | None]:
    """Install ``cfg`` as the active session config for the duration of a
    statement (``Session`` wraps every public entry point in one of these)."""
    token = _ACTIVE.set(cfg)
    try:
        yield cfg
    finally:
        _ACTIVE.reset(token)


@contextlib.contextmanager
def propagate(cfg: SessionConfig | None,
              cancel: CancelToken | None = None,
              trace: Any | None = None) -> Iterator[None]:
    """Re-install a config (+ cancel token, + parent trace span) captured on
    another thread — the bridge ``schedule.dispatch_blocks`` and
    ``Executor.submit`` use to carry session scope into pool-worker /
    background threads (contextvars are per-thread, so they do not cross
    ``ThreadPoolExecutor.submit``).  ``trace`` is the dispatching side's
    current span: spans the worker opens parent to it, which is how one
    statement's span tree crosses thread boundaries."""
    if cfg is None and cancel is None and trace is None:
        yield
        return
    t_cfg = _ACTIVE.set(cfg)
    t_can = _CANCEL.set(cancel)
    t_trc = _TRACE_CTX.set(trace)
    try:
        yield
    finally:
        _TRACE_CTX.reset(t_trc)
        _CANCEL.reset(t_can)
        _ACTIVE.reset(t_cfg)
