"""Deterministic fault injection + the typed fault-tolerance error surface.

Production engines treat task failure and storage faults as *expected events*
(Cylon's recoverable task execution; the paper's scalability agenda).  This
module is the chaos half of that contract: seeded, plan-addressable injection
points that the scheduler and the block store consult at every dispatch
boundary and every spill read/write, so robustness is **gated** by a
deterministic differential suite (``tests/test_faults.py``) instead of
claimed.

Injection points and addresses
------------------------------
Every injection point has a stable string *address*:

* ``dispatch/node=<op>/blk=<i>/try=<a>`` — a per-block task about to run on a
  pool worker (``schedule.dispatch_blocks``); can inject a worker exception
  (:class:`InjectedWorkerError`) or a slow task (sleep
  ``REPRO_FAULT_SLOW_MS``).  The shuffle/exchange layer (``core.shuffle``)
  runs each JOIN/SORT round under a suffixed node label —
  ``node=<join|sort|fused_join|fused_sort>:<exchange|local|gather>`` — so a
  plan rule like ``worker@join:exchange:1.0`` targets exactly the exchange
  boundary (bucketization / local kernels / payload gather are independently
  addressable);
* ``spill_write/blk<id>/dir<i>`` — a block about to be spilled; can inject
  ``OSError(ENOSPC)``;
* ``spill_read/blk<id>/<lineage|orphan>`` — a spilled block about to be
  faulted back; can corrupt the spill file (one flipped byte — caught by the
  CRC32 stamp) or delete it.

Fault plans (``REPRO_FAULT_PLAN`` / ``REPRO_FAULT_SEED``)
---------------------------------------------------------
A plan is a comma-separated list of rules::

    kind[@addr_substr]:rate[!]

with ``kind`` ∈ {``worker``, ``slow``, ``corrupt``, ``missing``, ``enospc``},
``rate`` ∈ [0, 1], ``@addr_substr`` restricting the rule to addresses that
contain the substring, and a trailing ``!`` making the rule *sticky*.
Examples::

    worker:0.1                     10% of first-attempt block tasks raise
    worker@blk=2:1.0!              block 2 fails on EVERY attempt (poison)
    corrupt:0.5,enospc:1.0         flip bits in half the recoverable spill
                                   reads; every spill write hits ENOSPC

Decisions are **deterministic**: each (kind, address) pair hashes with the
seed (splitmix64 over an FNV-1a digest) to a uniform draw in [0, 1) — the
same plan + seed + address always decides the same way, with no RNG state
shared between sites.  Non-sticky rules model *transient* faults: ``worker``
/ ``slow`` fire only on attempt 0 (so bounded retry recovers), and
``corrupt`` / ``missing`` fire only on reads of blocks that carry a recorded
producer (so recompute recovers).  Sticky rules (``!``) drop those guards —
the way to exercise the poison-block / unrecoverable-integrity typed-error
paths on purpose.

The shared warn-once env parser
-------------------------------
:func:`env_int` is the one parser for every ``REPRO_*`` integer knob: a
malformed value warns ONCE (per knob, per process) and falls back to the
default instead of silently returning 0 or crashing mid-statement.
"""
from __future__ import annotations

import errno
import os
import threading
import time
import warnings

from . import config as _config

__all__ = [
    "TaskError", "InjectedWorkerError", "SpillIntegrityError",
    "StoreClosedError", "IngestError", "StatementCancelled",
    "ExecutorClosedError", "is_retryable",
    "env_int", "active", "fault_point", "spill_write_fault",
    "spill_read_chaos", "injected_total", "injected_snapshot",
    "configure", "reset", "FaultPlan",
]


# =============================================================================
# typed errors — the "completes or raises ONE typed error" surface
# =============================================================================
class TaskError(RuntimeError):
    """A dispatched block task failed past the retry budget (or a dispatch
    blew its deadline).  Carries full provenance: plan node, block index,
    attempt count, and the underlying cause."""

    def __init__(self, message: str, *, node: str | None = None,
                 block: int | None = None, attempts: int = 0,
                 kind: str = "task", cause: BaseException | None = None):
        self.node = node
        self.block = block
        self.attempts = attempts
        self.kind = kind
        self.cause = cause
        where = f"node={node or '?'}"
        if block is not None:
            where += f", block={block}"
        detail = f" [{kind}; {where}; attempts={attempts}]"
        if cause is not None:
            detail += f" caused by {type(cause).__name__}: {cause}"
        super().__init__(message + detail)


class InjectedWorkerError(RuntimeError):
    """The exception a ``worker`` fault rule raises inside a pool task —
    retryable by definition (it models a transient worker crash)."""


class SpillIntegrityError(RuntimeError):
    """A spill file failed its CRC32 / header verification (or is missing)
    and the block has no recorded producer to recompute from."""


class StoreClosedError(RuntimeError):
    """A spilled block was faulted after ``BlockStore.shutdown()`` — its
    spill file is gone by design.  Names the handle and the shutdown site."""


class IngestError(RuntimeError):
    """``read_csv`` detected that the file changed (truncated or grew)
    between the byte-range planning pass and chunk tokenization."""


class StatementCancelled(RuntimeError):
    """An async statement's :class:`config.CancelToken` was set: the dispatch
    layer stopped at the next block boundary.  Never retried; a waiter joined
    on the cancelled statement's in-flight future re-evaluates instead of
    inheriting the cancellation (``Executor._eval``)."""

    def __init__(self, message: str, *, node: str | None = None):
        self.node = node
        super().__init__(message + (f" [node={node}]" if node else ""))


class ExecutorClosedError(RuntimeError):
    """A statement was submitted to — or was still in flight on — an executor
    that has been shut down (``Session.close`` racing a ``collect``).  The
    typed replacement for the old behavior of abandoning in-flight promise
    futures, which left waiters blocked forever."""


#: Exception classes the dispatch layer treats as transient and retries.
#: Deterministic user errors (ValueError, KeyError, OverflowError, ...)
#: propagate unchanged — retrying them wastes the budget and masks the
#: original type the caller's tests expect.
_RETRYABLE = (InjectedWorkerError, OSError, TimeoutError, ConnectionError)
_NEVER_RETRY = (TaskError, SpillIntegrityError, StoreClosedError, IngestError,
                StatementCancelled, ExecutorClosedError)


def is_retryable(exc: BaseException) -> bool:
    return isinstance(exc, _RETRYABLE) and not isinstance(exc, _NEVER_RETRY)


# =============================================================================
# shared warn-once env parser for REPRO_* integer knobs
# =============================================================================
_WARNED: set[str] = set()
_WARNED_LOCK = threading.Lock()


def env_int(name: str, default: int, *, minimum: int | None = None) -> int:
    """Parse an integer env knob; a malformed value warns ONCE per knob and
    falls back to ``default`` (never a silent 0)."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        v = int(raw)
    except (TypeError, ValueError):
        with _WARNED_LOCK:
            if name not in _WARNED:
                _WARNED.add(name)
                warnings.warn(
                    f"{name}={raw!r} is not an integer; using the default "
                    f"({default})", RuntimeWarning, stacklevel=2)
        return default
    if minimum is not None and v < minimum:
        v = minimum
    return v


# =============================================================================
# deterministic per-address draws
# =============================================================================
_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _draw(seed: int, kind: str, address: str) -> float:
    """Uniform [0, 1) decided purely by (seed, kind, address) — FNV-1a over
    the site name finished with one splitmix64 round."""
    h = 0xCBF29CE484222325
    for b in f"{kind}|{address}".encode():
        h = ((h ^ b) * 0x100000001B3) & _M64
    return _splitmix64(h ^ _splitmix64(seed & _M64)) / 2.0 ** 64


# =============================================================================
# the plan
# =============================================================================
_KINDS = ("worker", "slow", "corrupt", "missing", "enospc")


class _Rule:
    __slots__ = ("kind", "substr", "rate", "sticky")

    def __init__(self, kind: str, substr: str, rate: float, sticky: bool):
        self.kind = kind
        self.substr = substr
        self.rate = rate
        self.sticky = sticky


class FaultPlan:
    """A parsed ``REPRO_FAULT_PLAN`` + seed.  ``match`` is the one decision
    point; it also records the injection in the module counters."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self._rules: dict[str, list[_Rule]] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            head, sep, rate_s = part.rpartition(":")
            if not sep:
                raise ValueError(
                    f"REPRO_FAULT_PLAN rule {part!r}: expected "
                    "kind[@addr_substr]:rate[!]")
            sticky = rate_s.endswith("!")
            if sticky:
                rate_s = rate_s[:-1]
            kind, _, substr = head.partition("@")
            kind = kind.strip()
            if kind not in _KINDS:
                raise ValueError(
                    f"REPRO_FAULT_PLAN rule {part!r}: unknown fault kind "
                    f"{kind!r} (want one of {', '.join(_KINDS)})")
            try:
                rate = float(rate_s)
            except ValueError:
                raise ValueError(
                    f"REPRO_FAULT_PLAN rule {part!r}: rate {rate_s!r} is "
                    "not a float") from None
            self._rules.setdefault(kind, []).append(
                _Rule(kind, substr.strip(), min(max(rate, 0.0), 1.0), sticky))

    def match(self, kind: str, address: str, *, attempt: int = 0,
              recoverable: bool = True) -> bool:
        for r in self._rules.get(kind, ()):
            if r.substr and r.substr not in address:
                continue
            if not r.sticky:
                # transient semantics: retry / recompute can always recover
                if kind in ("worker", "slow") and attempt > 0:
                    continue
                if kind in ("corrupt", "missing") and not recoverable:
                    continue
            if _draw(self.seed, kind, address) < r.rate:
                _record(kind, address)
                return True
        return False


# =============================================================================
# module state: plan resolution, injected-fault counters
# =============================================================================
_LOCK = threading.Lock()
_OVERRIDE_PLAN: str | None = None
_OVERRIDE_SEED: int | None = None
_CACHED: tuple[str, int, FaultPlan] | None = None
_COUNTS: dict[str, int] = {}
_TOTAL = 0


def _record(kind: str, address: str = "") -> None:
    global _TOTAL
    with _LOCK:
        _COUNTS[kind] = _COUNTS.get(kind, 0) + 1
        _TOTAL += 1
    # trace imports this module, so the tracer is resolved lazily — and only
    # on the fault-firing path, which is never the production hot path
    from . import trace as _trace
    tr = _trace.current()
    if tr is not None:
        tr.instant(f"fault:{kind}", "fault", args={"at": address})


def injected_total() -> int:
    """Monotonic count of every injected fault (the executor snapshots this
    around plan-node evaluation → ``ExecStats.faults_injected``)."""
    return _TOTAL


def injected_snapshot() -> dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def active() -> bool:
    """Cheap per-dispatch gate: is ANY fault plan configured?  False is the
    production path — injection costs one contextvar + env lookup and nothing
    else.  Session-scoped resolution: the active :class:`config.SessionConfig`
    wins (``fault_plan=""`` explicitly *shields* a session from a process-wide
    plan), then the programmatic override, then ``REPRO_FAULT_PLAN``."""
    cfg = _config.current()
    if cfg is not None and cfg.fault_plan is not None:
        return bool(cfg.fault_plan)
    return (_OVERRIDE_PLAN is not None
            or bool(os.environ.get("REPRO_FAULT_PLAN")))


def _plan() -> FaultPlan | None:
    global _CACHED
    cfg = _config.current()
    if cfg is not None and cfg.fault_plan is not None:
        if not cfg.fault_plan:
            return None              # "" = injection off for this session
        seed = cfg.fault_seed if cfg.fault_seed is not None else \
            env_int("REPRO_FAULT_SEED", 0)
        p = cfg._plan_cache
        if p is None or p.spec != cfg.fault_plan or p.seed != seed:
            p = cfg._plan_cache = FaultPlan(cfg.fault_plan, seed)
        return p
    raw = _OVERRIDE_PLAN if _OVERRIDE_PLAN is not None else \
        os.environ.get("REPRO_FAULT_PLAN", "")
    if not raw:
        return None
    seed = _OVERRIDE_SEED if _OVERRIDE_SEED is not None else \
        env_int("REPRO_FAULT_SEED", 0)
    cached = _CACHED
    if cached is not None and cached[0] == raw and cached[1] == seed:
        return cached[2]
    plan = FaultPlan(raw, seed)
    _CACHED = (raw, seed, plan)
    return plan


def configure(plan: str | None = None, seed: int | None = None) -> None:
    """Process-wide programmatic override of ``REPRO_FAULT_PLAN`` /
    ``REPRO_FAULT_SEED`` (CI smokes, chaos harnesses).  Sticky until
    :func:`reset`.  ``Session(fault_plan=...)`` no longer calls this — its
    plan is session-scoped via ``config.SessionConfig`` and shadows this
    override only inside that session's statements."""
    global _OVERRIDE_PLAN, _OVERRIDE_SEED
    if plan is not None:
        FaultPlan(plan)          # validate eagerly: fail at configure time
        _OVERRIDE_PLAN = plan
    if seed is not None:
        _OVERRIDE_SEED = int(seed)


def reset() -> None:
    """Clear overrides, the parsed-plan cache, and the injected counters."""
    global _OVERRIDE_PLAN, _OVERRIDE_SEED, _CACHED, _COUNTS, _TOTAL
    with _LOCK:
        _OVERRIDE_PLAN = None
        _OVERRIDE_SEED = None
        _CACHED = None
        _COUNTS = {}
        _TOTAL = 0


# =============================================================================
# the injection points
# =============================================================================
def fault_point(address: str, *, attempt: int = 0) -> None:
    """Dispatch-boundary injection: may sleep (``slow``) and/or raise
    :class:`InjectedWorkerError` (``worker``).  Called by the scheduling
    layer just before a block task's function runs."""
    p = _plan()
    if p is None:
        return
    if p.match("slow", address, attempt=attempt):
        time.sleep(env_int("REPRO_FAULT_SLOW_MS", 25, minimum=0) / 1000.0)
    if p.match("worker", address, attempt=attempt):
        raise InjectedWorkerError(f"injected worker fault at {address}")


def spill_write_fault(address: str) -> None:
    """Spill-write injection: may raise ``OSError(ENOSPC)`` — exercised by
    the store's graceful-degradation path (victim stays resident, budget
    marked overrun, eviction moves on)."""
    p = _plan()
    if p is None:
        return
    if p.match("enospc", address):
        raise OSError(errno.ENOSPC,
                      f"injected ENOSPC (no space left) at {address}")


def spill_read_chaos(path: str, address: str, *, recoverable: bool) -> None:
    """Spill-read injection: may corrupt the on-disk file (one flipped byte
    — the CRC32 stamp catches it) or delete it.  ``recoverable`` says the
    block carries a recompute thunk; non-sticky rules only strike
    recoverable reads so the chaos suite stays completion-guaranteed."""
    p = _plan()
    if p is None:
        return
    if p.match("missing", address, recoverable=recoverable):
        try:
            os.unlink(path)
        except OSError:
            pass
        return
    if p.match("corrupt", address, recoverable=recoverable):
        try:
            with open(path, "r+b") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                if size == 0:
                    return
                f.seek(size // 2)
                b = f.read(1)
                f.seek(size // 2)
                f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        except OSError:
            pass
