"""Block handles: the untracked, budget-0 path of the block store.

Every partition block of a ``PartitionedFrame`` lives behind a
:class:`BlockHandle`.  This port carries only the fully resident path: a
handle wraps its Frame with no locking, no accounting and no spill machinery.
A memory budget (``REPRO_MEM_BUDGET`` above 0, or a session budget) raises
``NotImplementedError``: spilling device blocks (device → host → disk) is
ROADMAP item M8, and a budget is never silently ignored.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator

from . import config as _config
from .faults import env_int
from .frame import Frame

__all__ = ["BlockHandle", "BlockStore", "StoreStats", "get_store",
           "reset_store", "as_handle", "resolve", "pinned"]


class StoreStats:
    """The store counters the executor snapshots around every plan node.
    Without spilling they stay 0."""

    __slots__ = ("spills", "faults", "spilled_bytes", "faulted_bytes",
                 "resident_bytes", "peak_resident_bytes",
                 "checksum_failures", "recomputed_blocks",
                 "budget_overruns", "leaked_spill_files")

    def __init__(self):
        for name in self.__slots__:
            setattr(self, name, 0)

    def snapshot(self) -> tuple[int, int, int, int, int, int, int]:
        return (self.spills, self.faults, self.spilled_bytes,
                self.peak_resident_bytes, self.checksum_failures,
                self.recomputed_blocks, self.budget_overruns)


class BlockHandle:
    """One partition block, always resident.  Metadata (``nrows`` /
    ``ncols`` / ``nbytes``) matches the reference's handle."""

    __slots__ = ("_frame", "_nbytes", "nrows", "ncols", "benefit",
                 "_recompute")

    def __init__(self, frame: Frame,
                 recompute: "Callable[[], Frame] | None" = None):
        self._frame = frame
        self._nbytes: int | None = None
        self.nrows = frame.nrows
        self.ncols = frame.ncols
        self.benefit = 0.0
        # lineage hook, recorded for the spilling store of M8
        self._recompute = recompute

    @property
    def nbytes(self) -> int:
        if self._nbytes is None:
            self._nbytes = self._frame.nbytes()
        return self._nbytes

    @property
    def is_resident(self) -> bool:
        return True

    @property
    def is_tracked(self) -> bool:
        return False

    def frame(self) -> Frame:
        return self._frame

    @contextlib.contextmanager
    def pinned(self) -> Iterator[Frame]:
        yield self._frame

    def __repr__(self) -> str:
        return f"BlockHandle[{self.nrows}x{self.ncols}; resident]"


def _budget_unsupported(budget: int) -> NotImplementedError:
    return NotImplementedError(
        f"memory budget {budget} bytes: spilling device blocks is ROADMAP "
        "item M8 and not ported yet (use budget 0)")


class BlockStore:
    """The budget-0 store: ``put`` wraps a frame in a resident handle."""

    def __init__(self, budget_bytes: int = 0, spill_dir: str | None = None):
        self.budget = max(0, int(budget_bytes))
        if self.budget:
            raise _budget_unsupported(self.budget)
        self.stats = StoreStats()

    @property
    def active(self) -> bool:
        return False

    def put(self, frame: Frame, benefit: float = 0.0,
            recompute: "Callable[[], Frame] | None" = None) -> BlockHandle:
        return BlockHandle(frame, recompute)

    def shutdown(self) -> None:
        pass


_STORE: BlockStore | None = None


def get_store() -> BlockStore:
    """The session's store when its ``SessionConfig`` carries one, else the
    process store built from ``REPRO_MEM_BUDGET`` (which must be 0)."""
    cfg = _config.current()
    if cfg is not None and cfg.store is not None:
        return cfg.store
    global _STORE
    budget = env_int("REPRO_MEM_BUDGET", 0, minimum=0)
    if budget:
        raise _budget_unsupported(budget)
    if _STORE is None:
        _STORE = BlockStore()
    return _STORE


def reset_store() -> None:
    """Let the next use rebuild the store from the environment."""
    global _STORE
    _STORE = None


def as_handle(block: "Frame | BlockHandle",
              recompute: "Callable[[], Frame] | None" = None) -> BlockHandle:
    """Wrap a Frame into the store (identity on handles)."""
    if isinstance(block, BlockHandle):
        if recompute is not None and block._recompute is None:
            block._recompute = recompute
        return block
    return get_store().put(block, recompute=recompute)


def resolve(block: "Frame | BlockHandle") -> Frame:
    """The block's Frame (identity on Frames)."""
    if isinstance(block, BlockHandle):
        return block.frame()
    return block


@contextlib.contextmanager
def pinned(block: "Frame | BlockHandle") -> Iterator[Frame]:
    """Pin scope for per-block kernel execution (identity on Frames)."""
    if isinstance(block, BlockHandle):
        with block.pinned() as f:
            yield f
    else:
        yield block
