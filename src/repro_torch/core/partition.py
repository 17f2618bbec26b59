"""Modin-style block partitioning of a dataframe (paper §4.2).

A ``PartitionedFrame`` is a 2-D grid of ``Frame`` partitions:

    parts[i][j]  — row-block i, column-block j

Row-based partitioning is the special case ``col_parts == 1``; column-based is
``row_parts == 1``; block-based is the general grid.  The partitioning scheme
is chosen *per operation* (paper: "Our current simple approach to partitioning
is to do it on a per-operation basis"), with repartitioning inserted when the
next operator prefers a different scheme.

Execution model mirrors Modin-on-Ray: each partition's work is a block
program of torch operations dispatched onto a shared thread pool (torch
releases the GIL inside its operations; on CUDA every worker launches on the
default stream).  Dispatch goes through the scheduling layer
(``schedule.dispatch_blocks``), which coalesces several blocks into one pool
task when partitions ≫ workers.

The headline trick (paper §4.2 "Supporting billions of columns"): TRANSPOSE is
a *grid* transpose — each block is transposed locally (the block_transpose
kernel on the card), then the grid metadata is swapped.  No global shuffle.

Repartitioning is **zero-copy** where the data layout allows it: scheme
changes re-slice/re-group the existing blocks by metadata instead of
round-tripping through a full ``to_frame()`` concat + re-split.  Column
regrouping never touches data (columns are independent arrays, so merging and
splitting column blocks is pure metadata).  Row regrouping concatenates only
the block *segments* that actually cross a target boundary; a source block
that lands wholly inside one target group is passed through by identity.

Out-of-core residency (the block store, ``core.store``)
-------------------------------------------------------
Every grid cell is a ``store.BlockHandle``: the block's Frame may be resident
or spilled to disk under the ``REPRO_MEM_BUDGET`` byte budget.  All grid
*planning* (row/col sizes, segment maps, pass-through regroup, ``prefix``,
``nbytes``) runs on handle metadata and never faults a spilled block; only
per-block *programs* fault, and they do so inside the pool worker that runs
them (pinned for the duration), so spill I/O overlaps other blocks' compute.
``parts`` stays the compatible Frame-level view: indexing/iterating it
resolves exactly the touched block.  With the default budget 0 the handles
are untracked wrappers and every path below is bit-identical to the
pre-store behaviour.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .frame import Frame
from .schedule import dispatch_blocks, get_pool, pool_width
from .store import BlockHandle, as_handle, pinned, resolve

__all__ = ["PartitionedFrame", "default_grid", "get_pool"]


def _pmap(fn: Callable, items: Sequence) -> list:
    """Parallel map over partitions (ordered results), via the scheduling
    layer's coalesced dispatch (``schedule.dispatch_blocks``).  Single-item
    and multi-item workloads take the same path — every block runs on a pool
    worker — so exception provenance and thread-local device state do not
    depend on the partition count."""
    return dispatch_blocks(fn, items)


def _block_task(fn: Callable[[Frame], Frame]) -> Callable:
    """Lift a Frame→Frame block program to handles: fault + pin the input in
    the worker, run, and register the output with the store as it is
    produced (so a large output is budget-charged immediately and earlier
    outputs can spill while later blocks still compute).  An identity output
    keeps its input handle — no double charge.

    The output handle records ``fn`` over the *input handle* as its
    recompute thunk (lineage): if the output's spill file is later found
    corrupt or missing, the store re-runs the producer instead of crashing.
    The closure keeps the input handle alive — and therefore re-faultable —
    for as long as the output exists."""
    def run(h):
        with pinned(h) as f:
            out = fn(f)
            if out is f and isinstance(h, BlockHandle):
                return h
            return as_handle(out, recompute=lambda: fn(resolve(h)))
    return run


def default_grid(nrows: int, ncols: int, *, min_block_rows: int = 4096,
                 max_row_parts: int | None = None) -> tuple[int, int]:
    """Pick a (row_parts, col_parts) grid for a frame of the given shape.

    Mirrors Modin's default: square-ish grid bounded by the *configured pool
    width* (``schedule.pool_width``, which honors ``REPRO_POOL_WORKERS`` —
    not ``os.cpu_count()``, which would hand a 4-worker pool on a 64-core box
    a 64-row-part grid), with a minimum block height so tiny frames stay
    single-partition.
    """
    cores = max_row_parts or pool_width()
    row_parts = max(1, min(cores, nrows // max(1, min_block_rows)))
    col_parts = 1 if ncols < 64 else min(4, max(1, ncols // 64))
    return row_parts, col_parts


def _split_sizes(n: int, parts: int) -> list[int]:
    parts = max(1, min(parts, n)) if n > 0 else 1
    base, rem = divmod(n, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def _segments(src_sizes: list[int], tgt_sizes: list[int]) -> list[list[tuple[int, int, int]]]:
    """Map a source block layout onto a target layout: for each target group,
    the covering ``(src_block, lo, hi)`` half-open local ranges.  A segment
    spanning a whole source block signals an identity pass-through."""
    out: list[list[tuple[int, int, int]]] = []
    bi, off = 0, 0
    for t in tgt_sizes:
        need, segs = t, []
        while need > 0 and bi < len(src_sizes):
            avail = src_sizes[bi] - off
            if avail == 0:
                bi += 1
                off = 0
                continue
            take = min(need, avail)
            segs.append((bi, off, off + take))
            off += take
            need -= take
            if off == src_sizes[bi]:
                bi += 1
                off = 0
        out.append(segs)
    return out


class _RowView(Sequence):
    """One grid row as Frames: indexing/iterating resolves (faults) exactly
    the touched cells.  The handles stay the source of truth."""

    __slots__ = ("_hs",)

    def __init__(self, handles: list):
        self._hs = handles

    def __len__(self) -> int:
        return len(self._hs)

    def __getitem__(self, j):
        if isinstance(j, slice):
            return [resolve(h) for h in self._hs[j]]
        return resolve(self._hs[j])

    def __iter__(self):
        return (resolve(h) for h in self._hs)


class _PartsView(Sequence):
    """The grid as rows of ``_RowView``.  Supports the historical access
    patterns (``pf.parts[i][j]``, iteration) while resolving only the
    blocks actually touched; grid-level algebra (union, regroup) runs on
    ``pf.handles`` instead."""

    __slots__ = ("_rows",)

    def __init__(self, rows: list[list]):
        self._rows = rows

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [_RowView(r) for r in self._rows[i]]
        return _RowView(self._rows[i])

    def __iter__(self):
        return (_RowView(r) for r in self._rows)


def _cell_handles(row) -> list:
    if isinstance(row, _RowView):
        return list(row._hs)
    return [as_handle(c) for c in row]


class PartitionedFrame:
    """A grid of Frame partitions (behind store block handles) with global
    row/col split metadata."""

    def __init__(self, parts):
        if isinstance(parts, _PartsView):
            grid = [list(r) for r in parts._rows]
        else:
            grid = [_cell_handles(row) for row in parts]
        assert grid and grid[0], "grid must be non-empty"
        width = len(grid[0])
        assert all(len(row) == width for row in grid)
        self.handles: list[list[BlockHandle]] = grid

    # ------------------------------------------------------------------
    @property
    def parts(self) -> _PartsView:
        return _PartsView(self.handles)

    @property
    def row_parts(self) -> int:
        return len(self.handles)

    @property
    def col_parts(self) -> int:
        return len(self.handles[0])

    @property
    def row_sizes(self) -> list[int]:
        return [self.handles[i][0].nrows for i in range(self.row_parts)]

    @property
    def col_sizes(self) -> list[int]:
        return [self.handles[0][j].ncols for j in range(self.col_parts)]

    @property
    def nrows(self) -> int:
        return sum(self.row_sizes)

    @property
    def ncols(self) -> int:
        return sum(self.col_sizes)

    # ------------------------------------------------------------------
    # conversion
    # ------------------------------------------------------------------
    @staticmethod
    def from_frame(frame: Frame, row_parts: int = 1, col_parts: int = 1,
                   device=None) -> "PartitionedFrame":
        """``frame`` cut into a grid of blocks, each put into the store as it
        is cut; with ``device``, each block is copied there first, so a frame
        on the host reaches the device (and its budget) one block at a
        time."""
        row_sz = _split_sizes(frame.nrows, row_parts)
        col_sz = _split_sizes(frame.ncols, col_parts)
        grid: list[list[BlockHandle]] = []
        r0 = 0
        for rs in row_sz:
            row_block = frame.take_rows(np.arange(r0, r0 + rs))
            r0 += rs
            row_cells: list[BlockHandle] = []
            c0 = 0
            for cs in col_sz:
                cell = row_block.take_cols(range(c0, c0 + cs))
                row_cells.append(as_handle(cell if device is None else cell.to(device)))
                c0 += cs
            grid.append(row_cells)
        return PartitionedFrame(grid)

    def to_frame(self) -> Frame:
        rows = []
        for i in range(self.row_parts):
            block = resolve(self.handles[i][0])
            for j in range(1, self.col_parts):
                block = block.concat_cols(resolve(self.handles[i][j]))
            rows.append(block)
        out = rows[0]
        for block in rows[1:]:
            out = out.concat_rows(block)
        return out

    # ------------------------------------------------------------------
    # partition-wise application
    # ------------------------------------------------------------------
    def map_blockwise(self, fn: Callable[[Frame], Frame]) -> "PartitionedFrame":
        """Apply ``fn`` to every block in parallel (embarrassingly parallel
        operators: MAP, SELECTION with per-row predicates, RENAME...).
        Spilled inputs fault inside the worker task; outputs register with
        the store as they are produced."""
        flat = [h for row in self.handles for h in row]
        out = _pmap(_block_task(fn), flat)
        w = self.col_parts
        return PartitionedFrame([out[i * w:(i + 1) * w] for i in range(self.row_parts)])

    def map_row_blocks(self, fn: Callable[[Frame], Frame]) -> "PartitionedFrame":
        """Apply ``fn`` to each *full-width* row block (row partitioning)."""
        pf = self.repartition(col_parts=1)
        out = _pmap(_block_task(fn), [row[0] for row in pf.handles])
        return PartitionedFrame([[f] for f in out])

    def map_col_blocks(self, fn: Callable[[Frame], Frame]) -> "PartitionedFrame":
        """Apply ``fn`` to each *full-height* column block (column partitioning)."""
        pf = self.repartition(row_parts=1)
        out = _pmap(_block_task(fn), pf.handles[0])
        return PartitionedFrame([out])

    # ------------------------------------------------------------------
    # repartitioning (the paper's scheme changes between operators)
    # ------------------------------------------------------------------
    def repartition(self, row_parts: int | None = None, col_parts: int | None = None) -> "PartitionedFrame":
        """Change the grid scheme without a full-frame materialization.

        Column regrouping is pure metadata (zero-copy); row regrouping copies
        only the segments that cross target-group boundaries and forwards
        boundary-aligned blocks by identity — as *handles*, so a spilled
        block that passes through untouched is never faulted.  Never calls
        ``to_frame()``.
        """
        rp = row_parts if row_parts is not None else self.row_parts
        cp = col_parts if col_parts is not None else self.col_parts
        out = self
        if cp != out.col_parts:
            out = out._regroup_cols(cp)
        if rp != out.row_parts:
            out = out._regroup_rows(rp)
        return out

    def _regroup_cols(self, col_parts: int) -> "PartitionedFrame":
        """Re-split column blocks per row stripe.  Zero-copy: ``concat_cols``
        merges column lists and ``take_cols`` picks column objects — no device
        array is touched.  Whole-block segments forward the handle."""
        tgt = _split_sizes(self.ncols, col_parts)
        segs = _segments(self.col_sizes, tgt)
        grid: list[list] = []
        for stripe in self.handles:
            row: list = []
            for seglist in segs:
                if (len(seglist) == 1 and seglist[0][1] == 0
                        and seglist[0][2] == stripe[seglist[0][0]].ncols):
                    row.append(stripe[seglist[0][0]])   # identity: the handle
                    continue
                pieces = []
                for (bj, lo, hi) in seglist:
                    blk = resolve(stripe[bj])
                    pieces.append(blk if (lo == 0 and hi == blk.ncols)
                                  else blk.take_cols(range(lo, hi)))
                if not pieces:
                    cell = resolve(stripe[0]).take_cols([])
                else:
                    cell = pieces[0]
                    for p in pieces[1:]:
                        cell = cell.concat_cols(p)
                row.append(cell)
            grid.append(row)
        return PartitionedFrame(grid)

    def _regroup_rows(self, row_parts: int) -> "PartitionedFrame":
        """Re-split row blocks per column block.  Segments that cover a whole
        source block pass through by identity (the *handle* — untouched
        spilled blocks stay spilled); partial segments slice only their own
        rows; merged groups concatenate only their own segments — no
        full-frame concat ever happens.  Each new cell goes into the store
        as it is made, so under a budget the regrouped blocks are charged
        (and spill) one at a time instead of all standing on the device
        before the first is charged."""
        tgt = _split_sizes(self.nrows, row_parts)
        segs = _segments(self.row_sizes, tgt)
        grid: list[list] = []
        for seglist in segs:
            row: list = []
            for j in range(self.col_parts):
                if (len(seglist) == 1 and seglist[0][1] == 0
                        and seglist[0][2] == self.handles[seglist[0][0]][j].nrows):
                    row.append(self.handles[seglist[0][0]][j])
                    continue
                pieces = []
                for (bi, lo, hi) in seglist:
                    blk = resolve(self.handles[bi][j])
                    pieces.append(blk if (lo == 0 and hi == blk.nrows)
                                  else blk.take_rows(np.arange(lo, hi)))
                if not pieces:
                    cell = resolve(self.handles[0][j]).take_rows(np.arange(0))
                else:
                    cell = pieces[0]
                    for p in pieces[1:]:
                        cell = cell.concat_rows(p)
                del pieces
                row.append(as_handle(cell))
            grid.append(row)
        return PartitionedFrame(grid)

    # ------------------------------------------------------------------
    # grid transpose (metadata swap; per-block op supplied by caller)
    # ------------------------------------------------------------------
    def transpose_grid(self, block_transpose: Callable[[Frame], Frame]) -> "PartitionedFrame":
        flat = [self.handles[i][j] for j in range(self.col_parts)
                for i in range(self.row_parts)]
        out = _pmap(_block_task(block_transpose), flat)
        grid = []
        k = 0
        for _ in range(self.col_parts):
            row = []
            for _ in range(self.row_parts):
                row.append(out[k])
                k += 1
            grid.append(row)
        return PartitionedFrame(grid)

    # ------------------------------------------------------------------
    def row_block_offsets(self) -> list[int]:
        offs = [0]
        for s in self.row_sizes:
            offs.append(offs[-1] + s)
        return offs

    def row_handles(self) -> list:
        """The row-block handles of a single-col-part frame, in row order —
        metadata only, nothing faulted.  The exchange layer
        (``core.shuffle``) and the dedup key extraction iterate these to
        stage per-block work without ever concatenating the frame."""
        if self.col_parts != 1:
            raise ValueError("row_handles requires col_parts == 1 "
                             f"(have {self.col_parts})")
        return [row[0] for row in self.handles]

    def prefix(self, k: int) -> "PartitionedFrame":
        """First row blocks covering ≥ k rows (prefix computation, §6.1.2).
        Metadata-only: untouched suffix blocks are never faulted."""
        need, keep = k, []
        for i in range(self.row_parts):
            keep.append(self.handles[i])
            need -= self.handles[i][0].nrows
            if need <= 0:
                break
        return PartitionedFrame(keep)

    def nbytes(self) -> int:
        """Payload bytes across all blocks — handle metadata, so cache
        accounting never faults a spilled block."""
        return sum(h.nbytes for row in self.handles for h in row)

    def __repr__(self) -> str:
        return f"PartitionedFrame[{self.nrows}x{self.ncols}; grid {self.row_parts}x{self.col_parts}]"
