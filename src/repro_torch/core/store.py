"""Out-of-core block store: memory-governed spill/fault residency (§4.2/§6-7).

The paper's scalability agenda asks for dataframe engines that degrade
gracefully past RAM instead of OOM-ing — the property Modin gets from its
partitioned out-of-core layer.  This module is that layer for our engine:
every partition block of a ``PartitionedFrame`` lives behind a
:class:`BlockHandle` with two residency states,

    resident  — the ``Frame``'s tensors are on its device (HBM on the card);
    spilled   — the block's arrays live in an ``.npz`` file under the spill
                directory and the in-memory ``Frame`` reference is dropped.

A spill goes device → host → disk: each tensor comes to the host once
(``.cpu()``) and is written with ``np.savez``; a fault reads the file and
copies each array back onto the device the block came from.  int64 host key
columns (``physical._host_column``) stay numpy arrays both ways.  A tracked
block owns its memory: ``put`` copies a column that views a larger buffer
(a row range of a larger frame), so a spill frees every byte it uncharges.

A byte budget (``REPRO_MEM_BUDGET``; 0 = unlimited) governs residency — on
the card, the device bytes of resident blocks: when
the resident total would exceed the budget, the store evicts the
lowest-value unpinned blocks first — ordered by **benefit density** (the same
cost×hits/bytes score the executor's materialization cache uses, §6.2.2) with
LRU as the tie-break, so cached sub-plan results and live partitions charge
ONE budget under ONE policy (the executor stamps its entries' handles with
their cache benefit; un-cached working blocks default to 0 and evict first).

Pin/unpin ref-counts protect blocks around kernel execution: the scheduling
layer faults blocks *inside pool worker tasks* (overlapping spill I/O with
other blocks' compute — see ``schedule.dispatch_blocks``, which also orders
dispatch to run resident blocks first) and pins them for the duration of the
per-block program, so eviction can never un-account memory that a kernel is
actively reading.

Budget semantics: eviction makes room *before* a fault or put charges its
bytes, so the resident gauge stays ≤ budget + one in-flight block per worker
(the acceptance bound "budget + one block" on a 2-worker pool).  Pinned
blocks are never evicted; if pins alone exceed the budget, the store
overshoots rather than deadlocks.

``REPRO_MEM_BUDGET=0`` (the default) keeps the fully-resident fast path:
``put`` wraps the frame in an untracked handle with no locking, no
accounting, and no spill machinery — bit-identical to pre-store behaviour.

Fault tolerance: every spill file carries a CRC32-stamped header and
is verified on fault; a corrupt or missing file is *recovered* when the block
has a recorded producer (a recompute thunk registered by the partition /
physical layers at every blockwise-map output) and raises a typed
``SpillIntegrityError`` otherwise — never a partially-deserialized frame.
``ENOSPC``/``OSError`` during a spill write degrades gracefully: the write
fails over through the ``REPRO_SPILL_DIR`` directory list (``os.pathsep``
separated), and when every directory is exhausted the victim simply stays
resident, ``budget_overruns`` is counted, and eviction moves to the next
candidate.  Faulting a handle after ``shutdown()`` raises
``StoreClosedError`` naming the handle and the shutdown site.

The shuffle/exchange layer (``core.shuffle``) is a lineage client:
every bucket key frame and gathered output chunk of a JOIN/SORT is registered
here via ``as_handle(frame, recompute=builder)``, so exchange intermediates
spill under the same budget as data blocks and a corrupt/missing spill mid-
exchange recomputes through the recorded builder chain (chunk → bucket →
block key frame → source block) bit-identically.

Lock order: handle lock → store lock, never the reverse.  The spill write
itself holds only the victim's handle lock, so faults of *other* blocks
proceed concurrently with eviction I/O.
"""
from __future__ import annotations

import contextlib
import io
import itertools
import os
import pickle
import shutil
import struct
import tempfile
import threading
import traceback
import weakref
import zlib
from typing import Callable, Iterator

import numpy as np

import torch

from .frame import Column, Frame, host
from .dtypes import Domain
from . import config as _config
from . import faults as _faults
from . import trace as _trace
from .faults import SpillIntegrityError, StoreClosedError, env_int

__all__ = [
    "BlockHandle", "BlockStore", "StoreStats",
    "SpillIntegrityError", "StoreClosedError",
    "get_store", "reset_store", "configure", "unconfigure",
    "as_handle", "resolve", "pinned",
]

_SEQ = itertools.count(1)
_IDS = itertools.count()


class StoreStats:
    """Store-level counters (one instance per store; all mutation under the
    store lock).  ``spills``/``faults`` count block state transitions;
    ``spilled_bytes``/``faulted_bytes`` the payload they moved;
    ``resident_bytes`` is the live gauge and ``peak_resident_bytes`` its
    high-water mark.  The executor snapshots these around every plan-node
    evaluation and attributes the deltas to its ``ExecStats``."""

    __slots__ = ("spills", "faults", "spilled_bytes", "faulted_bytes",
                 "resident_bytes", "peak_resident_bytes",
                 "checksum_failures", "recomputed_blocks",
                 "budget_overruns", "leaked_spill_files")

    def __init__(self):
        self.spills = 0
        self.faults = 0
        self.spilled_bytes = 0
        self.faulted_bytes = 0
        self.resident_bytes = 0
        self.peak_resident_bytes = 0
        # fault-tolerance counters:
        self.checksum_failures = 0   # spill reads that failed CRC32 / were
        #                              missing on disk
        self.recomputed_blocks = 0   # blocks rebuilt from their recorded
        #                              producer after an integrity failure
        self.budget_overruns = 0     # spill writes abandoned (ENOSPC on every
        #                              spill dir) — the victim stayed resident
        self.leaked_spill_files = 0  # finalizer could not unlink a dead
        #                              handle's spill file (was: silent)

    def snapshot(self) -> tuple[int, int, int, int, int, int, int]:
        return (self.spills, self.faults, self.spilled_bytes,
                self.peak_resident_bytes, self.checksum_failures,
                self.recomputed_blocks, self.budget_overruns)


# =============================================================================
# Frame (de)serialization: one .npz per spilled block, prefixed with an
# integrity header:  MAGIC ++ "<IQ"(crc32(payload), len(payload)) ++ payload.
# The fault path verifies the stamp before deserializing, so a flipped bit or
# truncated file surfaces as SpillIntegrityError — never a corrupt frame.
# =============================================================================
_MAGIC = b"RSPL1\n"
_HDR = struct.Struct("<IQ")


def _save_frame(path: str, frame: Frame) -> None:
    """Write a Frame's arrays + metadata to ``path`` (uncompressed npz behind
    the CRC32 header).  Column payloads are stored as plain ``.npy`` members
    (loadable without pickle), each device tensor copied to the host once;
    the small metadata record (domains, dictionaries, labels, the frame's
    device and which arrays were tensors) is pickled into a byte-array
    member."""
    arrays: dict[str, np.ndarray] = {}
    cols_meta = []
    for j, c in enumerate(frame.columns):
        arrays[f"d{j}"] = host(c.data)
        has_mask = c.mask is not None
        if has_mask:
            arrays[f"m{j}"] = host(c.mask)
        cols_meta.append({
            "domain": c.domain.value,
            "dictionary": c.dictionary,
            "tensor_data": isinstance(c.data, torch.Tensor),
            "has_mask": has_mask,
            "tensor_mask": has_mask and isinstance(c.mask, torch.Tensor),
        })
    meta = {"cols": cols_meta, "row_labels": frame.row_labels,
            "col_labels": frame.col_labels, "row_domains": frame.row_domains,
            "device": str(frame.device)}
    arrays["__meta__"] = np.frombuffer(pickle.dumps(meta), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getbuffer()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(_HDR.pack(zlib.crc32(payload) & 0xFFFFFFFF, payload.nbytes))
        f.write(payload)
    os.replace(tmp, path)       # a fault never sees a half-written file


def _load_frame(path: str) -> Frame:
    with open(path, "rb") as fh:
        raw = fh.read()
    hdr_len = len(_MAGIC) + _HDR.size
    if len(raw) < hdr_len or raw[:len(_MAGIC)] != _MAGIC:
        raise SpillIntegrityError(
            f"spill file {path} has a bad or missing integrity header "
            "(not written by this store, or truncated below the header)")
    crc, n = _HDR.unpack_from(raw, len(_MAGIC))
    payload = memoryview(raw)[hdr_len:]
    if payload.nbytes != n or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise SpillIntegrityError(
            f"spill file {path} failed CRC32 verification "
            f"({payload.nbytes} bytes on disk vs {n} stamped)")
    with np.load(io.BytesIO(payload)) as z:
        meta = pickle.loads(z["__meta__"].tobytes())
        device = torch.device(meta["device"])
        cols = []
        for j, e in enumerate(meta["cols"]):
            d = z[f"d{j}"]
            if e["tensor_data"]:
                # was a tensor before the spill: back onto its device; int64
                # host key columns never take this branch (they stay numpy)
                d = torch.from_numpy(d).to(device)
            m = None
            if e["has_mask"]:
                m = z[f"m{j}"]
                if e["tensor_mask"]:
                    m = torch.from_numpy(m).to(device)
            cols.append(Column(d, Domain(e["domain"]), m, e["dictionary"]))
    return Frame(cols, meta["row_labels"], meta["col_labels"],
                 meta["row_domains"], device=device)


def _own(a):
    """``a``, or a copy of it where it is a view into a larger buffer."""
    if isinstance(a, torch.Tensor):
        if a.untyped_storage().nbytes() > a.numel() * a.element_size():
            return a.clone(memory_format=torch.contiguous_format)
    elif (isinstance(a, np.ndarray) and isinstance(a.base, np.ndarray)
            and a.base.nbytes > a.nbytes):
        return a.copy()
    return a


def _owned(frame: Frame) -> Frame:
    """``frame`` with every column array that views a larger buffer copied
    into memory of its own.  A tracked block must own what it is charged
    for: a row range of a larger frame (``Frame.take_rows``, so every block
    of ``PartitionedFrame.from_frame``) shares the whole frame's storage, and
    dropping it on a spill would free none of the bytes the store uncharges.
    (In the JAX package a slice is already a copy.)"""
    cols, moved = [], False
    for c in frame.columns:
        d = _own(c.data)
        m = None if c.mask is None else _own(c.mask)
        if d is not c.data or m is not c.mask:
            c, moved = Column(d, c.domain, m, c.dictionary), True
        cols.append(c)
    if not moved:
        return frame
    return Frame(cols, frame.row_labels, frame.col_labels, frame.row_domains,
                 device=frame.device)


# =============================================================================
# handles
# =============================================================================
class _Rec:
    """The part of a handle that must outlive it: how many resident bytes it
    has charged and which spill file it owns.  ``weakref.finalize`` hands this
    to the store when the handle is garbage-collected, so dead handles give
    their bytes back and delete their spill file deterministically."""
    __slots__ = ("charged", "path")

    def __init__(self):
        self.charged = 0
        self.path: str | None = None


class BlockHandle:
    """One partition block behind a residency state.  Metadata (``nrows`` /
    ``ncols`` / ``nbytes``) is always available without faulting, so grid
    planning, zero-copy regroup pass-through, and cache accounting never
    touch a spilled block's data."""

    __slots__ = ("_store", "_frame", "_nbytes", "nrows", "ncols", "_rec",
                 "_pins", "_seq", "_evicting", "benefit", "_lock", "_id",
                 "_recompute", "__weakref__")

    def __init__(self, store: "BlockStore | None", frame: Frame,
                 recompute: "Callable[[], Frame] | None" = None):
        self._store = store
        self._frame: Frame | None = frame
        self._nbytes: int | None = None
        self.nrows = frame.nrows
        self.ncols = frame.ncols
        self._rec = _Rec()
        self._pins = 0
        self._seq = next(_SEQ)
        self._evicting = False
        self.benefit = 0.0           # cache benefit density; 0 = evict first
        self._lock = threading.Lock()
        self._id = next(_IDS)
        # lineage hook: rebuilds this block's Frame from its recorded
        # producer when the spill file fails integrity verification.  The
        # thunk closes over the producer's *input handles*, keeping them
        # alive (and re-faultable) for as long as this block exists.
        self._recompute = recompute

    # -- metadata ---------------------------------------------------------
    @property
    def nbytes(self) -> int:
        n = self._nbytes
        if n is None:
            f = self._frame
            n = self._nbytes = (f.nbytes() if f is not None else 0)
        return n

    @property
    def is_resident(self) -> bool:
        return self._frame is not None

    @property
    def is_tracked(self) -> bool:
        return self._store is not None

    # -- data access ------------------------------------------------------
    def frame(self) -> Frame:
        """The block's Frame; faults it back from disk when spilled."""
        f = self._frame
        st = self._store
        if st is None:               # untracked fast path (budget 0)
            return f
        if f is not None:
            self._seq = next(_SEQ)   # touch (benign race — LRU hint only)
            return f
        return st._fault(self)

    def pin(self) -> None:
        if self._store is not None:
            with self._store._lock:
                self._pins += 1

    def unpin(self) -> None:
        if self._store is not None:
            with self._store._lock:
                self._pins -= 1

    @contextlib.contextmanager
    def pinned(self) -> Iterator[Frame]:
        """Fault + pin for the duration of a per-block program (the physical
        layer wraps every dispatch-boundary kernel in one of these)."""
        self.pin()
        try:
            yield self.frame()
        finally:
            self.unpin()

    def __repr__(self) -> str:
        state = "resident" if self.is_resident else "spilled"
        return f"BlockHandle[{self.nrows}x{self.ncols}; {state}]"


# =============================================================================
# the store
# =============================================================================
_UNSET = object()


class BlockStore:
    def __init__(self, budget_bytes: int = 0, spill_dir: str | None = None):
        self.budget = max(0, int(budget_bytes))
        self._base_dir = spill_dir
        self._base_list: list | None = None   # parsed spill-dir failover list
        self._dirs: list = []                 # mkdtemp'd dir per base entry
        self._dir_idx = 0                     # first dir that still has room
        self._closed = False
        self._closed_site: str | None = None
        # REENTRANT: dead-handle finalizers (_reap) take this lock, and the
        # cyclic GC can run them on a thread that is already inside a locked
        # section (any allocation — e.g. _reserve's victim sort — can trigger
        # a collection).  With a plain Lock that is a self-deadlock; with an
        # RLock the reentrant _reap is safe because it only adjusts gauges
        # (resident_bytes, leaked_spill_files), which commute with every
        # in-flight locked section.
        self._lock = threading.RLock()
        self._handles: "weakref.WeakSet[BlockHandle]" = weakref.WeakSet()
        self.stats = StoreStats()

    @property
    def active(self) -> bool:
        return self.budget > 0

    # ------------------------------------------------------------------
    def put(self, frame: Frame, benefit: float = 0.0,
            recompute: "Callable[[], Frame] | None" = None) -> BlockHandle:
        """Register a block.  Inactive store (budget 0): a zero-overhead
        untracked wrapper.  Active: charge the block's bytes (of a copy of
        any column that views a larger buffer — ``_owned``), evicting
        lower-value blocks first to stay within budget.  ``recompute`` is
        the optional lineage thunk — see :class:`BlockHandle`."""
        if not self.active:
            return BlockHandle(None, frame, recompute)
        h = BlockHandle(self, _owned(frame), recompute)
        h.benefit = benefit
        need = h.nbytes
        self._reserve(need, register=h)
        weakref.finalize(h, BlockStore._reap, self, h._rec)
        return h

    # ------------------------------------------------------------------
    def _fault(self, h: BlockHandle) -> Frame:
        """Load a spilled block back (runs on whatever thread touched it —
        pool workers, by construction of the dispatch layer, so fault I/O
        overlaps other blocks' compute).  Pins the handle around the load so
        concurrent eviction can't un-account it mid-fault; the bytes are
        reserved (evict-until-fit + charge, atomically) BEFORE the load, so
        the resident gauge covers in-flight loads and the peak stays within
        budget whenever anything is evictable."""
        with self._lock:
            f = h._frame
            if f is not None:
                h._seq = next(_SEQ)
                return f
            h._pins += 1
        charged = False
        try:
            with h._lock:
                f = h._frame
                if f is None:
                    path = h._rec.path
                    if path is None:
                        if self._closed:
                            raise StoreClosedError(
                                f"cannot fault {h!r} (block id {h._id}): "
                                "its spill file was deleted by "
                                "BlockStore.shutdown() at "
                                f"[{self._closed_site}] — the store was "
                                "reset/reconfigured after this frame was "
                                "ingested (configure the budget before "
                                "ingesting data)")
                        raise RuntimeError(
                            "spilled block's file is gone — the store was "
                            "reset/reconfigured after this frame was "
                            "ingested (configure the budget before "
                            "ingesting data)")
                    self._reserve(h.nbytes)
                    charged = True
                    tr = _trace.current()
                    if tr is None:
                        f = self._load_block(h, path)
                    else:
                        # fault I/O runs on the worker that needed the block;
                        # the span lands under that worker's chunk span, so a
                        # profile shows WHICH dispatch paid the disk stall
                        with tr.span("fault", "store",
                                     args={"block": h._id,
                                           "bytes": h.nbytes}):
                            f = self._load_block(h, path)
                    with self._lock:
                        h._frame = f
                        h._rec.charged = h.nbytes
                        charged = False
                        self.stats.faults += 1
                        self.stats.faulted_bytes += h.nbytes
        finally:
            if charged:              # load failed: give the reservation back
                with self._lock:
                    self.stats.resident_bytes -= h.nbytes
            with self._lock:
                h._pins -= 1
                h._seq = next(_SEQ)
        return f

    def _load_block(self, h: BlockHandle, path: str) -> Frame:
        """Deserialize ``h``'s spill file with integrity verification (and
        the chaos hook).  A corrupt/missing file is unlinked and the block
        recomputed from its recorded producer when one exists; otherwise the
        SpillIntegrityError propagates.  Runs under ``h._lock`` — safe for
        recompute because producer lineage is a DAG, so the thunk can fault
        *other* handles but never re-enter this one."""
        recoverable = h._recompute is not None
        if _faults.active():
            _faults.spill_read_chaos(
                path,
                f"spill_read/blk{h._id}/"
                + ("lineage" if recoverable else "orphan"),
                recoverable=recoverable)
        try:
            return _load_frame(path)
        except (SpillIntegrityError, OSError) as e:
            with self._lock:
                self.stats.checksum_failures += 1
            try:
                os.unlink(path)      # a later spill must rewrite, not reuse
            except OSError:
                pass
            h._rec.path = None
            rec_fn = h._recompute
            if rec_fn is None:
                raise SpillIntegrityError(
                    f"spill file for {h!r} (block id {h._id}) is corrupt or "
                    f"missing and the block has no recorded producer to "
                    f"recompute from: {e}") from e
            f = _owned(resolve(rec_fn()))
            with self._lock:
                self.stats.recomputed_blocks += 1
            return f

    # ------------------------------------------------------------------
    def _reserve(self, incoming: int, register: BlockHandle | None = None) -> None:
        """Atomically evict-until-fit and charge ``incoming`` bytes: the
        budget check and the charge happen under one lock hold, so
        concurrent reserves cannot interleave into an overshoot.  Victims
        are selected as a BATCH per scan — one (benefit, LRU) sort covers
        the whole shortfall instead of a full rescan per victim.  Only when
        nothing is evictable (every resident block pinned or mid-eviction)
        does the charge overshoot — bounding the peak at budget + the
        in-flight blocks of the moment (≤ one per pool worker).

        Victims whose spill *write* fails (ENOSPC on every spill dir) are
        skipped for the rest of this reservation — they stay resident and
        the scan moves to the next candidate.  The skip set is per-call, so
        a transient write failure is retried on the next reservation."""
        skip: set[int] = set()
        while True:
            victims: list[BlockHandle] = []
            with self._lock:
                shortfall = self.stats.resident_bytes + incoming - self.budget
                if shortfall > 0:
                    cands = sorted(
                        (c for c in self._handles
                         if c._frame is not None and c._pins == 0
                         and not c._evicting and id(c) not in skip),
                        key=lambda c: (c.benefit, c._seq))
                    freed = 0
                    for cand in cands:
                        if freed >= shortfall:
                            break
                        cand._evicting = True
                        victims.append(cand)
                        freed += cand._rec.charged
                if not victims:      # fits, or nothing evictable: charge now
                    self.stats.resident_bytes += incoming
                    if self.stats.resident_bytes > self.stats.peak_resident_bytes:
                        self.stats.peak_resident_bytes = self.stats.resident_bytes
                    if register is not None:
                        self._handles.add(register)
                        register._rec.charged = incoming
                    return
            for victim in victims:
                if not self._spill(victim):
                    skip.add(id(victim))

    def _spill(self, h: BlockHandle) -> bool:
        """Evict one block to disk.  Returns False when the spill *write*
        failed on every spill dir (graceful degradation: the victim stays
        resident and charged; ``stats.budget_overruns`` was counted)."""
        try:
            with h._lock:
                with self._lock:
                    f = h._frame
                    if f is None or h._pins > 0:
                        return True  # raced with a fault/pin: nothing to do
                path = h._rec.path
                if path is None:
                    tr = _trace.current()
                    if tr is None:
                        path = self._write_spill(h, f)
                    else:
                        with tr.span("spill", "store",
                                     args={"block": h._id,
                                           "bytes": h.nbytes}):
                            path = self._write_spill(h, f)
                    if path is None:
                        return False
                    h._rec.path = path
                # else: clean copy already on disk from a prior spill —
                # frames are immutable, so dropping the memory is enough
                with self._lock:
                    if h._pins > 0:
                        # pinned while we wrote: a kernel is reading this
                        # frame RIGHT NOW — keep it resident (and charged);
                        # the on-disk copy stays valid for a later eviction
                        return True
                    h._frame = None
                    self.stats.resident_bytes -= h._rec.charged
                    h._rec.charged = 0
                    self.stats.spills += 1
                    self.stats.spilled_bytes += h.nbytes
        finally:
            with self._lock:
                h._evicting = False
        return True

    # ------------------------------------------------------------------
    def _write_spill(self, h: BlockHandle, f: Frame) -> str | None:
        """Write ``f`` to the first spill dir that accepts it, failing over
        through the ``REPRO_SPILL_DIR`` list on any OSError (ENOSPC,
        read-only mount, ...).  Returns the written path, or None when every
        directory is exhausted — the graceful-degradation signal."""
        bases = self._bases()
        for idx in range(self._dir_idx, len(bases)):
            d = self._dir_at(idx)
            if d is None:
                continue             # this base dir itself is unusable
            path = os.path.join(d, f"blk{h._id}.npz")
            try:
                if _faults.active():
                    _faults.spill_write_fault(f"spill_write/blk{h._id}/dir{idx}")
                _save_frame(path, f)
            except OSError:
                continue             # fail over to the next spill dir
            if idx != self._dir_idx:
                self._dir_idx = idx  # later spills go straight to the
                #                      first dir that still has room
            return path
        with self._lock:
            self.stats.budget_overruns += 1
        return None

    def _bases(self) -> list:
        """The configured spill base-dir list (lazy, so tests that set
        ``REPRO_SPILL_DIR`` after store creation still take effect on first
        spill, as before).  ``None`` entries mean the system tempdir."""
        b = self._base_list
        if b is None:
            spec = self._base_dir or os.environ.get("REPRO_SPILL_DIR")
            parts = [p for p in (spec or "").split(os.pathsep) if p]
            b = self._base_list = parts or [None]
            self._dirs = [_UNSET] * len(b)
        return b

    def _dir_at(self, idx: int) -> str | None:
        """The mkdtemp'd spill directory under base dir ``idx`` (created on
        first use; None — cached — when the base dir can't be created)."""
        d = self._dirs[idx]
        if d is _UNSET:
            with self._lock:
                if self._dirs[idx] is _UNSET:
                    base = self._base_list[idx]
                    try:
                        if base:
                            os.makedirs(base, exist_ok=True)
                        self._dirs[idx] = tempfile.mkdtemp(
                            prefix="repro-spill-", dir=base or None)
                    except OSError:
                        self._dirs[idx] = None
                d = self._dirs[idx]
        return d

    @staticmethod
    def _reap(store: "BlockStore", rec: _Rec) -> None:
        """Finalizer for a dead handle: give back its resident charge and
        delete its spill file (no leaked files once the owning frames go).
        An unlink that fails for any reason other than the file already
        being gone is COUNTED (``stats.leaked_spill_files``), not
        swallowed — a leak the spill smoke and chaos suite assert on."""
        with store._lock:
            store.stats.resident_bytes -= rec.charged
            rec.charged = 0
        if rec.path is not None:
            try:
                os.unlink(rec.path)
            except FileNotFoundError:
                pass                 # already gone (shutdown, chaos): no leak
            except OSError:
                with store._lock:
                    store.stats.leaked_spill_files += 1
            rec.path = None

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        """Drop every spill file and the spill directories.  Handles that
        were spilled become unusable — call only when the owning session is
        done (``reset_store`` / process exit / the CI spill smoke).  A later
        fault of such a handle raises :class:`StoreClosedError` naming this
        call site."""
        site = "<unknown>"
        for fr in reversed(traceback.extract_stack(limit=16)[:-1]):
            if os.path.basename(fr.filename) != "store.py":
                site = (f"{os.path.basename(fr.filename)}:{fr.lineno} "
                        f"in {fr.name}")
                break
        with self._lock:
            self._closed = True
            self._closed_site = site
            for h in list(self._handles):
                h._rec.path = None
            dirs, self._dirs = self._dirs, []
            self._base_list = None
            self._dir_idx = 0
        for d in dirs:
            if isinstance(d, str):
                shutil.rmtree(d, ignore_errors=True)


# =============================================================================
# module-level singleton + helpers
# =============================================================================
_STORE: BlockStore | None = None
_STORE_LOCK = threading.Lock()
_BUDGET_OVERRIDE: int | None = None
_DIR_OVERRIDE: str | None = None


def _env_budget() -> int:
    if _BUDGET_OVERRIDE is not None:
        return _BUDGET_OVERRIDE
    # warn-once parse: a malformed REPRO_MEM_BUDGET used to silently mean
    # "unlimited" — now it still falls back to 0, but says so (faults.env_int)
    return env_int("REPRO_MEM_BUDGET", 0, minimum=0)


def get_store() -> BlockStore:
    """The block store for the *current scope*: a session with its own store
    (``Session(mem_budget_bytes=...)`` private store, or the shared
    ``QueryService`` store all tenants charge against) resolves to that store
    while its ``config.SessionConfig`` is active; everything else gets the
    process-wide singleton built from ``REPRO_MEM_BUDGET`` /
    ``REPRO_SPILL_DIR`` (or the sticky :func:`configure` override)."""
    cfg = _config.current()
    if cfg is not None and cfg.store is not None:
        return cfg.store
    global _STORE
    if _STORE is None:
        with _STORE_LOCK:
            if _STORE is None:
                _STORE = BlockStore(_env_budget(), _DIR_OVERRIDE)
    return _STORE


def reset_store() -> None:
    """Tear down the store (deleting spill files) and let the next use
    rebuild it from the current environment — the ``schedule.reset_pool``
    counterpart for tests and session reconfiguration.  Blocks ingested
    under the old store keep working only if they were resident."""
    global _STORE
    with _STORE_LOCK:
        if _STORE is not None:
            _STORE.shutdown()
        _STORE = None


def configure(budget_bytes: int | None = None,
              spill_dir: str | None = None) -> BlockStore:
    """Process-wide programmatic override of the env knobs.
    ``Session(mem_budget_bytes=...)`` no longer calls this — it builds a
    session-*private* store resolved through ``config.SessionConfig``, so two
    sessions with different budgets can no longer clobber each other's spill
    state.  The override is sticky — it
    outlives the session that set it and shadows ``REPRO_MEM_BUDGET`` until
    changed again.

    Re-configuring with the *current* settings is a no-op; actually
    changing them resets the store, which deletes every existing spill
    file — frames ingested earlier lose their spilled blocks — so
    configure before ingesting data."""
    global _BUDGET_OVERRIDE, _DIR_OVERRIDE
    if budget_bytes is not None:
        _BUDGET_OVERRIDE = max(0, int(budget_bytes))
    if spill_dir is not None:
        _DIR_OVERRIDE = spill_dir
    with _STORE_LOCK:
        cur = _STORE
    if (cur is not None and cur.budget == _env_budget()
            and (spill_dir is None or cur._base_dir == spill_dir)):
        return cur
    reset_store()
    return get_store()


def unconfigure() -> None:
    """Clear the sticky :func:`configure` overrides and reset the store, so
    the next use rebuilds from ``REPRO_MEM_BUDGET`` / ``REPRO_SPILL_DIR``
    again — the public undo for ``Session(mem_budget_bytes=...)``."""
    global _BUDGET_OVERRIDE, _DIR_OVERRIDE
    _BUDGET_OVERRIDE = None
    _DIR_OVERRIDE = None
    reset_store()


def as_handle(block: "Frame | BlockHandle",
              recompute: "Callable[[], Frame] | None" = None) -> BlockHandle:
    """Wrap a Frame into the store (identity on handles).  ``recompute`` is
    the optional lineage thunk recorded for spill-integrity recovery; on an
    existing handle it only fills a missing one (never overwrites)."""
    if isinstance(block, BlockHandle):
        if recompute is not None and block._recompute is None:
            block._recompute = recompute
        return block
    return get_store().put(block, recompute=recompute)


def resolve(block: "Frame | BlockHandle") -> Frame:
    """The block's Frame — faulting it in if spilled (identity on Frames)."""
    if isinstance(block, BlockHandle):
        return block.frame()
    return block


@contextlib.contextmanager
def pinned(block: "Frame | BlockHandle") -> Iterator[Frame]:
    """Fault + pin scope for per-block kernel execution (identity on
    Frames).  Every dispatch-boundary block program runs inside one."""
    if isinstance(block, BlockHandle):
        with block.pinned() as f:
            yield f
    else:
        yield block
