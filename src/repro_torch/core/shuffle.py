"""Shuffle/exchange layer: grace-hash JOIN and sample-sort SORT (paper §4/§6).

JOIN and SORT never concatenate their inputs.  A reusable **exchange**
primitive turns a partitioned input into per-bucket *key frames* (equality
keys for join, rank keys for sort, plus each row's global position), the
operator becomes a per-bucket local kernel whose outputs merge back by
index, and the payload is only *gathered*, chunk by chunk, straight from the
original input blocks (Cylon's local-pattern decomposition, PAPERS.md).

Where the work runs in this port: keys, buckets, local sorts and matches are
host numpy, as the key factorization of ``physical`` is; each block's key
columns come to the host once, inside that block's exchange task.  Payload
columns stay on the frames' device: the gather (:func:`take_global` →
``Frame.take_rows``) copies one index array to the device per gathered
block and moves every column there.

Exchange rounds (all through ``schedule.dispatch_blocks``, so coalescing and
retry apply):

1. ``<op>:exchange`` — per input block: normalize keys (``physical._row_keys``
   / ``_sort_rank_keys`` with wide-int flags OR-ed across every block of both
   inputs), assign buckets (splitmix64 of the key bit patterns for join;
   sampled splitters → range buckets for sort), and register a per-block key
   frame; then per bucket: concat that bucket's rows from every block key
   frame.  Bucket frames are block handles with producer lineage.
2. ``<op>:local`` — per bucket: vectorized local hash join
   (``physical._match_ids``) or local lexsort.  Only *index arrays* leave the
   bucket.
3. ``<op>:gather`` — chunked payload gather over the original input blocks,
   re-gridded via ``physical._output_pf``.

Ordering/null semantics are **bit-identical** with the serial path: every
left row lives in exactly one hash bucket and bucket rows keep ascending
global position, so a global stable sort of the per-bucket pairs by left
position reproduces the serial left-major / right-tie-break order; unmatched
right rows append in right order; sample-sort buckets are ranges of the
primary transformed key (NaN→+inf so nulls sort last either direction), so
local stable lexsorts concatenate into the exact global permutation.

Skew: a bucket larger than ``skew_factor × mean`` splits — join buckets split
the larger side positionally (replicating the smaller side; the same global
merge restores exactness), sort buckets refine recursively on successive key
columns (a positional split only once every key column is tied, where
stability makes it exact).  Splits are counted in ``ExecStats.skew_splits``.

Knobs (see the table in ``core/schedule.py``): ``REPRO_SHUFFLE=0`` keeps the
serial whole-frame path as the differential oracle; ``REPRO_SHUFFLE_BUCKETS``
pins the bucket count (default: pool width × coalesce factor);
``REPRO_SHUFFLE_SKEW_FACTOR`` sets the oversize threshold.

Fused consumers (FUSED_JOIN / FUSED_SORT): leading structured predicates
filter the match index (evaluated on chunked gathers of only the columns
they read) or, for SORT, each block before the exchange; a following
projection prunes the gathered columns.

Under a memory budget the exchange's bucket key frames and gathered chunks
are store blocks with producer lineage: they spill and fault like data
blocks, and the bucket count and gather chunks respect
``schedule.budget_max_block_bytes``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Sequence

import numpy as np

from . import algebra as alg
from . import config as _config
from . import trace as _trace
from .dtypes import Domain
from .faults import env_int
from .frame import Column, Frame, host
from .labels import RangeLabels, labels_from_values
from .partition import PartitionedFrame
from .schedule import (budget_max_block_bytes, coalesce_factor,
                       dispatch_blocks, node_scope, pool_width)
from .store import as_handle, pinned, resolve
from . import physical as P

__all__ = ["enabled", "configure", "bucket_count", "skew_factor",
           "shuffled_join", "shuffled_sort", "take_global"]


# =============================================================================
# configuration
# =============================================================================
_BUCKETS_OVERRIDE: int | None = None
_SKEW_OVERRIDE: int | None = None


def enabled() -> bool:
    """``REPRO_SHUFFLE=0`` falls back to the serial whole-frame JOIN/SORT —
    the bit-identity oracle the differential tests sweep against."""
    return os.environ.get("REPRO_SHUFFLE", "") != "0"


def configure(buckets: int | None = None, skew_factor: int | None = None, *,
              clear: bool = False) -> None:
    """Process-wide programmatic override of the shuffle knobs — sticky,
    like ``schedule.configure_retries``.  A session's own values
    (``config.SessionConfig``) shadow it inside that session's statements."""
    global _BUCKETS_OVERRIDE, _SKEW_OVERRIDE
    if clear:
        _BUCKETS_OVERRIDE = None
        _SKEW_OVERRIDE = None
    if buckets is not None:
        _BUCKETS_OVERRIDE = max(1, int(buckets))
    if skew_factor is not None:
        _SKEW_OVERRIDE = max(1, int(skew_factor))


def bucket_count(total_rows: int, key_bytes: int) -> int:
    """Exchange bucket count: pinned by the session or
    ``REPRO_SHUFFLE_BUCKETS`` when set, else pool width × coalesce factor
    (every worker gets a couple of local kernels), raised to the budget
    floor so one bucket's key frame never exceeds
    ``schedule.budget_max_block_bytes``."""
    cfg = _config.current()
    if cfg is not None and cfg.shuffle_buckets is not None:
        b = max(1, cfg.shuffle_buckets)
    else:
        b = (_BUCKETS_OVERRIDE if _BUCKETS_OVERRIDE is not None
             else env_int("REPRO_SHUFFLE_BUCKETS", 0, minimum=0))
    if b <= 0:
        b = max(1, pool_width() * coalesce_factor())
    mb = budget_max_block_bytes()
    if mb and key_bytes > 0:
        b = max(b, -(-key_bytes // mb))          # ceil
    return max(1, min(b, max(1, total_rows)))


def skew_factor() -> int:
    """A bucket holding more than ``skew_factor × mean`` rows splits."""
    cfg = _config.current()
    if cfg is not None and cfg.shuffle_skew_factor is not None:
        return max(1, cfg.shuffle_skew_factor)
    if _SKEW_OVERRIDE is not None:
        return _SKEW_OVERRIDE
    return env_int("REPRO_SHUFFLE_SKEW_FACTOR", 4, minimum=1)


# =============================================================================
# shared plumbing: block handles, key frames, global gather
# =============================================================================
def _grid_handles(pf: PartitionedFrame, grid: str | None, pref_key: str):
    """Full-width row-block handles coarsened to the operator's grid
    preference (the dedup path's policy), plus their global row offsets —
    metadata only."""
    blocks = P._dedup_grid_blocks(pf, grid, pref_key)
    offs = [0]
    for h in blocks:
        offs.append(offs[-1] + h.nrows)
    return blocks, np.asarray(offs, dtype=np.int64)


def _key_frame(mat: np.ndarray, pos: np.ndarray,
               bucket: np.ndarray | None = None) -> Frame:
    """Pack a normalized key matrix + global positions (+ optional bucket
    assignment) into a host Frame: K float64 key columns ``k0..k{K-1}``, an
    int64 ``pos`` column, optionally an int64 ``b``."""
    cols = [Column(np.ascontiguousarray(mat[:, j]), Domain.FLOAT)
            for j in range(mat.shape[1])]
    names: list[Any] = [f"k{j}" for j in range(mat.shape[1])]
    cols.append(Column(pos.astype(np.int64), Domain.INT))
    names.append("pos")
    if bucket is not None:
        cols.append(Column(bucket.astype(np.int64), Domain.INT))
        names.append("b")
    return Frame(cols, RangeLabels(int(mat.shape[0])),
                 labels_from_values(names))


def _key_mat(kf: Frame, ncols: int) -> np.ndarray:
    if ncols == 0:
        return np.zeros((kf.nrows, 0), dtype=np.float64)
    return np.stack([host(kf.col(f"k{j}").data) for j in range(ncols)], axis=1)


def _key_pos(kf: Frame) -> np.ndarray:
    return host(kf.col("pos").data).astype(np.int64, copy=False)


def _hash_buckets(mat: np.ndarray, nbuckets: int) -> np.ndarray:
    """Bucket id per row: splitmix64 of each normalized key column's float64
    bit pattern, mixed across columns.  Bitwise on purpose — the local
    factorization (``physical._keys_to_ids``) compares keys by bit view, so
    bit-equal keys always co-locate (including canonical-NaN null keys) and
    bit-distinct keys never falsely match across buckets."""
    if mat.shape[1] == 0 or nbuckets <= 1:
        return np.zeros(mat.shape[0], dtype=np.int64)
    h = np.zeros(mat.shape[0], dtype=np.uint64)
    for j in range(mat.shape[1]):
        z = np.ascontiguousarray(mat[:, j]).view(np.uint64).copy()
        z += np.uint64(0x9E3779B97F4A7C15)
        z ^= z >> np.uint64(30)
        z *= np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(31)
        h ^= z + np.uint64(0x9E3779B97F4A7C15) + (h << np.uint64(6)) \
            + (h >> np.uint64(2))
    return (h % np.uint64(nbuckets)).astype(np.int64)


def _bucket_frame(bid: int, key_handles: Sequence, select: Callable) -> Frame:
    """Concat bucket ``bid``'s rows from every block key frame, in block
    order (rows stay in ascending global position) — each bucket handle's
    recompute lineage.  ``select(kf) -> int64 bucket ids``.  The ``b``
    column (when present) is dropped from the output."""
    parts: list[Frame] = []
    for kh in key_handles:
        with pinned(kh) as kf:
            sel = np.nonzero(select(kf) == bid)[0]
            if sel.size:
                parts.append(kf.take_rows(sel))
    if not parts:
        with pinned(key_handles[0]) as kf:
            parts = [kf.take_rows(np.empty(0, dtype=np.int64))]
    out = parts[0]
    for p in parts[1:]:
        out = out.concat_rows(p)
    names = [n for n in out.col_labels.to_list() if n != "b"]
    out = out.take_cols(out.col_labels.positions_of(names))
    return Frame(out.columns, RangeLabels(out.nrows), out.col_labels)


def _phase(name: str):
    """Trace span for one shuffle phase (bucketize / exchange / local /
    gather) — a null context when tracing is off."""
    tr = _trace.current()
    if tr is None:
        return contextlib.nullcontext()
    return tr.span(name, "phase")


def _exchange(key_handles: Sequence, nb: int, select: Callable) -> list:
    """The exchange proper: bucket ids are computed ONCE per block key frame
    (one split task per block, each bucket's piece keeping ascending
    in-block positions), then one task per bucket concatenates its pieces in
    block order — bit-identical to :func:`_bucket_frame`, which stays on as
    each bucket handle's recompute lineage."""
    def split_task(kh):
        with pinned(kh) as kf:
            ids = select(kf)
            names = [n for n in kf.col_labels.to_list() if n != "b"]
            cols = [host(kf.col(nm).data) for nm in names]
        # bucket ids live in [0, nb): a counting split (one flatnonzero pass
        # per bucket) beats a comparison sort and is equally stable
        rows = [np.flatnonzero(ids == b) for b in range(nb)]
        return names, [[c[r] for c in cols] for r in rows]

    pieces = dispatch_blocks(split_task, list(key_handles))
    names = pieces[0][0]

    def bucket_task(bid):
        arrs = [np.concatenate([p[bid][j] for _, p in pieces])
                for j in range(len(names))]
        frame = Frame([Column(a, Domain.INT if nm == "pos" else Domain.FLOAT)
                       for a, nm in zip(arrs, names)],
                      RangeLabels(int(arrs[0].shape[0]) if arrs else 0),
                      labels_from_values(names))
        return as_handle(
            frame, recompute=lambda: _bucket_frame(bid, key_handles, select))

    return dispatch_blocks(bucket_task, list(range(nb)))


def take_global(handles: Sequence, offsets: np.ndarray, idx: np.ndarray,
                cols: Sequence[Any] | None = None) -> Frame:
    """Distributed gather: the rows at global positions ``idx`` (into the
    concat of ``handles``), in ``idx`` order, touching ONE pinned block at a
    time — the shuffle-native replacement for ``to_frame().take_rows(idx)``.
    Each block's rows are gathered on its device with one index copy.  Row
    labels come through the per-block ``take_rows``, so label semantics
    match the whole-frame gather exactly.  ``cols`` prunes the gathered
    columns."""
    idx = np.asarray(idx, dtype=np.int64)
    k = int(idx.shape[0])
    restore: np.ndarray | None = None
    if k == 0 or bool(np.all(idx[1:] >= idx[:-1])):
        sidx = idx                       # already ascending: gather in order
    else:
        # O(n) scatter sort over the global row space: mark each requested
        # position with its output slot, then read the marks back in
        # ascending position order — no comparison sort for the common
        # unique-index case (sort permutations, join left gathers)
        nglobal = int(offsets[-1])
        slot = np.full(nglobal, -1, dtype=np.int64)
        slot[idx] = np.arange(k, dtype=np.int64)
        sidx = np.flatnonzero(slot >= 0)
        if sidx.shape[0] == k:           # unique indices
            slot[sidx] = np.arange(k, dtype=np.int64)   # rank in sidx
            restore = slot[idx]
        else:                            # repeats: general stable sort
            order = np.argsort(idx, kind="stable")
            sidx = idx[order]
            restore = np.empty(k, dtype=np.int64)
            restore[order] = np.arange(k, dtype=np.int64)
    cuts = np.searchsorted(sidx, np.asarray(offsets, dtype=np.int64))
    parts: list[Frame] = []
    for bi, h in enumerate(handles):
        s, e = int(cuts[bi]), int(cuts[bi + 1])
        if e <= s:
            continue
        with pinned(h) as f:
            g = f.induce()
            if cols is not None:
                g = P._project_block(g, cols)
            parts.append(g.take_rows(sidx[s:e] - int(offsets[bi])))
    if not parts:                       # empty gather: keep the schema
        with pinned(handles[0]) as f:
            g = f.induce()
            if cols is not None:
                g = P._project_block(g, cols)
            parts = [g.take_rows(np.empty(0, dtype=np.int64))]
    out = parts[0]
    for p in parts[1:]:
        out = out.concat_rows(p)
    return out if restore is None else out.take_rows(restore)


def _chunk_bounds(total: int, row_bytes: float) -> list[tuple[int, int]]:
    """Split ``total`` output rows into gather chunks no larger than one
    budget block and, independent of any budget, into roughly one chunk per
    pool slot so the payload gather runs in parallel.  Tiny outputs stay one
    chunk: fan-out overhead would swamp the work."""
    if total <= 0:
        return [(0, 0)]
    step = total
    mb = budget_max_block_bytes()
    if mb and row_bytes > 0:
        step = max(1024, int(mb // max(1.0, row_bytes)))
    fan = max(1, pool_width() * coalesce_factor())
    step = min(step, max(4096, -(-total // fan)))
    return [(lo, min(lo + step, total)) for lo in range(0, total, step)]


def _row_bytes(handles: Sequence) -> float:
    rows = sum(h.nrows for h in handles)
    return (sum(h.nbytes for h in handles) / rows) if rows else 0.0


def _schema_names(handles: Sequence) -> list:
    with pinned(handles[0]) as f:
        return f.col_labels.to_list()


def _gather_chunks(builders: Sequence[Callable[[], Frame]],
                   label: str) -> PartitionedFrame:
    """Materialize gather chunks through the pool, each registered with its
    builder as producer lineage."""
    def one(build):
        return as_handle(build(), recompute=build)

    with node_scope(label), _phase(label):
        out = dispatch_blocks(one, list(builders))
    return PartitionedFrame([[h] for h in out])


# =============================================================================
# JOIN: grace-hash exchange + per-bucket vectorized local join
# =============================================================================
def _join_key_handles(blocks, offsets, subset, joint, B):
    """Round 1b: per-block normalized key frames (+ bucket assignment),
    registered with producer lineage against the source block."""
    def task(args):
        h, off, joint_, B_ = args

        def build(f: Frame) -> Frame:
            f = f.induce()
            mat = P._row_keys(f, subset, joint_)
            pos = np.arange(off, off + f.nrows, dtype=np.int64)
            return _key_frame(mat, pos, _hash_buckets(mat, B_))

        with pinned(h) as f:
            kf = build(f)
        return as_handle(kf, recompute=lambda: build(resolve(h)))

    items = [(h, int(offsets[i]), joint, B) for i, h in enumerate(blocks)]
    return dispatch_blocks(task, items)


def _join_bucket_handles(key_handles, B):
    """Round 1c: per-bucket key frames (the exchange output)."""
    return _exchange(key_handles, B,
                     lambda kf: host(kf.col("b").data).astype(np.int64, copy=False))


def _local_join_tasks(lbuckets, rbuckets, mean_rows, stats):
    """Per-bucket local-join work items, splitting skewed buckets: the larger
    side of an oversized bucket splits positionally into parts (each part
    sees the whole smaller side), which is exact because the global merge
    sorts pairs by left position and derives unmatched rows from the pair
    set.  Each item is (lbh, rbh, llo, lhi, rlo, rhi)."""
    thresh = skew_factor() * max(1, mean_rows)
    tasks = []
    for lbh, rbh in zip(lbuckets, rbuckets):
        ln, rn = lbh.nrows, rbh.nrows
        total = ln + rn
        if total <= thresh or max(ln, rn) < 2:
            tasks.append((lbh, rbh, 0, ln, 0, rn))
            continue
        k = min(max(2, -(-total // max(1, thresh))), 32)
        if stats is not None:
            stats.skew_splits += k - 1
        big = ln if ln >= rn else rn
        cuts = np.linspace(0, big, k + 1).astype(np.int64)
        for p in range(k):
            lo, hi = int(cuts[p]), int(cuts[p + 1])
            if ln >= rn:
                tasks.append((lbh, rbh, lo, hi, 0, rn))
            else:
                tasks.append((lbh, rbh, 0, ln, lo, hi))
    return tasks


def _local_join(args, K: int):
    """One local join kernel: factorize the bucket slice jointly, match with
    the shared vectorized matcher, and return global-position results —
    (pairs_l, pairs_r, left_pos_seen, right_pos_seen)."""
    lbh, rbh, llo, lhi, rlo, rhi = args
    with pinned(lbh) as lkf, pinned(rbh) as rkf:
        if K == 1:
            # single-key fast path: ``_keys_to_ids`` factorizes by the int64
            # bit view, so the raw bit patterns are already an
            # equality-consistent id space (canonical NaN included)
            lids = host(lkf.col("k0").data).view(np.int64)[llo:lhi]
            rids = host(rkf.col("k0").data).view(np.int64)[rlo:rhi]
        else:
            lmat = _key_mat(lkf, K)[llo:lhi]
            rmat = _key_mat(rkf, K)[rlo:rhi]
            lids, rids = P._keys_to_ids(lmat, rmat)
        lpos = _key_pos(lkf)[llo:lhi]
        rpos = _key_pos(rkf)[rlo:rhi]
    li, ri, _, _ = P._match_ids(lids, rids, "inner")
    return lpos[li], rpos[ri], lpos, rpos


def _merge_join_results(results, how: str):
    """Fold per-bucket/part local results into the serial-order global match
    indices (lidx, ridx, lvalid, rvalid) — see the module docstring for the
    ordering argument."""
    pl = [r[0] for r in results]
    pr = [r[1] for r in results]
    main_l = (np.concatenate(pl) if pl
              else np.empty(0, dtype=np.int64))
    main_r = (np.concatenate(pr) if pr
              else np.empty(0, dtype=np.int64))
    main_rv = np.ones(main_l.shape[0], dtype=bool)
    if how in ("left", "outer"):
        # unmatched-left: every left row was seen by ≥1 task; matched ones
        # appear in some task's pair set
        seen_l = (np.unique(np.concatenate([r[2] for r in results]))
                  if results else np.empty(0, dtype=np.int64))
        matched_l = np.unique(main_l)
        un_l = np.setdiff1d(seen_l, matched_l, assume_unique=True)
        main_l = np.concatenate([main_l, un_l])
        main_r = np.concatenate([main_r, np.zeros(un_l.shape[0],
                                                  dtype=np.int64)])
        main_rv = np.concatenate([main_rv, np.zeros(un_l.shape[0],
                                                    dtype=bool)])
    # global stable sort by left position: per-bucket pairs are already
    # left-major with right-order ties, and a left row lives in exactly one
    # bucket, so this reproduces the serial emission order exactly
    order = np.argsort(main_l, kind="stable")
    lidx, ridx, rvalid = main_l[order], main_r[order], main_rv[order]
    lvalid = np.ones(lidx.shape[0], dtype=bool)
    if how in ("right", "outer"):
        seen_r = (np.unique(np.concatenate([r[3] for r in results]))
                  if results else np.empty(0, dtype=np.int64))
        matched_r = np.unique(main_r[main_rv]) if main_rv.any() else \
            np.empty(0, dtype=np.int64)
        un_r = np.setdiff1d(seen_r, matched_r, assume_unique=True)  # sorted
        lidx = np.concatenate([lidx, np.zeros(un_r.shape[0],
                                              dtype=np.int64)])
        ridx = np.concatenate([ridx, un_r])
        lvalid = np.concatenate([lvalid, np.zeros(un_r.shape[0],
                                                  dtype=bool)])
        rvalid = np.concatenate([rvalid, np.ones(un_r.shape[0], dtype=bool)])
    return lidx, ridx, lvalid, rvalid


def _gather_pred_keep(preds, refs, lh, loffs, rh, roffs, lidx, ridx,
                      lvalid, rvalid, drop_right, row_bytes) -> np.ndarray:
    """Evaluate the fused consumer predicates against chunked gathers of
    only the columns they read (the distributed ``_gather_join_cols``)."""
    lnames = set(_schema_names(lh))
    rnames = {n for n in _schema_names(rh) if n not in drop_right}
    lref = [n for n in refs if n in lnames]
    rref = [n for n in refs if n not in lnames and n in rnames]
    for n in refs:
        if n not in lnames and n not in rnames:
            raise KeyError(n)
    keeps = []
    for lo, hi in _chunk_bounds(int(lidx.shape[0]), row_bytes):
        mini = None
        if lref:
            part = take_global(lh, loffs, lidx[lo:hi], cols=lref)
            mini = P._mask_all(part, None if lvalid is None
                               else lvalid[lo:hi])
        if rref:
            part = take_global(rh, roffs, ridx[lo:hi], cols=rref)
            part = P._mask_all(part, None if rvalid is None
                               else rvalid[lo:hi])
            mini = part if mini is None else mini.concat_cols(part)
        keeps.append(host(P._fused_selection_mask(preds, mini)).astype(bool))
    return (np.concatenate(keeps) if keeps
            else np.empty(0, dtype=bool))


def shuffled_join(left: PartitionedFrame, right: PartitionedFrame,
                  params: dict, stages: Sequence[alg.Stage] = (),
                  stats=None) -> PartitionedFrame:
    """Grace-hash JOIN over the exchange layer — bit-identical to the serial
    ``REPRO_SHUFFLE=0`` path, with neither input ever concatenated."""
    how = params["how"]
    on = params["on"]
    left_on = params["left_on"] or on
    right_on = params["right_on"] or on
    label = "fused_join" if stages else "join"
    grid = params.get("grid")

    lh, loffs = _grid_handles(left, grid, "join")
    rh, roffs = _grid_handles(right, grid, "join")

    if left_on is None:
        # CROSS-PRODUCT: pure index arithmetic — no keys, no exchange
        ml, mr = left.nrows, right.nrows
        lidx = np.repeat(np.arange(ml, dtype=np.int64), mr)
        ridx = np.tile(np.arange(mr, dtype=np.int64), ml)
        lvalid = rvalid = None
        drop_right: tuple = ()
    else:
        K = len(left_on)
        total_rows = left.nrows + right.nrows
        key_bytes = total_rows * (K + 1) * 8
        B = bucket_count(total_rows, key_bytes)
        with node_scope(f"{label}:exchange"), _phase(f"{label}:exchange"):
            # wide-int flags must agree across every block of BOTH inputs
            flag_items = ([(h, left_on) for h in lh]
                          + [(h, right_on) for h in rh])

            def flags_task(args):
                h, sub = args
                with pinned(h) as f:
                    return P._wide_int_flags(f.induce(), sub)

            all_flags = dispatch_blocks(flags_task, flag_items)
            joint = np.zeros_like(all_flags[0])
            for fl in all_flags:
                joint = joint | fl
            with _phase(f"{label}:bucketize"):
                lkeys = _join_key_handles(lh, loffs, left_on, joint, B)
                rkeys = _join_key_handles(rh, roffs, right_on, joint, B)
                lbuckets = _join_bucket_handles(lkeys, B)
                rbuckets = _join_bucket_handles(rkeys, B)
        if stats is not None:
            stats.shuffle_buckets += 2 * B
            stats.shuffle_bytes += sum(
                (K + 1) * 8 * h.nrows for h in lbuckets + rbuckets)
        mean_rows = max(1, total_rows // max(1, B))
        tasks = _local_join_tasks(lbuckets, rbuckets, mean_rows, stats)
        with node_scope(f"{label}:local"), _phase(f"{label}:local"):
            results = dispatch_blocks(lambda a: _local_join(a, K), tasks)
        lidx, ridx, lvalid, rvalid = _merge_join_results(results, how)
        drop_right = tuple(right_on) if on is not None else ()

    preds, proj, rest = P._split_consumer_stages(stages) if stages else \
        ([], None, ())
    row_bytes = _row_bytes(lh) + _row_bytes(rh)
    row_labels = None
    if preds and lidx.shape[0]:
        refs = sorted(frozenset().union(*[p.refs() for p in preds]), key=repr)
        with node_scope(f"{label}:gather"), _phase(f"{label}:gather"):
            keep = _gather_pred_keep(preds, refs, lh, loffs, rh, roffs,
                                     lidx, ridx, lvalid, rvalid, drop_right,
                                     row_bytes)
        # the unfused path filters AFTER the join resets its index (same
        # label bookkeeping as physical._fused_join)
        row_labels = RangeLabels(int(lidx.shape[0])).take(np.nonzero(keep)[0])
        lidx, ridx = lidx[keep], ridx[keep]
        lvalid = lvalid[keep] if lvalid is not None else None
        rvalid = rvalid[keep] if rvalid is not None else None
    if stats is not None:
        stats.gather_rows += int(lidx.shape[0])

    total = int(lidx.shape[0])
    labels = row_labels if row_labels is not None else RangeLabels(total)
    keep_cols = frozenset(proj) if proj is not None else None
    keep_l = [n for n in _schema_names(lh) if keep_cols is None or n in keep_cols]
    keep_r = [n for n in _schema_names(rh)
              if n not in drop_right and (keep_cols is None or n in keep_cols)]

    def chunk_builder(lo: int, hi: int) -> Callable[[], Frame]:
        def build() -> Frame:
            lpart = take_global(lh, loffs, lidx[lo:hi], cols=keep_l)
            rpart = take_global(rh, roffs, ridx[lo:hi], cols=keep_r)
            lpart = P._mask_all(lpart, None if lvalid is None
                                else lvalid[lo:hi])
            rpart = P._mask_all(rpart, None if rvalid is None
                                else rvalid[lo:hi])
            out = lpart.concat_cols(rpart)
            out = Frame(out.columns, labels.take(np.arange(lo, hi)),
                        out.col_labels, device=out.device)
            if proj is not None:
                out = out.take_cols(out.col_labels.positions_of(proj))
            return out
        return build

    builders = [chunk_builder(lo, hi)
                for lo, hi in _chunk_bounds(total, row_bytes)]
    pfo = P._output_pf(_gather_chunks(builders, f"{label}:gather"))
    if rest:
        pfo = pfo.map_blockwise(lambda b: P._run_stages_block(b, rest))
    return pfo


# =============================================================================
# SORT: sample-sort range exchange + per-bucket local lexsort
# =============================================================================
def _sort_transform(keys: list[np.ndarray], ascending: bool) -> np.ndarray:
    """The direction/null-unified transform: after it, a plain ascending
    stable lexsort reproduces ``physical._sort_perm`` for either direction
    (NaN → +inf sorts last; descending negates values)."""
    out = []
    for v in keys:
        t = np.where(np.isnan(v), np.inf, v if ascending else -v)
        out.append(np.asarray(t, dtype=np.float64))
    return np.stack(out, axis=1)


def _sort_key_handles(blocks, offsets, by, ascending, keeps=None):
    """Per-block transformed rank-key frames + deterministic per-block
    splitter samples of the primary key.  ``keeps`` (per-block bool masks,
    the fused-filter path) drops filtered rows before they enter the
    exchange; global positions stay those of the original blocks."""
    def task(args):
        h, off, keep = args

        def build(f: Frame) -> Frame:
            f = f.induce()
            mat = _sort_transform(P._sort_rank_keys(f, by), ascending)
            pos = np.arange(off, off + f.nrows, dtype=np.int64)
            if keep is not None:
                mat, pos = mat[keep], pos[keep]
            return _key_frame(mat, pos)

        with pinned(h) as f:
            kf = build(f)
            s = np.sort(host(kf.col("k0").data))
            if s.size > 128:
                s = s[np.linspace(0, s.size - 1, 128).astype(np.int64)]
        return as_handle(kf, recompute=lambda: build(resolve(h))), s

    items = [(h, int(offsets[i]), None if keeps is None else keeps[i])
             for i, h in enumerate(blocks)]
    out = dispatch_blocks(task, items)
    return [o[0] for o in out], [o[1] for o in out]


def _splitters(samples: list[np.ndarray], B: int) -> np.ndarray:
    cand = np.sort(np.concatenate(samples)) if samples else \
        np.empty(0, dtype=np.float64)
    if cand.size == 0 or B <= 1:
        return np.empty(0, dtype=np.float64)
    picks = np.linspace(0, cand.size - 1, B + 1).astype(np.int64)[1:-1]
    return cand[picks]


def _lex_perm(keys: list[np.ndarray]) -> np.ndarray:
    """Stable lexicographic argsort of transformed (NaN-free, see
    :func:`_sort_transform`) float64 key columns, most-significant first.
    Adjacent key pairs pack into complex128 — numpy orders complex by
    (real, imag), bit-identical to the two-pass lexsort for NaN-free floats
    (ties, ±0, ±inf included) — halving the stable-sort passes."""
    packed = [keys[j] + 1j * keys[j + 1] if j + 1 < len(keys) else keys[j]
              for j in range(0, len(keys), 2)]
    if len(packed) == 1:
        return np.argsort(packed[0], kind="stable")
    return np.lexsort(tuple(reversed(packed)))


def _refine_parts(mat: np.ndarray, rows: np.ndarray, j: int,
                  thresh: int, splits: list[int]) -> list[np.ndarray]:
    """Recursive range refinement of an oversized sort bucket.  Quantile cuts
    on key column ``j``, with values *equal to a cut* isolated into their own
    group (``lo + hi`` over left/right searchsorted) — a hot value can never
    lump together with its neighbors.  A single-valued oversized group is
    fully tied on this column and recurses on the next one; with every key
    column tied a positional split is exact (stable lexsort ⇒ tied rows keep
    bucket order).  Groups are emitted in range order, so concatenation
    preserves the global sort."""
    if rows.shape[0] <= thresh:
        return [rows]
    if j >= mat.shape[1]:
        k = -(-rows.shape[0] // max(1, thresh))
        parts = [p for p in np.array_split(rows, k) if p.shape[0]]
        splits[0] += max(0, len(parts) - 1)
        return parts
    v = mat[rows, j]
    sv = np.sort(v)
    if sv[0] == sv[-1]:
        return _refine_parts(mat, rows, j + 1, thresh, splits)
    k = max(2, -(-rows.shape[0] // max(1, thresh)))
    picks = np.linspace(0, sv.size - 1, k + 1).astype(np.int64)[1:-1]
    cuts = np.unique(sv[picks])
    lo = np.searchsorted(cuts, v, side="left")
    hi = np.searchsorted(cuts, v, side="right")
    gid = lo + hi
    out: list[np.ndarray] = []
    made = 0
    for g in range(2 * int(cuts.size) + 1):
        grp = rows[gid == g]
        if not grp.shape[0]:
            continue
        made += 1
        if grp.shape[0] > thresh and grp.shape[0] < rows.shape[0]:
            out.extend(_refine_parts(mat, grp, j, thresh, splits))
        else:
            out.append(grp)
    splits[0] += max(0, made - 1)
    return out


def shuffled_sort(pf: PartitionedFrame, by: Sequence[Any], ascending: bool,
                  stages: Sequence[alg.Stage] = (), stats=None,
                  grid: str | None = None) -> PartitionedFrame:
    """Sample-sort over the exchange layer — bit-identical to the serial
    ``REPRO_SHUFFLE=0`` permutation, with the input never concatenated."""
    label = "fused_sort" if stages else "sort"
    blocks, offs = _grid_handles(pf, grid, "sort")
    K = len(by)
    n = pf.nrows
    B = bucket_count(n, n * (K + 1) * 8)

    preds, proj, rest = P._split_consumer_stages(stages) if stages else \
        ([], None, ())
    keeps = None
    if preds:
        # the fused consumer filter first, on the unsorted blocks: row-local,
        # so permutation- and block-invariant, and stable sorting commutes
        # with subsetting, so filtered rows never enter the exchange, the
        # local sorts or the payload gather
        def mask_task(h):
            with pinned(h) as f:
                return host(P._fused_selection_mask(preds, f.induce())).astype(bool)

        with node_scope(f"{label}:exchange"), _phase(f"{label}:exchange"):
            keeps = dispatch_blocks(mask_task, blocks)

    with node_scope(f"{label}:exchange"), _phase(f"{label}:exchange"):
        with _phase(f"{label}:bucketize"):
            key_handles, samples = _sort_key_handles(blocks, offs, by,
                                                     ascending, keeps)
            cuts = _splitters(samples, B)

        nb = int(cuts.size) + 1
        buckets = _exchange(
            key_handles, nb,
            lambda kf: np.searchsorted(
                cuts, host(kf.col("k0").data),
                side="right").astype(np.int64))
    if stats is not None:
        stats.shuffle_buckets += nb
        stats.shuffle_bytes += sum((K + 1) * 8 * h.nrows for h in buckets)

    # skew refinement: oversized buckets split into range-refined parts so
    # local sorts stay balanced; parts are emitted in range order, so the
    # final concat is still the global permutation.  Sized on the rows that
    # entered the exchange (the fused filter may have dropped some).
    nexch = sum(h.nrows for h in buckets)
    thresh = skew_factor() * max(1, nexch // max(1, nb))
    work: list = []          # (bucket_handle, local_rows | None)
    splits = [0]

    def refine_task(bh):
        with pinned(bh) as kf:
            mat = _key_mat(kf, K)
            rows = np.arange(kf.nrows, dtype=np.int64)
            return _refine_parts(mat, rows, 0, thresh, splits)

    oversized = [bh for bh in buckets if bh.nrows > thresh]
    refined: dict[int, list[np.ndarray]] = {}
    if oversized:
        with node_scope(f"{label}:local"), _phase(f"{label}:local"):
            parts_lists = dispatch_blocks(refine_task, oversized)
        refined = {id(bh): parts for bh, parts in zip(oversized, parts_lists)}
    for bh in buckets:
        for rows in refined.get(id(bh), [None]):
            work.append((bh, rows))
    if stats is not None:
        stats.skew_splits += splits[0]

    def local_sort(args):
        bh, rows = args
        with pinned(bh) as kf:
            keys = [host(kf.col(f"k{j}").data) for j in range(K)]
            pos = _key_pos(kf)
        if rows is not None:
            keys, pos = [c[rows] for c in keys], pos[rows]
        if not keys:
            return pos
        return pos[_lex_perm(keys)]

    with node_scope(f"{label}:local"), _phase(f"{label}:local"):
        sorted_pos = dispatch_blocks(local_sort, work)
    idx = (np.concatenate(sorted_pos) if sorted_pos
           else np.empty(0, dtype=np.int64))
    if stats is not None:
        stats.gather_rows += int(idx.shape[0])

    row_bytes = _row_bytes(blocks)
    cols = list(proj) if proj is not None else None

    def chunk_builder(lo: int, hi: int) -> Callable[[], Frame]:
        def build() -> Frame:
            return take_global(blocks, offs, idx[lo:hi], cols=cols)
        return build

    builders = [chunk_builder(lo, hi)
                for lo, hi in _chunk_bounds(int(idx.shape[0]), row_bytes)]
    pfo = P._output_pf(_gather_chunks(builders, f"{label}:gather"))
    if rest:
        pfo = pfo.map_blockwise(lambda b: P._run_stages_block(b, rest))
    return pfo
