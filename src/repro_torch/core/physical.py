"""Physical operators: dataframe algebra over partitioned frames (paper §4).

Each logical operator picks a partitioning scheme per the paper's §4.2 table:

  MAP / SELECTION / RENAME      → embarrassingly parallel, any partitioning
  GROUPBY(n)                    → row-parallel partial aggregation (the
                                  ``segment_reduce`` kernel) + small combine
  GROUPBY(1)                    → same with G = 1 (pure reduction)
  WINDOW                        → blocked scan (the ``window_scan`` kernel)
                                  with a cross-block carry composed on the
                                  device; diff/shift through a row halo
  TRANSPOSE                     → per-block kernel transpose + grid swap
  SORT / JOIN                   → shuffle-native (``core/shuffle.py``): range
                                  or hash buckets exchanged through the pool,
                                  local per-bucket sorts / joins, chunked
                                  payload gather on the device.
                                  ``REPRO_SHUFFLE=0`` keeps the serial
                                  whole-frame path below as the oracle.
  DIFFERENCE / DROP-DUPLICATES  → blocking, but block-parallel: per-block key
                                  extraction through the pool, one joint
                                  factorization, then blockwise keep-mask
                                  filters; the input is never concatenated.
                                  ``REPRO_BLOCK_DEDUP=0`` keeps the serial
                                  whole-frame path as the oracle.

Fusion (paper §5).  ``FUSED_PIPELINE`` runs a chain of row-local operators
(elementwise MAP, SELECTION, PROJECTION, RENAME) as one per-block program
(``_run_stages_block``): a run of structured selections is ANDed into one
predicate and evaluated once; a run of maps runs its UDFs one after another.
Where ``REPRO_JIT_UDFS`` says so (``_jit_udfs_enabled``: by default on a
CUDA block, not on a CPU block) each such run is ONE compiled program a
block (``torch.compile`` on inductor of the chain traced on fake tensors),
adopted only where its first block reproduces the eager result bit for
bit; a chain that fails to trace or compile, or differs, stays eager
(``jit_stats`` counts each outcome).  The barrier-fused operators run
the chain inside the blocking operator's own per-block programs:
``FUSED_GROUPBY`` stages each block and reads its key span, then computes
codes and every partial (``segment_reduce``) against one global dense
range; ``FUSED_WINDOW`` runs pre-stages in the local-scan program
(``window_scan``) and post-stages in the carry-application program;
``FUSED_SORT`` / ``FUSED_JOIN`` filter the permutation / match index with
the consumer predicates before the payload gather, and a following
projection prunes the gathered columns; ``FUSED_DROP_DUPLICATES`` /
``FUSED_DIFFERENCE`` run the producer chain in the key-extraction program
and filter the keep mask with the consumer predicates.

Column data stays on the frames' device.  What still goes through the host:
the general key factorization (``_row_keys`` / ``_keys_to_ids``: string and
multi-column group keys), SORT's and JOIN's keys (each block's key columns
come to the host once, in its exchange task), their bucketing, local sorts
and match indices (only index arrays go back to the device, one copy per
gathered block), the coded (string) transpose, the row filters' index (a
keep mask is brought to the host once to index the row labels), and
DIFFERENCE's and DROP-DUPLICATES' keys: each block's key columns come to the
host once in ``_row_keys`` (inside its key-extraction task), the joint
factorization and the keep masks (``np.isin`` over dense ids, first
occurrences by ``np.unique``) are host numpy, and each keep mask goes back
to the device once a block, as ``Frame.filter_rows`` takes it.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import algebra as alg
from . import trace as _trace
from .dtypes import Domain, common_storage, parse_column, to_device, torch_dtype
from .frame import Column, Frame, as_tensor, host, infer_domain
from .labels import IntLabels, RangeLabels, labels_from_values
from .partition import PartitionedFrame
from .schedule import (GRID_PREFS, dispatch_blocks, output_row_parts,
                       preferred_row_parts)
from .store import as_handle, pinned, resolve
from ..kernels import ops as kops

__all__ = ["run_node", "eval_expr", "NULL_CODE"]

NULL_CODE = -1


# =============================================================================
# Expression evaluation (structured predicates / scalar exprs)
# =============================================================================
def _is_int(t: torch.Tensor) -> bool:
    return not t.dtype.is_floating_point and t.dtype != torch.bool


def _lit_dtype(value) -> torch.dtype:
    """A literal's storage: in-range int literals in int32 (identical wrap
    semantics to int32 columns), float literals in float32; only
    out-of-int32-range literals take int64."""
    if isinstance(value, bool):
        return torch.bool
    if isinstance(value, int):
        return torch.int32 if -2 ** 31 <= value < 2 ** 31 else torch.int64
    if isinstance(value, float):
        return torch.float32
    raise TypeError(f"literal {value!r} cannot meet a numeric column")


def _lit_full(shape, value, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=_lit_dtype(value), device=device)


def _has_wide_lit(expr: alg.Expr) -> bool:
    """True if any int literal in ``expr`` falls outside int32: predicate
    chains holding one run on the interpreted path, as the reference's do
    (its jit is 32-bit)."""
    if isinstance(expr, alg.Lit):
        v = expr.value
        return (isinstance(v, int) and not isinstance(v, bool)
                and not -2 ** 31 <= v < 2 ** 31)
    if isinstance(expr, alg.BinExpr):
        return _has_wide_lit(expr.left) or _has_wide_lit(expr.right)
    if isinstance(expr, alg.UnaryExpr):
        return _has_wide_lit(expr.operand)
    return False


def _wide_int_column(c: Column) -> bool:
    """True for an INT column in 64-bit storage (the host int64 key columns
    of ``_host_column``): the reference keeps such columns out of its
    compiled programs, which would truncate them to int32."""
    return c.domain is Domain.INT and c.data.dtype.itemsize > 4


def _eval_expr_core(expr: alg.Expr, getcol: Callable, nrows: int, device,
                    bin_hook: Callable | None = None,
                    lit: Callable | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The one expression interpreter, shared by the interpreted per-frame
    path (``eval_expr``) and the compiled predicate programs
    (``_eval_expr_env``), so the two cannot diverge.  ``getcol(name) →
    (values, mask)``; ``bin_hook(BinExpr) → result | None`` lets the frame
    path intercept coded-column comparisons (host code-table translation);
    ``lit(value) → (values, mask)`` builds a literal (default: ``nrows``
    rows on ``device``)."""
    if isinstance(expr, alg.ColRef):
        return getcol(expr.name)
    if isinstance(expr, alg.Lit):
        if lit is not None:
            return lit(expr.value)
        return (_lit_full((nrows,), expr.value, device),
                torch.ones((nrows,), dtype=torch.bool, device=device))
    if isinstance(expr, alg.UnaryExpr):
        v, mask = _eval_expr_core(expr.operand, getcol, nrows, device, bin_hook, lit)
        if expr.op == "~":
            return ~v.to(torch.bool), mask
        if expr.op == "isna":
            return ~mask, torch.ones_like(mask)
        if expr.op == "notna":
            return mask, torch.ones_like(mask)
        raise ValueError(expr.op)
    if isinstance(expr, alg.BinExpr):
        if bin_hook is not None:
            hit = bin_hook(expr)
            if hit is not None:
                return hit
        lv, lm = _eval_expr_core(expr.left, getcol, nrows, device, bin_hook, lit)
        rv, rm = _eval_expr_core(expr.right, getcol, nrows, device, bin_hook, lit)
        return _bin_numeric(expr.op, lv, lm, rv, rm)
    raise TypeError(expr)


def eval_expr(expr: alg.Expr, frame: Frame) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized evaluation → (values, valid_mask) tensors."""
    dev = frame.device

    def getcol(name):
        c = frame.col(name)
        data = c.data if isinstance(c.data, torch.Tensor) else torch.from_numpy(c.data).to(dev)
        return data, c.valid_mask().to(dev)

    def bin_hook(e: alg.BinExpr):
        # coded-column vs literal comparisons translate to code-space
        if isinstance(e.left, alg.ColRef) and isinstance(e.right, alg.Lit):
            c = frame.col(e.left.name)
            if c.domain.is_coded and e.op in ("==", "!="):
                code = _lit_to_code(c, e.right.value)
                v = c.data == code if e.op == "==" else c.data != code
                return v, c.valid_mask()
        return None

    return _eval_expr_core(expr, getcol, frame.nrows, dev, bin_hook)


def _lit_to_code(column: Column, value: Any) -> int:
    table = column.dictionary or ()
    key = str(value)
    return table.index(key) if key in table else -2  # -2 never matches


def _bin_numeric(op: str, lv, lm, rv, rm) -> tuple[torch.Tensor, torch.Tensor]:
    """Binary op over (values, mask) pairs.  int⊕int stays in integer dtypes
    for ``+ - * % //`` and comparisons — a float32 round-trip corrupts values
    above 2²⁴.  Like numpy/pandas integer dtypes, ``+ - *`` wrap on int32
    overflow; ``% //`` by zero yield null.  An int64 operand promotes the
    pair to int64 (and to float64 against a float)."""
    mask = lm & rm
    if op in ("&", "|"):
        lb, rb = lv.to(torch.bool), rv.to(torch.bool)
        return (lb & rb if op == "&" else lb | rb), mask
    both_int = _is_int(lv) and _is_int(rv)
    if op in ("+", "-", "*", "%", "//") and both_int:
        if op == "+":
            return lv + rv, mask
        if op == "-":
            return lv - rv, mask
        if op == "*":
            return lv * rv, mask
        # int division by 0: mark those rows null instead of surfacing a
        # plausible integer; feed the masked slots a dummy 1
        mask = mask & (rv != 0)
        rv = torch.where(rv == 0, torch.ones_like(rv), rv)
        return (torch.remainder(lv, rv) if op == "%"
                else torch.div(lv, rv, rounding_mode="floor")), mask
    if op in ("+", "-", "*", "/", "%", "//"):
        lf, rf = _as_float_pair(lv, rv)
        if op == "%":
            out = torch.remainder(lf, rf)
        elif op == "//":
            out = torch.div(lf, rf, rounding_mode="floor")
        else:
            out = {"+": lf + rf, "-": lf - rf, "*": lf * rf, "/": lf / rf}[op]
        return out, mask
    if both_int:
        lf, rf = lv, rv
    else:
        lf, rf = _as_float_pair(lv, rv)
    out = {
        "==": lf == rf, "!=": lf != rf, "<": lf < rf,
        "<=": lf <= rf, ">": lf > rf, ">=": lf >= rf,
    }[op]
    return out, mask


def _as_float_pair(lv, rv):
    """Float substrate for a mixed binary op: float32 unless either operand
    carries 64-bit storage — then float64, the promotion numpy/pandas apply
    to int64⊕float."""
    if lv.element_size() > 4 or rv.element_size() > 4:
        return lv.to(torch.float64), rv.to(torch.float64)
    return lv.to(torch.float32), rv.to(torch.float32)


def _predicate_mask(frame: Frame, predicate) -> torch.Tensor:
    if isinstance(predicate, alg.Udf):
        out = predicate.fn({n: c for n, c in zip(frame.col_labels.to_list(), frame.columns)}, frame)
        return as_tensor(out, frame.device).to(torch.bool)
    v, mask = eval_expr(predicate, frame)
    return v.to(torch.bool) & mask  # null comparisons → False


# =============================================================================
# Per-operator physical implementations
# =============================================================================
def _selection(pf: PartitionedFrame, predicate) -> PartitionedFrame:
    if pf.col_parts == 1:
        return pf.map_blockwise(lambda f: f.filter_rows(_predicate_mask(f, predicate)))
    # predicate may span column blocks: evaluate per row-stripe, filter blocks
    def stripe(i: int) -> list[Frame]:
        full = pf.parts[i][0]
        for j in range(1, pf.col_parts):
            full = full.concat_cols(pf.parts[i][j])
        keep = host(_predicate_mask(full, predicate))
        return [blk.filter_rows(keep) for blk in pf.parts[i]]
    rows = dispatch_blocks(stripe, range(pf.row_parts))
    return PartitionedFrame(rows)


def _project_block(frame: Frame, cols: Sequence[Any]) -> Frame:
    return frame.take_cols(frame.col_labels.positions_of(cols))


def _projection(pf: PartitionedFrame, cols: Sequence[Any]) -> PartitionedFrame:
    f = pf.repartition(col_parts=1)
    return f.map_blockwise(lambda frame: _project_block(frame, cols))


def _union(left: PartitionedFrame, right: PartitionedFrame) -> PartitionedFrame:
    l = left.repartition(col_parts=1)
    r = right.repartition(col_parts=1)
    # handle-level stack: pure metadata
    return PartitionedFrame(l.handles + r.handles)


def _output_pf(out: Frame | PartitionedFrame) -> PartitionedFrame:
    """Re-grid a blocking operator's output to the pool width
    (``schedule.output_row_parts``); small results stay single-partition."""
    if isinstance(out, PartitionedFrame):
        return out.repartition(row_parts=output_row_parts(out.nrows),
                               col_parts=1)
    return PartitionedFrame.from_frame(out,
                                       row_parts=output_row_parts(out.nrows))


# ---- equality keys (host) ----------------------------------------------------
_HASH_MASK = (1 << 52) - 1  # exactly-representable ints in float64
_WIDE_INT_LIMIT = 1 << 53   # |v| beyond this, float64 merges distinct int64s


def _fnv64(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s.encode():
        h ^= ch
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _hash_wide_ints(v: np.ndarray) -> np.ndarray:
    """splitmix64-style mix of int64 key values, masked into the float64-exact
    range (a plain cast would collide 2**53 with 2**53 + 1)."""
    z = v.astype(np.int64).view(np.uint64).copy()
    z += np.uint64(0x9E3779B97F4A7C15)
    z ^= z >> np.uint64(30)
    z *= np.uint64(0xBF58476D1CE4E5B9)
    z ^= z >> np.uint64(27)
    z *= np.uint64(0x94D049BB133111EB)
    z ^= z >> np.uint64(31)
    return (z & np.uint64(_HASH_MASK)).astype(np.float64)


def _wide_key_values(arr: np.ndarray) -> np.ndarray:
    """Key values for a column at a wide-flagged position: integer storage
    hashes directly; a float column hashes only its integral in-range
    values (``5.0`` must still equal int ``5``)."""
    if arr.dtype.kind in "iub":
        return _hash_wide_ints(arr)
    f = np.asarray(arr, dtype=np.float64)
    intlike = np.isfinite(f) & (np.floor(f) == f) & (np.abs(f) < 2.0 ** 63)
    hashed = _hash_wide_ints(np.where(intlike, f, 0.0).astype(np.int64))
    return np.where(intlike, hashed, f)


def _wide_int_flags(frame: Frame, subset: Sequence[Any] | None) -> np.ndarray:
    """Per-key-column bool: INT column holding values outside ±2**53 (only
    possible with int64 storage).  Callers OR the flags across frames."""
    cols = frame.columns if subset is None else [frame.col(n) for n in subset]
    out = np.zeros(len(cols), dtype=bool)
    for i, c in enumerate(cols):
        # dtype check first: int32 storage can never be wide, and copying it
        # to the host just to skip it would cost a device transfer
        if c.domain is not Domain.INT or c.data.dtype.itemsize <= 4:
            continue
        v = host(c.data)
        if c.mask is not None:
            v = v[host(c.mask)]
        if v.size and bool(((v > _WIDE_INT_LIMIT) | (v < -_WIDE_INT_LIMIT)).any()):
            out[i] = True
    return out


def _row_keys(frame: Frame, subset: Sequence[Any] | None,
              wide: np.ndarray | None = None) -> np.ndarray:
    """Normalized per-row key matrix (host) for equality (join / groupby).
    Coded (Σ*) columns map through a *value* hash so keys compare correctly
    across frames with different dictionaries; numerics are their float64
    values; nulls are NaN (never equal a valid key)."""
    cols = frame.columns if subset is None else [frame.col(n) for n in subset]
    mats = []
    for i, c in enumerate(cols):
        if c.domain.is_coded:
            table = c.dictionary or ()
            lut = np.asarray([float(_fnv64(str(v)) & _HASH_MASK) for v in table]
                             or [0.0], dtype=np.float64)
            # integer codes whatever the storage: a 0-row coded column may
            # come with float storage, and float codes cannot index the LUT
            codes = host(c.data).astype(np.int64)
            v = lut[np.clip(codes, 0, len(lut) - 1)]
            v = np.where(codes >= 0, v, np.nan)
        elif wide is not None and bool(wide[i]):
            v = _wide_key_values(host(c.data))
        else:
            v = host(c.data).astype(np.float64)
        if c.mask is not None:
            v = np.where(host(c.mask), v, np.nan)
        mats.append(v)
    return np.stack(mats, axis=1) if mats else np.zeros((frame.nrows, 0))


def _sort_rank_keys(frame: Frame, subset: Sequence[Any]) -> list[np.ndarray]:
    """Per-column sort keys (host): lexicographic rank for coded columns,
    values for numerics (ordering, unlike equality, needs real value
    order); nulls are NaN.  Each key column comes to the host once."""
    out = []
    for name in subset:
        c = frame.col(name)
        if c.domain.is_coded:
            table = list(c.dictionary or ())
            rank = np.empty(max(len(table), 1), dtype=np.float64)
            for r, idx in enumerate(sorted(range(len(table)), key=lambda i: str(table[i]))):
                rank[idx] = r
            codes = host(c.data)
            v = rank[np.clip(codes, 0, len(table) - 1 if table else 0)]
            v = np.where(codes >= 0, v, np.nan)
        else:
            v = host(c.data).astype(np.float64)
        if c.mask is not None:
            v = np.where(host(c.mask), v, np.nan)
        out.append(v)
    return out


def _keys_to_ids(*key_mats: np.ndarray) -> list[np.ndarray]:
    """Jointly factorize row-key matrices → dense ids (NaN-safe)."""
    all_rows = np.concatenate(key_mats, axis=0)
    # use bit-view so NaN == NaN for grouping purposes
    view = all_rows.view(np.int64).reshape(all_rows.shape)
    n, ncols = view.shape
    if ncols == 0:
        inv = np.zeros(n, dtype=np.int64)
    elif ncols == 1:
        _, inv = np.unique(view[:, 0], return_inverse=True)
    else:
        # multi-key: column-wise factorization, then a mixed-radix combine
        def col_inv(j: int):
            _, invj = np.unique(view[:, j], return_inverse=True)
            return (invj.astype(np.int64),
                    int(invj.max()) + 1 if invj.size else 1)

        per_col = dispatch_blocks(col_inv, range(ncols), attribute=False)
        invs = [p[0] for p in per_col]
        cards = [p[1] for p in per_col]
        space = 1
        for c in cards:
            space *= c
        if space < 2 ** 62:
            code = invs[0]
            for invj, c in zip(invs[1:], cards[1:]):
                code = code * np.int64(c) + invj
            _, inv = np.unique(code, return_inverse=True)
        else:
            inv = invs[0]
            for invj, c in zip(invs[1:], cards[1:]):
                _, inv = np.unique(inv * np.int64(c) + invj,
                                   return_inverse=True)
                inv = inv.astype(np.int64)
    out, off = [], 0
    for m in key_mats:
        out.append(inv[off:off + m.shape[0]].astype(np.int64))
        off += m.shape[0]
    return out


# ---- DIFFERENCE / DROP-DUPLICATES -------------------------------------------
# Block-parallel local-dedup → joint-factorize → blockwise-filter: per-block
# key extraction runs through ``schedule.dispatch_blocks``, the per-block key
# matrices are jointly factorized in one host pass, and the first-occurrence /
# anti-join keep masks filter the blocks in place (no ``to_frame()`` concat).


def _block_dedup_enabled() -> bool:
    """``REPRO_BLOCK_DEDUP=0`` routes DIFFERENCE / DROP-DUPLICATES through
    the serial whole-frame path, the oracle of the block-parallel one."""
    return os.environ.get("REPRO_BLOCK_DEDUP", "") != "0"


def _dedup_grid_blocks(pf: PartitionedFrame, grid: str | None,
                       pref_key: str) -> list:
    """Full-width row-block handles coarsened to the recorded grid
    preference (blocks ≈ workers: fewer per-block fixed costs and fewer
    pieces to combine).  Dedup and the exchange give results that do not
    depend on the blocking, so the regrid may come before an absorbed
    producer chain: fused and unfused plans agree on any grid."""
    pf1 = pf.repartition(col_parts=1)
    rp = preferred_row_parts(pf1.row_parts, grid or GRID_PREFS[pref_key],
                             total_bytes=pf1.nbytes())
    if rp != pf1.row_parts:
        pf1 = pf1.repartition(row_parts=rp)
    return pf1.row_handles()


def _key_block(args) -> tuple[Any, np.ndarray, np.ndarray, np.ndarray | None]:
    """The per-block key-extraction program, one dispatch per partition: run
    the absorbed producer chain, induce, flag wide ints, build the key matrix
    (the key columns come to the host here), and evaluate the pushable
    consumer predicates on the device (row-local, so legal on the
    pre-filter block).  The staged block returns as a store handle."""
    block, subset, stages, preds = args
    with pinned(block) as src:
        f = (_run_stages_block(src, stages) if stages else src).induce()
        flags = _wide_int_flags(f, subset)
        mat = _row_keys(f, subset, flags)
        keep = host(_fused_selection_mask(preds, f)).astype(bool) if preds else None
        hout = block if f is src else as_handle(
            f, recompute=lambda: (_run_stages_block(resolve(block), stages)
                                  if stages else resolve(block)).induce())
    return hout, flags, mat, keep


def _joint_key_mats(results, subset):
    """OR the per-block wide-int flags and re-key (through the pool) the
    blocks whose own decision disagrees: every block in one joint
    factorization must hash-or-cast each column alike."""
    blocks = [r[0] for r in results]
    flags = [r[1] for r in results]
    mats = [r[2] for r in results]
    keeps = [r[3] for r in results]
    joint = np.zeros_like(flags[0])
    for fl in flags:
        joint = joint | fl
    if joint.any():
        redo = [i for i, fl in enumerate(flags)
                if not bool((fl == joint).all())]

        def rekey(i):
            with pinned(blocks[i]) as f:
                return _row_keys(f, subset, joint)

        fixed = dispatch_blocks(rekey, redo)
        for i, m in zip(redo, fixed):
            mats[i] = m
    return blocks, mats, keeps


def _apply_keep_blocks(blocks: Sequence, keeps: Sequence[np.ndarray],
                       proj) -> PartitionedFrame:
    """Blockwise keep-mask filter (and gather-time projection): the
    survivors are materialized once, post-filter, in their partitioned
    form; each keep mask reaches the device as one index copy."""
    def filt(args):
        h, keep = args

        def build(f):
            g = f.filter_rows(keep)
            if proj is not None:
                g = _project_block(g, proj)
            return g

        with pinned(h) as f:
            return as_handle(build(f), recompute=lambda: build(resolve(h)))

    out = dispatch_blocks(filt, list(zip(blocks, keeps)))
    return PartitionedFrame([[b] for b in out])


def _dedup_finish(pfo: PartitionedFrame, rest) -> PartitionedFrame:
    out = _output_pf(pfo)
    if rest:
        out = out.map_blockwise(lambda b: _run_stages_block(b, rest))
    return out


def _difference(left: PartitionedFrame, right: PartitionedFrame, stats=None,
                pre_l: Sequence[alg.Stage] = (),
                pre_r: Sequence[alg.Stage] = (),
                post: Sequence[alg.Stage] = (),
                grid: str | None = None) -> PartitionedFrame:
    """Ordered anti-join on all columns: left rows whose full-row key appears
    in the right input are dropped; survivors keep left order and labels.
    Both sides' key extraction runs in one pool round, the membership test
    is a host ``np.isin`` over dense ids, and the keep masks filter the left
    blocks in place."""
    if not _block_dedup_enabled():
        return _difference_serial(left, right, stats, pre_l, pre_r, post)
    lblocks = _dedup_grid_blocks(left, grid, "difference")
    rblocks = _dedup_grid_blocks(right, grid, "difference")
    preds, proj, rest = _split_consumer_stages(post)
    items = ([(b, None, pre_l, preds) for b in lblocks]
             + [(b, None, pre_r, ()) for b in rblocks])
    results = dispatch_blocks(_key_block, items)
    frames, mats, pred_keeps = _joint_key_mats(results, None)
    nl = len(lblocks)
    if stats is not None:
        stats.dedup_blocks += len(frames)
        stats.dedup_key_rows += sum(int(m.shape[0]) for m in mats)
    ids = _keys_to_ids(*mats)
    lids, rids = ids[:nl], ids[nl:]
    rset = np.unique(np.concatenate(rids))
    keeps = []
    for lid, pk in zip(lids, pred_keeps[:nl]):
        k = ~np.isin(lid, rset)
        if pk is not None:
            k = k & pk
        keeps.append(k)
    if stats is not None:
        stats.gather_rows += int(sum(int(k.sum()) for k in keeps))
    return _dedup_finish(_apply_keep_blocks(frames[:nl], keeps, proj), rest)


def _drop_duplicates(pf: PartitionedFrame, subset, stats=None,
                     pre: Sequence[alg.Stage] = (),
                     post: Sequence[alg.Stage] = (),
                     grid: str | None = None) -> PartitionedFrame:
    """First-occurrence dedup over the (subset) equality keys,
    block-parallel.  A frame with no key columns has nothing to compare, so
    every row survives (pandas)."""
    if not _block_dedup_enabled():
        return _drop_duplicates_serial(pf, subset, stats, pre, post)
    blocks = _dedup_grid_blocks(pf, grid, "drop_duplicates")
    preds, proj, rest = _split_consumer_stages(post)
    results = dispatch_blocks(_key_block,
                              [(b, subset, pre, preds) for b in blocks])
    frames, mats, pred_keeps = _joint_key_mats(results, subset)
    total = sum(int(m.shape[0]) for m in mats)
    if stats is not None:
        stats.dedup_blocks += len(frames)
        stats.dedup_key_rows += total
    if mats[0].shape[1] == 0:
        keep_global = np.ones(total, dtype=bool)
    else:
        all_ids = np.concatenate(_keys_to_ids(*mats))
        _, first = np.unique(all_ids, return_index=True)
        keep_global = np.zeros(total, dtype=bool)
        keep_global[first] = True
    keeps, off = [], 0
    for m, pk in zip(mats, pred_keeps):
        k = keep_global[off:off + m.shape[0]]
        off += m.shape[0]
        if pk is not None:
            k = k & pk
        keeps.append(k)
    if stats is not None:
        stats.gather_rows += int(sum(int(k.sum()) for k in keeps))
    return _dedup_finish(_apply_keep_blocks(frames, keeps, proj), rest)


def _difference_serial(left: PartitionedFrame, right: PartitionedFrame,
                       stats=None, pre_l=(), pre_r=(), post=()) -> PartitionedFrame:
    """The whole-frame oracle path (``REPRO_BLOCK_DEDUP=0``)."""
    if pre_l:
        left = _run_fused(left, pre_l)
    if pre_r:
        right = _run_fused(right, pre_r)
    lf, rf = left.to_frame().induce(), right.to_frame().induce()
    flags = _wide_int_flags(lf, None) | _wide_int_flags(rf, None)
    lids, rids = _keys_to_ids(_row_keys(lf, None, flags),
                              _row_keys(rf, None, flags))
    keep = ~np.isin(lids, np.unique(rids))
    if stats is not None:
        stats.dedup_blocks += 2
        stats.dedup_key_rows += lf.nrows + rf.nrows
        stats.gather_rows += int(keep.sum())
    out = _output_pf(lf.filter_rows(keep))
    if post:
        out = out.map_blockwise(lambda b: _run_stages_block(b, post))
    return out


def _drop_duplicates_serial(pf: PartitionedFrame, subset, stats=None,
                            pre=(), post=()) -> PartitionedFrame:
    """The whole-frame oracle path (``REPRO_BLOCK_DEDUP=0``)."""
    if pre:
        pf = _run_fused(pf, pre)
    f = pf.to_frame().induce()
    mat = _row_keys(f, subset, _wide_int_flags(f, subset))
    if mat.shape[1] == 0:
        keep = np.ones(f.nrows, dtype=bool)
    else:
        ids = _keys_to_ids(mat)[0]
        _, first = np.unique(ids, return_index=True)
        keep = np.zeros(f.nrows, dtype=bool)
        keep[first] = True
    if stats is not None:
        stats.dedup_blocks += 1
        stats.dedup_key_rows += f.nrows
        stats.gather_rows += int(keep.sum())
    out = _output_pf(f.filter_rows(keep))
    if post:
        out = out.map_blockwise(lambda b: _run_stages_block(b, post))
    return out


# ---- JOIN -------------------------------------------------------------------
def _match_ids(lids: np.ndarray, rids: np.ndarray, how: str):
    """Vectorized equality matching over factorized key ids: left-major,
    right order breaking ties, unmatched-left rows interleaved in place
    (left/outer), unmatched-right rows appended in right order
    (right/outer).  Returns (lidx, ridx, lvalid, rvalid)."""
    nl, nr = int(lids.shape[0]), int(rids.shape[0])
    order_r = np.argsort(rids, kind="stable")
    srids = rids[order_r]
    order_l = np.argsort(lids, kind="stable")
    slids = lids[order_l]
    starts = np.empty(nl, dtype=np.int64)
    ends = np.empty(nl, dtype=np.int64)
    starts[order_l] = np.searchsorted(srids, slids, side="left")
    ends[order_l] = np.searchsorted(srids, slids, side="right")
    counts = (ends - starts).astype(np.int64)
    matched = counts > 0
    if how in ("left", "outer"):
        out_counts = np.where(matched, counts, 1)
    else:
        out_counts = counts
    total = int(out_counts.sum())
    lidx = np.repeat(np.arange(nl, dtype=np.int64), out_counts)
    offs = np.cumsum(out_counts) - out_counts
    within = np.arange(total, dtype=np.int64) - np.repeat(offs, out_counts)
    rvalid = np.repeat(matched, out_counts)
    pos = np.repeat(starts.astype(np.int64), out_counts) + within
    if nr:
        gather = order_r[np.minimum(pos, nr - 1)].astype(np.int64)
    else:
        gather = np.zeros(total, dtype=np.int64)
    ridx = np.where(rvalid, gather, 0)
    lvalid = np.ones(total, dtype=bool)
    if how in ("right", "outer"):
        rpos = np.nonzero(~np.isin(rids, lids))[0].astype(np.int64)
        lidx = np.concatenate([lidx, np.zeros(rpos.shape[0], dtype=np.int64)])
        ridx = np.concatenate([ridx, rpos])
        lvalid = np.concatenate([lvalid,
                                 np.zeros(rpos.shape[0], dtype=bool)])
        rvalid = np.concatenate([rvalid, np.ones(rpos.shape[0], dtype=bool)])
    return lidx, ridx, lvalid, rvalid


def _join_indices(lf: Frame, rf: Frame, params: dict):
    """Build the match indices: (lidx, ridx, lvalid, rvalid, drop_right)."""
    how = params["how"]
    on = params["on"]
    left_on = params["left_on"] or on
    right_on = params["right_on"] or on

    if left_on is None:  # CROSS-PRODUCT: nested order, left outer (Table 1 †)
        ml, mr = lf.nrows, rf.nrows
        lidx = np.repeat(np.arange(ml), mr)
        ridx = np.tile(np.arange(mr), ml)
        return lidx, ridx, None, None, ()

    flags = _wide_int_flags(lf, left_on) | _wide_int_flags(rf, right_on)
    lids, rids = _keys_to_ids(_row_keys(lf, left_on, flags),
                              _row_keys(rf, right_on, flags))
    lidx, ridx, lvalid, rvalid = _match_ids(lids, rids, how)
    drop_right = tuple(right_on) if on is not None else ()
    return lidx, ridx, lvalid, rvalid, drop_right


def _join(left: PartitionedFrame, right: PartitionedFrame, params: dict,
          stats=None) -> PartitionedFrame:
    from . import shuffle as _shuffle
    if _shuffle.enabled():
        return _shuffle.shuffled_join(left, right, params, (), stats)
    return _join_serial(left, right, params, stats)


def _join_serial(left: PartitionedFrame, right: PartitionedFrame, params: dict,
                 stats=None) -> PartitionedFrame:
    """The whole-frame oracle path (``REPRO_SHUFFLE=0``): host match
    indices, device payload gather."""
    lf, rf = left.to_frame().induce(), right.to_frame().induce()
    lidx, ridx, lvalid, rvalid, drop_right = _join_indices(lf, rf, params)
    if stats is not None:
        stats.gather_rows += int(lidx.shape[0])
    out = _assemble_join(lf, rf, lidx, ridx, lvalid, rvalid, drop_right)
    return _output_pf(out)


def _gather_join_cols(lf: Frame, rf: Frame, lidx, ridx, lvalid, rvalid,
                      drop_right, names: Sequence[Any]) -> Frame:
    """Gather only the named columns of the (virtual) join result: the
    predicate's working set, not the payload.  Left columns shadow right
    ones on a name collision, as in ``_assemble_join``'s concat order."""
    lnames = set(lf.col_labels.to_list())
    rnames = {n for n in rf.col_labels.to_list() if n not in drop_right}
    cols, out_names = [], []
    for n in names:
        if n in lnames:
            c, side_valid = lf.col(n).take(lidx), lvalid
        elif n in rnames:
            c, side_valid = rf.col(n).take(ridx), rvalid
        else:
            raise KeyError(n)
        if side_valid is not None and not side_valid.all():
            vm = c.valid_mask() & to_device(side_valid, c.device)
            c = Column(c.data, c.domain, vm, c.dictionary)
        cols.append(c)
        out_names.append(n)
    return Frame(cols, RangeLabels(int(lidx.shape[0])), labels_from_values(out_names),
                 device=lf.device)


def _fused_join(left: PartitionedFrame, right: PartitionedFrame, params: dict,
                stages: Sequence[alg.Stage], stats=None) -> PartitionedFrame:
    from . import shuffle as _shuffle
    if _shuffle.enabled():
        return _shuffle.shuffled_join(left, right, params, stages, stats)
    return _fused_join_serial(left, right, params, stages, stats)


def _fused_join_serial(left: PartitionedFrame, right: PartitionedFrame,
                       params: dict, stages: Sequence[alg.Stage],
                       stats=None) -> PartitionedFrame:
    """Consumer fusion into JOIN: leading structured selections run against
    a gather of only the predicate's columns and filter the (lidx, ridx)
    match indices; the payload gather then builds only the surviving rows
    (and only the projected columns)."""
    lf, rf = left.to_frame().induce(), right.to_frame().induce()
    lidx, ridx, lvalid, rvalid, drop_right = _join_indices(lf, rf, params)
    preds, proj, rest = _split_consumer_stages(stages)
    row_labels = None
    if preds and lidx.shape[0]:
        refs = sorted(frozenset().union(*[p.refs() for p in preds]), key=repr)
        mini = _gather_join_cols(lf, rf, lidx, ridx, lvalid, rvalid,
                                 drop_right, refs)
        keep = host(_fused_selection_mask(preds, mini)).astype(bool)
        # the unfused path filters AFTER the join resets its index: surviving
        # rows keep their position in the unfiltered join result as label
        row_labels = RangeLabels(int(lidx.shape[0])).take(np.nonzero(keep)[0])
        lidx, ridx = lidx[keep], ridx[keep]
        lvalid = lvalid[keep] if lvalid is not None else None
        rvalid = rvalid[keep] if rvalid is not None else None
    if stats is not None:
        stats.gather_rows += int(lidx.shape[0])
    keep_cols = frozenset(proj) if proj is not None else None
    out = _assemble_join(lf, rf, lidx, ridx, lvalid, rvalid, drop_right,
                         keep_cols=keep_cols, row_labels=row_labels)
    if proj is not None:
        out = out.take_cols(out.col_labels.positions_of(proj))
    pfo = _output_pf(out)
    if rest:
        pfo = pfo.map_blockwise(lambda b: _run_stages_block(b, rest))
    return pfo


def _assemble_join(lf: Frame, rf: Frame, lidx, ridx, lvalid, rvalid, drop_right,
                   keep_cols: frozenset | None = None, row_labels=None) -> Frame:
    lsrc = lf
    if keep_cols is not None:
        lsrc = lf.take_cols([j for j, n in enumerate(lf.col_labels.to_list())
                             if n in keep_cols])
    lpart = lsrc.take_rows(lidx)
    keep_r = [j for j, n in enumerate(rf.col_labels.to_list())
              if n not in drop_right and (keep_cols is None or n in keep_cols)]
    rpart = rf.take_cols(keep_r).take_rows(ridx)
    lpart = _mask_all(lpart, lvalid)
    rpart = _mask_all(rpart, rvalid)
    out = lpart.concat_cols(rpart)
    if row_labels is None:
        row_labels = RangeLabels(out.nrows)   # reset index
    return Frame(out.columns, row_labels, out.col_labels, device=out.device)


def _mask_all(frame: Frame, valid: np.ndarray | None) -> Frame:
    if valid is None or valid.all():
        return frame
    vmask = to_device(valid, frame.device)
    cols = [Column(c.data, c.domain, c.valid_mask() & vmask, c.dictionary) for c in frame.columns]
    return Frame(cols, frame.row_labels, frame.col_labels, frame.row_domains,
                 device=frame.device)


# ---- GROUPBY ----------------------------------------------------------------
def _groupby(pf: PartitionedFrame, keys: Sequence[Any], aggs: Sequence[tuple]) -> PartitionedFrame:
    """Row-parallel partial aggregation + tree combine (paper §4.2 Fig. 6).

    groupby(1) is ``keys == ()``: all rows fall into segment 0 and the combine
    is a pure reduction.  The working grid adapts to the pool width at plan
    time (blocks ≈ workers)."""
    rp = preferred_row_parts(pf.row_parts, GRID_PREFS["groupby"],
                             total_bytes=pf.nbytes())
    pf = pf.repartition(row_parts=rp, col_parts=1)
    row_blocks = [row[0].induce() for row in pf.parts]
    return _groupby_blocks(row_blocks, keys, aggs)


def _dense_codes(c: Column, vmin: int) -> torch.Tensor:
    """Group codes ``v - vmin`` on the column's device; nulls → -1.  int32
    arithmetic: valid values lie in [vmin, vmin + 65535], and a null slot's
    wrapped value is replaced."""
    data = c.data if isinstance(c.data, torch.Tensor) else torch.from_numpy(c.data)
    codes = (data - vmin).to(torch.int32)
    if c.mask is not None:
        codes = torch.where(c.mask.to(codes.device), codes, NULL_CODE)
    return codes


def _groupby_blocks(row_blocks: list, keys: Sequence[Any],
                    aggs: Sequence[tuple]) -> PartitionedFrame:
    row_blocks = [resolve(b) for b in row_blocks]
    # ---- dense small-range INT key: no host factorization ------------------
    # (the paper's groupby(n) benchmark shape: "passenger_count"-like keys).
    # codes = v - min, computed per block on the device; empty groups dropped
    # after the combine.
    dense = _dense_int_key(row_blocks, keys) if len(keys) == 1 else None
    if dense is not None:
        vmin, G = dense
        codes_per_block = [_dense_codes(b.col(keys[0]), vmin) for b in row_blocks]
        return _groupby_with_codes(row_blocks, keys, aggs, codes_per_block,
                                   int(G), key_values=[int(vmin) + i for i in range(int(G))],
                                   drop_empty=True)

    # ---- global key factorization (host) -----------------------------------
    if keys:
        flags = np.zeros(len(keys), dtype=bool)
        for b in row_blocks:
            flags |= _wide_int_flags(b, keys)
        key_mats = [_row_keys(b, keys, flags) for b in row_blocks]
        ids_per_block = _keys_to_ids(*key_mats)
        all_ids = np.concatenate(ids_per_block)
        all_keys = np.concatenate(key_mats, axis=0)
        valid_rows = ~np.isnan(all_keys).any(axis=1)  # pandas drops null keys
        valid_idx = np.nonzero(valid_rows)[0]
        uniq_ids, first = np.unique(all_ids[valid_rows], return_index=True)
        first_global = valid_idx[first]
        # decode representative key VALUES so output groups sort
        # lexicographically by value, not by hash/code
        offsets = np.cumsum([0] + [b.nrows for b in row_blocks])

        def decode_row(gidx: int) -> tuple:
            bi = int(np.searchsorted(offsets, gidx, side="right") - 1)
            local = int(gidx - offsets[bi])
            return tuple(row_blocks[bi].col(k).value_at(local) for k in keys)
        rep_vals = [decode_row(int(gi)) for gi in first_global]
        perm = sorted(range(len(rep_vals)), key=lambda i: tuple(
            (str(type(v)), v) if not isinstance(v, (int, float, bool)) else ("num", v)
            for v in rep_vals[i]))
        order = uniq_ids[np.asarray(perm, dtype=np.int64)] if len(perm) else uniq_ids
        rep_sorted = [rep_vals[i] for i in perm]
        G = len(order)
        n_ids = int(all_ids.max()) + 1 if all_ids.size else 0
        remap = np.full(n_ids, NULL_CODE, dtype=np.int32)
        remap[order] = np.arange(G, dtype=np.int32)
        codes_per_block = [to_device(remap[ids] if ids.size else ids.astype(np.int32),
                                     b.device)
                           for ids, b in zip(ids_per_block, row_blocks)]
    else:
        G = 1
        rep_sorted = None
        codes_per_block = [torch.zeros(b.nrows, dtype=torch.int32, device=b.device)
                           for b in row_blocks]
    return _groupby_with_codes(row_blocks, keys, aggs, codes_per_block, G,
                               rep_sorted=rep_sorted)


def _dense_int_key(row_blocks: list[Frame], keys) -> tuple[int, int] | None:
    """(vmin, G) when the single key column is INT with a small value range —
    codes are then ``v - vmin`` with no host factorization.  The span is two
    device reductions per block."""
    try:
        cols = [b.col(keys[0]) for b in row_blocks]
    except KeyError:
        return None
    if any(c.domain is not Domain.INT for c in cols):
        return None
    vmin, vmax = None, None
    for c in cols:
        span = _key_span(c)
        if span is None:
            continue
        lo, hi = span
        vmin = lo if vmin is None else min(vmin, lo)
        vmax = hi if vmax is None else max(vmax, hi)
    if vmin is None:
        return None
    g = vmax - vmin + 1
    if g > 65536:
        return None
    return vmin, g


def _key_span(c: Column) -> tuple[int, int] | None:
    """(min, max) of an INT column's valid values, None when it has none:
    two reductions on the column's device and one copy of the pair."""
    if isinstance(c.data, np.ndarray):
        v = c.data if c.mask is None else c.data[host(c.mask)]
        return (int(v.min()), int(v.max())) if v.size else None
    if c.data.numel() == 0 or (c.mask is not None and not bool(c.mask.any())):
        return None
    if c.mask is None:
        lo, hi = torch.aminmax(c.data)
    else:
        big = torch.iinfo(c.data.dtype)
        lo = torch.where(c.mask, c.data, big.max).min()
        hi = torch.where(c.mask, c.data, big.min).max()
    lo, hi = host(torch.stack([lo, hi])).tolist()
    return int(lo), int(hi)


def _agg_need(aggs) -> list[tuple[Any, str]]:
    """The (column, base-statistic) partial vectors an agg list requires."""
    need: list[tuple[Any, str]] = []
    for col_label, func, _ in aggs:
        for base in _bases_for(func):
            if (col_label, base) not in need:
                need.append((col_label, base))
    return need


_PRESENCE = ("__presence__", "sum")


def _block_partial(block: Frame, codes: torch.Tensor, G: int, need: Sequence[tuple],
                   presence: bool) -> dict:
    """Per-block partial aggregates (``kernels.ops.segment_reduce_multi``):
    null masking, squaring, presence (so empty dense-range slots drop after
    the combine), and one ``segment_reduce`` per reduce op with same-op
    columns batched (M, C)."""
    dev = block.device
    outs = kops.segment_reduce_multi(
        [as_tensor(block.col(col_label).data, dev) for col_label, _ in need],
        [block.col(col_label).mask for col_label, _ in need],
        codes, bases=[base for _, base in need], num_segments=G,
        presence=presence)
    result = {key: outs[i] for i, key in enumerate(need)}
    if presence:
        result[_PRESENCE] = outs[len(need)]
    return result


def _combine_partials(partials: Sequence[dict], want: Sequence[tuple]) -> dict:
    """Combine of per-block partials (G-sized, tiny vs data), in block order."""
    combined: dict[tuple, torch.Tensor] = {}
    for key in want:
        base = key[1]
        parts = [p[key] for p in partials]
        acc = parts[0]
        for nxt in parts[1:]:
            if base in ("sum", "count", "sumsq"):
                acc = acc + nxt
            elif base == "min":
                acc = torch.minimum(acc, nxt)
            else:
                acc = torch.maximum(acc, nxt)
        combined[key] = acc
    return combined


def _groupby_with_codes(row_blocks: list[Frame], keys, aggs, codes_per_block,
                        G: int, rep_sorted=None, key_values=None,
                        drop_empty: bool = False) -> PartitionedFrame:
    need = _agg_need(aggs)

    def block_partial(args) -> dict:
        block, codes = args
        return _block_partial(block, codes, G, need, presence=drop_empty)

    partials = dispatch_blocks(block_partial, list(zip(row_blocks, codes_per_block)))
    want = need + [_PRESENCE] if drop_empty else need
    combined = _combine_partials(partials, want)
    return _finalize_groupby(combined, row_blocks[0] if row_blocks else None,
                             keys, aggs, G, rep_sorted, key_values, drop_empty)


def _finalize_groupby(combined: dict, template: Frame | None, keys, aggs,
                      G: int, rep_sorted=None, key_values=None,
                      drop_empty: bool = False) -> PartitionedFrame:
    # the partials' device, so that a spilled template is not faulted in
    # just to name it
    if combined:
        dev = next(iter(combined.values())).device
    else:
        dev = resolve(template).device if template is not None else torch.device("cpu")
    out_cols: list[Column] = []
    out_names: list[Any] = []
    # key columns first (representative decoded values, sorted order)
    if keys and key_values is not None:      # dense-int fast path
        out_cols.append(_host_column(list(key_values), Domain.INT, dev))
        out_names.append(keys[0])
    elif keys:
        template = resolve(template)
        for kpos, kname in enumerate(keys):
            src = template.col(kname)
            vals = [r[kpos] for r in rep_sorted]
            dom = src.domain if src.domain is not Domain.UNSPECIFIED else None
            out_cols.append(_host_column(vals, dom, dev))
            out_names.append(kname)
    for col_label, func, out_label in aggs:
        cnt = combined.get((col_label, "count"))
        if func == "count":
            vals = cnt
        elif func == "sum":
            vals = combined[(col_label, "sum")]
        elif func == "mean":
            vals = combined[(col_label, "sum")] / torch.clamp(cnt, min=1.0)
        elif func in ("min", "max"):
            vals = combined[(col_label, func)]
        elif func in ("var", "std"):
            s, ss = combined[(col_label, "sum")], combined[(col_label, "sumsq")]
            var = (ss - s * s / torch.clamp(cnt, min=1.0)) / torch.clamp(cnt - 1.0, min=1.0)
            vals = torch.sqrt(torch.clamp(var, min=0.0)) if func == "std" else var
        elif func == "any":
            vals = (combined[(col_label, "max")] > 0).to(torch.float32)
        elif func == "all":
            vals = (combined[(col_label, "min")] > 0).to(torch.float32)
        else:
            raise ValueError(func)
        mask = cnt > 0 if cnt is not None else None
        dom = Domain.INT if func == "count" else (Domain.BOOL if func in ("any", "all") else Domain.FLOAT)
        data = vals.to(torch_dtype(dom))
        out_cols.append(Column(data, dom, mask if func != "count" else None, None))
        out_names.append(out_label)

    frame = Frame(out_cols, RangeLabels(G), labels_from_values(out_names), device=dev)
    if drop_empty:
        frame = frame.filter_rows(combined[_PRESENCE] > 0)
    return _output_pf(frame)


def _bases_for(func: str) -> tuple[str, ...]:
    return {
        "sum": ("sum", "count"), "count": ("count",), "mean": ("sum", "count"),
        "min": ("min", "count"), "max": ("max", "count"),
        "var": ("sum", "sumsq", "count"), "std": ("sum", "sumsq", "count"),
        "any": ("max", "count"), "all": ("min", "count"),
    }[func]


def _host_column(values: list, domain: Domain | None, device) -> Column:
    """A column from host values on ``device``.  Decoded INT keys beyond
    int32 stay an exact int64 HOST column (int32 storage would wrap them)."""
    if domain is Domain.INT:
        ints = [int(v) for v in values if v is not None]
        if ints and not all(-2 ** 31 <= v < 2 ** 31 for v in ints):
            data = np.asarray([0 if v is None else int(v) for v in values],
                              dtype=np.int64)
            mask = np.asarray([v is not None for v in values])
            return Column(data, Domain.INT,
                          None if mask.all() else torch.from_numpy(mask), None)
    p = parse_column(values, domain, device=device)
    return Column(p.data, p.domain, p.mask, p.dictionary)


# ---- FUSED GROUPBY: producer chain inside the partial-aggregation program ----
def _fused_groupby(pf: PartitionedFrame, stages: Sequence[alg.Stage],
                   keys: Sequence[Any], aggs: Sequence[tuple],
                   grid: str | None = None) -> PartitionedFrame:
    """Producer fusion into GROUPBY: the row-local chain runs inside the
    groupby's own per-block programs.  Pass A (one dispatch per partition)
    stages the block and reads its key span; the spans agree on one global
    dense range, and pass B (one dispatch per partition) computes the codes
    against it on the device and every partial in one
    ``kernels.ops.segment_reduce_multi`` call (``segment_reduce`` on the
    card).  Keys that don't qualify (non-INT, multi-key, range > 65536) take
    ``_groupby_blocks`` over the staged blocks."""
    pf1 = pf.repartition(col_parts=1)
    blocks = [row[0] for row in pf1.handles]
    single_key = len(keys) == 1

    def stage_block(block):
        with pinned(block) as src:
            f = _run_stages_block(src, stages).induce()
            info = None
            if single_key:
                try:
                    c = f.col(keys[0])
                except KeyError:
                    c = None
                if c is not None and c.domain is Domain.INT:
                    info = _key_span(c) or "empty"
            hout = block if f is src else as_handle(
                f, recompute=lambda: _run_stages_block(
                    resolve(block), stages).induce())
        return hout, info

    results = dispatch_blocks(stage_block, blocks)
    staged = [r[0] for r in results]
    infos = [r[1] for r in results]

    # stage first, regrid second: the unfused GROUPBY receives exactly this
    # staged block sequence as its input and makes the same regroup
    # decision, so both compute partials over the same row groupings (key
    # spans are global min / max, which regrouping cannot change)
    rp = preferred_row_parts(len(staged), grid or GRID_PREFS["fused_groupby"],
                             total_bytes=sum(h.nbytes for h in staged))
    if rp != len(staged):
        staged = [row[0] for row in
                  PartitionedFrame([[b] for b in staged])
                  .repartition(row_parts=rp).handles]

    spans = [i for i in infos if isinstance(i, tuple)]
    if single_key and spans and all(i is not None for i in infos):
        gmin = min(i[0] for i in spans)
        G = max(i[1] for i in spans) - gmin + 1
        if G <= 65536:
            need = _agg_need(aggs)

            def partial_block(block) -> dict:
                with pinned(block) as f:
                    return _block_partial(f, _dense_codes(f.col(keys[0]), gmin),
                                          G, need, presence=True)

            partials = dispatch_blocks(partial_block, staged)
            combined = _combine_partials(partials, need + [_PRESENCE])
            return _finalize_groupby(combined, staged[0], keys, aggs, G,
                                     key_values=[gmin + i for i in range(G)],
                                     drop_empty=True)
    return _groupby_blocks(staged, keys, aggs)


# ---- SORT ---------------------------------------------------------------
def _sort_perm(f: Frame, by: Sequence[Any], ascending: bool) -> np.ndarray:
    """The sort permutation: position i of the result comes from row idx[i]."""
    key_cols = []
    for v in _sort_rank_keys(f, by):
        # nulls (NaN) sort last regardless of direction
        v = np.where(np.isnan(v), np.inf if ascending else -np.inf, v)
        key_cols.append(v)
    if ascending:
        return np.lexsort(tuple(reversed(key_cols)))   # stable; first key primary
    return np.lexsort(tuple(-k for k in reversed(key_cols)))


def _sort(pf: PartitionedFrame, by: Sequence[Any], ascending: bool,
          stats=None) -> PartitionedFrame:
    from . import shuffle as _shuffle
    if _shuffle.enabled() and len(by):
        return _shuffle.shuffled_sort(pf, by, ascending, (), stats)
    return _sort_serial(pf, by, ascending, stats)


def _sort_serial(pf: PartitionedFrame, by: Sequence[Any], ascending: bool,
                 stats=None) -> PartitionedFrame:
    """The whole-frame oracle path (``REPRO_SHUFFLE=0``; also empty ``by``,
    which must raise exactly like ``np.lexsort(())``)."""
    f = pf.to_frame().induce()
    idx = _sort_perm(f, by, ascending)
    if stats is not None:
        stats.gather_rows += int(idx.shape[0])
    return _output_pf(f.take_rows(idx))


def _split_consumer_stages(stages: Sequence[alg.Stage]):
    """Split a consumer chain into (pushable predicates, gather projection,
    remaining stages).  Leading structured-``Expr`` selections are evaluated
    against the pre-gather frame (row-local predicates are permutation-
    invariant) and filter the gather index; an immediately following
    projection prunes the gathered columns.  Everything after the first
    MAP/RENAME (value/name changes) runs post-gather."""
    preds: list[alg.Expr] = []
    i = 0
    while (i < len(stages) and stages[i].op == "selection"
           and isinstance(stages[i].params["predicate"], alg.Expr)):
        preds.append(stages[i].params["predicate"])
        i += 1
    proj = None
    if i < len(stages) and stages[i].op == "projection":
        proj = stages[i].params["cols"]
        i += 1
    return preds, proj, stages[i:]


def _fused_sort(pf: PartitionedFrame, by: Sequence[Any], ascending: bool,
                stages: Sequence[alg.Stage], stats=None,
                grid: str | None = None) -> PartitionedFrame:
    from . import shuffle as _shuffle
    if _shuffle.enabled() and len(by):
        return _shuffle.shuffled_sort(pf, by, ascending, stages, stats,
                                      grid=grid)
    return _fused_sort_serial(pf, by, ascending, stages, stats)


def _fused_sort_serial(pf: PartitionedFrame, by: Sequence[Any],
                       ascending: bool, stages: Sequence[alg.Stage],
                       stats=None) -> PartitionedFrame:
    """Consumer fusion into SORT: selections filter the permutation index
    before the payload gather, so the materialized frame is built once,
    post-filter, instead of gathered-then-filtered."""
    f = pf.to_frame().induce()
    idx = _sort_perm(f, by, ascending)
    preds, proj, rest = _split_consumer_stages(stages)
    if preds:
        # evaluated on the unsorted frame (row-local, so permutation-
        # invariant): no gather happens before the filter
        keep = host(_fused_selection_mask(preds, f)).astype(bool)
        idx = idx[keep[idx]]
    g = f.take_cols(f.col_labels.positions_of(proj)) if proj is not None else f
    if stats is not None:
        stats.gather_rows += int(idx.shape[0])
    out = _output_pf(g.take_rows(idx))
    if rest:
        out = out.map_blockwise(lambda b: _run_stages_block(b, rest))
    return out


# ---- WINDOW -------------------------------------------------------------
def _window_targets(frame: Frame, cols) -> list:
    if cols:
        return list(cols)
    return [n for n, c in zip(frame.col_labels.to_list(), frame.columns)
            if c.domain.is_numeric]


def _window(pf: PartitionedFrame, func: str, cols, size, periods,
            pre: Sequence[alg.Stage] = (), post: Sequence[alg.Stage] = (),
            grid: str | None = None) -> PartitionedFrame:
    """WINDOW over a row grid adapted to the pool width ("few_seams": every
    partition boundary costs a carry composition or a halo build).  The
    running functions are a blocked scan (``kernels.ops.window_scan``) with
    a cross-block carry; diff/shift read a halo of the rows before each
    block; rolling(w) is cumsum − shift(cumsum, w).

    FUSED_WINDOW's ``pre`` stages run in the same per-block program as the
    local scan, its ``post`` stages in the carry-application program, with
    the carry combine between them where the unfused path places it.
    Row-dropping pre-stages are staged on the incoming grid before a
    regroup, as the unfused plan filters per incoming block and regrids the
    filtered result: that keeps the seams, and so the carries, identical."""
    rp = preferred_row_parts(pf.row_parts, grid or GRID_PREFS["window"],
                             total_bytes=pf.nbytes())
    if rp != pf.row_parts and any(st.op == "selection" for st in pre):
        pf = pf.repartition(col_parts=1).map_blockwise(
            lambda b: _run_stages_block(b, pre))
        pre = ()
    pf = pf.repartition(row_parts=rp, col_parts=1)

    if func in ("cumsum", "cummax", "cummin", "cumprod"):
        return _window_scan_blocks(pf, func, cols, pre, post)

    # the halo and rolling paths need the staged blocks before the halo
    # tails are built; the producer chain still runs as one pool round
    if pre:
        pf = pf.map_blockwise(lambda b: _run_stages_block(b, pre))
    template = pf.parts[0][0].induce()
    targets = _window_targets(template, cols)
    if func in ("diff", "shift"):
        return _window_halo(pf, func, targets, periods, post)
    if func in ("rolling_sum", "rolling_mean"):
        assert size is not None, "rolling window requires size"
        # rolling(w) = cumsum − shift(cumsum, w); first w−1 rows are null
        csum = _window_scan_blocks(pf, "cumsum", targets)
        shifted = _window_halo(csum, "shift", targets, size)
        out = _rolling_combine(csum, shifted, targets, size,
                               mean=(func == "rolling_mean"))
        if post:
            out = out.map_blockwise(lambda b: _run_stages_block(b, post))
        return out
    raise ValueError(func)


def _apply_cols(frame: Frame, targets, fn: Callable[[Column], Column]) -> Frame:
    cols = list(frame.columns)
    names = frame.col_labels.to_list()
    for j, n in enumerate(names):
        if n in targets:
            cols[j] = fn(cols[j])
    return Frame(cols, frame.row_labels, frame.col_labels, frame.row_domains,
                 device=frame.device)


def _carry_combine(func: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if func == "cumsum":
        return a + b
    if func == "cummax":
        return torch.maximum(a, b)
    if func == "cummin":
        return torch.minimum(a, b)
    return a * b   # cumprod


def _window_scan_blocks(pf: PartitionedFrame, func: str, cols,
                        pre: Sequence[alg.Stage] = (),
                        post: Sequence[alg.Stage] = ()) -> PartitionedFrame:
    """Blocked scan with cross-block carry composition, in two parallel
    per-block passes: (pre-stages + local scan + block total), then an
    exclusive combine of the totals in block order, then (carry application
    + post-stages).  Totals are 0-d tensors on the blocks' device, combined
    there: no host sync per block.  cumprod runs through the same kernel,
    so every scan on the card is bit-identical from run to run."""
    blocks = [row[0] for row in pf.handles]

    def local(block):
        def build(src):
            f = _run_stages_block(src, pre).induce() if pre else src.induce()
            dev = f.device

            def scan_col(c: Column) -> Column:
                v = torch.where(c.valid_mask().to(dev),
                                as_tensor(c.data, dev).to(torch.float32),
                                _scan_identity(func))
                return Column(kops.window_scan(v, func), Domain.FLOAT, c.mask, None)

            targets = _window_targets(f, cols)
            return _apply_cols(f, targets, scan_col), targets

        with pinned(block) as src:
            scanned, targets = build(src)
            # a copy, not a view: a view would keep the whole scanned
            # column on the device after the block spills
            totals = ({n: scanned.col(n).data[-1].clone() for n in targets}
                      if scanned.nrows else {})
            return (as_handle(scanned,
                              recompute=lambda: build(resolve(block))[0]),
                    totals, targets)

    locals_ = dispatch_blocks(local, blocks)

    # exclusive combine of block totals → per-block carries (device, tiny)
    carries: list[dict] = []
    acc: dict[Any, torch.Tensor] = {}
    for _scanned, totals, _targets in locals_:
        carries.append(dict(acc))
        for n, t in totals.items():
            acc[n] = t if n not in acc else _carry_combine(func, acc[n], t)

    if not post and not any(carries):
        return PartitionedFrame([[item[0]] for item in locals_])

    def apply(args):
        (block, _totals, targets), carry = args

        def build(scanned):
            if carry:
                cols_ = list(scanned.columns)
                names = scanned.col_labels.to_list()
                for j, n in enumerate(names):
                    if n in targets and n in carry:
                        v = _carry_combine(func, cols_[j].data, carry[n])
                        cols_[j] = Column(v, cols_[j].domain, cols_[j].mask, None)
                scanned = Frame(cols_, scanned.row_labels, scanned.col_labels,
                                scanned.row_domains, device=scanned.device)
            return _run_stages_block(scanned, post) if post else scanned

        with pinned(block) as scanned:
            out = build(scanned)
            return block if out is scanned else as_handle(
                out, recompute=lambda: build(resolve(block)))

    out = dispatch_blocks(apply, list(zip(locals_, carries)))
    return PartitionedFrame([[b] for b in out])


def _scan_identity(func: str) -> float:
    return {"cumsum": 0.0, "cummax": -float("inf"), "cummin": float("inf"),
            "cumprod": 1.0}[func]


def _window_halo(pf: PartitionedFrame, func: str, targets, periods: int,
                 post: Sequence[alg.Stage] = ()) -> PartitionedFrame:
    """diff/shift via a ``periods``-row halo — the running tail of everything
    before the block (a single block may be shorter than ``periods``).
    ``post`` stages run inside the same per-block program."""
    blocks = [row[0] for row in pf.handles]

    # round 1 (parallel): induce each block once and take its tail — the
    # only rows that can ever reach a later block's halo
    def prep(h):
        with pinned(h) as raw:
            f = raw.induce()
            return (h if f is raw
                    else as_handle(f,
                                   recompute=lambda: resolve(h).induce())), \
                f.tail(periods)

    prepped = dispatch_blocks(prep, blocks)

    # serial compose of the small tails → per-block running halos (a block's
    # rows beyond its last ``periods`` can never appear in any halo, so
    # composing tails is exact)
    halos: list[Frame | None] = [None]
    running: Frame | None = None
    for _h, tail in prepped[:-1]:
        running = tail if running is None else (
            running.concat_rows(tail).tail(periods))
        halos.append(running)

    def local(args):
        (blk, _tail), halo = args
        with pinned(blk) as f:
            return as_handle(_halo_block(f, halo),
                             recompute=lambda: _halo_block(resolve(blk), halo))

    def _halo_block(block: Frame, halo: Frame | None) -> Frame:
        ext = halo.concat_rows(block) if halo is not None else block
        pad = ext.nrows - block.nrows
        dev = ext.device

        def do(c_name) -> Column:
            c = ext.col(c_name)
            v = as_tensor(c.data, dev).to(torch.float32)
            valid = c.valid_mask().to(dev)
            prev = torch.roll(v, periods)
            prev_valid = torch.roll(valid, periods)
            in_range = torch.arange(ext.nrows, device=dev) >= periods
            if func == "diff":
                out = v - prev
                mask = valid & prev_valid & in_range
            else:  # shift
                out = prev
                mask = prev_valid & in_range
            return Column(out[pad:], Domain.FLOAT, mask[pad:], None)

        cols = list(block.columns)
        names = block.col_labels.to_list()
        for j, n in enumerate(names):
            if n in targets:
                cols[j] = do(n)
        got = Frame(cols, block.row_labels, block.col_labels, block.row_domains,
                    device=block.device)
        return _run_stages_block(got, post) if post else got

    out = dispatch_blocks(local, list(zip(prepped, halos)))
    return PartitionedFrame([[b] for b in out])


def _rolling_combine(csum: PartitionedFrame, shifted: PartitionedFrame, targets,
                     size: int, mean: bool) -> PartitionedFrame:
    rows = []
    offset = 0
    for (crow, srow) in zip(csum.parts, shifted.parts):
        cb, sb = crow[0], srow[0]
        cols = list(cb.columns)
        names = cb.col_labels.to_list()
        rowpos = torch.arange(cb.nrows, device=cb.device) + offset
        full = rowpos >= size - 1
        for j, n in enumerate(names):
            if n in targets:
                c, s = cb.col(n), sb.col(n)
                base = torch.where(s.valid_mask(), s.data, 0.0)
                out = c.data - base
                if mean:
                    out = out / size
                cols[j] = Column(out, Domain.FLOAT, c.valid_mask() & full, None)
        rows.append([Frame(cols, cb.row_labels, cb.col_labels, device=cb.device)])
        offset += cb.nrows
    return PartitionedFrame(rows)


# ---- TRANSPOSE ----------------------------------------------------------
def _transpose(pf: PartitionedFrame) -> PartitionedFrame:
    """Grid transpose: per-block kernel transpose + grid metadata swap."""
    def block_t(frame: Frame) -> Frame:
        # No induction: coded-ness is decidable from declared domains, and
        # UNSPECIFIED columns (a prior transpose's output) are numeric storage
        # whose logical schema is recovered via row_domains downstream.
        f = frame
        tgt = common_storage(f.schema)
        if tgt.is_coded:
            return _transpose_coded(f.induce())
        mat, dom = f.as_matrix(tgt if tgt is not Domain.UNSPECIFIED else Domain.FLOAT)
        out = kops.transpose(mat)
        out_mask = None
        if any(c.mask is not None for c in f.columns):
            mm = torch.stack([c.valid_mask() for c in f.columns], dim=1)
            out_mask = kops.transpose(mm)
        # second-transpose schema recovery (paper §3.3): the child's recorded
        # row-type vector gives the output schema without re-running S(·)
        rec = f.row_domains if (f.row_domains is not None
                                and len(f.row_domains) == f.nrows) else None
        # wide output ("billions of columns", paper §4.2): every new column
        # is a strided view of the one transposed matrix, made in one call
        datas = out.unbind(1)
        masks = out_mask.unbind(1) if out_mask is not None else None
        new_cols = []
        for i in range(f.nrows):
            dom = rec[i] if rec is not None else Domain.UNSPECIFIED
            data = datas[i]
            if rec is not None:
                data = data.to(torch_dtype(dom))
            new_cols.append(Column(data, dom, None if masks is None else masks[i], None))
        return Frame(new_cols, f.col_labels, f.row_labels, row_domains=f.schema,
                     device=f.device)

    return pf.transpose_grid(block_t)


def _transpose_coded(f: Frame) -> Frame:
    """Heterogeneous/string transpose: host re-encode (paper: coerce to
    Object; schema induction recovers on a second transpose)."""
    records = f.to_records()
    rec = f.row_domains if (f.row_domains is not None
                            and len(f.row_domains) == f.nrows) else None
    dev = f.device
    new_cols = []
    for i in range(f.nrows):
        vals = [records[i][j] for j in range(f.ncols)]
        if rec is not None:
            new_cols.append(_host_column(vals, rec[i], dev))
        else:
            new_cols.append(_host_column(
                [None if v is None else str(v) for v in vals], Domain.STR, dev))
    return Frame(new_cols, f.col_labels, f.row_labels, row_domains=f.schema,
                 device=dev)


# ---- MAP ------------------------------------------------------------------
def _apply_udf_block(frame: Frame, udf: alg.Udf) -> Frame:
    """Run a Udf over one block.  UDFs see torch tensors."""
    f = frame.induce()
    cols_in = {n: c for n, c in zip(f.col_labels.to_list(), f.columns)}
    out = udf.fn(cols_in, f)
    if isinstance(out, Frame):
        return out
    # dict {label: Column | array | (array, mask)} preserving row count
    dev = f.device
    names, cols = [], []
    for name, v in out.items():
        names.append(name)
        if isinstance(v, Column):
            cols.append(v)
        elif isinstance(v, tuple):
            data, mask = v
            data = as_tensor(data, dev)
            cols.append(Column(data, infer_domain(data),
                               None if mask is None else as_tensor(mask, dev), None))
        else:
            arr = as_tensor(v, dev)
            cols.append(Column(arr, infer_domain(arr), None, None))
    return Frame(cols, f.row_labels, labels_from_values(names), device=dev)


def _map(pf: PartitionedFrame, udf: alg.Udf) -> PartitionedFrame:
    if udf.elementwise:
        return pf.repartition(col_parts=1).map_blockwise(
            lambda f: _apply_udf_block(f, udf))
    return PartitionedFrame.from_frame(_apply_udf_block(pf.to_frame(), udf))


# ---- label movement ---------------------------------------------------------
def _to_labels(pf: PartitionedFrame, column: Any) -> PartitionedFrame:
    def conv(frame: Frame) -> Frame:
        f = frame.induce()
        j = f.col_labels.position_of(column)
        c = f.columns[j]
        labels = labels_from_values(c.to_pylist(), c.domain)
        keep = [x for x in range(f.ncols) if x != j]
        g = f.take_cols(keep)
        return Frame(g.columns, labels, g.col_labels, device=g.device)
    return pf.repartition(col_parts=1).map_blockwise(conv)


def _from_labels(pf: PartitionedFrame, label: Any) -> PartitionedFrame:
    pf = pf.repartition(col_parts=1)
    offsets = pf.row_block_offsets()

    def conv(args):
        (block, start) = args

        def build(f):
            vals = f.row_labels.to_list()
            c = _host_column(vals, Domain.INT if isinstance(f.row_labels, (RangeLabels, IntLabels))
                             else None, f.device)
            return Frame([c] + list(f.columns),
                         RangeLabels(f.nrows, start),
                         labels_from_values([label]).concat(f.col_labels),
                         device=f.device)

        with pinned(block) as f:
            return as_handle(build(f), recompute=lambda: build(resolve(block)))

    out = dispatch_blocks(conv, [(row[0], offsets[i])
                                 for i, row in enumerate(pf.handles)])
    return PartitionedFrame([[b] for b in out])


def _rename_block(frame: Frame, mapping: dict) -> Frame:
    names = [mapping.get(n, n) for n in frame.col_labels.to_list()]
    return Frame(frame.columns, frame.row_labels, labels_from_values(names),
                 frame.row_domains, device=frame.device)


def _rename(pf: PartitionedFrame, mapping_items) -> PartitionedFrame:
    mapping = dict(mapping_items)
    return pf.map_blockwise(lambda frame: _rename_block(frame, mapping))


def _limit(pf: PartitionedFrame, k: int, tail: bool) -> PartitionedFrame:
    # Touch only the row blocks the prefix/suffix needs (§6.1.2).
    if not tail:
        f = pf.prefix(k).to_frame()
        return PartitionedFrame.from_frame(f.head(k))
    need, keep = k, []
    for i in range(pf.row_parts - 1, -1, -1):
        keep.insert(0, pf.handles[i])
        need -= pf.handles[i][0].nrows
        if need <= 0:
            break
    f = PartitionedFrame(keep).to_frame()
    return PartitionedFrame.from_frame(f.tail(k))


# ---- rewrite targets: column-space ops without any TRANSPOSE (paper §5) ------
def _key_rows_matrix(pf: PartitionedFrame, row_names: Sequence[Any]) -> np.ndarray:
    """(len(row_names), ncols) float64 matrix of the named rows' values."""
    pf1 = pf.repartition(col_parts=1)
    rows = []
    for name in row_names:
        found = None
        for bi, row in enumerate(pf1.parts):
            try:
                local = row[0].row_labels.position_of(name)
                found = (bi, local)
                break
            except KeyError:
                continue
        if found is None:
            raise KeyError(name)
        bi, local = found
        one = pf1.parts[bi][0].take_rows(np.asarray([local]))
        rows.append(_row_keys(one.induce(), None)[0])
    return np.stack(rows, axis=0)


def _column_sort(pf: PartitionedFrame, by: Sequence[Any], ascending: bool) -> PartitionedFrame:
    keys = _key_rows_matrix(pf, by)                       # (K, n)
    if ascending:
        perm = np.lexsort(tuple(reversed([k for k in keys])))
    else:
        perm = np.lexsort(tuple(reversed([-k for k in keys])))
    pf1 = pf.repartition(col_parts=1)
    return pf1.map_blockwise(lambda f: f.take_cols(perm.tolist()))


def _column_filter(pf: PartitionedFrame, predicate: alg.Expr) -> PartitionedFrame:
    refs = sorted(predicate.refs(), key=repr)
    keys = _key_rows_matrix(pf, refs)                     # (K, n)
    n = keys.shape[1]
    dev = pf.parts[0][0].device
    temp = Frame(
        [Column(to_device(keys[i].astype(np.float32), dev), Domain.FLOAT)
         for i in range(len(refs))],
        RangeLabels(n),
        labels_from_values(list(refs)),
        device=dev,
    )
    keep = host(_predicate_mask(temp, predicate))
    idx = np.nonzero(keep)[0].tolist()
    pf1 = pf.repartition(col_parts=1)
    return pf1.map_blockwise(lambda f: f.take_cols(idx))


# =============================================================================
# FUSED PIPELINE (paper §5): one per-block program for a row-local chain
# =============================================================================
def _eval_expr_env(expr: alg.Expr, env: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """``eval_expr`` over a plain {name: (values, mask)} environment: the
    entry of compiled predicate programs (no Frame objects, no coded
    columns; callers gate on that).  Same interpreter core as ``eval_expr``,
    so fused and unfused predicates cannot diverge.  Literals are made like
    the first column (``full_like``), so a traced program holds no row
    count and serves every block size."""
    ref = next(iter(env.values()))[0]

    def lit(value):
        return (torch.full_like(ref, value, dtype=_lit_dtype(value)),
                torch.ones_like(ref, dtype=torch.bool))

    return _eval_expr_core(expr, env.__getitem__, ref.shape[0], ref.device, lit=lit)


# Compiled programs.  ``REPRO_JIT_UDFS`` (``_jit_udfs_enabled``) runs a run
# of structured predicates, or of elementwise MAP stages, as ONE compiled
# program a block: the chain is traced on fake tensors (``make_fx``: the
# frame and label plumbing runs as Python, the tensor operations become one
# graph), and the graph is compiled by ``torch.compile(fullgraph=True)`` on
# inductor (Triton kernels on the card, C++ on the CPU) with dynamic sizes,
# so one program serves every block size.  The first block through a chain
# runs both eagerly and compiled; the program is adopted only if it
# reproduces the eager result bit for bit, else (or where it fails to
# trace or compile) the chain's entry is None and the chain stays eager.
# Both caches are bounded FIFOs keyed by the chain's structure, the
# columns' storage and the device: predicates with varying literals each
# get a distinct key.  The locks guard the lookups only; a probe traces and
# compiles outside them, and the pool's other threads run the chain eagerly
# while one probes it (its entry is ``_JIT_PROBING`` meanwhile).
#
# Tracing (``make_fx``, and inductor's own tracing inside a compile) sets
# one flag for the whole process, and a compiled program that starts in any
# thread while it is set raises.  So a probe holds ``_GATE`` alone, and a
# compiled program runs under it shared where no probe holds it or waits
# for it; where one does (or the program meets the flag: a recompile in
# another thread), the block runs eagerly, which the probe made bit-equal.
# A block never waits for a compile.
_JIT_MISS = object()
_JIT_PROBING = object()
_PRED_JIT: dict[tuple, Callable | None] = {}
_PRED_JIT_LOCK = threading.Lock()
_PRED_JIT_MAX = 256
_MAP_JIT: dict[tuple, tuple | None] = {}
_MAP_JIT_LOCK = threading.Lock()
_MAP_JIT_MAX = 128
_MAP_JIT_MISS = _JIT_MISS
_JIT_LOG_MAX = 64
_JIT_STATS_LOCK = threading.Lock()
_JIT_STATS: dict = {}


def reset_jit_stats() -> None:
    """Zero the counts of ``jit_stats``."""
    with _JIT_STATS_LOCK:
        _JIT_STATS.clear()
        _JIT_STATS.update(adopted={"map": 0, "predicate": 0}, rejected={},
                          compile_s=0.0, eager_blocks=0, chains=[])


reset_jit_stats()


def jit_stats() -> dict:
    """The compiled-program probes since the last reset: chains adopted by
    kind, chains rejected by reason ("trace error", "traces differ",
    "compile error", "bits differ", "failed after adoption"), the seconds
    the probes' compiled first calls took (compiles included), the blocks
    of adopted chains that ran eagerly because a probe was tracing or
    compiling, and the last 64 outcomes as (kind, chain, outcome)."""
    with _JIT_STATS_LOCK:
        return {"adopted": dict(_JIT_STATS["adopted"]),
                "rejected": dict(_JIT_STATS["rejected"]),
                "compile_s": _JIT_STATS["compile_s"],
                "eager_blocks": _JIT_STATS["eager_blocks"],
                "chains": list(_JIT_STATS["chains"])}


def _jit_note(kind: str, name: str, outcome: str, seconds: float = 0.0) -> None:
    with _JIT_STATS_LOCK:
        if outcome == "adopted":
            _JIT_STATS["adopted"][kind] += 1
        else:
            _JIT_STATS["rejected"][outcome] = _JIT_STATS["rejected"].get(outcome, 0) + 1
        _JIT_STATS["compile_s"] += seconds
        _JIT_STATS["chains"].append((kind, name, outcome))
        del _JIT_STATS["chains"][:-_JIT_LOG_MAX]


def _fifo_set(cache: dict, cap: int, key, entry) -> None:
    """``cache[key] = entry``, the oldest entries evicted to keep ``cap``
    (the caller holds the cache's lock)."""
    if key not in cache:
        while len(cache) >= cap:
            cache.pop(next(iter(cache)))
    cache[key] = entry


def _jit_put(cache: dict, lock, cap: int, key, entry) -> None:
    with lock:
        _fifo_set(cache, cap, key, entry)


def _jit_lookup(cache: dict, lock, cap: int, key, claim: bool):
    """``cache``'s entry for ``key``; where it has none and ``claim``, the
    key is marked as being probed (``_JIT_PROBING``: the caller probes it)
    and ``_JIT_MISS`` comes back."""
    with lock:
        entry = cache.get(key, _JIT_MISS)
        if entry is _JIT_MISS and claim:
            _fifo_set(cache, cap, key, _JIT_PROBING)
        return entry


def _jit_release(cache: dict, lock, key) -> None:
    """Drop a probe's claim on ``key`` (its eager run raised)."""
    with lock:
        if cache.get(key) is _JIT_PROBING:
            del cache[key]


class _ProgramGate:
    """Many holders at once (``shared``: compiled programs running) or one
    alone (``alone``: a probe tracing and compiling).  ``shared`` never
    waits: it yields False where a probe holds the gate or waits for it
    (the caller then runs its block eagerly), so probes are not starved and
    blocks do not stall behind a compile."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._shared = 0
        self._alone = False
        self._waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cv:
            held = not (self._alone or self._waiting)
            self._shared += held
        try:
            yield held
        finally:
            if held:
                with self._cv:
                    self._shared -= 1
                    self._cv.notify_all()

    @contextlib.contextmanager
    def alone(self):
        with self._cv:
            self._waiting += 1
            while self._alone or self._shared:
                self._cv.wait()
            self._waiting -= 1
            self._alone = True
        try:
            yield
        finally:
            with self._cv:
                self._alone = False
                self._cv.notify_all()


_GATE = _ProgramGate()


def _nested_trace(e: BaseException) -> bool:
    """The error a compiled program raises where it starts while another
    thread traces (the process-wide FX flag set)."""
    return isinstance(e, RuntimeError) and "symbolically trace a dynamo-optimized" in str(e)


def _compiler_error(e: BaseException) -> bool:
    """A failure of dynamo or inductor (a recompile refused or over the
    recompile limit), as against a fault of the device or of memory."""
    from torch._dynamo import exc
    kinds = tuple(getattr(exc, k) for k in ("TorchDynamoException", "FailOnRecompileLimitHit")
                  if hasattr(exc, k))
    return isinstance(e, kinds)


def _run_program(fn: Callable, args: Sequence[torch.Tensor]):
    """An adopted program's outputs on ``args``, or None where the block is
    to run eagerly: a probe holds or waits for the gate, or the program met
    the tracing flag of another thread (counted in ``jit_stats``'s
    ``eager_blocks``).  Other errors propagate."""
    with _GATE.shared() as held:
        if held:
            try:
                return fn(*args)
            except RuntimeError as e:
                if not _nested_trace(e):
                    raise
    with _JIT_STATS_LOCK:
        _JIT_STATS["eager_blocks"] += 1
    return None


def _jit_udfs_enabled(device=None) -> bool:
    """``REPRO_JIT_UDFS``: ``0`` runs map and predicate runs eagerly
    everywhere, any other non-empty value compiles them everywhere; unset,
    the block's device decides: compiled on a CUDA block, eager on a CPU
    block (the counterpart of the reference's ``jax.default_backend() !=
    "cpu"``: on the CPU the eager path is the tuned one, and an inductor
    compile costs seconds)."""
    flag = os.environ.get("REPRO_JIT_UDFS", "")
    if flag == "0":
        return False
    if flag:
        return True
    return device is not None and torch.device(device).type == "cuda"


class _TraceError(Exception):
    """A chain that cannot become one program (its reason in ``args[0]``)."""


def _trace_program(fn: Callable, example: Sequence[torch.Tensor]):
    """``fn(*tensors)`` as one graph of tensor operations, traced on fake
    tensors shaped like ``example`` (``make_fx``): the Python around the
    tensors (frames, labels, the UDFs' own code) runs at trace time.  Traced
    once more one row longer: a graph that differs is refused, since a
    program must serve every block size (a UDF that made a tensor of the
    block's length, or whose Python gives another graph each call)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    n = example[0].shape[0]
    try:
        gm = make_fx(fn, tracing_mode="fake")(*example)
        longer = [torch.empty((n + 1,), dtype=t.dtype, device=t.device) for t in example]
        again = make_fx(fn, tracing_mode="fake")(*longer)
    except Exception as e:   # data-dependent Python, host numpy, .tolist(), ...
        raise _TraceError("trace error") from e
    if gm.code != again.code:
        raise _TraceError("traces differ")
    return gm


def _eager_numerics() -> dict:
    """Inductor settings that keep eager's rounding where this torch has
    them: ``emulate_precision_casts`` (which also turns off Triton's fusion
    of a multiply and an add into one FMA) and, on the card, denormals kept
    as eager keeps them."""
    from torch._inductor import config
    have = config.get_config_copy()
    want = {"emulate_precision_casts": True, "eager_numerics.disable_ftz": True}
    return {k: v for k, v in want.items() if k in have}


def _compile_program(gm):
    """The traced graph compiled: ``torch.compile(fullgraph=True)`` on
    inductor, sizes dynamic."""
    return torch.compile(gm, fullgraph=True, dynamic=True, options=_eager_numerics())


def _probe(kind: str, name: str, trace: Callable, args: Sequence[torch.Tensor],
           same: Callable):
    """Trace and compile a chain's program, run it on ``args`` and hold its
    outputs to the eager result with ``same(outputs) → bool``.  Returns the
    compiled program, or None (the outcome is counted in ``jit_stats``);
    never raises.  The probe runs in one ``jit_probe`` span (``args``: the
    kind, the outcome as ``jit_stats`` names it, the compile seconds),
    opened outside what ``make_fx`` traces."""
    with _trace.scope("jit_probe", "jit") as sp:
        fn, outcome, seconds = _probe_outcome(trace, args, same)
        _jit_note(kind, name, outcome, seconds)
        if sp is not None:
            sp.args = {"kind": kind, "outcome": outcome, "compile_s": seconds}
    return fn if outcome == "adopted" else None


def _probe_outcome(trace: Callable, args: Sequence[torch.Tensor],
                   same: Callable) -> tuple:
    """(the compiled program or None, the outcome, the compile seconds) of
    one probe.  The first call (the compile) gets copies of the contiguous
    arguments at storage offset 0: compiled on a block's view at some
    offset, the program would be specialized to offsets of 2 or more (or to
    an offset equal to the length), and recompile, unprobed, for the first
    block of a frame."""
    t0 = time.perf_counter()
    try:
        with _GATE.alone():
            t0 = time.perf_counter()
            fn = _compile_program(_trace_program(trace, args))
            out = fn(*[a.clone() if a.is_contiguous() else a for a in args])
        seconds = time.perf_counter() - t0
    except _TraceError as e:
        return None, e.args[0], 0.0
    except Exception:   # inductor / dynamo refused the graph
        return None, "compile error", time.perf_counter() - t0
    try:
        equal = same(out)
    except Exception:    # outputs of another shape or structure
        equal = False
    return fn, "adopted" if equal else "bits differ", seconds


def _compiled_predicate(expr: alg.Expr, refs: tuple, masked: tuple) -> Callable:
    """The whole predicate chain as one program over the referenced
    columns' values and the masks that exist (``masked[i]``: column i has
    one) → the bool keep mask."""
    def prog(*tensors):
        datas, rest = tensors[:len(refs)], list(tensors[len(refs):])
        env = {}
        for r, d, has in zip(refs, datas, masked):
            env[r] = (d, rest.pop(0) if has else torch.ones_like(d, dtype=torch.bool))
        v, mask = _eval_expr_env(expr, env)
        return v.to(torch.bool) & mask
    return prog


def _fused_selection_mask(preds: Sequence[alg.Expr], frame: Frame) -> torch.Tensor:
    """Keep mask (a bool tensor on the frame's device) for a run of
    structured predicates: their conjunction, as ONE compiled program where
    ``_jit_udfs_enabled`` and the chain qualifies, else interpreted.
    ANDing before filtering is exact: predicates are row-local, so a row an
    earlier selection removes gives False whatever the later ones give."""
    combined = preds[0]
    for p in preds[1:]:
        combined = alg.BinExpr("&", combined, p)
    refs = tuple(sorted(combined.refs(), key=repr))
    if not refs or not _jit_udfs_enabled(frame.device):
        return _predicate_mask(frame, combined)
    try:
        cols = [frame.col(r) for r in refs]
    except KeyError:
        return _predicate_mask(frame, combined)
    if any(c.domain.is_coded for c in cols):
        # coded columns need host code-table translation → interpreted path
        return _predicate_mask(frame, combined)
    if (any(not isinstance(c.data, torch.Tensor) or _wide_int_column(c) for c in cols)
            or _has_wide_lit(combined)):
        # wide int64 host columns and out-of-int32 literals stay on the
        # interpreted path, as the reference keeps them out of its jit
        return _predicate_mask(frame, combined)
    masked = tuple(c.mask is not None for c in cols)
    args = [c.data for c in cols] + [c.mask for c in cols if c.mask is not None]
    key = (combined.key(), tuple(c.data.dtype for c in cols), masked, str(frame.device))
    # a block of fewer than two rows runs eagerly (too small to hold a
    # program to, and a size a dynamic program would recompile for)
    fn = _jit_lookup(_PRED_JIT, _PRED_JIT_LOCK, _PRED_JIT_MAX, key, frame.nrows >= 2)
    if frame.nrows < 2 or fn is None or fn is _JIT_PROBING:
        return _predicate_mask(frame, combined)
    if fn is not _JIT_MISS:
        try:
            keep = _run_program(fn, args)
        except Exception as e:
            if not _compiler_error(e):
                raise
            _jit_note("predicate", repr(combined), "failed after adoption")
            _jit_put(_PRED_JIT, _PRED_JIT_LOCK, _PRED_JIT_MAX, key, None)
            keep = None
        return _predicate_mask(frame, combined) if keep is None else keep
    try:
        eager = _predicate_mask(frame, combined)
    except BaseException:
        _jit_release(_PRED_JIT, _PRED_JIT_LOCK, key)
        raise
    fn = _probe("predicate", repr(combined), _compiled_predicate(combined, refs, masked),
                args, lambda keep: torch.equal(keep, eager))
    _jit_put(_PRED_JIT, _PRED_JIT_LOCK, _PRED_JIT_MAX, key, fn)
    return eager


def _run_map_stages_eager(frame: Frame, udfs: Sequence[alg.Udf]) -> Frame:
    cur = frame
    for u in udfs:
        cur = _apply_udf_block(cur, u)
    return cur


def _map_run_program(udfs: Sequence[alg.Udf], names: tuple, domains: tuple,
                     masked: tuple):
    """The whole map chain as one program over the columns' values and the
    masks that exist.  Output metadata (names, domains, which columns have
    a mask) is captured at trace time: static for an elementwise chain, or
    the trace fails and the chain stays eager."""
    meta: dict = {}

    def prog(*tensors):
        datas, rest = tensors[:len(names)], list(tensors[len(names):])
        n = datas[0].shape[0]
        cols = [Column(d, dom, rest.pop(0) if has else None, None)
                for d, dom, has in zip(datas, domains, masked)]
        f = Frame(cols, RangeLabels(n), labels_from_values(list(names)))
        for u in udfs:
            f = _apply_udf_block(f, u)
        meta["labels"] = f.col_labels
        meta["domains"] = tuple(c.domain for c in f.columns)
        meta["masked"] = tuple(c.mask is not None for c in f.columns)
        return (tuple(c.data for c in f.columns)
                + tuple(c.mask for c in f.columns if c.mask is not None))

    return prog, meta


def _program_frame(out: Sequence[torch.Tensor], meta: dict, row_labels) -> Frame:
    """The frame a map-run program's flat outputs stand for."""
    k = len(meta["domains"])
    masks = iter(out[k:])
    cols = [Column(d, dom, next(masks) if has else None, None)
            for d, dom, has in zip(out[:k], meta["domains"], meta["masked"])]
    return Frame(cols, row_labels, meta["labels"])


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as the same-size int (NaNs compare by bits)."""
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _frames_bit_equal(a: Frame, b: Frame) -> bool:
    """Labels, domains, masks and every valid value's bits equal."""
    if a.col_labels.to_list() != b.col_labels.to_list():
        return False
    if a.row_labels is not b.row_labels and a.row_labels.to_list() != b.row_labels.to_list():
        return False
    for ca, cb in zip(a.columns, b.columns):
        if ca.domain is not cb.domain:
            return False
        if not (isinstance(ca.data, torch.Tensor) and isinstance(cb.data, torch.Tensor)):
            return False
        va, vb = ca.valid_mask(), cb.valid_mask()
        if not torch.equal(va, vb) or ca.data.dtype != cb.data.dtype:
            return False
        zero = torch.zeros((), dtype=ca.data.dtype, device=ca.data.device)
        if not torch.equal(_bits(torch.where(va, ca.data, zero)),
                           _bits(torch.where(vb, cb.data, zero))):
            return False
    return True


def _run_map_stages(frame: Frame, udfs: Sequence[alg.Udf]) -> Frame:
    """A run of consecutive elementwise MAP stages over one block: one
    compiled program where ``_jit_udfs_enabled`` and the chain traces, else
    one UDF after another (and on blocks of fewer than two rows).  The
    first block through a chain runs BOTH ways; the program is adopted only
    if it reproduces the eager result bit for bit, so fused and unfused
    plans cannot diverge."""
    f = frame.induce()
    if not _jit_udfs_enabled(f.device):
        return _run_map_stages_eager(f, udfs)
    names = f.col_labels.to_list()
    domains = tuple(c.domain for c in f.columns)
    if any(d.is_coded for d in domains) or not f.columns or any(
            not isinstance(c.data, torch.Tensor) for c in f.columns):
        return _run_map_stages_eager(f, udfs)
    masked = tuple(c.mask is not None for c in f.columns)
    key = (tuple(u.key() for u in udfs), tuple(names), domains, masked,
           tuple(c.data.dtype for c in f.columns), str(f.device))
    try:
        hash(key)
    except TypeError:   # unhashable labels
        return _run_map_stages_eager(f, udfs)

    entry = _jit_lookup(_MAP_JIT, _MAP_JIT_LOCK, _MAP_JIT_MAX, key, f.nrows >= 2)
    if f.nrows < 2 or entry is None or entry is _JIT_PROBING:
        return _run_map_stages_eager(f, udfs)

    args = [c.data for c in f.columns] + [c.mask for c in f.columns if c.mask is not None]
    chain = "->".join(u.name for u in udfs)
    if entry is not _MAP_JIT_MISS:
        fn, meta = entry
        try:
            out = _run_program(fn, args)
        except Exception as e:
            if not _compiler_error(e):
                raise
            _jit_note("map", chain, "failed after adoption")
            _jit_put(_MAP_JIT, _MAP_JIT_LOCK, _MAP_JIT_MAX, key, None)
            out = None
        if out is None:
            return _run_map_stages_eager(f, udfs)
        return _program_frame(out, meta, f.row_labels)

    # probe: trace, compile, run, and hold to the eager path on this block
    try:
        eager = _run_map_stages_eager(f, udfs)
    except BaseException:
        _jit_release(_MAP_JIT, _MAP_JIT_LOCK, key)
        raise
    prog, meta = _map_run_program(udfs, tuple(names), domains, masked)
    fn = _probe("map", chain, prog, args,
                lambda out: _frames_bit_equal(eager, _program_frame(out, meta, f.row_labels)))
    _jit_put(_MAP_JIT, _MAP_JIT_LOCK, _MAP_JIT_MAX, key, None if fn is None else (fn, meta))
    return eager


def _run_stages_block(frame: Frame, stages: Sequence[alg.Stage]) -> Frame:
    """Run a row-local stage chain over one block: the shared per-block
    program body of FUSED_PIPELINE and of every barrier-fused operator."""
    cur = frame
    i = 0
    while i < len(stages):
        st = stages[i]
        if st.op == "selection":
            # a run of structured-Expr selections → one conjunction
            preds = []
            while (i < len(stages) and stages[i].op == "selection"
                   and isinstance(stages[i].params["predicate"], alg.Expr)):
                preds.append(stages[i].params["predicate"])
                i += 1
            if preds:
                cur = cur.filter_rows(_fused_selection_mask(preds, cur))
            else:  # opaque Udf predicate
                cur = cur.filter_rows(_predicate_mask(cur, st.params["predicate"]))
                i += 1
        elif st.op == "map":
            udfs = []
            while i < len(stages) and stages[i].op == "map":
                udfs.append(stages[i].params["udf"])
                i += 1
            cur = _run_map_stages(cur, udfs)
        elif st.op == "projection":
            cur = _project_block(cur, st.params["cols"])
            i += 1
        elif st.op == "rename":
            cur = _rename_block(cur, dict(st.params["mapping"]))
            i += 1
        else:
            raise ValueError(f"non-fusible stage {st.op}")
    return cur


def _run_fused(pf: PartitionedFrame, stages: Sequence[alg.Stage]) -> PartitionedFrame:
    """A fused row-local chain: one sweep per row partition, values staying
    on the device across stages, one pool dispatch for the whole chain."""
    pf1 = pf.repartition(col_parts=1)
    return pf1.map_blockwise(lambda f: _run_stages_block(f, stages))


# =============================================================================
# dispatcher
# =============================================================================
def run_node(node: alg.Node, inputs: list[PartitionedFrame],
             stats=None) -> PartitionedFrame:
    """Dispatch one plan node.  ``stats`` (duck-typed ``ExecStats``) receives
    ``gather_rows`` (the payload rows SORT / JOIN / DIFFERENCE /
    DROP-DUPLICATES gathered; fused consumers gather fewer on selective
    chains), ``dedup_blocks`` / ``dedup_key_rows`` (the blocks and rows the
    dedup key extraction processed) and the exchange counters of
    ``core.shuffle``."""
    op = node.op
    if op == "fused_pipeline":
        return _run_fused(inputs[0], node.params["stages"])
    if op == "fused_groupby":
        return _fused_groupby(inputs[0], node.params["stages"],
                              node.params["keys"], node.params["aggs"],
                              node.params.get("grid"))
    if op == "fused_sort":
        return _fused_sort(inputs[0], node.params["by"], node.params["ascending"],
                           node.params["stages"], stats,
                           grid=node.params.get("grid"))
    if op == "fused_join":
        return _fused_join(inputs[0], inputs[1], node.params,
                           node.params["stages"], stats)
    if op == "fused_window":
        return _window(inputs[0], node.params["func"], node.params["cols"],
                       node.params["size"], node.params["periods"],
                       node.params["pre_stages"], node.params["post_stages"],
                       grid=node.params.get("grid"))
    if op == "fused_difference":
        return _difference(inputs[0], inputs[1], stats,
                           node.params["pre_stages"],
                           node.params["right_pre_stages"],
                           node.params["post_stages"],
                           grid=node.params.get("grid"))
    if op == "fused_drop_duplicates":
        return _drop_duplicates(inputs[0], node.params["subset"], stats,
                                node.params["pre_stages"],
                                node.params["post_stages"],
                                grid=node.params.get("grid"))
    if op == "selection":
        return _selection(inputs[0], node.params["predicate"])
    if op == "projection":
        return _projection(inputs[0], node.params["cols"])
    if op == "union":
        return _union(inputs[0], inputs[1])
    if op == "difference":
        return _difference(inputs[0], inputs[1], stats)
    if op == "join":
        return _join(inputs[0], inputs[1], node.params, stats)
    if op == "drop_duplicates":
        return _drop_duplicates(inputs[0], node.params["subset"], stats)
    if op == "sort":
        return _sort(inputs[0], node.params["by"], node.params["ascending"], stats)
    if op == "groupby":
        return _groupby(inputs[0], node.params["keys"], node.params["aggs"])
    if op == "rename":
        return _rename(inputs[0], node.params["mapping"])
    if op == "window":
        return _window(inputs[0], node.params["func"], node.params["cols"],
                       node.params["size"], node.params["periods"])
    if op == "transpose":
        return _transpose(inputs[0])
    if op == "map":
        return _map(inputs[0], node.params["udf"])
    if op == "to_labels":
        return _to_labels(inputs[0], node.params["column"])
    if op == "from_labels":
        return _from_labels(inputs[0], node.params["label"])
    if op == "limit":
        return _limit(inputs[0], node.params["k"], node.params["tail"])
    if op == "column_sort":
        return _column_sort(inputs[0], node.params["by"], node.params["ascending"])
    if op == "column_filter":
        return _column_filter(inputs[0], node.params["predicate"])
    raise ValueError(f"no physical implementation for {op}")
