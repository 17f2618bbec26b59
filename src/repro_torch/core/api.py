"""Pandas-flavoured user API over the dataframe algebra (paper §4.1 API layer).

Every method rewrites a pandas-style call into algebra nodes — the paper's
"rewrites pandas API calls into a sequence of algebraic operators, allowing
pandas code to run as-is".  The surface covers the workflow of Figure 1
(iloc point updates, .T, column map, get_dummies, merge, cov) plus the
high-density functions of §3.6 (head/shape/sum/mean/groupby/sort_values/
drop/append/fillna/isna/cumsum/diff/shift/pivot/agg/...).

Evaluation follows the session mode: eager (pandas), lazy (Spark) or
opportunistic (§6.1.1, the default).  Frames live on the session's device
(CUDA unless the caller passes ``device="cpu"``); UDFs see torch tensors.
``read_csv`` parses on the host and lands each chunk's columns on the device.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import algebra as alg
from . import config as _config
from .dtypes import (Domain, parse_column, resolve_device, storage_dtype,
                     to_device)
from .faults import IngestError, env_int
from .frame import Column, Frame, host, infer_domain
from .labels import RangeLabels, labels_from_values
from .partition import PartitionedFrame
from .session import EvalMode, Session, get_session
from ..kernels import ops as kops

__all__ = ["DataFrame", "read_csv", "from_pydict", "concat", "get_dummies"]

_ANON = itertools.count()


# =============================================================================
# column expression wrapper (Series-lite, enough for predicates & arithmetic)
# =============================================================================
class ColumnExpr:
    def __init__(self, df: "DataFrame", expr: alg.Expr):
        self._df = df
        self._expr = expr

    # comparisons → predicates
    def _wrap(self, e: alg.Expr) -> "ColumnExpr":
        return ColumnExpr(self._df, e)

    def __eq__(self, o):  # type: ignore[override]
        return self._wrap(self._expr == _unwrap(o))

    def __ne__(self, o):  # type: ignore[override]
        return self._wrap(self._expr != _unwrap(o))

    def __lt__(self, o):
        return self._wrap(self._expr < _unwrap(o))

    def __le__(self, o):
        return self._wrap(self._expr <= _unwrap(o))

    def __gt__(self, o):
        return self._wrap(self._expr > _unwrap(o))

    def __ge__(self, o):
        return self._wrap(self._expr >= _unwrap(o))

    def __add__(self, o):
        return self._wrap(self._expr + _unwrap(o))

    def __sub__(self, o):
        return self._wrap(self._expr - _unwrap(o))

    def __mul__(self, o):
        return self._wrap(self._expr * _unwrap(o))

    def __truediv__(self, o):
        return self._wrap(self._expr / _unwrap(o))

    def __mod__(self, o):
        return self._wrap(self._expr % _unwrap(o))

    def __floordiv__(self, o):
        return self._wrap(self._expr // _unwrap(o))

    def __and__(self, o):
        return self._wrap(alg.BinExpr("&", self._expr, _unwrap(o)))

    def __or__(self, o):
        return self._wrap(alg.BinExpr("|", self._expr, _unwrap(o)))

    def __invert__(self):
        return self._wrap(~self._expr)

    def isna(self):
        return self._wrap(self._expr.isna())

    def notna(self):
        return self._wrap(self._expr.notna())

    # value-level map (paper §2 C3): host fn per value, schema re-induced
    def map(self, fn: Callable[[Any], Any]) -> "DataFrame":
        assert isinstance(self._expr, alg.ColRef)
        return self._df._map_values(fn, [self._expr.name])

    # aggregates → scalars
    def _agg(self, func: str):
        assert isinstance(self._expr, alg.ColRef)
        name = self._expr.name
        node = alg.GroupBy(self._df._node, (), [(name, func, name)])
        f = self._df._session.collect(node)
        return f.col(name).to_pylist()[0]

    def sum(self):
        return self._agg("sum")

    def mean(self):
        return self._agg("mean")

    def max(self):
        return self._agg("max")

    def min(self):
        return self._agg("min")

    def count(self):
        return self._agg("count")

    def to_list(self) -> list:
        assert isinstance(self._expr, alg.ColRef)
        f = self._df._session.collect(alg.Projection(self._df._node, [self._expr.name]))
        return f.columns[0].to_pylist()


def _unwrap(o):
    if isinstance(o, ColumnExpr):
        return o._expr
    if isinstance(o, alg.Expr):
        return o
    return alg.Lit(o)


def _fill_scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``dtype``.  For an integer column it
    raises what the reference's ``jnp.asarray`` raises where ``torch.tensor``
    would raise RuntimeError: ValueError for NaN, OverflowError for +-inf or
    a value outside the type's range.  Other values truncate alike (1.5 -> 1)."""
    if not (dtype.is_floating_point or dtype == torch.bool) and isinstance(value, (int, float)):
        if math.isnan(value):
            raise ValueError("cannot convert float NaN to integer")
        if math.isinf(value):
            raise OverflowError("cannot convert float infinity to integer")
        info = torch.iinfo(dtype)
        if not info.min <= math.trunc(value) <= info.max:
            raise OverflowError(f"fill value {value!r} out of range for {dtype}")
    return torch.tensor(value, dtype=dtype, device=device)


# =============================================================================
# the DataFrame handle
# =============================================================================
class DataFrame:
    """A handle: (session, plan node).  Composing methods builds the query
    DAG; inspection triggers evaluation per the session mode."""

    def __init__(self, data: Any = None, *, session: Session | None = None,
                 node: alg.Node | None = None, row_labels: Sequence | None = None,
                 device: Any = None):
        """``device``: where a dict's columns land — the session's device
        (CUDA unless the session was made for another) when not given."""
        self._session = session or get_session(device)
        if node is not None:
            self._node = node
        elif isinstance(data, dict):
            dev = resolve_device(device) if device is not None else self._session.device
            self._node = self._session.register_frame(
                Frame.from_pydict(data, row_labels=row_labels, device=dev))
        elif isinstance(data, Frame):
            self._node = self._session.register_frame(data)
        elif isinstance(data, PartitionedFrame):
            self._node = self._session.register_frame(data)
        else:
            raise TypeError(f"cannot construct DataFrame from {type(data)}")
        self._session.statement(self._node)

    # ------------------------------------------------------------------
    def _derive(self, node: alg.Node) -> "DataFrame":
        out = DataFrame.__new__(DataFrame)
        out._session = self._session
        out._node = node
        self._session.statement(node)
        return out

    def _collect(self) -> Frame:
        return self._session.collect(self._node)

    # ------------------------------------------------------------------
    # inspection (§3.6 high-density functions)
    # ------------------------------------------------------------------
    def head(self, k: int = 5) -> Frame:
        return self._session.head(self._node, k)

    def tail(self, k: int = 5) -> Frame:
        return self._session.tail(self._node, k)

    def collect(self) -> Frame:
        return self._collect()

    def to_pydict(self) -> dict:
        return self._collect().to_pydict()

    def to_records(self) -> list[tuple]:
        return self._collect().to_records()

    @property
    def shape(self) -> tuple[int, int]:
        f = self._collect()
        return f.shape

    @property
    def columns(self) -> list:
        f = self._collect()
        return f.col_labels.to_list()

    @property
    def index(self) -> list:
        return self._collect().row_labels.to_list()

    @property
    def dtypes(self) -> list:
        return [d.value for d in self._collect().induce().schema]

    def __repr__(self) -> str:
        try:
            f = self.head(5)
            return f"DataFrame(plan={self._node.op}, head=\n{f.to_pydict()})"
        except Exception as e:  # plans can fail lazily, like any dataframe lib
            return f"DataFrame(plan={self._node.op}, error={e})"

    def __len__(self) -> int:
        return self._collect().nrows

    # ------------------------------------------------------------------
    # selection / projection / indexing
    # ------------------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            return ColumnExpr(self, alg.col(key))
        if isinstance(key, list):
            return self._derive(alg.Projection(self._node, key))
        if isinstance(key, ColumnExpr):
            return self._derive(alg.Selection(self._node, key._expr))
        if isinstance(key, alg.Expr):
            return self._derive(alg.Selection(self._node, key))
        raise TypeError(type(key))

    def __setitem__(self, key: str, value) -> None:
        """Column assign (paper C3: ``df[c] = df[c].map(f)`` etc.)."""
        if isinstance(value, DataFrame):
            # ``df[c] = df[c].map(f)``: the map produced a full-frame plan with
            # the column transformed in place — adopt it lazily when it derives
            # from this frame's plan, else splice the named column eagerly.
            if (value._node.op == "map" and value._node.children
                    and value._node.children[0] == self._node):
                self._node = value._node
                return
            src = value._collect()
            names = src.col_labels.to_list()
            col = src.columns[names.index(key)] if key in names else src.columns[0]
            self._assign_materialized(key, col)
            return
        if isinstance(value, ColumnExpr):
            expr = value._expr
            udf = alg.Udf.wrap(_expr_assign_fn(key, expr), name=f"assign_{key}_{expr!r}",
                               deps=frozenset(expr.refs()), elementwise=True)
            self._node = self._session.statement(alg.Map(self._node, udf))
            return
        # host array/list: eager materialize + splice
        vals = list(value)
        p = parse_column(vals, device=self._collect().device)
        self._assign_materialized(key, Column(p.data, p.domain, p.mask, p.dictionary))

    def _assign_materialized(self, key: str, col: Column) -> None:
        f = self._collect()
        names = f.col_labels.to_list()
        cols = list(f.columns)
        if key in names:
            cols[names.index(key)] = col
        else:
            names.append(key)
            cols.append(col)
        nf = Frame(cols, f.row_labels, labels_from_values(names), device=f.device)
        self._node = self._session.statement(self._session.register_frame(nf))

    # iloc point get/set (paper C1 — ordered point updates)
    @property
    def iloc(self) -> "_ILoc":
        return _ILoc(self)

    def drop(self, columns: Sequence[str]) -> "DataFrame":
        keep = [c for c in self.columns if c not in set(columns)]
        return self._derive(alg.Projection(self._node, keep))

    def dropna(self) -> "DataFrame":
        pred = None
        for c in self.columns:
            e = alg.col(c).notna()
            pred = e if pred is None else alg.BinExpr("&", pred, e)
        return self._derive(alg.Selection(self._node, pred))

    # ------------------------------------------------------------------
    # maps & user-defined transforms
    # ------------------------------------------------------------------
    def map_udf(self, udf: alg.Udf) -> "DataFrame":
        return self._derive(alg.Map(self._node, udf))

    def _map_values(self, fn: Callable, columns: Sequence[str]) -> "DataFrame":
        """Per-value host function over given columns (schema re-induced —
        the S(·) interplay of paper §3.3 MAP)."""
        cols = tuple(columns)

        def apply(cdict, frame):
            out_cols, out_names = [], []
            for n, c in cdict.items():
                if n in cols:
                    vals = [None if v is None else fn(v) for v in c.to_pylist()]
                    p = parse_column(vals, device=c.device)
                    out_cols.append(Column(p.data, p.domain, p.mask, p.dictionary))
                else:
                    out_cols.append(c)
                out_names.append(n)
            return Frame(out_cols, frame.row_labels, labels_from_values(out_names),
                         device=frame.device)

        udf = alg.Udf.wrap(apply, name=f"map_values_{fn.__name__}_{cols}_{next(_ANON)}",
                           deps=frozenset(cols), elementwise=True)
        return self._derive(alg.Map(self._node, udf))

    def fillna(self, value) -> "DataFrame":
        def apply(cdict, frame):
            out = {}
            for n, c in cdict.items():
                if c.mask is not None:
                    if c.domain.is_coded:
                        vals = [value if v is None else v for v in c.to_pylist()]
                        p = parse_column([str(v) for v in vals], Domain.STR,
                                         device=c.device)
                        out[n] = Column(p.data, p.domain, p.mask, p.dictionary)
                    else:
                        fill = _fill_scalar(value, c.data.dtype, c.device)
                        out[n] = Column(torch.where(c.mask, c.data, fill),
                                        c.domain, None, None)
                else:
                    out[n] = c
            return Frame(list(out.values()), frame.row_labels,
                         labels_from_values(list(out.keys())), device=frame.device)

        udf = alg.Udf.wrap(apply, name=f"fillna_{value!r}", elementwise=True)
        return self._derive(alg.Map(self._node, udf))

    def isna(self) -> "DataFrame":
        def apply(cdict, frame):
            out = {}
            for n, c in cdict.items():
                out[n] = Column(~c.valid_mask(), Domain.BOOL, None, None)
            return Frame(list(out.values()), frame.row_labels,
                         labels_from_values(list(out.keys())), device=frame.device)
        udf = alg.Udf.wrap(apply, name="isna", elementwise=True)
        return self._derive(alg.Map(self._node, udf))

    # ------------------------------------------------------------------
    # relational
    # ------------------------------------------------------------------
    def merge(self, other: "DataFrame", on: str | Sequence[str] | None = None,
              how: str = "inner", left_on=None, right_on=None) -> "DataFrame":
        on_t = [on] if isinstance(on, str) else on
        lo = [left_on] if isinstance(left_on, str) else left_on
        ro = [right_on] if isinstance(right_on, str) else right_on
        return self._derive(alg.Join(self._node, other._node, on=on_t, how=how,
                                     left_on=lo, right_on=ro))

    def cross(self, other: "DataFrame") -> "DataFrame":
        return self._derive(alg.Join(self._node, other._node, on=None, how="inner"))

    def append(self, other: "DataFrame") -> "DataFrame":
        return self._derive(alg.Union(self._node, other._node))

    def difference(self, other: "DataFrame") -> "DataFrame":
        return self._derive(alg.Difference(self._node, other._node))

    def drop_duplicates(self, subset: Sequence[str] | None = None) -> "DataFrame":
        return self._derive(alg.DropDuplicates(self._node, subset))

    def sort_values(self, by: str | Sequence[str], ascending: bool = True) -> "DataFrame":
        by_t = [by] if isinstance(by, str) else list(by)
        return self._derive(alg.Sort(self._node, by_t, ascending))

    def rename(self, columns: dict) -> "DataFrame":
        return self._derive(alg.Rename(self._node, columns))

    def groupby(self, keys: str | Sequence[str]) -> "_GroupBy":
        return _GroupBy(self, [keys] if isinstance(keys, str) else list(keys))

    # ------------------------------------------------------------------
    # dataframe-specific
    # ------------------------------------------------------------------
    @property
    def T(self) -> "DataFrame":
        return self._derive(alg.Transpose(self._node))

    def transpose(self) -> "DataFrame":
        return self.T

    def set_index(self, column: str) -> "DataFrame":
        return self._derive(alg.ToLabels(self._node, column))

    def reset_index(self, name: str = "index") -> "DataFrame":
        return self._derive(alg.FromLabels(self._node, name))

    # ------------------------------------------------------------------
    # windows (§3.4: cummax, diff, shift, ...)
    # ------------------------------------------------------------------
    def cumsum(self, cols=None):
        return self._derive(alg.Window(self._node, "cumsum", cols))

    def cummax(self, cols=None):
        return self._derive(alg.Window(self._node, "cummax", cols))

    def cummin(self, cols=None):
        return self._derive(alg.Window(self._node, "cummin", cols))

    def diff(self, periods: int = 1, cols=None):
        return self._derive(alg.Window(self._node, "diff", cols, periods=periods))

    def shift(self, periods: int = 1, cols=None):
        return self._derive(alg.Window(self._node, "shift", cols, periods=periods))

    def rolling_sum(self, size: int, cols=None):
        return self._derive(alg.Window(self._node, "rolling_sum", cols, size=size))

    def rolling_mean(self, size: int, cols=None):
        return self._derive(alg.Window(self._node, "rolling_mean", cols, size=size))

    # ------------------------------------------------------------------
    # aggregation sugar
    # ------------------------------------------------------------------
    def _numeric_cols(self) -> list:
        f = self._collect().induce()
        return [n for n, c in zip(f.col_labels.to_list(), f.columns)
                if c.domain.is_numeric]

    def agg(self, funcs: Sequence[str]) -> "DataFrame":
        """Paper §3.4: one GROUPBY per aggregate + UNION, in listed order."""
        cols = self._numeric_cols()
        node = None
        for fn in funcs:
            g = alg.GroupBy(self._node, (), [(c, fn, c) for c in cols])
            node = g if node is None else alg.Union(node, g)
        return self._derive(node)

    def sum(self):
        return self.agg(["sum"])

    def mean(self):
        return self.agg(["mean"])

    def count(self):
        return self.agg(["count"])

    def max(self):
        return self.agg(["max"])

    def min(self):
        return self.agg(["min"])

    def cov(self) -> Frame:
        """Matrix covariance (paper §2 A3): requires a matrix dataframe."""
        f = self._collect().induce()
        assert f.is_matrix(), "cov() requires a homogeneous numeric (matrix) dataframe"
        mat, _ = f.as_matrix(Domain.FLOAT)
        x = mat - mat.mean(dim=0, keepdim=True)
        c = (x.T @ x) / max(1, (f.nrows - 1))
        return Frame.from_matrix(c, Domain.FLOAT, row_labels=f.col_labels,
                                 col_labels=f.col_labels)

    # ------------------------------------------------------------------
    def pivot(self, index: str, columns: str, values: str) -> "DataFrame":
        """Paper §3.4 pivot.  Composed from algebra ops: one shared-scan
        SELECTION+PROJECTION per pivot value joined on the index (MQO turns
        these into shared sub-plans), finishing with TOLABELS."""
        f = self._collect().induce()
        pcol = f.col(columns)
        distinct = sorted(set(v for v in pcol.to_pylist() if v is not None),
                          key=lambda v: str(v))
        node = None
        for v in distinct:
            sel = alg.Selection(self._node, alg.col(columns) == alg.lit(v))
            proj = alg.Projection(sel, [index, values])
            ren = alg.Rename(proj, {values: v})
            node = ren if node is None else alg.Join(node, ren, on=[index], how="outer")
        return self._derive(alg.ToLabels(node, index))


def _expr_assign_fn(key: str, expr: alg.Expr):
    from .physical import eval_expr

    def apply(cdict, frame):
        v, mask = eval_expr(expr, frame)
        out = dict(cdict)
        out[key] = Column(v, infer_domain(v), None if bool(mask.all()) else mask, None)
        return Frame(list(out.values()), frame.row_labels,
                     labels_from_values(list(out.keys())), device=frame.device)

    return apply


# =============================================================================
class _ILoc:
    def __init__(self, df: DataFrame):
        self._df = df

    def __getitem__(self, rc):
        r, c = rc
        return self._df._collect().iloc_get(r, c)

    def __setitem__(self, rc, value):
        r, c = rc
        f = self._df._collect().iloc_set(r, c, value)
        self._df._node = self._df._session.statement(
            self._df._session.register_frame(f))


class _GroupBy:
    def __init__(self, df: DataFrame, keys: list):
        self._df = df
        self._keys = keys

    def agg(self, spec: dict) -> DataFrame:
        aggs = []
        for c, fns in spec.items():
            for fn in ([fns] if isinstance(fns, str) else fns):
                out = f"{c}_{fn}" if not isinstance(fns, str) else c
                aggs.append((c, fn, out))
        return self._df._derive(alg.GroupBy(self._df._node, self._keys, aggs))

    def _all(self, fn: str) -> DataFrame:
        cols = [c for c in self._df.columns if c not in self._keys]
        f = self._df._collect().induce()
        numeric = {n for n, c in zip(f.col_labels.to_list(), f.columns)
                   if c.domain.is_numeric}
        aggs = [(c, fn, c) for c in cols if fn == "count" or c in numeric]
        return self._df._derive(alg.GroupBy(self._df._node, self._keys, aggs))

    def count(self):
        return self._all("count")

    def sum(self):
        return self._all("sum")

    def mean(self):
        return self._all("mean")

    def max(self):
        return self._all("max")

    def min(self):
        return self._all("min")


# =============================================================================
# module-level constructors
# =============================================================================
def from_pydict(data: dict, session: Session | None = None,
                row_labels: Sequence | None = None, device: Any = None) -> DataFrame:
    return DataFrame(data, session=session, row_labels=row_labels, device=device)


# =============================================================================
# CSV ingest: chunk-parallel streaming parser into store-backed blocks
# =============================================================================
# Two-pass schema induction over byte-range chunks (paper §3.2 S(·) at scale):
# pass 1 tokenizes each chunk in a pool worker and votes per-column
# *castability* flags (bool/int/float — conjunctive across chunks, so the
# merged domain equals what the seed's whole-column induce_schema would have
# chosen); pass 2 re-tokenizes and parses each chunk directly into a
# store-registered Frame block with vectorized numpy casts.  The whole file
# is never held as host lists — a CSV larger than REPRO_MEM_BUDGET streams
# straight into a spill-backed PartitionedFrame, earlier blocks spilling
# while later chunks still parse.
#
# Correctness over the seed parser: quoted fields may contain the separator
# (RFC-4180 quoting incl. doubled quotes), CRLF line endings are stripped,
# and a quoted empty field ("") is tokenized distinctly from a missing field
# — with pandas-default NA handling both become null (keep_default_na=True),
# with keep_default_na=False both surface as the empty string, exactly like
# ``pandas.read_csv`` (differential suite:
# tests/test_read_csv_differential.py).
#
# ``REPRO_CSV_STREAM=0`` routes through the seed parser (kept below as
# ``_read_csv_seed`` — the benchmark baseline and a fallback oracle).

_BOOL_TRUE = ("true", "yes", "t", "1")
_BOOL_FALSE = ("false", "no", "f", "0")


def _read_csv_seed(path: str, session: Session | None = None,
                   sep: str = ",", device: Any = None) -> DataFrame:
    """The seed parser: whole file as host lists, per-value Python casts.
    Baseline for BENCH_outofcore and the ``REPRO_CSV_STREAM=0`` escape
    hatch.  Known gaps (fixed by the streaming parser): no quoting, no CRLF,
    empty conflated with missing."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split(sep)
        rows = [line.rstrip("\n").split(sep) for line in f if line.strip()]
    data = {h: [r[i] if i < len(r) and r[i] != "" else None for r in rows]
            for i, h in enumerate(header)}
    return DataFrame(data, session=session, device=device)


def _split_line(line: str, sep: str) -> list[str]:
    """Tokenize one record into str fields.  Both an unquoted empty field
    and a quoted empty ("") surface as '' — exactly pandas' behaviour in
    both NA modes (default: '' → null; keep_default_na=False: '' stays a
    string value), so '' is the single missing sentinel downstream.  Quoted
    fields may contain the separator; doubled quotes escape a quote
    (RFC 4180)."""
    if '"' not in line:
        return line.split(sep)
    fields: list[str] = []
    i, n = 0, len(line)
    step = len(sep)
    while True:
        if i < n and line[i] == '"':
            buf = []
            i += 1
            closed = False
            while i < n:
                ch = line[i]
                if ch == '"':
                    if i + 1 < n and line[i + 1] == '"':
                        buf.append('"')
                        i += 2
                        continue
                    i += 1
                    closed = True
                    break
                buf.append(ch)
                i += 1
            if not closed:
                # a quoted field that never closes on this line is the
                # start of a multiline quoted field — the byte-range
                # chunker splits records on raw newlines, so supporting it
                # would silently corrupt data.  Fail loudly instead.
                raise ValueError(
                    "read_csv: quoted field contains a line break "
                    "(unterminated quote) — embedded newlines are not "
                    f"supported by the streaming parser: {line[:80]!r}")
            j = line.find(sep, i)
            if j == -1:
                buf.append(line[i:])
                fields.append("".join(buf))
                return fields
            buf.append(line[i:j])
            fields.append("".join(buf))
            i = j + step
        else:
            j = line.find(sep, i)
            if j == -1:
                fields.append(line[i:])
                return fields
            fields.append(line[i:j])
            i = j + step


_PAD: dict[int, list[str]] = {}


def _chunk_rows(raw: bytes, sep: str, width: int) -> list[list[str]]:
    """Decode + tokenize a byte-range chunk into width-padded field rows
    (CRLF-stripped, blank lines skipped — pandas skip_blank_lines).  A row
    with MORE fields than the header raises, like pandas' ParserError —
    silently truncating would drop data; short rows pad with missing
    fields, also pandas semantics."""
    rows: list[list[str]] = []
    pad = _PAD.setdefault(width, [""] * width)
    quote_free = b'"' not in raw
    for line in raw.decode("utf-8", errors="replace").split("\n"):
        if line.endswith("\r"):
            line = line[:-1]
        if not line:
            continue
        r = line.split(sep) if quote_free else _split_line(line, sep)
        m = len(r)
        if m != width:
            if m > width:
                raise ValueError(
                    f"read_csv: expected {width} fields, saw {m}: "
                    f"{line[:80]!r}")
            r = r + pad[m:]
        rows.append(r)
    return rows


def _chunk_columns(rows: list[list[str]], width: int) -> list[np.ndarray]:
    """Transpose to per-column numpy string arrays — the vectorized substrate
    every cast below runs on."""
    if not rows:
        return [np.empty(0, dtype="U1") for _ in range(width)]
    return [np.asarray(col) for col in zip(*rows)]


_BOOLSET = frozenset(_BOOL_TRUE + _BOOL_FALSE)


def _encode_str_column(arr: np.ndarray, valid: np.ndarray | None) -> tuple[np.ndarray, tuple]:
    """Dictionary-encode in first-occurrence order (order-stable, like
    ``dtypes.encode_dictionary``, but via one vectorized unique) →
    (codes int32 with -1 at nulls, table)."""
    n = int(arr.shape[0])
    codes = np.full(n, -1, dtype=np.int32)
    vals = arr if valid is None else arr[valid]
    if vals.size == 0:
        return codes, ()
    uniq, first, inv = np.unique(vals, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(order.shape[0], dtype=np.int32)
    rank[order] = np.arange(order.shape[0], dtype=np.int32)
    if valid is None:
        codes[:] = rank[inv]
    else:
        codes[valid] = rank[inv]
    return codes, tuple(str(u) for u in uniq[order])


def _scan_column(arr: np.ndarray, na_empty: bool):
    """Per-chunk castability flags + optimistic local parse, ONE vector cast
    per column: ``(flags, local_domain, data, valid_or_None, dictionary)``.

    ``flags = (bool_ok, int_ok, float_ok, any_value)`` are conjunctive
    across chunks, so the merged decision equals the seed's whole-column
    S(·) (bool ≺ int ≺ float ≺ Σ*).  The expensive vector casts are gated
    on a first-value probe — a float column never pays a full int attempt,
    a numeric column never pays the lowercase/isin bool sweep — and the
    successful cast IS the parse, kept for the finalize pass.  INT parses
    stay int64 host arrays here: the chunk cannot know yet whether the
    global domain is INT (int32 range-check applies, seed parity) or FLOAT
    (no range limit)."""
    n = int(arr.shape[0])
    miss = (arr == "") if na_empty else None
    any_miss = bool(miss.any()) if miss is not None else False
    valid = ~miss if any_miss else None
    present = arr[valid] if any_miss else arr
    if present.size == 0:
        return ((True, True, True, False), Domain.UNSPECIFIED,
                np.zeros(n, dtype=np.float32), None, None)
    probe = str(present[0])
    # ---- bool: probe, then one strip/lower + isin sweep --------------------
    bool_ok = False
    low = None
    if probe.strip().lower() in _BOOLSET:
        low = np.char.lower(np.char.strip(arr))
        sub = low[valid] if any_miss else low
        bool_ok = bool(np.isin(sub, _BOOL_TRUE + _BOOL_FALSE).all())
    # ---- int: probe, then the real cast (kept) -----------------------------
    int_ok, ints = False, None
    try:
        np.asarray([probe]).astype(np.int64)
        int_ok = True
    except (ValueError, OverflowError):
        pass
    if int_ok:
        try:
            ints = (np.where(miss, "0", arr) if any_miss else arr).astype(np.int64)
        except (ValueError, OverflowError):
            int_ok = False
    # ---- float: implied by int; else probe + cast (kept) -------------------
    flts = None
    if int_ok:
        float_ok = True
    else:
        float_ok = False
        try:
            np.asarray([probe]).astype(np.float64)
            float_ok = True
        except ValueError:
            pass
        if float_ok:
            try:
                flts = (np.where(miss, "0", arr) if any_miss else arr).astype(np.float64)
            except ValueError:
                float_ok = False
    flags = (bool_ok, int_ok, float_ok, True)
    if bool_ok:
        # ``low`` spans the full array; missing slots lower to '' → False,
        # and the mask hides them anyway
        return flags, Domain.BOOL, np.isin(low, _BOOL_TRUE), valid, None
    if int_ok:
        return flags, Domain.INT, ints, valid, None
    if float_ok:
        return flags, Domain.FLOAT, flts.astype(np.float32), valid, None
    codes, table = _encode_str_column(arr, valid)
    return flags, Domain.STR, codes, valid, table


def _finalize_column(data: np.ndarray, valid: np.ndarray | None,
                     dictionary: tuple | None, local: Domain,
                     dom: Domain, text: np.ndarray | None,
                     na_empty: bool, device) -> Column:
    """Convert a chunk column's optimistic local parse to the merged global
    domain — pure vector casts, except the (rare) demotion to Σ*, which
    re-reads the chunk's text.  Outputs match ``parse_column``: same
    storage dtypes, mask=None when all valid, tensors on ``device``."""
    n = int(data.shape[0])
    mask = None if valid is None else to_device(valid, device)
    if dom is Domain.UNSPECIFIED:          # whole COLUMN all-null
        return Column(to_device(np.zeros(n, dtype=np.float32), device), dom,
                      to_device(np.zeros(n, dtype=np.bool_), device), None)
    if local is Domain.UNSPECIFIED:        # all-null CHUNK of a typed column
        zero = np.zeros(n, dtype=storage_dtype(dom))
        if dom.is_coded:
            zero = np.full(n, -1, dtype=np.int32)
        return Column(to_device(zero, device), dom,
                      to_device(np.zeros(n, dtype=np.bool_), device),
                      () if dom.is_coded else None)
    if dom is Domain.STR and local is not Domain.STR:
        # demotion: another chunk had non-numeric text — re-encode from the
        # original characters (the parsed numbers can't reproduce them)
        assert text is not None
        miss = (text == "") if na_empty else None
        v = None if miss is None or not miss.any() else ~miss
        codes, table = _encode_str_column(text, v)
        return Column(to_device(codes, device), Domain.STR,
                      None if v is None else to_device(v, device), table)
    if dom is Domain.BOOL:                 # global BOOL ⇒ local BOOL
        return Column(to_device(data, device), dom, mask, None)
    if dom is Domain.INT:
        ints = data.astype(np.int64)       # local BOOL or INT
        if ints.size and (int(ints.max(initial=0)) > 2 ** 31 - 1
                          or int(ints.min(initial=0)) < -2 ** 31):
            # seed parity: ints beyond int32 must not silently wrap through
            # device storage (see dtypes.parse_column)
            raise OverflowError("integer column exceeds int32 storage")
        return Column(to_device(ints.astype(np.int32), device), dom, mask, None)
    if dom is Domain.FLOAT:
        if local is Domain.FLOAT:
            return Column(to_device(data, device), dom, mask, None)
        # widening from BOOL/INT: exact (every int the chunk held is a
        # parsed text literal, so float64→float32 equals parsing as float)
        f = data.astype(np.float64).astype(np.float32)
        return Column(to_device(f, device), dom, mask, None)
    # dom is STR and local is STR: codes/table are already final
    return Column(to_device(data, device), Domain.STR, mask, dictionary)


def _csv_chunk_ranges(path: str, sep: str) -> tuple[list[str], list[tuple[int, int]]]:
    """Header + newline-aligned byte ranges.  Chunk count targets one task
    per (worker × coalesce slack); under a memory budget the chunk size is
    additionally capped at budget/4 so ingest blocks are spillable units."""
    from .schedule import budget_max_block_bytes, coalesce_factor, pool_width
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        hdr = f.readline()
        body0 = f.tell()
        header = _split_line(hdr.decode("utf-8", errors="replace")
                             .rstrip("\r\n"), sep)
        body = size - body0
        target = pool_width() * coalesce_factor()
        chunk_env = env_int("REPRO_CSV_CHUNK_BYTES", 0, minimum=0)
        if chunk_env:
            chunk_bytes = chunk_env
        else:
            chunk_bytes = max(1 << 16, body // max(1, target))
            mb = budget_max_block_bytes()
            if mb:
                # parsed block bytes can exceed the CSV bytes that produced
                # them (int64 intermediates, masks) — halve the cap so the
                # workers' pinned in/out pairs stay inside the budget
                chunk_bytes = min(chunk_bytes, max(1 << 12, mb // 2))
        bounds = [body0]
        pos = body0 + chunk_bytes
        while pos < size:
            f.seek(pos)
            f.readline()                 # align to the next record start
            pos = f.tell()
            if pos >= size:
                break
            bounds.append(pos)
            pos += chunk_bytes
        bounds.append(size)
    ranges = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)
              if bounds[i + 1] > bounds[i]]
    return header, ranges or [(body0, body0)]


def read_csv(path: str, session: Session | None = None, sep: str = ",",
             usecols: Sequence[str] | None = None,
             keep_default_na: bool = True, device: Any = None) -> DataFrame:
    """CSV ingest: chunk-parallel streaming parse straight into block-store
    partitions (schema induced by a two-pass per-chunk vote + parse).

    ``usecols`` pushes the projection into the parser — unselected columns
    are tokenized but never materialized.  ``keep_default_na=False`` keeps
    empty fields as empty strings instead of nulls (pandas semantics).
    Parsing runs on the host; each chunk's finished columns go to ``device``
    (the session's device when not given) once, and into the session's
    block store — a budgeted session's own, where the reference's
    ``read_csv`` charges the process store whatever the session.
    """
    if os.environ.get("REPRO_CSV_STREAM", "") == "0":
        if usecols is not None or not keep_default_na:
            raise ValueError(
                "REPRO_CSV_STREAM=0 routes through the seed parser, which "
                "supports neither usecols nor keep_default_na=False")
        return _read_csv_seed(path, session=session, sep=sep, device=device)
    session = session or get_session(device)
    dev = resolve_device(device) if device is not None else session.device
    # the session's scope, as around every Session entry point: its store
    # (a budgeted session's private one) takes the chunks as they parse
    with _config.scope(session.config):
        from .partition import PartitionedFrame
        from .schedule import dispatch_blocks
        from .store import as_handle, pinned, resolve

        header, ranges = _csv_chunk_ranges(path, sep)
        planned_size = ranges[-1][1]      # file size the byte ranges were cut for
        width = len(header)
        if usecols is not None:
            want = set(usecols)
            missing = want - set(header)
            if missing:
                raise KeyError(f"usecols not in header: {sorted(missing)}")
            sel = [j for j, h in enumerate(header) if h in want]
        else:
            sel = list(range(width))
        names = [header[j] for j in sel]

        def read_range(rng: tuple[int, int]) -> bytes:
            # the byte ranges are only meaningful against the file they were
            # planned over: a file that is truncated or grows between planning
            # and chunk tokenization must fail as ONE clear error, not silently
            # parse a torn record (or drop the appended tail)
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                actual = f.tell()
                if actual != planned_size:
                    raise IngestError(
                        f"{path} changed during streaming ingest: byte ranges "
                        f"were planned over {planned_size} bytes but the file "
                        f"is now {actual} bytes "
                        f"({'truncated' if actual < planned_size else 'grew'} "
                        "between range planning and chunk tokenization)")
                f.seek(rng[0])
                data = f.read(rng[1] - rng[0])
            if len(data) != rng[1] - rng[0]:
                raise IngestError(
                    f"{path} truncated during streaming ingest: chunk "
                    f"[{rng[0]}, {rng[1]}) returned only {len(data)} bytes")
            return data

        na_empty = keep_default_na

        # ---- pass 1: per-chunk domain vote + optimistic local parse ------------
        # Each worker tokenizes its byte range once, votes castability flags per
        # column, and parses to the chunk-LOCAL domain, registering the result
        # with the block store immediately — under a budget, early chunks spill
        # while later chunks still parse, so the file is never fully resident.
        def scan_chunk(rng):
            def parse():
                rows = _chunk_rows(read_range(rng), sep, width)
                cols = _chunk_columns(rows, width)
                scanned = [_scan_column(cols[j], na_empty) for j in sel]
                parts = [Column(to_device(s[2], dev) if s[1] is not Domain.INT
                                else s[2],
                                s[1],
                                None if s[3] is None else to_device(s[3], dev),
                                s[4])
                         for s in scanned]
                f = Frame(parts, RangeLabels(len(rows)), labels_from_values(names),
                          device=dev)
                return f, scanned

            f, scanned = parse()
            # lineage: the CSV byte range IS this block's producer — a corrupt
            # spill re-parses the chunk from the source file
            return (as_handle(f, recompute=lambda: parse()[0]), f.nrows,
                    [s[0] for s in scanned], [s[1] for s in scanned])

        scans = dispatch_blocks(scan_chunk, ranges, attribute=False)

        # ---- merge the votes: conjunctive flags ≡ whole-column S(·) ------------
        domains: list[Domain] = []
        for k in range(len(sel)):
            bool_ok = all(s[2][k][0] for s in scans)
            int_ok = all(s[2][k][1] for s in scans)
            float_ok = all(s[2][k][2] for s in scans)
            any_val = any(s[2][k][3] for s in scans)
            if not any_val:
                domains.append(Domain.UNSPECIFIED)
            elif bool_ok:
                domains.append(Domain.BOOL)
            elif int_ok:
                domains.append(Domain.INT)
            elif float_ok:
                domains.append(Domain.FLOAT)
            else:
                domains.append(Domain.STR)

        # ---- pass 2: finalize each chunk to the merged domains -----------------
        # Pure vector casts on the already-parsed blocks; only a demotion to Σ*
        # (this chunk parsed numbers, another chunk proved the column textual)
        # re-reads the chunk's bytes.
        offsets = [0]
        for s in scans:
            offsets.append(offsets[-1] + s[1])

        def finalize_chunk(args):
            (handle, m, _flags, local_doms), rng, start = args
            needs_text = [j for j, (ld, gd) in enumerate(zip(local_doms, domains))
                          if gd is Domain.STR and ld not in (Domain.STR,
                                                             Domain.UNSPECIFIED)]
            text_cols = None
            if needs_text:
                cols = _chunk_columns(_chunk_rows(read_range(rng), sep, width),
                                      width)
                text_cols = {j: cols[sel[j]] for j in needs_text}
            if (start == 0 and not needs_text
                    and all(ld is gd and gd in (Domain.BOOL, Domain.FLOAT,
                                                Domain.STR)
                            for ld, gd in zip(local_doms, domains))):
                # first chunk, every column already in final storage form (INT
                # stays int64 in the intermediate — range-checked at finalize)
                return handle
            def build(f):
                out = []
                for j, (ld, gd) in enumerate(zip(local_doms, domains)):
                    c = f.columns[j]
                    if ld is gd and gd in (Domain.BOOL, Domain.FLOAT, Domain.STR):
                        # already in final storage form: reuse the column object
                        # — no host/device round trip in the ingest hot path
                        out.append(c)
                        continue
                    data = host(c.data)
                    valid = None if c.mask is None else host(c.mask)
                    out.append(_finalize_column(
                        data, valid, c.dictionary, ld, gd,
                        text_cols.get(j) if text_cols else None, na_empty, dev))
                return Frame(out, RangeLabels(m, start), labels_from_values(names),
                             device=dev)

            with pinned(handle) as f:
                return as_handle(build(f),
                                 recompute=lambda: build(resolve(handle)))

        handles = dispatch_blocks(
            finalize_chunk,
            [(scans[i], rng, offsets[i]) for i, rng in enumerate(ranges)],
            attribute=False)
        pf = PartitionedFrame([[h] for h in handles])
        return DataFrame(pf, session=session)


def concat(dfs: Sequence[DataFrame]) -> DataFrame:
    out = dfs[0]
    for d in dfs[1:]:
        out = out.append(d)
    return out


def get_dummies(df: DataFrame, columns: Sequence[str]) -> DataFrame:
    """One-hot encoding (paper §2 A1) via the onehot kernel."""
    cols = tuple(columns)

    def apply(cdict, frame):
        out_cols, out_names = [], []
        for n, c in cdict.items():
            if n in cols and c.domain.is_coded:
                table = c.dictionary or ()
                hot = kops.onehot_encode(c.data, len(table)).to(torch.int32)
                for g, val in enumerate(table):
                    out_names.append(f"{n}_{val}")
                    out_cols.append(Column(hot[:, g], Domain.INT, c.mask, None))
            else:
                out_names.append(n)
                out_cols.append(c)
        return Frame(out_cols, frame.row_labels, labels_from_values(out_names),
                     device=frame.device)

    udf = alg.Udf.wrap(apply, name=f"get_dummies_{cols}", deps=frozenset(cols),
                       elementwise=True)
    return df.map_udf(udf)
