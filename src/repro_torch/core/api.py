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
``read_csv`` waits for the streaming store (ROADMAP M8).
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Sequence

import torch

from . import algebra as alg
from .dtypes import Domain, parse_column, resolve_device
from .frame import Column, Frame, infer_domain
from .labels import labels_from_values
from .partition import PartitionedFrame
from .session import EvalMode, Session, get_session
from ..kernels import ops as kops

__all__ = ["DataFrame", "from_pydict", "concat", "get_dummies"]

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
