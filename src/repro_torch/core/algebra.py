"""The dataframe algebra (paper §3.3, Table 1) as a logical plan language.

Operators
---------
Ordered analogs of extended relational algebra:
  SELECTION, PROJECTION, UNION, DIFFERENCE, CROSS/JOIN, DROP-DUPLICATES,
  GROUPBY, SORT, RENAME
plus SQL's WINDOW, plus the four dataframe-specific operators:
  TRANSPOSE, MAP, TOLABELS, FROMLABELS.

Each node records the Table-1 properties that drive optimization:
  * ``schema_kind``  — static / inferred / dynamic (dynamic ⇒ output schema is
    data-dependent and must be induced by S(·) at runtime);
  * ``order``        — parent-preserving vs order-creating (SORT, GROUPBY);
  * ``touches``      — metadata / data / both (TOLABELS & co. move values
    between A_mn and R_m/C_n, which relational algebra cannot express).

Predicates and projections are *structured expressions* (``Expr``) when
analyzable — enabling pushdown rules in ``rewrite.py`` — and opaque ``Udf``
objects otherwise (MAP's general case).  Udfs carry declared column
dependencies so rewrites can still reason about commutation.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional, Sequence

__all__ = [
    "Expr", "ColRef", "Lit", "BinExpr", "UnaryExpr", "col", "lit",
    "Udf",
    "Node", "Source", "Selection", "Projection", "Union", "Difference",
    "Join", "DropDuplicates", "GroupBy", "Sort", "Rename", "Window",
    "Transpose", "Map", "ToLabels", "FromLabels", "Limit",
    "ColumnSort", "ColumnFilter", "Stage", "FusedPipeline",
    "FusedGroupBy", "FusedSort", "FusedJoin", "FusedWindow",
    "FusedDifference", "FusedDropDuplicates",
    "AGG_FUNCS", "WINDOW_FUNCS", "prefix_safe", "fusible", "FUSIBLE_OPS",
    "BARRIER_FUSED_OPS",
]

AGG_FUNCS = ("sum", "count", "mean", "min", "max", "any", "all", "var", "std")
WINDOW_FUNCS = ("cumsum", "cummax", "cummin", "cumprod", "diff", "shift", "rolling_sum", "rolling_mean")


# =============================================================================
# Expressions (structured, analyzable predicates / scalar transforms)
# =============================================================================
class Expr:
    """Scalar expression over a row's columns."""

    def refs(self) -> frozenset:
        raise NotImplementedError

    # operator sugar ----------------------------------------------------
    def _bin(self, op: str, other) -> "Expr":
        return BinExpr(op, self, other if isinstance(other, Expr) else Lit(other))

    def __eq__(self, other):  # type: ignore[override]
        return self._bin("==", other)

    def __ne__(self, other):  # type: ignore[override]
        return self._bin("!=", other)

    def __lt__(self, other):
        return self._bin("<", other)

    def __le__(self, other):
        return self._bin("<=", other)

    def __gt__(self, other):
        return self._bin(">", other)

    def __ge__(self, other):
        return self._bin(">=", other)

    def __add__(self, other):
        return self._bin("+", other)

    def __sub__(self, other):
        return self._bin("-", other)

    def __mul__(self, other):
        return self._bin("*", other)

    def __truediv__(self, other):
        return self._bin("/", other)

    def __mod__(self, other):
        return self._bin("%", other)

    def __floordiv__(self, other):
        return self._bin("//", other)

    def __and__(self, other):
        return self._bin("&", other)

    def __or__(self, other):
        return self._bin("|", other)

    def __invert__(self):
        return UnaryExpr("~", self)

    def isna(self):
        return UnaryExpr("isna", self)

    def notna(self):
        return UnaryExpr("notna", self)

    def __hash__(self):
        return hash(self.key())

    def key(self) -> tuple:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class ColRef(Expr):
    name: Any

    def refs(self) -> frozenset:
        return frozenset([self.name])

    def key(self) -> tuple:
        return ("col", self.name)

    def __repr__(self):
        return f"col({self.name!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: Any

    def refs(self) -> frozenset:
        return frozenset()

    def key(self) -> tuple:
        # type name included: 1 == 1.0 == True in Python, but int/float/bool
        # literals evaluate differently (integer arithmetic stays exact), so
        # their plans must not collide in the executor/predicate caches
        return ("lit", type(self.value).__name__, self.value)

    def __repr__(self):
        return f"lit({self.value!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class BinExpr(Expr):
    op: str
    left: Expr
    right: Expr

    def refs(self) -> frozenset:
        return self.left.refs() | self.right.refs()

    def key(self) -> tuple:
        return ("bin", self.op, self.left.key(), self.right.key())

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class UnaryExpr(Expr):
    op: str
    operand: Expr

    def refs(self) -> frozenset:
        return self.operand.refs()

    def key(self) -> tuple:
        return ("un", self.op, self.operand.key())

    def __repr__(self):
        return f"{self.op}({self.operand!r})"


def col(name: Any) -> ColRef:
    return ColRef(name)


def lit(v: Any) -> Lit:
    return Lit(v)


# =============================================================================
# Opaque user-defined functions (MAP's general case)
# =============================================================================
_UDF_COUNTER = itertools.count()


@dataclasses.dataclass(frozen=True)
class Udf:
    """A named row-wise function ``f : D_n → D'_{n'}`` (paper §3.3 MAP).

    ``fn`` receives a host dict {col_label: column Frame view} at the
    *vectorized* level (whole-column arrays, not scalars) and returns a dict
    of output columns — the TPU-idiomatic batch form of the paper's per-row f.

    ``deps``: column labels read (None ⇒ all — blocks pushdown through it).
    ``elementwise``: True ⇒ output row i depends only on input row i (legal to
    run per row-block with no cross-partition exchange, and commutes with
    SELECTION).  Hashing/caching is by ``name`` + ``version``: two Udfs with
    the same (name, version) are treated as the same function.
    """

    name: str
    fn: Callable
    deps: Optional[frozenset] = None
    elementwise: bool = True
    out_cols: Optional[tuple] = None     # declared output labels (else inferred)
    version: int = 0

    @staticmethod
    def wrap(fn: Callable, name: str | None = None, **kw) -> "Udf":
        return Udf(name=name or f"udf_{next(_UDF_COUNTER)}", fn=fn, **kw)

    def key(self) -> tuple:
        return ("udf", self.name, self.version)

    def __hash__(self):
        return hash(self.key())


# =============================================================================
# Logical plan nodes
# =============================================================================
class Node:
    """Logical plan node.  Immutable; structurally hashable for CSE/reuse."""

    op: str = "?"
    schema_kind: str = "static"   # static | inferred | dynamic  (Table 1)
    order: str = "parent"         # parent | new                 (Table 1)
    touches: str = "data"         # data | metadata | both       (Table 1)

    def __init__(self, children: Sequence["Node"], **params):
        self.children = tuple(children)
        self.params = params
        self._key = (self.op, tuple(c._key for c in self.children), _freeze(params))
        self._hash = hash(self._key)

    # structural identity → common-subexpression detection (paper §6.2.1)
    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, Node) and self._key == other._key

    def cache_key(self) -> tuple:
        return self._key

    def __repr__(self):
        ps = ", ".join(f"{k}={v!r}" for k, v in self.params.items() if v is not None)
        return f"{self.op}({ps})<-[{', '.join(c.op for c in self.children)}]"

    # --- traversal helpers --------------------------------------------
    def walk(self):
        seen = set()
        stack = [self]
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            yield n
            stack.extend(n.children)

    def depth(self) -> int:
        return 1 + max((c.depth() for c in self.children), default=0)


def _freeze(obj):
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    if isinstance(obj, (set, frozenset)):
        return tuple(sorted(_freeze(v) for v in obj))
    if isinstance(obj, Expr):
        return obj.key()
    if isinstance(obj, Udf):
        return obj.key()
    if isinstance(obj, Stage):
        return obj.key()
    return obj


# ---- sources ----------------------------------------------------------------
class Source(Node):
    """A materialized input dataframe (leaf).  ``frame_id`` keys the session's
    frame store; the payload itself never enters the plan (hashability)."""

    op = "source"

    def __init__(self, frame_id: str, nrows: int | None = None, ncols: int | None = None):
        super().__init__([], frame_id=frame_id, nrows=nrows, ncols=ncols)


# ---- ordered relational analogs ---------------------------------------------
class Selection(Node):
    op = "selection"

    def __init__(self, child: Node, predicate: Expr | Udf):
        super().__init__([child], predicate=predicate)

    @property
    def predicate(self):
        return self.params["predicate"]


class Projection(Node):
    op = "projection"

    def __init__(self, child: Node, cols: Sequence[Any]):
        super().__init__([child], cols=tuple(cols))

    @property
    def cols(self):
        return self.params["cols"]


class Union(Node):
    op = "union"
    # ordered by left argument first, then right (Table 1 †)

    def __init__(self, left: Node, right: Node):
        super().__init__([left, right])


class Difference(Node):
    op = "difference"

    def __init__(self, left: Node, right: Node):
        super().__init__([left, right])


class Join(Node):
    """JOIN / CROSS-PRODUCT.  ``on=None`` ⇒ cross product.  Ordered: left
    order outer, right order breaking ties (Table 1 †)."""

    op = "join"

    def __init__(self, left: Node, right: Node, on: Sequence[Any] | None = None,
                 how: str = "inner", left_on: Sequence[Any] | None = None,
                 right_on: Sequence[Any] | None = None):
        super().__init__(
            [left, right],
            on=tuple(on) if on is not None else None,
            left_on=tuple(left_on) if left_on is not None else None,
            right_on=tuple(right_on) if right_on is not None else None,
            how=how,
        )


class DropDuplicates(Node):
    op = "drop_duplicates"

    def __init__(self, child: Node, subset: Sequence[Any] | None = None):
        super().__init__([child], subset=tuple(subset) if subset else None)


class GroupBy(Node):
    """GROUPBY keys with per-column aggregates; output ordered by sorted key
    (order: New, Table 1)."""

    op = "groupby"
    order = "new"

    def __init__(self, child: Node, keys: Sequence[Any], aggs: Sequence[tuple]):
        # aggs: tuple of (col_label, func_name, out_label)
        super().__init__([child], keys=tuple(keys), aggs=tuple(tuple(a) for a in aggs))


class Sort(Node):
    op = "sort"
    order = "new"

    def __init__(self, child: Node, by: Sequence[Any], ascending: bool = True):
        super().__init__([child], by=tuple(by), ascending=ascending)


class Rename(Node):
    op = "rename"
    touches = "metadata"

    def __init__(self, child: Node, mapping: dict):
        super().__init__([child], mapping=tuple(sorted(mapping.items(), key=repr)))


class Window(Node):
    """Sliding-window function applied in order (SQL WINDOW analog)."""

    op = "window"

    def __init__(self, child: Node, func: str, cols: Sequence[Any] | None = None,
                 size: int | None = None, periods: int = 1):
        assert func in WINDOW_FUNCS, func
        super().__init__([child], func=func, cols=tuple(cols) if cols else None,
                         size=size, periods=periods)


# ---- dataframe-specific operators --------------------------------------------
class Transpose(Node):
    op = "transpose"
    schema_kind = "dynamic"   # output schema induced from data (Table 1)
    touches = "both"

    def __init__(self, child: Node):
        super().__init__([child])


class Map(Node):
    op = "map"
    schema_kind = "inferred"  # from the Udf's signature when declared
    touches = "both"

    def __init__(self, child: Node, udf: Udf):
        super().__init__([child], udf=udf)

    @property
    def udf(self) -> Udf:
        return self.params["udf"]


class ToLabels(Node):
    """Promote a data column to the row labels (paper: data → metadata)."""

    op = "to_labels"
    schema_kind = "dynamic"
    touches = "both"

    def __init__(self, child: Node, column: Any):
        super().__init__([child], column=column)


class FromLabels(Node):
    """Demote the row labels into data column 0; reset labels to positional."""

    op = "from_labels"
    schema_kind = "dynamic"
    touches = "both"

    def __init__(self, child: Node, label: Any = "index"):
        super().__init__([child], label=label)


# ---- physical-ish convenience node (head/tail prefix; §6.1.2) -----------------
class Limit(Node):
    op = "limit"

    def __init__(self, child: Node, k: int, tail: bool = False):
        super().__init__([child], k=k, tail=tail)


# ---- rewrite-target nodes (paper §5 "Pipelining and rewriting") ----------------
class ColumnSort(Node):
    """Reorder *columns* by the values in the rows named ``by`` — the rewrite
    target of TRANSPOSE∘SORT∘TRANSPOSE (paper: "can be rewritten as a MAP and
    RENAME").  Physically a single column permutation: no transpose, no data
    reshuffle beyond a take_cols."""

    op = "column_sort"
    touches = "both"

    def __init__(self, child: Node, by: Sequence[Any], ascending: bool = True):
        super().__init__([child], by=tuple(by), ascending=ascending)


class ColumnFilter(Node):
    """Drop columns by a predicate over the rows named in the predicate —
    rewrite target of TRANSPOSE∘SELECTION∘TRANSPOSE."""

    op = "column_filter"
    touches = "both"

    def __init__(self, child: Node, predicate: "Expr"):
        super().__init__([child], predicate=predicate)


# ---- fusion-target node (paper §5 "Pipelining"; Cylon local-pattern fusion) --
class Stage:
    """One row-local operator folded into a :class:`FusedPipeline`.

    Carries the original node's ``op`` and *live* params (Expr / Udf objects —
    the physical runner needs them), while hashing by the same frozen key the
    source node would have used, so fused plans stay structurally hashable for
    the executor's materialization cache."""

    __slots__ = ("op", "params", "_key")

    def __init__(self, op: str, params: dict):
        self.op = op
        self.params = dict(params)
        self._key = ("stage", op, _freeze(self.params))

    def key(self) -> tuple:
        return self._key

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, Stage) and other._key == self._key

    def __repr__(self):
        return f"stage:{self.op}"


class FusedPipeline(Node):
    """A maximal chain of row-local operators compiled into one per-block
    program (paper §5: ordered semantics still admit pipelined execution of
    row-local chains).  ``stages`` run bottom-up — ``stages[0]`` consumes the
    child's output.  Evaluated as a single pass per row partition with no
    intermediate ``PartitionedFrame``s and one cache entry for the group."""

    op = "fused_pipeline"
    schema_kind = "inferred"
    touches = "both"

    def __init__(self, child: Node, stages: Sequence[Stage]):
        super().__init__([child], stages=tuple(stages))

    @property
    def stages(self) -> tuple:
        return self.params["stages"]

    def __repr__(self):
        return ("fused_pipeline[" + "∘".join(s.op for s in reversed(self.stages))
                + f"]<-[{self.children[0].op}]")


# ---- barrier-fused nodes (fusion *through* blocking operators) ---------------
# A blocking operator (GROUPBY/SORT/JOIN/WINDOW) is a materialization boundary,
# but the row-local work adjacent to it is not: the producer chain feeding a
# GROUPBY is per-block work that can run inside the same per-partition program
# as the partial aggregation, and the consumer chain after a SORT/JOIN can
# filter/project the gather *index* before the payload gather.  These nodes are
# the rewrite targets of ``rewrite.fuse_pipelines``'s barrier pass.
class FusedGroupBy(Node):
    """GROUPBY with its row-local producer chain absorbed: ``stages`` run
    bottom-up on each row block inside the same per-partition program that
    computes the ``segment_reduce`` partial aggregates — one dispatch per
    partition for the whole pre-shuffle stage.

    ``grid`` is the plan-time grid preference recorded by the fusion pass
    (``"workers"``: partial programs want blocks ≈ workers); the physical
    layer resolves it against the configured pool width
    (``schedule.preferred_row_parts``)."""

    op = "fused_groupby"
    order = "new"
    touches = "both"

    def __init__(self, child: Node, stages: Sequence[Stage],
                 keys: Sequence[Any], aggs: Sequence[tuple],
                 grid: str | None = None):
        super().__init__([child], stages=tuple(stages), keys=tuple(keys),
                         aggs=tuple(tuple(a) for a in aggs), grid=grid)

    @property
    def stages(self) -> tuple:
        return self.params["stages"]


class FusedSort(Node):
    """SORT with its row-local consumer chain absorbed: leading structured
    selections filter the permutation *index* before the payload gather (the
    materialized frame is built once, post-filter), a leading projection prunes
    the gathered columns, and any remaining stages run on the gathered blocks."""

    op = "fused_sort"
    order = "new"
    touches = "both"

    def __init__(self, child: Node, by: Sequence[Any], ascending: bool,
                 stages: Sequence[Stage], grid: str | None = None):
        super().__init__([child], by=tuple(by), ascending=ascending,
                         stages=tuple(stages), grid=grid)

    @property
    def stages(self) -> tuple:
        return self.params["stages"]


class FusedJoin(Node):
    """JOIN with its row-local consumer chain absorbed: leading structured
    selections are evaluated on a gather of only the predicate's columns and
    filter the (lidx, ridx) match indices before the payload gather."""

    op = "fused_join"
    touches = "both"

    def __init__(self, left: Node, right: Node, on, how, left_on, right_on,
                 stages: Sequence[Stage], grid: str | None = None):
        super().__init__(
            [left, right],
            on=tuple(on) if on is not None else None,
            left_on=tuple(left_on) if left_on is not None else None,
            right_on=tuple(right_on) if right_on is not None else None,
            how=how,
            stages=tuple(stages),
            grid=grid,
        )

    @property
    def stages(self) -> tuple:
        return self.params["stages"]


class FusedWindow(Node):
    """WINDOW with adjacent row-local chains absorbed.  ``pre_stages`` run in
    the same per-block program as the local scan; ``post_stages`` run in the
    same per-block program as the carry application — carry composition at
    partition seams is preserved because the carry combine happens between the
    two, exactly where the unfused path placed it.

    ``grid`` is the plan-time grid preference recorded by the fusion pass
    (``"few_seams"``: every partition seam costs a carry composition)."""

    op = "fused_window"
    touches = "both"

    def __init__(self, child: Node, func: str, cols: Sequence[Any] | None,
                 size: int | None, periods: int,
                 pre_stages: Sequence[Stage], post_stages: Sequence[Stage],
                 grid: str | None = None):
        assert func in WINDOW_FUNCS, func
        super().__init__([child], func=func, cols=tuple(cols) if cols else None,
                         size=size, periods=periods,
                         pre_stages=tuple(pre_stages),
                         post_stages=tuple(post_stages), grid=grid)

    @property
    def pre_stages(self) -> tuple:
        return self.params["pre_stages"]

    @property
    def post_stages(self) -> tuple:
        return self.params["post_stages"]


class FusedDropDuplicates(Node):
    """DROP-DUPLICATES with adjacent row-local chains absorbed.
    ``pre_stages`` (the producer chain) run inside the same per-block program
    that extracts the equality keys — one dispatch per partition for the whole
    pre-dedup stage, like ``FusedGroupBy``'s producer sweep.  ``post_stages``
    (the consumer chain) follow the ``FusedSort``/``FusedJoin`` index-first
    pattern: leading structured selections AND into the first-occurrence keep
    mask *before* the survivors are materialized, and a leading projection
    prunes the filtered blocks.

    ``grid`` is the plan-time grid preference recorded by the fusion pass
    (``"workers"``: key extraction wants blocks ≈ workers)."""

    op = "fused_drop_duplicates"
    touches = "both"

    def __init__(self, child: Node, subset: Sequence[Any] | None,
                 pre_stages: Sequence[Stage], post_stages: Sequence[Stage],
                 grid: str | None = None):
        super().__init__([child], subset=tuple(subset) if subset else None,
                         pre_stages=tuple(pre_stages),
                         post_stages=tuple(post_stages), grid=grid)

    @property
    def pre_stages(self) -> tuple:
        return self.params["pre_stages"]

    @property
    def post_stages(self) -> tuple:
        return self.params["post_stages"]


class FusedDifference(Node):
    """DIFFERENCE with adjacent row-local chains absorbed: ``pre_stages`` /
    ``right_pre_stages`` run inside the left/right per-block key-extraction
    programs, ``post_stages`` filter the anti-join keep mask before the
    surviving left rows are materialized (see ``FusedDropDuplicates``)."""

    op = "fused_difference"
    touches = "both"

    def __init__(self, left: Node, right: Node,
                 pre_stages: Sequence[Stage],
                 right_pre_stages: Sequence[Stage],
                 post_stages: Sequence[Stage], grid: str | None = None):
        super().__init__([left, right], pre_stages=tuple(pre_stages),
                         right_pre_stages=tuple(right_pre_stages),
                         post_stages=tuple(post_stages), grid=grid)

    @property
    def pre_stages(self) -> tuple:
        return self.params["pre_stages"]

    @property
    def post_stages(self) -> tuple:
        return self.params["post_stages"]


BARRIER_FUSED_OPS = ("fused_groupby", "fused_sort", "fused_join", "fused_window",
                     "fused_difference", "fused_drop_duplicates")


# Row-local, order-preserving unary operators whose physical implementation is
# a pure per-row-block transform: legal to fuse into one per-partition program.
# LIMIT is deliberately excluded (its k applies to the *global* row order, not
# per block); non-elementwise MAPs run on the whole frame and cannot fuse.
FUSIBLE_OPS = ("map", "selection", "projection", "rename")


def fusible(node: Node) -> bool:
    """True if ``node`` may join a fused row-local pipeline."""
    if node.op not in FUSIBLE_OPS or len(node.children) != 1:
        return False
    if node.op == "map":
        return node.params["udf"].elementwise
    return True


# =============================================================================
# Prefix-safety analysis (§6.1.2): can LIMIT(k) be answered from an input
# prefix?  True for order-preserving, row-local operators.
# =============================================================================
_PREFIX_SAFE = {"selection", "projection", "map", "rename", "union", "limit",
                "from_labels", "to_labels", "source", "window",
                "fused_pipeline", "fused_window"}
# fused_pipeline: fusible ops are all row-local/order-preserving, so a fused
# group inherits prefix-safety by construction.
# window is prefix-safe for forward windows (cumsum/…): row i depends only on
# rows ≤ i — and fused_window adds only row-local pre/post stages, so it
# inherits the same property (barrier-fusing a window must not disable §6.1.2
# prefix evaluation).  fused_groupby/fused_sort/fused_join stay blocking like
# the operators they absorb.  GROUPBY/SORT/JOIN/TRANSPOSE/DIFFERENCE/
# DROP-DUPLICATES are blocking (paper: "it is hard to produce the first k
# tuples of a GROUP BY or SORT without examining the entire data first").


def prefix_safe(node: Node) -> bool:
    """Prefix-evaluable: every op row-local/order-preserving AND a single
    source (multi-source plans like UNION need completeness bookkeeping the
    simple prefix path doesn't carry)."""
    sources = 0
    for n in node.walk():
        if n.op == "source":
            sources += 1
        if n.op not in _PREFIX_SAFE:
            return False
    return sources <= 1
