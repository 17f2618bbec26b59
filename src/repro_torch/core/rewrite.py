"""Query rewriting for the dataframe algebra (paper §5 "Pipelining and
rewriting").

Ordered semantics restrict the classical rule set — set-operator
commutativity fails without compensating sorts — but the paper identifies the
rules that *do* hold, plus dataframe-specific transpose eliminations:

  R1  TRANSPOSE(TRANSPOSE(x))                  → x
  R2  TRANSPOSE(SORT(TRANSPOSE(x)))            → COLUMN_SORT(x)      (MAP+RENAME)
  R3  TRANSPOSE(SELECTION(TRANSPOSE(x)))       → COLUMN_FILTER(x)
  R4  SELECTION(SELECTION(x, p1), p2)          → SELECTION(x, p2 & p1)
      (filters commute / fuse under ordered semantics)
  R5  SELECTION(UNION(l, r), p)                → UNION(SEL(l,p), SEL(r,p))
  R6  SELECTION(MAP(x, u), p)                  → MAP(SELECTION(x, p), u)
      when u is elementwise and p only references columns u passes through
  R7  SELECTION(CROSS(l, r), l.a == r.b)       → JOIN(l, r, a=b)
      (the paper's §6.2 incremental-join pattern)
  R8  MAP(MAP(x, u1), u2)                      → MAP(x, u2 ∘ u1)     (pipelining)
  R9  PROJECTION(PROJECTION(x, c1), c2)        → PROJECTION(x, c2)
  R10 LIMIT(LIMIT(x, k1), k2)                  → LIMIT(x, min)
  R11 LIMIT(k) pushdown through row-local ops  → evaluate less input
      (prefix computation §6.1.2 exploits this dynamically; the static rule
      pushes LIMIT below SELECTION-free row-local chains)

Rules apply bottom-up to a fixpoint.  Column-name inference threads through
static-schema operators so R6/R7 only fire when provably safe.

After rule rewriting, a separate **fusion pass** (``fuse_pipelines``) collapses
maximal chains of row-local operators (elementwise MAP, SELECTION, PROJECTION,
RENAME) into single ``FusedPipeline`` nodes, which the physical layer executes
as one per-partition program — the paper's §5 pipelining argument made
explicit in the plan language.

Barrier fusion (fusing *through* blocking operators)
----------------------------------------------------
Blocking operators (GROUPBY / SORT / JOIN / WINDOW) remain materialization
boundaries for the *shuffled* data, but the row-local chains adjacent to them
fuse into the blocking operator's own per-block programs (Cylon-style
local-pattern fusion into the shuffle stage):

  * GROUPBY absorbs its row-local *producer* chain — the map/filter sweep runs
    inside the same per-block program as the ``segment_reduce`` partial
    aggregation (``FusedGroupBy``);
  * SORT / JOIN absorb their row-local *consumer* chain — leading structured
    selections filter the permutation / match *index* before the payload
    gather, and a leading projection prunes the gathered columns
    (``FusedSort`` / ``FusedJoin``);
  * WINDOW absorbs chains on both sides — pre-stages join the local-scan
    block program, post-stages join the carry-application block program, with
    carry composition preserved at partition seams (``FusedWindow``);
  * DIFFERENCE / DROP-DUPLICATES absorb chains on both sides — producer
    chains (either DIFFERENCE input) run inside the per-block key-extraction
    program, and consumer selections/projections filter the keep mask before
    the surviving rows are materialized (``FusedDifference`` /
    ``FusedDropDuplicates``, the SORT/JOIN index-first pattern).

What still blocks fusion, and why:

  * **In-plan sharing** — a sub-plan referenced by ≥ 2 parents keeps its own
    node and cache identity; absorbing it would re-execute shared work per
    branch where the cache serves it once.
  * **Session history (MQO, §6.2.1)** — a sub-plan whose structural key
    matches a prior session statement is never absorbed or descended through
    *while that statement's result is materialized or in flight*, so the
    materialization cache can still serve the shared prefix.  (An uncached
    statement is no barrier: splitting there would cost fusion and buy no
    reuse.)  Fusion is deterministic, so the split sub-plan re-fuses to
    exactly the prior statement's cache key.
  * **Non-row-local operators** — LIMIT (its k is global, not per block),
    non-elementwise MAPs (whole-frame), TRANSPOSE / TOLABELS / FROMLABELS
    (metadata movement), and consumer chains *after* GROUPBY (its output is
    already aggregate-sized — there is no gather to prune, so plain chain
    fusion above it is already optimal).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from . import algebra as alg
from .schedule import GRID_PREFS

__all__ = ["optimize", "infer_columns", "rebuild", "fuse_pipelines",
           "FusionStats"]


# -----------------------------------------------------------------------------
# static column-label inference (None ⇒ unknown/dynamic)
# -----------------------------------------------------------------------------
def infer_columns(node: alg.Node, source_columns: Callable[[str], list | None]) -> list | None:
    op = node.op

    def child(i=0):
        return infer_columns(node.children[i], source_columns)

    if op == "source":
        return source_columns(node.params["frame_id"])
    if op in ("selection", "sort", "drop_duplicates", "limit", "window",
              "column_sort", "column_filter"):
        return child()
    if op == "projection":
        return list(node.params["cols"])
    if op == "rename":
        base = child()
        if base is None:
            return None
        mapping = dict(node.params["mapping"])
        return [mapping.get(c, c) for c in base]
    if op in ("union", "difference"):
        return child(0)
    if op == "join":
        l, r = child(0), infer_columns(node.children[1], source_columns)
        if l is None or r is None:
            return None
        drop = set(node.params["on"] or ())
        return l + [c for c in r if c not in drop]
    if op == "map":
        u: alg.Udf = node.params["udf"]
        return list(u.out_cols) if u.out_cols is not None else None
    if op == "to_labels":
        base = child()
        if base is None:
            return None
        return [c for c in base if c != node.params["column"]]
    if op == "from_labels":
        base = child()
        if base is None:
            return None
        return [node.params["label"]] + base
    if op == "groupby":
        return list(node.params["keys"]) + [a[2] for a in node.params["aggs"]]
    return None  # transpose & anything else: dynamic


# -----------------------------------------------------------------------------
# node reconstruction
# -----------------------------------------------------------------------------
_CTORS: dict[str, Callable] = {}


def _ctor(op: str):
    def reg(fn):
        _CTORS[op] = fn
        return fn
    return reg


@_ctor("source")
def _(n, ch):
    return n


@_ctor("selection")
def _(n, ch):
    return alg.Selection(ch[0], n.params["predicate"])


@_ctor("projection")
def _(n, ch):
    return alg.Projection(ch[0], n.params["cols"])


@_ctor("union")
def _(n, ch):
    return alg.Union(ch[0], ch[1])


@_ctor("difference")
def _(n, ch):
    return alg.Difference(ch[0], ch[1])


@_ctor("join")
def _(n, ch):
    return alg.Join(ch[0], ch[1], on=n.params["on"], how=n.params["how"],
                    left_on=n.params["left_on"], right_on=n.params["right_on"])


@_ctor("drop_duplicates")
def _(n, ch):
    return alg.DropDuplicates(ch[0], n.params["subset"])


@_ctor("groupby")
def _(n, ch):
    return alg.GroupBy(ch[0], n.params["keys"], n.params["aggs"])


@_ctor("sort")
def _(n, ch):
    return alg.Sort(ch[0], n.params["by"], n.params["ascending"])


@_ctor("rename")
def _(n, ch):
    return alg.Rename(ch[0], dict(n.params["mapping"]))


@_ctor("window")
def _(n, ch):
    return alg.Window(ch[0], n.params["func"], n.params["cols"],
                      n.params["size"], n.params["periods"])


@_ctor("transpose")
def _(n, ch):
    return alg.Transpose(ch[0])


@_ctor("map")
def _(n, ch):
    return alg.Map(ch[0], n.params["udf"])


@_ctor("to_labels")
def _(n, ch):
    return alg.ToLabels(ch[0], n.params["column"])


@_ctor("from_labels")
def _(n, ch):
    return alg.FromLabels(ch[0], n.params["label"])


@_ctor("limit")
def _(n, ch):
    return alg.Limit(ch[0], n.params["k"], n.params["tail"])


@_ctor("column_sort")
def _(n, ch):
    return alg.ColumnSort(ch[0], n.params["by"], n.params["ascending"])


@_ctor("column_filter")
def _(n, ch):
    return alg.ColumnFilter(ch[0], n.params["predicate"])


@_ctor("fused_pipeline")
def _(n, ch):
    return alg.FusedPipeline(ch[0], n.params["stages"])


@_ctor("fused_groupby")
def _(n, ch):
    return alg.FusedGroupBy(ch[0], n.params["stages"], n.params["keys"],
                            n.params["aggs"], grid=n.params.get("grid"))


@_ctor("fused_sort")
def _(n, ch):
    return alg.FusedSort(ch[0], n.params["by"], n.params["ascending"],
                         n.params["stages"], grid=n.params.get("grid"))


@_ctor("fused_join")
def _(n, ch):
    return alg.FusedJoin(ch[0], ch[1], n.params["on"], n.params["how"],
                         n.params["left_on"], n.params["right_on"],
                         n.params["stages"], grid=n.params.get("grid"))


@_ctor("fused_window")
def _(n, ch):
    return alg.FusedWindow(ch[0], n.params["func"], n.params["cols"],
                           n.params["size"], n.params["periods"],
                           n.params["pre_stages"], n.params["post_stages"],
                           grid=n.params.get("grid"))


@_ctor("fused_drop_duplicates")
def _(n, ch):
    return alg.FusedDropDuplicates(ch[0], n.params["subset"],
                                   n.params["pre_stages"],
                                   n.params["post_stages"],
                                   grid=n.params.get("grid"))


@_ctor("fused_difference")
def _(n, ch):
    return alg.FusedDifference(ch[0], ch[1], n.params["pre_stages"],
                               n.params["right_pre_stages"],
                               n.params["post_stages"],
                               grid=n.params.get("grid"))


def rebuild(node: alg.Node, children: Sequence[alg.Node]) -> alg.Node:
    if tuple(children) == node.children:
        return node
    return _CTORS[node.op](node, list(children))


# -----------------------------------------------------------------------------
# the rules
# -----------------------------------------------------------------------------
def _and(p1: alg.Expr, p2: alg.Expr) -> alg.Expr:
    return alg.BinExpr("&", p1, p2)


def _rule_once(node: alg.Node, cols_of: Callable[[alg.Node], list | None]) -> alg.Node | None:
    """Try every rule at ``node``; return the rewritten node or None."""
    op = node.op
    ch = node.children

    # R1: TRANSPOSE∘TRANSPOSE → identity
    if op == "transpose" and ch[0].op == "transpose":
        return ch[0].children[0]

    # R2: TRANSPOSE∘SORT∘TRANSPOSE → COLUMN_SORT
    if op == "transpose" and ch[0].op == "sort" and ch[0].children[0].op == "transpose":
        inner = ch[0].children[0].children[0]
        return alg.ColumnSort(inner, ch[0].params["by"], ch[0].params["ascending"])

    # R3: TRANSPOSE∘SELECTION∘TRANSPOSE → COLUMN_FILTER (structured preds only)
    if (op == "transpose" and ch[0].op == "selection"
            and ch[0].children[0].op == "transpose"
            and isinstance(ch[0].params["predicate"], alg.Expr)):
        inner = ch[0].children[0].children[0]
        return alg.ColumnFilter(inner, ch[0].params["predicate"])

    # R4: fuse stacked selections (filters commute under ordered semantics)
    if (op == "selection" and ch[0].op == "selection"
            and isinstance(node.params["predicate"], alg.Expr)
            and isinstance(ch[0].params["predicate"], alg.Expr)):
        return alg.Selection(ch[0].children[0],
                             _and(node.params["predicate"], ch[0].params["predicate"]))

    # R5: push selection through union
    if op == "selection" and ch[0].op == "union":
        p = node.params["predicate"]
        u = ch[0]
        return alg.Union(alg.Selection(u.children[0], p), alg.Selection(u.children[1], p))

    # R6: push selection below an elementwise pass-through MAP
    if (op == "selection" and ch[0].op == "map"
            and isinstance(node.params["predicate"], alg.Expr)):
        u: alg.Udf = ch[0].params["udf"]
        pred: alg.Expr = node.params["predicate"]
        in_cols = cols_of(ch[0].children[0])
        out_cols = cols_of(ch[0])
        if (u.elementwise and in_cols is not None and out_cols is not None
                and pred.refs() <= (set(in_cols) & set(out_cols))
                and _passes_through(u, pred.refs())):
            return alg.Map(alg.Selection(ch[0].children[0], pred), u)

    # R7: selection(cross, l.a == r.b) → join  (paper §6.2)
    if (op == "selection" and ch[0].op == "join" and ch[0].params["on"] is None
            and ch[0].params["left_on"] is None and ch[0].params["how"] == "inner"):
        pred = node.params["predicate"]
        if (isinstance(pred, alg.BinExpr) and pred.op == "=="
                and isinstance(pred.left, alg.ColRef) and isinstance(pred.right, alg.ColRef)):
            l, r = ch[0].children
            lcols, rcols = cols_of(l), cols_of(r)
            if lcols is not None and rcols is not None:
                a, b = pred.left.name, pred.right.name
                if a in lcols and b in rcols and a not in rcols and b not in lcols:
                    return alg.Join(l, r, how="inner", left_on=[a], right_on=[b])
                if b in lcols and a in rcols and b not in rcols and a not in lcols:
                    return alg.Join(l, r, how="inner", left_on=[b], right_on=[a])

    # R8: fuse stacked elementwise MAPs (pipelining)
    if op == "map" and ch[0].op == "map":
        u2: alg.Udf = node.params["udf"]
        u1: alg.Udf = ch[0].params["udf"]
        if u1.elementwise and u2.elementwise:
            fused = _fuse_udfs(u1, u2)
            return alg.Map(ch[0].children[0], fused)

    # R9: collapse stacked projections
    if op == "projection" and ch[0].op == "projection":
        return alg.Projection(ch[0].children[0], node.params["cols"])

    # R10: collapse stacked limits (same direction)
    if op == "limit" and ch[0].op == "limit" and node.params["tail"] == ch[0].params["tail"]:
        return alg.Limit(ch[0].children[0],
                         min(node.params["k"], ch[0].params["k"]),
                         node.params["tail"])

    # R11: push head-LIMIT below row-local order-preserving unary ops
    if (op == "limit" and not node.params["tail"]
            and ch[0].op in ("map", "rename", "projection") and len(ch[0].children) == 1):
        u = ch[0]
        if u.op != "map" or u.params["udf"].elementwise:
            pushed = alg.Limit(u.children[0], node.params["k"], False)
            return rebuild(u, [pushed])

    return None


def _passes_through(u: alg.Udf, names) -> bool:
    """Best-effort: MAP passes a column through unchanged if it's declared in
    out_cols and not in deps (the udf never reads it, so by the elementwise
    contract it must be forwarding it)."""
    if u.out_cols is None:
        return False
    if u.deps is None:
        return False
    return all(n in u.out_cols and n not in u.deps for n in names)


def _fuse_udfs(u1: alg.Udf, u2: alg.Udf) -> alg.Udf:
    def fused(cols, frame):
        from .frame import Frame  # local import to avoid cycle at module load
        mid = u1.fn(cols, frame)
        if not isinstance(mid, Frame):
            from .labels import labels_from_values
            from .frame import Column, as_tensor, infer_domain
            names, cs = [], []
            for name, v in mid.items():
                names.append(name)
                if isinstance(v, Column):
                    cs.append(v)
                else:
                    t = as_tensor(v, frame.device)
                    cs.append(Column(t, infer_domain(t)))
            mid = Frame(cs, frame.row_labels, labels_from_values(names))
        cols2 = {n: c for n, c in zip(mid.col_labels.to_list(), mid.columns)}
        return u2.fn(cols2, mid)

    return alg.Udf(
        name=f"{u2.name}∘{u1.name}",
        fn=fused,
        deps=u1.deps,
        elementwise=True,
        out_cols=u2.out_cols,
        version=max(u1.version, u2.version),
    )


# -----------------------------------------------------------------------------
# entry point
# -----------------------------------------------------------------------------
def optimize(node: alg.Node, source_columns: Callable[[str], list | None] | None = None,
             max_passes: int = 10) -> alg.Node:
    """Bottom-up rewriting to a fixpoint."""
    src = source_columns or (lambda _fid: None)
    memo: dict = {}

    def cols_of(n: alg.Node):
        if n not in memo:
            memo[n] = infer_columns(n, src)
        return memo[n]

    def rewrite_tree(n: alg.Node) -> alg.Node:
        new_children = [rewrite_tree(c) for c in n.children]
        cur = rebuild(n, new_children)
        for _ in range(max_passes):
            nxt = _rule_once(cur, cols_of)
            if nxt is None:
                return cur
            cur = nxt
            # rule may expose new opportunities below; re-descend once
            cur = rebuild(cur, [rewrite_tree(c) for c in cur.children])
        return cur

    prev = None
    cur = node
    passes = 0
    while cur is not prev and passes < max_passes:
        prev = cur
        cur = rewrite_tree(cur)
        passes += 1
    return cur


# -----------------------------------------------------------------------------
# fusion pass (paper §5 pipelining; runs after rule rewriting, before physical)
# -----------------------------------------------------------------------------
@dataclasses.dataclass
class FusionStats:
    """What the fusion pass did to one plan — surfaced through ``ExecStats``
    so fused-vs-unfused benchmark wins are attributable.

    Counter semantics (one source of truth, asserted in tests and benches):
      * ``groups``          — FusedPipeline nodes in the *final* plan;
      * ``barrier_groups``  — barrier-fused nodes (FusedGroupBy/FusedSort/
                              FusedJoin/FusedWindow) in the final plan;
      * ``producer_ops``    — operator nodes absorbed as producer stages of a
                              barrier node (GROUPBY pre-aggregation sweep,
                              WINDOW pre_stages);
      * ``consumer_ops``    — operator nodes absorbed as consumer stages
                              (SORT/JOIN post-gather chain, WINDOW post_stages);
      * ``fused_ops``       — total operator nodes absorbed into *any* fused
                              construct.  Invariant::

                                fused_ops == pipeline_ops + producer_ops
                                             + consumer_ops

                              where ``pipeline_ops`` is the stage count of the
                              surviving FusedPipeline groups.
    """

    groups: int = 0          # FusedPipeline nodes in the final plan
    fused_ops: int = 0       # operator nodes absorbed into any fused construct
    barrier_groups: int = 0  # barrier-fused nodes in the final plan
    producer_ops: int = 0    # stages absorbed on the producer side of a barrier
    consumer_ops: int = 0    # stages absorbed on the consumer side of a barrier


def fuse_pipelines(node: alg.Node,
                   history: "frozenset | set | None" = None) -> tuple[alg.Node, FusionStats]:
    """Collapse maximal chains of row-local operators into ``FusedPipeline``
    nodes, then fuse the surviving chains *through* blocking-operator
    boundaries (barrier pass) — see the module docstring for the barrier
    rules.

    Only chains of **two or more** operators fuse into a FusedPipeline — a
    lone SELECTION keeps its own node (and cache identity), so single-statement
    plans are unchanged and sub-plan reuse across queries still hits the
    cache.  (A lone row-local op *adjacent to a blocking operator* is still
    absorbed by the barrier pass: there the win is a saved materialization,
    not just a saved dispatch.)  A fused group gets one cache entry keyed on
    the whole chain instead of one per node.

    A sub-plan referenced by more than one parent **within** the plan is a
    fusion barrier: absorbing it into each branch's chain would re-execute the
    shared work per branch, where the per-node path evaluates it once and
    serves the other branches from the cache.

    ``history`` (MQO-aware fusion boundaries, paper §6.2.1): structural cache
    keys of *prior session statements whose results are live* (materialized
    or in flight — the executor filters; see ``Executor.note_statement``).  A
    chain never descends through — and the barrier pass never absorbs — a
    node whose key is in the history: the sub-plan keeps its own identity, is
    re-fused exactly as the prior statement was (fusion is deterministic),
    and therefore re-produces the prior statement's cache key, so the
    materialization cache serves the shared prefix instead of re-executing it
    inside a bigger fused group.
    """
    stats = FusionStats()
    history = history or frozenset()

    # structural reference counts: how many parent edges point at each
    # (structurally-identified) sub-plan — shared nodes must keep their own
    # node/cache identity, so chains may not absorb them mid-run
    refs: dict[alg.Node, int] = {}
    for n in node.walk():
        for c in n.children:
            refs[c] = refs.get(c, 0) + 1

    memo: dict[alg.Node, alg.Node] = {}

    def visit(n: alg.Node) -> alg.Node:
        hit = memo.get(n)
        if hit is not None:
            return hit
        out = None
        if alg.fusible(n):
            chain = [n]                      # top-down collection
            tail = n.children[0]
            while (alg.fusible(tail) and refs.get(tail, 0) <= 1
                   and tail.cache_key() not in history):
                chain.append(tail)
                tail = tail.children[0]
            if len(chain) >= 2:
                stats.groups += 1
                stats.fused_ops += len(chain)
                stages = tuple(alg.Stage(m.op, m.params) for m in reversed(chain))
                out = alg.FusedPipeline(visit(tail), stages)
        if out is None:
            out = rebuild(n, [visit(c) for c in n.children])
        memo[n] = out
        return out

    fused = visit(node)
    return _fuse_barriers(fused, stats, history), stats


# -----------------------------------------------------------------------------
# barrier pass: fuse row-local chains THROUGH blocking operators
# -----------------------------------------------------------------------------
def _chain_stages(n: alg.Node) -> tuple | None:
    """The absorbable stage tuple of ``n``: a FusedPipeline's stages, or a
    single-op tuple for a lone fusible operator.  None ⇒ not absorbable."""
    if n.op == "fused_pipeline":
        return n.params["stages"]
    if alg.fusible(n):
        return (alg.Stage(n.op, n.params),)
    return None


def _fuse_barriers(node: alg.Node, stats: FusionStats, history) -> alg.Node:
    """Bottom-up pattern match over the chain-fused plan:

      * GROUPBY(chain)           → FusedGroupBy     (producer fusion)
      * chain(SORT) / chain(JOIN) → FusedSort/Join  (consumer fusion)
      * chain?(WINDOW(chain?))   → FusedWindow      (pre/post stage fusion)
      * chain?(DROPDUP(chain?))  → FusedDropDuplicates  (pre/post fusion)
      * chain?(DIFFERENCE(chain?, chain?)) → FusedDifference (both inputs'
        producer chains + the consumer chain)

    A "chain" is a FusedPipeline or a lone fusible op.  Absorption respects
    the same sharing barriers as chain fusion: a node referenced twice within
    the plan, or present in the session statement history, keeps its identity.
    """
    refs: dict[alg.Node, int] = {}
    for n in node.walk():
        for c in n.children:
            refs[c] = refs.get(c, 0) + 1

    def absorbable(n: alg.Node) -> tuple | None:
        if refs.get(n, 0) > 1 or n.cache_key() in history:
            return None
        return _chain_stages(n)

    def on_absorb(n: alg.Node, side: str, count: int) -> None:
        if n.op == "fused_pipeline":      # chain group dissolves into barrier
            stats.groups -= 1
            stats.fused_ops -= count      # re-attributed below
        stats.fused_ops += count
        if side == "producer":
            stats.producer_ops += count
        else:
            stats.consumer_ops += count

    memo: dict[alg.Node, alg.Node] = {}

    def visit(n: alg.Node) -> alg.Node:
        hit = memo.get(n)
        if hit is not None:
            return hit
        out = rebuild(n, [visit(c) for c in n.children])

        # producer fusion into GROUPBY: the row-local sweep joins the
        # per-block partial-aggregation program
        if out.op == "groupby":
            stages = absorbable(out.children[0])
            if stages:
                child = out.children[0]
                grand = child.children[0]
                on_absorb(child, "producer", len(stages))
                stats.barrier_groups += 1
                out = alg.FusedGroupBy(grand, stages, out.params["keys"],
                                       out.params["aggs"], grid=GRID_PREFS["fused_groupby"])

        # producer fusion into DROP-DUPLICATES: the row-local sweep joins the
        # per-block key-extraction program
        elif out.op == "drop_duplicates":
            stages = absorbable(out.children[0])
            if stages:
                child = out.children[0]
                on_absorb(child, "producer", len(stages))
                stats.barrier_groups += 1
                out = alg.FusedDropDuplicates(
                    child.children[0], out.params["subset"], stages, (),
                    grid=GRID_PREFS["fused_drop_duplicates"])

        # producer fusion into DIFFERENCE: either input's row-local chain
        # joins that side's per-block key-extraction program
        elif out.op == "difference":
            sl = absorbable(out.children[0])
            sr = absorbable(out.children[1])
            if sl or sr:
                l, r = out.children
                if sl:
                    on_absorb(l, "producer", len(sl))
                    l = l.children[0]
                if sr:
                    on_absorb(r, "producer", len(sr))
                    r = r.children[0]
                stats.barrier_groups += 1
                out = alg.FusedDifference(l, r, sl or (), sr or (), (),
                                          grid=GRID_PREFS["fused_difference"])

        # producer fusion into WINDOW (no consumer chain above — the
        # consumer-side variant is handled from the chain node below)
        elif out.op == "window":
            stages = absorbable(out.children[0])
            if stages:
                child = out.children[0]
                on_absorb(child, "producer", len(stages))
                stats.barrier_groups += 1
                out = alg.FusedWindow(child.children[0], out.params["func"],
                                      out.params["cols"], out.params["size"],
                                      out.params["periods"], stages, (),
                                      grid=GRID_PREFS["fused_window"])

        # consumer fusion: a chain sitting on a SORT/JOIN/WINDOW
        chain_stages = _chain_stages(out)
        if chain_stages:
            below = out.children[0]
            if refs.get(below, 0) <= 1 and below.cache_key() not in history:
                if below.op == "sort":
                    on_absorb(out, "consumer", len(chain_stages))
                    stats.barrier_groups += 1
                    out = alg.FusedSort(below.children[0], below.params["by"],
                                        below.params["ascending"], chain_stages,
                                        grid=GRID_PREFS["fused_sort"])
                elif below.op == "join":
                    on_absorb(out, "consumer", len(chain_stages))
                    stats.barrier_groups += 1
                    out = alg.FusedJoin(below.children[0], below.children[1],
                                        below.params["on"], below.params["how"],
                                        below.params["left_on"],
                                        below.params["right_on"], chain_stages,
                                        grid=GRID_PREFS["fused_join"])
                elif below.op == "window":
                    # (an absorbable pre-chain would already have turned this
                    # child into a fused_window in its own visit — see below)
                    on_absorb(out, "consumer", len(chain_stages))
                    stats.barrier_groups += 1
                    out = alg.FusedWindow(below.children[0], below.params["func"],
                                          below.params["cols"],
                                          below.params["size"],
                                          below.params["periods"],
                                          (), chain_stages,
                                          grid=GRID_PREFS["fused_window"])
                elif below.op == "fused_window" and not below.params["post_stages"]:
                    # window already producer-fused on the way up: attach the
                    # consumer chain as its post stages
                    on_absorb(out, "consumer", len(chain_stages))
                    out = alg.FusedWindow(below.children[0],
                                          below.params["func"],
                                          below.params["cols"],
                                          below.params["size"],
                                          below.params["periods"],
                                          below.params["pre_stages"],
                                          chain_stages,
                                          grid=below.params.get("grid")
                                          or GRID_PREFS["fused_window"])
                elif below.op == "drop_duplicates":
                    on_absorb(out, "consumer", len(chain_stages))
                    stats.barrier_groups += 1
                    out = alg.FusedDropDuplicates(
                        below.children[0], below.params["subset"], (),
                        chain_stages,
                        grid=GRID_PREFS["fused_drop_duplicates"])
                elif below.op == "difference":
                    on_absorb(out, "consumer", len(chain_stages))
                    stats.barrier_groups += 1
                    out = alg.FusedDifference(
                        below.children[0], below.children[1], (), (),
                        chain_stages, grid=GRID_PREFS["fused_difference"])
                elif (below.op == "fused_drop_duplicates"
                      and not below.params["post_stages"]):
                    # dedup already producer-fused on the way up: attach the
                    # consumer chain as its post stages
                    on_absorb(out, "consumer", len(chain_stages))
                    out = alg.FusedDropDuplicates(
                        below.children[0], below.params["subset"],
                        below.params["pre_stages"], chain_stages,
                        grid=below.params.get("grid")
                        or GRID_PREFS["fused_drop_duplicates"])
                elif (below.op == "fused_difference"
                      and not below.params["post_stages"]):
                    on_absorb(out, "consumer", len(chain_stages))
                    out = alg.FusedDifference(
                        below.children[0], below.children[1],
                        below.params["pre_stages"],
                        below.params["right_pre_stages"], chain_stages,
                        grid=below.params.get("grid")
                        or GRID_PREFS["fused_difference"])
        if out is not n:
            # a rebuilt node inherits the original's parent-edge count, so a
            # shared sub-plan stays unabsorbable after its subtree changed
            refs[out] = refs.get(out, 0) + refs.get(n, 0)
        memo[n] = out
        return out

    return visit(node)
