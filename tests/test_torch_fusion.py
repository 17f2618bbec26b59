"""Fusion of the PyTorch port (paper §5 pipelining and barrier fusion)
against the JAX package, and within the port against its own per-node plans.

Cases come from ``tests/test_fusion.py`` (row-local chains at (row, col)
parts (1, 1), (3, 1), (4, 2), (1, 2), UDF predicates, the pass's structure,
the shared-subplan barrier, one cache entry a group, ``head``, int precision
above 2^24, literal-keyed caches), ``tests/test_blocking_fusion.py``
(producer chains into GROUPBY, consumer chains after SORT and JOIN, WINDOW
chains across seams, the session-history barrier, resubmission, the counter
invariant, a shared blocking node) and the fused SORT / JOIN cases of
``tests/test_shuffle_differential.py``.  Every plan runs in the port with
``optimize=True`` (fused) and ``optimize=False`` (per node), which must agree
bit for bit (labels, masks and every valid value's bits), and in the
reference with ``optimize=True``: labels, masks, ints and codes bit-equal,
floats to rtol=atol=1e-4.  The port runs with ``device="cpu"``, so the plain
versions of ``segment_reduce`` (K1) and ``window_scan`` (K4) stand in for
the kernels.

The reference's two tests of its jit-compiled map runs
(``test_blocking_fusion.py::test_map_run_jit_*``) have no counterpart: the
port runs map and predicate runs eagerly and has no compiled map path (and
no ``REPRO_JIT_UDFS``).  UDFs are written once per package.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import algebra as ralg
from repro.core import rewrite as rrewrite
from repro.core.dtypes import Domain as RDomain
from repro.core.executor import Executor as RExecutor
from repro.core.frame import Column as RColumn
from repro.core.frame import Frame as RFrame
from repro.core.partition import PartitionedFrame as RPF
from repro.core.physical import eval_expr as r_eval_expr
from repro.core.session import EvalMode as REvalMode
from repro.core.session import Session as RSession
from repro_torch.core import algebra as talg
from repro_torch.core import rewrite as trewrite
from repro_torch.core.dtypes import Domain as TDomain
from repro_torch.core.executor import Executor as TExecutor
from repro_torch.core.frame import Column as TColumn
from repro_torch.core.frame import Frame as TFrame
from repro_torch.core.frame import host
from repro_torch.core.partition import PartitionedFrame as TPF
from repro_torch.core.physical import eval_expr as t_eval_expr
from repro_torch.core.session import EvalMode as TEvalMode
from repro_torch.core.session import Session as TSession
from repro_torch.kernels import segment_reduce as sr_mod
from repro_torch.kernels import window_scan as ws_mod

PKG = {
    "ref": dict(alg=ralg, Ex=RExecutor, PF=RPF, F=RFrame, C=RColumn, Dm=RDomain, kw={},
                rw=rrewrite, Session=RSession, Mode=REvalMode),
    "port": dict(alg=talg, Ex=TExecutor, PF=TPF, F=TFrame, C=TColumn, Dm=TDomain,
                 kw={"device": "cpu"}, rw=trewrite, Session=TSession, Mode=TEvalMode),
}


@pytest.fixture(autouse=True)
def _engine_env(monkeypatch):
    for knob in ("REPRO_SHUFFLE", "REPRO_BLOCK_DEDUP"):
        monkeypatch.delenv(knob, raising=False)
    yield monkeypatch


# =============================================================================
# frames and UDFs of both packages
# =============================================================================
def _chain_frame(pkg: str, n: int = 97):
    """tests/test_fusion.py's frame."""
    rng = np.random.default_rng(7)
    return PKG[pkg]["F"].from_pydict({
        "k": [("a", "b", "c")[i % 3] for i in range(n)],
        "v": rng.integers(-50, 50, n).tolist(),
        "f": rng.standard_normal(n).astype(np.float32).tolist(),
        "g": rng.standard_normal(n).astype(np.float32).tolist(),
    }, row_labels=[f"r{i}" for i in range(n)], **PKG[pkg]["kw"])


def _mk_frame(pkg: str, n: int = 211, with_nulls: bool = True, seed: int = 11):
    """tests/test_blocking_fusion.py's frame."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 6, n).astype(object)
    v = rng.integers(-50, 50, n).astype(object)
    x = rng.standard_normal(n).astype(np.float32).astype(object)
    s = np.asarray([("a", "b", "c")[i % 3] for i in range(n)], dtype=object)
    if with_nulls:
        for arr, step in ((k, 17), (v, 13), (x, 7)):
            arr[::step] = None
    return PKG[pkg]["F"].from_pydict(
        {"k": k.tolist(), "v": v.tolist(), "x": x.tolist(), "s": s.tolist()},
        row_labels=[f"r{i}" for i in range(n)], **PKG[pkg]["kw"])


def _scale_udf(pkg: str, name: str = "x", a: float = 2.0, b: float = 1.0):
    p = PKG[pkg]

    def fn(cols, frame):
        out = dict(cols)
        c = cols[name]
        out[name] = p["C"](c.data * a + b, p["Dm"].FLOAT, c.mask, None)
        return out
    return p["alg"].Udf(name=f"scale_{name}_{a}_{b}", fn=fn,
                        deps=frozenset([name]), elementwise=True)


def _store(pkg: str, frames: dict, row_parts: int = 1, col_parts: int = 1,
           parts: dict | None = None) -> dict:
    """``frames``: {frame id: builder(pkg) -> Frame}; ``parts`` overrides
    ``row_parts`` per frame id."""
    return {fid: PKG[pkg]["PF"].from_frame(build(pkg), row_parts=(parts or {}).get(fid, row_parts),
                                           col_parts=col_parts)
            for fid, build in frames.items()}


def _src(pkg: str, fid: str = "f0", store: dict | None = None):
    pf = store[fid] if store is not None else None
    return PKG[pkg]["alg"].Source(fid, nrows=pf.nrows if pf else 0,
                                  ncols=pf.ncols if pf else 0)


# =============================================================================
# comparison
# =============================================================================
def _valid(c) -> np.ndarray:
    return np.ones(len(c), bool) if c.mask is None else host(c.mask)


def _bit_equal(a, b) -> None:
    """Two port frames: labels, schema, masks and every valid value's bits."""
    assert a.col_labels.to_list() == b.col_labels.to_list()
    assert a.row_labels.to_list() == b.row_labels.to_list()
    assert a.schema == b.schema
    for x, y in zip(a.columns, b.columns):
        vx, vy = _valid(x), _valid(y)
        np.testing.assert_array_equal(vx, vy)
        dx, dy = host(x.data)[vx], host(y.data)[vy]
        assert dx.dtype == dy.dtype
        assert dx.tobytes() == dy.tobytes(), "fused and per-node values differ"
        assert x.dictionary == y.dictionary


def _matches_reference(ref, port) -> None:
    """Reference vs port: labels, schema, masks, ints and codes bit-equal,
    floats to rtol=atol=1e-4."""
    assert port.col_labels.to_list() == ref.col_labels.to_list()
    assert port.row_labels.to_list() == ref.row_labels.to_list()
    assert [d.value for d in port.schema] == [d.value for d in ref.schema]
    for a, b in zip(ref.columns, port.columns):
        assert a.dictionary == b.dictionary
        va = np.ones(len(a), bool) if a.mask is None else np.asarray(a.mask)
        np.testing.assert_array_equal(_valid(b), va)
        da, db = np.asarray(a.data)[va], host(b.data)[va]
        if da.dtype.kind == "f":
            np.testing.assert_allclose(db, da, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(db, da)


def _check(plan_of, frames: dict, row_parts: int = 1, col_parts: int = 1,
           parts: dict | None = None):
    """``plan_of(pkg, store)`` in the port fused and per node (bit-equal)
    and in the reference fused (to tolerance).  Returns (fused port frame,
    fused executor, per-node executor, reference executor)."""
    out = {}
    for pkg, opts in (("port", (True, False)), ("ref", (True,))):
        store = _store(pkg, frames, row_parts, col_parts, parts)
        for optimize in opts:
            ex = PKG[pkg]["Ex"](store, optimize=optimize)
            out[pkg, optimize] = (ex.evaluate(plan_of(pkg, store)).to_frame(), ex)
    _bit_equal(out["port", True][0], out["port", False][0])
    _matches_reference(out["ref", True][0], out["port", True][0])
    return (out["port", True][0], out["port", True][1], out["port", False][1],
            out["ref", True][1])


# =============================================================================
# row-local chains (tests/test_fusion.py)
# =============================================================================
def _chain(pkg: str, src):
    alg = PKG[pkg]["alg"]
    m = alg.Map(src, _scale_udf(pkg, "f"))
    s = alg.Selection(m, alg.col("v") > alg.lit(0))
    p = alg.Projection(s, ("k", "v", "f"))
    return alg.Rename(p, {"f": "F"})


@pytest.mark.parametrize("row_parts,col_parts", [(1, 1), (3, 1), (4, 2), (1, 2)])
def test_fused_chain_matches_per_node_path(row_parts, col_parts):
    got, fx, _, rx = _check(lambda pkg, st: _chain(pkg, _src(pkg, store=st)),
                            {"f0": _chain_frame}, row_parts, col_parts)
    assert fx.stats.fused_groups >= 1 and fx.stats.fused_groups == rx.stats.fused_groups
    assert got.col_labels.to_list() == ["k", "v", "F"]


def test_fused_chain_with_udf_predicate_and_multiple_selections():
    preds = {"ref": lambda cols, frame: np.asarray(cols["v"].data) % 2 == 0,
             "port": lambda cols, frame: cols["v"].data % 2 == 0}
    got = {}
    for pkg, p in PKG.items():
        alg = p["alg"]
        store = _store(pkg, {"f0": lambda k: _chain_frame(k, 64)}, row_parts=3)
        pred = alg.Udf(name="even_v", elementwise=True, deps=frozenset(["v"]), fn=preds[pkg])
        plan = alg.Selection(alg.Selection(alg.Map(_src(pkg, store=store), _scale_udf(pkg, "f")),
                                           pred), alg.col("f") > alg.lit(0.0))
        ex = p["Ex"](store, optimize=False)
        fused_plan, fs = p["rw"].fuse_pipelines(plan)
        assert fused_plan.op == "fused_pipeline" and fs.fused_ops == 3
        got[pkg] = (ex._eval(fused_plan).to_frame(), ex._eval(plan).to_frame())
    _bit_equal(*got["port"])
    _matches_reference(got["ref"][0], got["port"][0])


def test_fusion_pass_structure():
    """The port's pass gives the reference's plan shapes and counters."""
    shapes = {}
    for pkg, p in PKG.items():
        alg, rw = p["alg"], p["rw"]
        src = alg.Source("f0", nrows=10, ncols=3)
        sel = alg.Selection(src, alg.col("v") > alg.lit(0))
        out, fs = rw.fuse_pipelines(sel)
        assert (out is sel or out == sel) and fs.groups == 0
        g = alg.GroupBy(alg.Rename(sel, {"v": "w"}), ("k",), [("w", "sum", "ws")])
        top = alg.Projection(alg.Selection(g, alg.col("ws") > alg.lit(1)), ("k",))
        out, fs = rw.fuse_pipelines(top)
        assert fs.groups == 1 and fs.barrier_groups == 1
        assert fs.producer_ops == 2 and fs.consumer_ops == 0
        assert fs.fused_ops == 2 + fs.producer_ops + fs.consumer_ops
        assert out.op == "fused_pipeline" and out.children[0].op == "fused_groupby"
        assert [s.op for s in out.children[0].stages] == ["selection", "rename"]
        assert [s.op for s in out.stages] == ["selection", "projection"]
        whole = alg.Udf(name="whole", fn=lambda c, f: f, elementwise=False)
        _, fs2 = rw.fuse_pipelines(alg.Selection(alg.Map(src, whole), alg.col("v") > alg.lit(0)))
        assert fs2.groups == 0
        lim, fs3 = rw.fuse_pipelines(alg.Limit(alg.Selection(alg.Rename(src, {"a": "b"}),
                                                             alg.col("v") > alg.lit(0)), 5))
        assert lim.op == "limit" and fs3.groups == 1 and fs3.fused_ops == 2
        shapes[pkg] = [n.op for n in out.walk()]
    assert shapes["port"] == shapes["ref"]


def test_shared_subplan_is_a_fusion_barrier():
    """A sub-plan two branches share keeps its own node, so the per-node
    cache still dedupes it."""
    def plan_of(pkg, store):
        alg = PKG[pkg]["alg"]
        sel = alg.Selection(alg.Source("f0", nrows=50, ncols=2), alg.col("v") > alg.lit(4))
        b1 = alg.Rename(alg.Projection(sel, ("v",)), {"v": "a"})
        b2 = alg.Rename(alg.Projection(sel, ("w",)), {"w": "b"})
        return alg.Union(b1, b2)

    fused, fs = trewrite.fuse_pipelines(plan_of("port", None))
    assert fs.groups == 2 and fs.fused_ops == 4
    assert sum(1 for n in fused.walk() if n.op == "selection") == 1
    frames = {"f0": lambda pkg: PKG[pkg]["F"].from_pydict(
        {"v": list(range(50)), "w": [i * 10 for i in range(50)]}, **PKG[pkg]["kw"])}
    _, fx, _, rx = _check(plan_of, frames, row_parts=3)
    assert fx.stats.cache_hits >= 1 and fx.stats.cache_hits == rx.stats.cache_hits


def test_fused_group_has_single_cache_entry():
    store = _store("port", {"f0": lambda k: _chain_frame(k, 60)}, row_parts=2)
    plan = _chain("port", _src("port", store=store))
    ex = TExecutor(store, optimize=True)
    ex.evaluate(plan)
    non_source = [k for k in ex.cache if k[0] != "source"]
    assert len(non_source) == 1 and non_source[0][0] == "fused_pipeline"
    before = ex.stats.cache_hits
    ex.evaluate(plan)
    assert ex.stats.cache_hits == before + 1


def test_fused_prefix_head():
    heads = {}
    for pkg, p in PKG.items():
        store = _store(pkg, {"f0": lambda k: _chain_frame(k, 90)}, row_parts=3)
        plan = _chain(pkg, _src(pkg, store=store))
        ex = p["Ex"](store, optimize=True)
        heads[pkg] = ex.evaluate_prefix(plan, 4).to_frame().head(4)
        assert ex.stats.prefix_evals == 1, pkg
        if pkg == "port":
            full = p["Ex"](store, optimize=False).evaluate(plan).to_frame().head(4)
            _bit_equal(heads[pkg], full)
    _matches_reference(heads["ref"], heads["port"])


def test_int_arithmetic_preserves_precision_above_2_24():
    big = 20_000_001          # > 2**24: float32 cannot hold big + 1
    f = TFrame.from_pydict({"v": [big, -7, 5]}, device="cpu")
    rf = RFrame.from_pydict({"v": [big, -7, 5]})
    for expr in [(lambda a: a.col("v") + a.lit(1)), (lambda a: a.col("v") - a.lit(2)),
                 (lambda a: a.col("v") * a.lit(2)), (lambda a: a.col("v") % a.lit(10)),
                 (lambda a: a.col("v") // a.lit(10))]:
        v, _ = t_eval_expr(expr(talg), f)
        rv, _ = r_eval_expr(expr(ralg), rf)
        assert not v.dtype.is_floating_point
        assert host(v).tolist() == np.asarray(rv).tolist()
    v, _ = t_eval_expr(talg.col("v") == talg.lit(big + 1), f)
    assert not bool(host(v)[0])
    v, _ = t_eval_expr(talg.col("v") / talg.lit(2), f)
    assert v.dtype.is_floating_point
    # and through a fused chain (a projection, then the predicate)
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.Selection(alg.Projection(_src(pkg, store=st), ("v",)),
                             alg.col("v") + alg.lit(1) == alg.lit(big + 1))
    got, fx, _, rx = _check(plan_of, {"f0": lambda pkg: PKG[pkg]["F"].from_pydict(
        {"v": [big, big + 1, -7, 5], "w": [0.5, 1.5, 2.5, 3.5]}, **PKG[pkg]["kw"])})
    assert fx.stats.fused_groups == rx.stats.fused_groups == 1
    assert got.col("v").to_pylist() == [big]


def test_int_and_float_literals_do_not_collide_in_caches():
    """1 == 1.0 in Python, but plans differing only in the literal's type
    have distinct cache keys: float32 rounds 2^24 + 1 back to 2^24."""
    assert talg.lit(1).key() != talg.lit(1.0).key()
    assert talg.lit(1).key() != talg.lit(True).key()
    big = 2 ** 24
    counts = {}
    for pkg, p in PKG.items():
        alg = p["alg"]
        store = {"f0": p["PF"].from_frame(p["F"].from_pydict({"v": [big]}, **p["kw"]))}
        src = alg.Source("f0", nrows=1, ncols=1)
        pa = alg.Selection(src, (alg.col("v") + alg.lit(1.0)) == alg.lit(float(big)))
        pb = alg.Selection(src, (alg.col("v") + alg.lit(1)) == alg.lit(big))
        assert pa.cache_key() != pb.cache_key()
        ex = p["Ex"](store, optimize=True)
        counts[pkg] = (ex.evaluate(pa).nrows, ex.evaluate(pb).nrows)
    assert counts["port"] == counts["ref"] == (1, 0)


# =============================================================================
# producer fusion into GROUPBY (tests/test_blocking_fusion.py)
# =============================================================================
@pytest.mark.parametrize("row_parts", [1, 4, 7])
def test_producer_into_groupby_dense_int_key(row_parts):
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.GroupBy(
            alg.Selection(alg.Map(_src(pkg, store=st), _scale_udf(pkg)),
                          alg.col("v") > alg.lit(0)),
            ("k",),
            [("x", "sum", "xs"), ("x", "mean", "xm"), ("v", "min", "vmin"),
             ("v", "max", "vmax"), ("v", "count", "vc"), ("x", "std", "xstd")])
    _, fx, _, _ = _check(plan_of, {"f0": _mk_frame}, row_parts)
    assert fx.stats.barrier_fused_groups == 1
    assert fx.stats.producer_stage_ops == 2
    assert fx._prepared(plan_of("port", None)).op == "fused_groupby"


def test_producer_into_groupby_plain_segment_reduce_on_the_cpu():
    """The fused partials take ``segment_reduce``'s plain version on CPU
    tensors: no kernel launch, the same result as per node."""
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.GroupBy(alg.Selection(_src(pkg, store=st), alg.col("v") > alg.lit(0)),
                           ("k",), [("x", "sum", "xs"), ("v", "max", "vx")])
    sr_mod.counter.reset()
    _, fx, _, _ = _check(plan_of, {"f0": lambda pkg: _mk_frame(pkg, 120)}, 3)
    assert fx._prepared(plan_of("port", None)).op == "fused_groupby"
    assert sr_mod.counter.launches == 0


def test_producer_into_groupby_string_key_general_path():
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.GroupBy(
            alg.Selection(alg.Map(_src(pkg, store=st), _scale_udf(pkg)),
                          alg.col("v") > alg.lit(-10)),
            ("s",), [("x", "sum", "xs"), ("v", "mean", "vm")])
    _, fx, _, _ = _check(plan_of, {"f0": _mk_frame}, 5)
    assert fx.stats.barrier_fused_groups == 1


def test_producer_into_groupby_null_keys_dropped():
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.GroupBy(alg.Selection(_src(pkg, store=st), alg.col("v") != alg.lit(3)),
                           ("k",), [("v", "sum", "vs")])
    _, fx, _, _ = _check(plan_of, {"f0": _mk_frame}, 3)
    assert fx._prepared(plan_of("port", None)).op == "fused_groupby"


def test_producer_into_groupby_empty_selection():
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.GroupBy(alg.Selection(_src(pkg, store=st), alg.col("v") > alg.lit(10 ** 6)),
                           ("k",), [("v", "sum", "vs")])
    got, _, _, _ = _check(plan_of, {"f0": lambda pkg: _mk_frame(pkg, 64, with_nulls=False)}, 3)
    assert got.nrows == 0


# =============================================================================
# consumer fusion after SORT / JOIN
# =============================================================================
@pytest.mark.parametrize("row_parts", [1, 4])
def test_consumer_after_sort_filters_index_before_gather(row_parts):
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.Projection(alg.Selection(alg.Sort(_src(pkg, store=st), ("v",)),
                                            alg.col("v") > alg.lit(5)), ("k", "v"))
    _, fx, px, rx = _check(plan_of, {"f0": _mk_frame}, row_parts)
    assert fx._prepared(plan_of("port", None)).op == "fused_sort"
    assert 0 < fx.stats.gather_rows < px.stats.gather_rows
    assert px.stats.gather_rows == 211
    assert fx.stats.gather_rows == rx.stats.gather_rows


def test_consumer_after_sort_with_trailing_map():
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.Map(alg.Selection(alg.Sort(_src(pkg, store=st), ("v",), ascending=False),
                                     alg.col("x").notna()), _scale_udf(pkg))
    _, fx, _, _ = _check(plan_of, {"f0": _mk_frame}, 3)
    assert fx._prepared(plan_of("port", None)).op == "fused_sort"


def _rates(pkg):
    return PKG[pkg]["F"].from_pydict({"k": [0, 1, 2, 3, 9], "w": [10.0, None, 30.0, 40.0, 50.0]},
                                     **PKG[pkg]["kw"])


def _join_frames(right, n=97, with_nulls=True) -> dict:
    return {"f0": lambda pkg: _mk_frame(pkg, n, with_nulls), "f1": right}


@pytest.mark.parametrize("how", ["inner", "left", "outer"])
def test_consumer_after_join_filters_match_index(how):
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.Selection(alg.Join(_src(pkg, "f0", st), _src(pkg, "f1", st),
                                      on=("k",), how=how), alg.col("w") > alg.lit(15.0))
    frames = _join_frames(_rates)
    _, fx, px, rx = _check(plan_of, frames, 3, parts={"f1": 1})
    assert fx._prepared(plan_of("port", _store("port", frames, 3))).op == "fused_join"
    assert fx.stats.gather_rows < px.stats.gather_rows
    assert fx.stats.gather_rows == rx.stats.gather_rows


def test_consumer_after_join_projection_prunes_gather():
    right = lambda pkg: PKG[pkg]["F"].from_pydict({"k": [0, 1, 2], "w": [1.0, 2.0, 3.0]},
                                                  **PKG[pkg]["kw"])

    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.Projection(alg.Selection(
            alg.Join(_src(pkg, "f0", st), _src(pkg, "f1", st), on=("k",), how="inner"),
            alg.col("v") > alg.lit(0)), ("k", "w"))
    frames = _join_frames(right, n=80, with_nulls=False)
    _, fx, _, _ = _check(plan_of, frames, 2, parts={"f1": 1})
    assert fx._prepared(plan_of("port", _store("port", frames, 2))).op == "fused_join"


# =============================================================================
# WINDOW chains across seams
# =============================================================================
@pytest.mark.parametrize("func", ["cumsum", "cummax", "cummin", "cumprod"])
def test_window_scan_chain_seams(func):
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.Map(alg.Window(
            alg.Selection(_src(pkg, store=st), alg.col("v") % alg.lit(3) != alg.lit(0)),
            func, ("x",)), _scale_udf(pkg))
    ws_mod.counter.reset()
    _, fx, _, _ = _check(plan_of, {"f0": lambda pkg: _mk_frame(pkg, 150)}, 6)
    prep = fx._prepared(plan_of("port", None))
    assert prep.op == "fused_window"
    assert [s.op for s in prep.pre_stages] == ["selection"]
    assert [s.op for s in prep.post_stages] == ["map"]
    assert ws_mod.counter.launches == 0      # the plain scan on CPU tensors


def test_window_seam_exactness_single_vs_many_blocks():
    """Block boundaries are invisible: the fused multi-block result equals
    the single-block one (cumsum to rounding)."""
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.Map(alg.Window(alg.Selection(_src(pkg, store=st), alg.col("v") > alg.lit(-100)),
                                  "cumsum", ("x",)), _scale_udf(pkg))
    frames = {"f0": lambda pkg: _mk_frame(pkg, 120, with_nulls=False)}
    got = []
    for rp in (8, 1):
        store = _store("port", frames, rp)
        got.append(TExecutor(store, optimize=True).evaluate(plan_of("port", store)).to_frame())
    np.testing.assert_allclose(host(got[0].col("x").data), host(got[1].col("x").data),
                               rtol=1e-5, atol=1e-5)
    _check(plan_of, frames, 8)


@pytest.mark.parametrize("func,size", [("diff", None), ("shift", None), ("rolling_sum", 8)])
def test_window_halo_and_rolling_chains(func, size):
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        return alg.Map(alg.Window(alg.Selection(_src(pkg, store=st), alg.col("v").notna()),
                                  func, ("x",), size=size, periods=2), _scale_udf(pkg))
    _, fx, _, _ = _check(plan_of, {"f0": lambda pkg: _mk_frame(pkg, 100)}, 4)
    assert fx._prepared(plan_of("port", None)).op == "fused_window"


def test_fused_window_stays_prefix_safe():
    """Barrier-fusing a forward window keeps §6.1.2 prefix evaluation."""
    heads = {}
    for pkg, p in PKG.items():
        store = _store(pkg, {"f0": lambda k: _mk_frame(k, 300, with_nulls=False)}, 6)
        alg = p["alg"]
        plan = alg.Map(alg.Window(alg.Selection(_src(pkg, store=store),
                                                alg.col("v") > alg.lit(-200)),
                                  "cumsum", ("x",)), _scale_udf(pkg))
        ex = p["Ex"](store, optimize=True)
        assert ex._prepared(plan).op == "fused_window"
        heads[pkg] = ex.evaluate_prefix(plan, 4).to_frame().head(4)
        assert ex.stats.prefix_evals == 1, pkg
        if pkg == "port":
            full = p["Ex"](store, optimize=False).evaluate(plan).to_frame().head(4)
            _bit_equal(heads[pkg], full)
    _matches_reference(heads["ref"], heads["port"])


# =============================================================================
# MQO fusion barriers (session statement history)
# =============================================================================
def test_history_splits_fused_group_and_reuses_cache():
    outs = {}
    for pkg, p in PKG.items():
        alg = p["alg"]
        kw = p["kw"]
        f = _mk_frame(pkg, 128, with_nulls=False)
        sess = p["Session"](mode=p["Mode"].LAZY, **kw)
        src = sess.register_frame(p["PF"].from_frame(f, row_parts=3))
        shared = alg.Selection(alg.Map(src, _scale_udf(pkg)), alg.col("v") > alg.lit(0))
        sess.statement(shared)
        sess.collect(shared)
        plan = alg.GroupBy(shared, ("k",), [("x", "sum", "xs")])
        prep = sess.executor._prepared(plan)
        assert prep.op == "groupby" and prep.children[0].op == "fused_pipeline", pkg
        hits = sess.executor.stats.cache_hits
        out = sess.collect(plan)
        assert sess.executor.stats.cache_hits > hits, pkg
        sess2 = p["Session"](mode=p["Mode"].LAZY, **kw)
        src2 = sess2.register_frame(p["PF"].from_frame(f, row_parts=3))
        shared2 = alg.Selection(alg.Map(src2, _scale_udf(pkg)), alg.col("v") > alg.lit(0))
        plan2 = alg.GroupBy(shared2, ("k",), [("x", "sum", "xs")])
        assert sess2.executor._prepared(plan2).op == "fused_groupby", pkg
        outs[pkg] = (out, sess2.collect(plan2))
        sess.close()
        sess2.close()
    _bit_equal(*outs["port"])
    _matches_reference(outs["ref"][0], outs["port"][0])


def test_resubmitting_same_statement_reproduces_fused_key():
    """A statement is never a fusion barrier against itself."""
    f = _mk_frame("port", 90, with_nulls=False)
    sess = TSession(mode=TEvalMode.EAGER, device="cpu")
    try:
        src = sess.register_frame(TPF.from_frame(f, row_parts=2))
        plan = talg.GroupBy(talg.Selection(src, talg.col("v") > talg.lit(0)),
                            ("k",), [("v", "sum", "vs")])
        sess.statement(plan)
        evaluated = sess.executor.stats.evaluated_nodes
        sess.statement(plan)
        assert sess.executor.stats.evaluated_nodes == evaluated
        assert sess.executor._prepared(plan).op == "fused_groupby"
    finally:
        sess.close()


# =============================================================================
# counters: one source of truth
# =============================================================================
def test_counter_invariant_across_mixed_plan():
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        g = alg.GroupBy(alg.Selection(alg.Map(_src(pkg, store=st), _scale_udf(pkg)),
                                      alg.col("v") > alg.lit(0)), ("k",), [("x", "sum", "xs")])
        return alg.Rename(alg.Selection(g, alg.col("xs") > alg.lit(0.0)), {"xs": "total"})
    out, fs = trewrite.fuse_pipelines(plan_of("port", None))
    pipeline_ops = sum(len(n.params["stages"]) for n in out.walk() if n.op == "fused_pipeline")
    assert fs.fused_ops == pipeline_ops + fs.producer_ops + fs.consumer_ops
    assert fs.barrier_groups == 1 and fs.producer_ops == 2 and fs.groups == 1
    _, fx, _, rx = _check(plan_of, {"f0": lambda pkg: _mk_frame(pkg, 96, with_nulls=False)}, 2)
    st = fx.stats
    assert st.fused_stage_ops == pipeline_ops + st.producer_stage_ops + st.consumer_stage_ops
    names = ("fused_groups", "fused_stage_ops", "barrier_fused_groups",
             "producer_stage_ops", "consumer_stage_ops")
    assert [getattr(st, k) for k in names] == [getattr(rx.stats, k) for k in names]


def test_shared_blocking_node_not_absorbed():
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        srt = alg.Sort(_src(pkg, store=st), ("v",))
        b1 = alg.Projection(alg.Selection(srt, alg.col("v") > alg.lit(0)), ("v",))
        b2 = alg.Projection(alg.Selection(srt, alg.col("v") < alg.lit(0)), ("v",))
        return alg.Union(b1, b2)
    out, fs = trewrite.fuse_pipelines(plan_of("port", None))
    assert fs.barrier_groups == 0
    assert sum(1 for n in out.walk() if n.op == "sort") == 1
    _check(plan_of, {"f0": lambda pkg: _mk_frame(pkg, 60, with_nulls=False)}, 2)


# =============================================================================
# fused SORT / JOIN through the exchange against the serial path
# (tests/test_shuffle_differential.py)
# =============================================================================
def _shuffle_sweep(plan_of, frames: dict, monkeypatch) -> None:
    """Fused (exchange) == per-node (exchange) == fused serial
    ``REPRO_SHUFFLE=0`` in the port, and == the reference, on grids 1 and 4."""
    for rp in (1, 4):
        got, fx, _, _ = _check(plan_of, frames, rp)
        assert fx.stats.shuffle_buckets > 0
        monkeypatch.setenv("REPRO_SHUFFLE", "0")
        try:
            store = _store("port", frames, rp)
            ex = TExecutor(store, optimize=True)
            serial = ex.evaluate(plan_of("port", store)).to_frame()
            assert ex.stats.shuffle_buckets == 0
        finally:
            monkeypatch.delenv("REPRO_SHUFFLE")
        _bit_equal(got, serial)


def _join_case(seed: int, nulls: bool, nl: int, nr: int) -> dict:
    rng = np.random.default_rng(seed)
    pool = int(rng.choice([3, 8, 40]))

    def keys(n):
        ks = rng.integers(0, pool, n).tolist()
        if nulls:
            mask = rng.random(n) < 0.25
            ks = [None if m else k for k, m in zip(ks, mask)]
        return ks

    ldata = {"k": keys(nl), "a": (rng.integers(0, 100, nl) * 0.25).tolist()}
    rdata = {"k": keys(nr), "b": (rng.integers(0, 100, nr) * 0.5).tolist()}
    return {"l": lambda pkg: PKG[pkg]["F"].from_pydict(ldata, **PKG[pkg]["kw"]),
            "r": lambda pkg: PKG[pkg]["F"].from_pydict(rdata, **PKG[pkg]["kw"])}


def test_fused_join_filter_project_matches_serial(monkeypatch):
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        j = alg.Join(alg.Source("l"), alg.Source("r"), on=["k"], how="left")
        return alg.Projection(alg.Selection(j, alg.col("a") > alg.lit(5.0)), ["k", "a"])
    _shuffle_sweep(plan_of, _join_case(9, False, 40, 40), monkeypatch)


def test_fused_join_right_side_predicate_matches_serial(monkeypatch):
    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        j = alg.Join(alg.Source("l"), alg.Source("r"), on=["k"], how="outer")
        return alg.Selection(j, alg.col("b") < alg.lit(30.0))
    _shuffle_sweep(plan_of, _join_case(13, True, 35, 30), monkeypatch)


def test_fused_sort_filter_project_matches_serial(monkeypatch):
    rng = np.random.default_rng(6)
    n = 50
    ks = rng.integers(0, 8, n).tolist()
    mask = rng.random(n) < 0.25
    data = {"k": [None if m else k for k, m in zip(ks, mask)],
            "x": (rng.integers(0, 6, n) * 0.5).tolist(), "p": list(range(n))}

    def plan_of(pkg, st):
        alg = PKG[pkg]["alg"]
        s = alg.Sort(alg.Source("s"), ["k", "x"], False)
        return alg.Projection(alg.Selection(s, alg.col("x") > alg.lit(0.5)), ["k", "p"])
    _shuffle_sweep(plan_of, {"s": lambda pkg: PKG[pkg]["F"].from_pydict(data, **PKG[pkg]["kw"])},
                   monkeypatch)
