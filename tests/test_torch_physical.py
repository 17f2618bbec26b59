"""Physical layer of the PyTorch port against the JAX package.

The four Fig. 6 cases (map, groupby(n), groupby(1), transpose) run through
``physical.run_node`` as ``benchmarks/bench_fig6.py`` drives them, over row
grids {1, W, 4W} (W = pool width), plus a string-key groupby (the general
key-factorization path), the serial join's hows and a coded TRANSPOSE.
Labels, schemas, ints, codes and masks compare bit-equal; float aggregates
use rtol=atol=1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algebra as ralg
from repro.core import physical as rphys
from repro.core.dtypes import Domain as RDomain
from repro.core.frame import Column as RColumn
from repro.core.frame import Frame as RFrame
from repro.core.labels import labels_from_values as rlabels
from repro.core.partition import PartitionedFrame as RPF
from repro.core.schedule import pool_width
from repro.data.synthetic import numeric_matrix_frame as r_matrix
from repro.data.synthetic import taxi_like_frame as r_taxi
from repro_torch.core import algebra as talg
from repro_torch.core import physical as tphys
from repro_torch.core.dtypes import Domain as TDomain
from repro_torch.core.frame import Column as TColumn
from repro_torch.core.frame import Frame as TFrame
from repro_torch.core.frame import host
from repro_torch.core.labels import labels_from_values as tlabels
from repro_torch.core.partition import PartitionedFrame as TPF
from repro_torch.data import numeric_matrix_frame as t_matrix
from repro_torch.data import taxi_like_frame as t_taxi

N = 3000


def _frames_match(ref, port, float_tol=True):
    assert port.col_labels.to_list() == ref.col_labels.to_list()
    assert port.row_labels.to_list() == ref.row_labels.to_list()
    assert [d.value for d in port.schema] == [d.value for d in ref.schema]
    for a, b in zip(ref.columns, port.columns):
        assert a.dictionary == b.dictionary
        va = np.ones(len(a), bool) if a.mask is None else np.asarray(a.mask)
        np.testing.assert_array_equal(host(b.valid_mask()), va)
        da, db = np.asarray(a.data)[va], host(b.data)[va]
        if float_tol and da.dtype.kind == "f":
            np.testing.assert_allclose(db, da, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(db, da)


def _exec(alg, run_node, pf, build):
    src = alg.Source("bench", 0, 0)

    def ev(node):
        if node.op == "source":
            return pf
        return run_node(node, [ev(c) for c in node.children])

    return ev(build(alg, src)).to_frame()


def _r_fillna():
    def fn(cols, frame):
        out = {}
        for n, c in cols.items():
            if c.domain is RDomain.FLOAT and c.mask is not None:
                out[n] = RColumn(jnp.where(c.mask, c.data, 0.0), c.domain, None, None)
            else:
                out[n] = c
        return RFrame(list(out.values()), frame.row_labels, rlabels(list(out.keys())))
    return ralg.Udf.wrap(fn, name="bench_fillna", elementwise=True)


def _t_fillna():
    def fn(cols, frame):
        out = {}
        for n, c in cols.items():
            if c.domain is TDomain.FLOAT and c.mask is not None:
                out[n] = TColumn(torch.where(c.mask, c.data, 0.0), c.domain, None, None)
            else:
                out[n] = c
        return TFrame(list(out.values()), frame.row_labels, tlabels(list(out.keys())))
    return talg.Udf.wrap(fn, name="bench_fillna", elementwise=True)


CASES = {
    "map": lambda alg, src: alg.Map(src, _r_fillna() if alg is ralg else _t_fillna()),
    "groupby_n": lambda alg, src: alg.GroupBy(src, ("passenger_count",),
                                              [("f0", "count", "cnt")]),
    "groupby_1": lambda alg, src: alg.GroupBy(src, (), [("f0", "count", "cnt")]),
    "groupby_n_aggs": lambda alg, src: alg.GroupBy(
        src, ("passenger_count",),
        [("f0", "sum", "s"), ("f1", "mean", "m"), ("f2", "min", "lo"),
         ("f3", "max", "hi"), ("f4", "var", "v"), ("f5", "std", "sd")]),
    "groupby_str_key": lambda alg, src: alg.GroupBy(
        src, ("payment_type",), [("f0", "sum", "s"), ("f1", "count", "c"),
                                 ("passenger_count", "mean", "pm")]),
    "groupby_two_keys": lambda alg, src: alg.GroupBy(
        src, ("payment_type", "passenger_count"), [("f2", "min", "lo")]),
}


def _grids():
    w = pool_width()
    return sorted({1, w, 4 * w})


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("grid", _grids())
def test_fig6_cases_match_reference(case, grid):
    rpf = RPF.from_frame(r_taxi(N, seed=0), row_parts=grid)
    tpf = TPF.from_frame(t_taxi(N, seed=0, device="cpu"), row_parts=grid)
    ref = _exec(ralg, rphys.run_node, rpf, CASES[case])
    port = _exec(talg, tphys.run_node, tpf, CASES[case])
    _frames_match(ref, port)


@pytest.mark.parametrize("grid", _grids())
@pytest.mark.parametrize("col_parts", [1, 2])
def test_fig6_transpose_matches_reference(grid, col_parts):
    rpf = RPF.from_frame(r_matrix(N // 10, 64, seed=0), row_parts=grid, col_parts=col_parts)
    tpf = TPF.from_frame(t_matrix(N // 10, 64, seed=0, device="cpu"), row_parts=grid,
                         col_parts=col_parts)
    t = lambda alg, src: alg.Transpose(src)
    tt = lambda alg, src: alg.Transpose(alg.Transpose(src))
    _frames_match(_exec(ralg, rphys.run_node, rpf, t),
                  _exec(talg, tphys.run_node, tpf, t), float_tol=False)
    back = _exec(talg, tphys.run_node, tpf, tt)
    _frames_match(_exec(ralg, rphys.run_node, rpf, tt), back, float_tol=False)
    _frames_match(rpf.to_frame(), back, float_tol=False)        # .T.T is the input


def _small(pkg):
    Frame = RFrame if pkg == "ref" else TFrame
    kw = {} if pkg == "ref" else {"device": "cpu"}
    left = Frame.from_pydict({"k": ["a", "b", "a", None, "d"], "lv": [1, 2, 3, 4, 5],
                              "x": [0.5, None, 1.5, 2.5, 3.5]}, **kw)
    right = Frame.from_pydict({"k": ["a", "a", "c", "b"], "rv": [10, 20, 30, 40]}, **kw)
    PF = RPF if pkg == "ref" else TPF
    return PF.from_frame(left, row_parts=2), PF.from_frame(right, row_parts=2)


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_serial_matches_reference(how):
    params = {"on": ["k"], "how": how, "left_on": None, "right_on": None}
    rl, rr = _small("ref")
    tl, tr = _small("port")
    _frames_match(rphys._join_serial(rl, rr, params).to_frame(),
                  tphys._join_serial(tl, tr, params).to_frame())


def test_cross_join_matches_reference():
    params = {"on": None, "how": "inner", "left_on": None, "right_on": None}
    rl, rr = _small("ref")
    tl, tr = _small("port")
    _frames_match(rphys._join_serial(rl, rr, params).to_frame(),
                  tphys._join_serial(tl, tr, params).to_frame())


@pytest.mark.parametrize("grid", [1, 2])
def test_coded_transpose_matches_reference(grid):
    d = {"iPhone 11 Pro": ["5.8-inch", "12MP", "120MP", "Yes"],
         "iPhone XR": ["6.1-inch", "12MP", "7MP", "No"],
         "n": [1, 2, None, 4]}
    rows = ["Display", "Camera", "Front Camera", "Wireless Charging"]
    rpf = RPF.from_frame(RFrame.from_pydict(d, row_labels=rows), row_parts=grid)
    tpf = TPF.from_frame(TFrame.from_pydict(d, row_labels=rows, device="cpu"), row_parts=grid)
    for build in (lambda a, s: a.Transpose(s), lambda a, s: a.Transpose(a.Transpose(s))):
        _frames_match(_exec(ralg, rphys.run_node, rpf, build),
                      _exec(talg, tphys.run_node, tpf, build))


ROW_OPS = {
    "selection": lambda a, s: a.Selection(s, (a.col("lv") > 1) & a.col("x").notna()),
    "selection_code": lambda a, s: a.Selection(s, a.col("k") == "a"),
    "projection": lambda a, s: a.Projection(s, ["x", "k"]),
    "rename": lambda a, s: a.Rename(s, {"lv": "value"}),
    "limit": lambda a, s: a.Limit(s, 3, tail=False),
    "tail": lambda a, s: a.Limit(s, 2, tail=True),
    "to_labels": lambda a, s: a.ToLabels(s, "k"),
    "from_labels": lambda a, s: a.FromLabels(s, "idx"),
    "union": lambda a, s: a.Union(s, s),
    "arith": lambda a, s: a.Selection(s, (a.col("lv") * 2 - 1) % 3 == a.lit(1)),
}


@pytest.mark.parametrize("op", list(ROW_OPS))
def test_row_local_ops_match_reference(op):
    rl, _ = _small("ref")
    tl, _ = _small("port")
    _frames_match(_exec(ralg, rphys.run_node, rl, ROW_OPS[op]),
                  _exec(talg, tphys.run_node, tl, ROW_OPS[op]))


@pytest.mark.parametrize("op,item", [("drop_duplicates", "M6"), ("difference", "M6")])
def test_unported_ops_name_their_roadmap_item(op, item):
    """The two operators of ROADMAP item ``item`` were the last that raised
    ``NotImplementedError``; they now run and match the reference."""
    rl, _ = _small("ref")
    tl, _ = _small("port")
    build = {"drop_duplicates": lambda a, s: a.DropDuplicates(s, ["k"]),
             "difference": lambda a, s: a.Difference(
                 s, a.Selection(s, a.col("lv") > a.lit(0)))}[op]
    _frames_match(_exec(ralg, rphys.run_node, rl, build),
                  _exec(talg, tphys.run_node, tl, build))
