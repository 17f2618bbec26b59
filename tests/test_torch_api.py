"""API layer of the PyTorch port against the JAX package: the Figure-1
workflow and the Fig. 6 operator mix (``tests/test_system.py``) mirrored on
the port and compared value by value, the algebra cases of
``tests/test_algebra_ops.py`` run through both, and the three evaluation
modes agreeing.  Labels, ints and codes compare bit-equal; floats (cov,
means) use rtol=atol=1e-4."""
import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.data.synthetic import numeric_matrix_frame as r_matrix
from repro.data.synthetic import taxi_like_frame as r_taxi
from repro_torch.core.frame import host
from repro_torch.data import numeric_matrix_frame as t_matrix
from repro_torch.data import taxi_like_frame as t_taxi


def _same(ref, port):
    """Reference vs port Frame: labels, schema, masks, values."""
    assert port.col_labels.to_list() == ref.col_labels.to_list()
    assert port.row_labels.to_list() == ref.row_labels.to_list()
    assert [d.value for d in port.schema] == [d.value for d in ref.schema]
    for a, b in zip(ref.columns, port.columns):
        assert a.dictionary == b.dictionary
        va = np.ones(len(a), bool) if a.mask is None else np.asarray(a.mask)
        np.testing.assert_array_equal(host(b.valid_mask()), va)
        da, db = np.asarray(a.data)[va], host(b.data)[va]
        if da.dtype.kind == "f":
            np.testing.assert_allclose(db, da, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(db, da)


def _sessions(mode="eager", parts=2, **kw):
    return (R.Session(mode=mode, default_row_parts=parts, **kw),
            T.Session(mode=mode, default_row_parts=parts, device="cpu", **kw))


@pytest.fixture
def both():
    rs, ts = _sessions()
    yield rs, ts
    rs.close()
    ts.close()


def figure1(api, s):
    """The paper's Figure-1 workflow (tests/test_system.py), returning every
    intermediate the test inspects."""
    out = {}
    products = api.DataFrame({
        "iPhone 11 Pro": ["5.8-inch", "12MP", "120MP", "Yes"],
        "iPhone 11 Pro Max": ["6.5-inch", "12MP", "12MP", "Yes"],
        "iPhone XR": ["6.1-inch", "12MP", "7MP", "No"],
        "iPhone 8 Plus": ["5.5-inch", "12MP", "7MP", "No"],
    }, row_labels=["Display", "Camera", "Front Camera", "Wireless Charging"], session=s)
    out["head"] = products.head(4)
    products.iloc[2, 0] = "12MP"
    out["fixed"] = products.iloc[2, 0]
    pt = products.T
    out["transposed"] = pt.collect()
    pt["Wireless Charging"] = pt["Wireless Charging"].map(lambda v: 1 if v == "Yes" else 0)
    out["mapped"] = pt.collect().induce()
    prices = api.DataFrame({
        "model": ["iPhone 11 Pro", "iPhone 11 Pro Max", "iPhone XR", "iPhone 8 Plus"],
        "price": [999, 1099, 599, 449],
        "rating": [4.5, 4.6, 4.4, 4.3],
    }, session=s)
    one_hot = api.get_dummies(pt.reset_index("model"), ["Display"])
    out["one_hot"] = one_hot.collect()
    joined = one_hot.merge(prices, on="model")
    out["joined"] = joined.collect()
    num = joined[[c for c in joined.columns if c not in ("model", "Camera", "Front Camera")]]
    out["cov"] = num.cov()
    out["shape"] = num.shape
    return out


def test_figure1_workflow_end_to_end(both):
    rs, ts = both
    ref, port = figure1(R, rs), figure1(T, ts)
    for k in ("head", "transposed", "mapped", "one_hot", "joined", "cov"):
        _same(ref[k], port[k])
    assert port["fixed"] == ref["fixed"] == "12MP"
    assert port["shape"] == ref["shape"]
    assert port["mapped"].col("Wireless Charging").to_pylist() == [1, 1, 0, 0]
    assert any(c.startswith("Display_") for c in port["one_hot"].col_labels.to_list())


def fig6_mix(api, s, frame):
    df = api.DataFrame(frame, session=s)
    out = {"filled": df.fillna(0.0).collect(),
           "groupby_n": df.groupby("passenger_count").count().collect(),
           "groupby_1": df["f0"].count(),
           "agg": df.groupby("passenger_count").agg(
               {"f0": ["sum", "mean", "min", "max"]}).collect()}
    num = df[[f"f{i}" for i in range(6)]]
    out["back"] = num.T.T.collect()
    return out


def test_fig6_operator_mix_partitioned(both):
    rs, ts = both
    n = 20_000
    ref = fig6_mix(R, rs, r_taxi(n, seed=1))
    port = fig6_mix(T, ts, t_taxi(n, seed=1, device="cpu"))
    for k in ("filled", "groupby_n", "agg", "back"):
        _same(ref[k], port[k])
    assert port["groupby_1"] == ref["groupby_1"]
    g = port["groupby_n"]
    assert sum(g.col("payment_type").to_pylist()) == n
    assert port["back"].shape == (n, 6)


def test_wide_count_matches_reference(both):
    """An all-column aggregate of the wide output of .T: 1,600 columns, more
    than one segment_reduce launch takes on the card."""
    rs, ts = both
    ref = R.DataFrame(r_matrix(1600, 3, seed=0), session=rs).T.count().collect()
    port = T.DataFrame(t_matrix(1600, 3, seed=0, device="cpu"), session=ts).T.count().collect()
    _same(ref, port)
    assert port.shape == (1, 1600) and port.col(port.col_labels.to_list()[0]).to_pylist() == [3]


@pytest.mark.parametrize("fn", ["sum", "mean", "min", "max"])
def test_wide_aggregates_match_numpy(fn):
    """The other all-column aggregates of that wide frame, against numpy from
    the same seed (the reference takes minutes to compile them at this
    width, so numpy stands in for it)."""
    s = T.Session(mode="eager", default_row_parts=2, device="cpu")
    try:
        got = getattr(T.DataFrame(t_matrix(1600, 3, seed=0, device="cpu"), session=s).T,
                      fn)().collect()
    finally:
        s.close()
    x = np.random.default_rng(0).standard_normal((1600, 3)).astype(np.float32)
    want = getattr(x.astype(np.float64), fn)(axis=1)
    assert got.shape == (1, 1600)
    np.testing.assert_allclose(host(got.as_matrix()[0])[0], want, rtol=1e-4, atol=1e-4)


CASES = {
    "selection": lambda api, s: (lambda d: d[d["v"] > 2])(_df(api, s)),
    "selection_nulls": lambda api, s: (lambda d: d[d["w"] > 1])(_df(api, s)),
    "projection": lambda api, s: _df(api, s)[["w", "k"]],
    "union": lambda api, s: api.DataFrame({"x": [1, 2]}, session=s).append(
        api.DataFrame({"x": [3, 4]}, session=s)),
    "cross": lambda api, s: api.DataFrame({"x": [1, 2]}, session=s).cross(
        api.DataFrame({"y": [10, 20]}, session=s)),
    "join_inner": lambda api, s: api.DataFrame(
        {"k": ["a", "b", "a"], "lv": [1, 2, 3]}, session=s).merge(
        api.DataFrame({"k": ["a", "a", "c"], "rv": [10, 20, 30]}, session=s), on="k"),
    "join_outer": lambda api, s: api.DataFrame(
        {"k": ["a", "b"], "lv": [1, 2]}, session=s).merge(
        api.DataFrame({"k": ["a", "c"], "rv": [10, 30]}, session=s), on="k", how="outer"),
    "groupby_agg": lambda api, s: _df(api, s).groupby("k").agg(
        {"v": ["sum", "count", "mean"], "w": ["min", "max"]}),
    "rename": lambda api, s: _df(api, s).rename(columns={"v": "value"}),
    "transpose_hetero": lambda api, s: api.DataFrame(
        {"i": [1, 2, 3], "f": [1.5, 2.5, 3.5]}, session=s).T.T,
    "transpose_labels": lambda api, s: api.DataFrame(
        {"a": [1, 2], "b": [3, 4]}, row_labels=["r0", "r1"], session=s).T,
    "labels_inverse": lambda api, s: api.DataFrame(
        {"k": ["x", "y", "z"], "v": [1, 2, 3]}, session=s).set_index("k").reset_index("k"),
    "get_dummies": lambda api, s: api.get_dummies(api.DataFrame(
        {"c": ["p", "q", "p", None], "v": [1, 2, 3, 4]}, session=s), ["c"]),
    "agg_union": lambda api, s: api.DataFrame(
        {"v": [1.0, 2.0, 3.0], "u": [4.0, 5.0, 6.0]}, session=s).agg(["sum", "min"]),
    "pivot": lambda api, s: api.DataFrame(
        {"year": [2001, 2001, 2002, 2002], "month": ["jan", "feb", "jan", "feb"],
         "sales": [100, 110, 150, 200]}, session=s).pivot(
        index="year", columns="month", values="sales"),
    "isna": lambda api, s: _df(api, s).isna(),
    "dropna": lambda api, s: _df(api, s).dropna(),
    "assign_expr": lambda api, s: _assign(_df(api, s)),
}


def _df(api, s):
    return api.DataFrame({
        "k": ["a", "b", "a", "c", "b", "a", None, "c"],
        "v": [3, 1, 4, 1, 5, 9, 2, 6],
        "w": [0.5, None, 1.5, 2.0, None, 3.0, 3.5, 4.0],
    }, session=s)


def _assign(d):
    d["z"] = d["v"] * 2 + d["w"]
    return d


@pytest.mark.parametrize("case", list(CASES))
def test_algebra_cases_match_reference(both, case):
    rs, ts = both
    _same(CASES[case](R, rs).collect(), CASES[case](T, ts).collect())


def test_scalar_aggregates_match(both):
    rs, ts = both
    for fn in ("sum", "count", "max", "min", "mean"):
        for col in ("v", "w"):
            assert getattr(_df(T, ts)[col], fn)() == pytest.approx(
                getattr(_df(R, rs)[col], fn)(), rel=1e-6)


@pytest.mark.parametrize("mode", ["eager", "lazy", "opportunistic"])
def test_modes_agree(mode):
    rs, ts = _sessions(mode, parts=3)
    es = T.Session(mode="eager", default_row_parts=3, device="cpu")
    try:
        for case in ("groupby_agg", "join_outer", "transpose_labels", "get_dummies"):
            got = CASES[case](T, ts).collect()
            _same(CASES[case](R, rs).collect(), got)
            _same(CASES[case](T, es).collect(), got)
        port, ref = figure1(T, ts), figure1(R, rs)
        _same(ref["cov"], port["cov"])
    finally:
        for s in (rs, ts, es):
            s.close()


def test_mem_budget_is_refused():
    with pytest.raises(NotImplementedError, match="M8"):
        T.Session(mem_budget_bytes=1 << 20, device="cpu")


@pytest.mark.parametrize("case", ["column_sort", "column_filter"])
def test_transpose_rewrites_match_reference(case):
    """R2 / R3 turn TRANSPOSE∘SORT∘TRANSPOSE and TRANSPOSE∘SELECTION∘TRANSPOSE
    into column-space ops that need neither a transpose nor a SORT (LAZY, so
    the inner statements are never evaluated on their own)."""
    rs, ts = _sessions("lazy")
    try:
        def build(api, s):
            d = api.DataFrame({"a": [3, 1, 2], "b": [2, 5, 1], "c": [9, 0, 4]},
                              row_labels=["r0", "r1", "r2"], session=s)
            if case == "column_sort":
                return d.T.sort_values("r0", ascending=False).T
            return d.T[d.T["r1"] > 0].T
        _same(build(R, rs).collect(), build(T, ts).collect())
        assert ts.stats.evaluated_nodes >= 1
    finally:
        rs.close()
        ts.close()


def ordered_slice(api, s, frame):
    """The ordered path: sort → cumsum / cummax / rolling_mean / diff /
    shift, the §6.1 filter → cumsum workflow, and a merge through the
    shuffle.  Statements by name."""
    df = api.DataFrame(frame, session=s)
    rates = api.DataFrame({"passenger_count": [1, 2, 3, 4, 5, 6],
                           "rate": [2.5, 3.0, 3.5, 4.0, 4.5, 5.0]}, session=s)
    srt = df.sort_values("f0")
    return {"sorted": srt, "cumsum": srt.cumsum(), "cummax": srt.cummax(cols=["f1"]),
            "rolling": srt.rolling_mean(10, cols=["f3"]), "diff": srt.diff(2, cols=["f2"]),
            "shift": srt.shift(3, cols=["f2"]),
            "workflow": df[df["passenger_count"] > 1].cumsum(cols=["f0"]),
            "merge": df.merge(rates, on="passenger_count")}


@pytest.mark.parametrize("mode", ["eager", "lazy", "opportunistic"])
def test_ordered_slice_matches_reference(mode):
    """head(5) of every statement, then the whole results, against the
    reference's Session; prefix computation fires alike, with fusion live
    in both.  In OPPORTUNISTIC mode the heads come after the background runs
    have finished, so the count does not depend on timing: both fuse the
    filter into the background run's window, and once that filter is a live
    statement both re-plan the head unfused (the MQO fusion barrier), miss
    the cache and take the prefix path."""
    rs, ts = _sessions(mode, parts=3)
    try:
        ref = ordered_slice(R, rs, r_taxi(20_000, seed=1))
        port = ordered_slice(T, ts, t_taxi(20_000, seed=1, device="cpu"))
        if mode == "opportunistic":
            for stmts in (ref, port):
                for d in stmts.values():
                    d._node.handle.result()
        for k in ref:
            _same(ref[k].head(5), port[k].head(5))
        assert ts.executor.stats.prefix_evals == rs.executor.stats.prefix_evals
        if mode == "lazy":
            assert ts.executor.stats.prefix_evals == 1      # the workflow's head
        for k in ref:
            _same(ref[k].collect(), port[k].collect())
    finally:
        rs.close()
        ts.close()


@pytest.mark.parametrize("value,error", [(float("nan"), ValueError), (float("inf"), OverflowError),
                                         (float("-inf"), OverflowError), (2**31, OverflowError),
                                         (-2**31 - 1, OverflowError)])
def test_fillna_int_column_unholdable_value_raises_as_reference(both, value, error):
    """A fill value an int32 column cannot hold raises the reference's
    exception type (``jnp.asarray``) in both packages."""
    got = []
    for api, s in zip((R, T), both):
        df = api.DataFrame({"a": [1, None, 3], "b": [0.5, 1.5, 2.5]}, session=s)
        with pytest.raises(Exception) as info:
            df.fillna(value).collect()
        got.append(type(info.value))
    assert got == [error, error]


def test_fillna_int_column_truncates_as_reference(both):
    rs, ts = both
    ref, port = (api.DataFrame({"a": [1, None, 3]}, session=s).fillna(1.5).collect()
                 for api, s in ((R, rs), (T, ts)))
    _same(ref, port)
    assert port.col("a").to_pylist() == [1, 1, 3]
