"""DIFFERENCE and DROP-DUPLICATES of the PyTorch port against the JAX package
and pandas.

The cases of ``tests/test_dedup_differential.py``, with its seeds and sizes:
dedup, difference and subset dedup over int / float / coded columns with
null masks, duplicate-free and duplicate-heavy inputs, the 0-row and 0-col
edges, null keys, cross-dictionary coded columns, wide ints past 2^53, the
fused producer and consumer chains, the no-``to_frame()`` spy and the API
level.  Every port result is held against pandas (the oracle) on row grids
{1, W, 4W} (W = pool width) × fused (``optimize=True``) / per-node plans,
and against the serial ``REPRO_BLOCK_DEDUP=0`` path; the reference runs the
same plan on each grid and must give the same result.  Labels, masks, ints
and codes compare bit-equal, floats to rtol=atol=1e-4.

One divergence is held on purpose: a DIFFERENCE whose right side has no rows
and a coded column stored as float32 raises ``IndexError`` in the reference
(its ``_row_keys`` indexes a hash LUT with float codes).  The port gives
pandas' answer there, and the tests below say so.  The seeded sweep stands
in for the reference's hypothesis properties; 137, 276 and 371 are seeds of
the class on which the reference's hypothesis test fails.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from repro.core import algebra as ralg
from repro.core.dtypes import Domain as RDomain
from repro.core.executor import Executor as RExecutor
from repro.core.frame import Column as RColumn
from repro.core.frame import Frame as RFrame
from repro.core.labels import RangeLabels as RRange
from repro.core.labels import labels_from_values as rlabels
from repro.core.partition import PartitionedFrame as RPF
from repro_torch import core as T
from repro_torch.core import algebra as talg
from repro_torch.core.dtypes import Domain as TDomain
from repro_torch.core.executor import Executor as TExecutor
from repro_torch.core.frame import Column as TColumn
from repro_torch.core.frame import Frame as TFrame
from repro_torch.core.labels import RangeLabels as TRange
from repro_torch.core.labels import labels_from_values as tlabels
from repro_torch.core.partition import PartitionedFrame as TPF
from repro_torch.core.schedule import pool_width

PKG = {
    "ref": dict(alg=ralg, Dm=RDomain, Ex=RExecutor, C=RColumn, F=RFrame, RL=RRange,
                lab=rlabels, PF=RPF, kw={}),
    "port": dict(alg=talg, Dm=TDomain, Ex=TExecutor, C=TColumn, F=TFrame, RL=TRange,
                 lab=tlabels, PF=TPF, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _dedup_env(monkeypatch):
    monkeypatch.delenv("REPRO_BLOCK_DEDUP", raising=False)
    yield monkeypatch


# =============================================================================
# case generation (as tests/test_dedup_differential.py makes them)
# =============================================================================
_STRINGS = ["aa", "bb", "cc", "dd", "ee", "ff", "gg", "hh"]
_FLOATS = [float(np.float32(x)) for x in
           (0.5, -1.25, 3.75, 7.125, -0.625, 2.5, 9.875, -4.5)]
_KINDS = ("int", "float", "coded")
_DOMS = {"int": "INT", "float": "FLOAT", "coded": "STR"}


def _gen_column(rng, kind: str, nrows: int, pool: int, null_p: float) -> list:
    if kind == "int":
        vals = rng.integers(0, max(pool, 1), nrows).tolist()
    elif kind == "float":
        vals = [_FLOATS[i % len(_FLOATS)] for i in rng.integers(0, max(pool, 1), nrows)]
    else:
        vals = [_STRINGS[i % len(_STRINGS)] for i in rng.integers(0, max(pool, 1), nrows)]
    if null_p > 0:
        nulls = rng.random(nrows) < null_p
        vals = [None if n else v for v, n in zip(vals, nulls)]
    return vals


def _gen_case(seed: int, *, dup_heavy: bool | None = None,
              nrows: int | None = None) -> tuple[dict, list]:
    """(data dict, domain names) for one random frame."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60)) if nrows is None else nrows
    ncols = int(rng.integers(1, 5))
    heavy = bool(rng.integers(0, 2)) if dup_heavy is None else dup_heavy
    pool = 3 if heavy else 50
    null_p = float(rng.choice([0.0, 0.15, 0.4]))
    data, domains = {}, []
    for j in range(ncols):
        kind = _KINDS[int(rng.integers(0, len(_KINDS)))]
        data[f"c{j}_{kind}"] = _gen_column(rng, kind, n, pool, null_p)
        domains.append(_DOMS[kind])
    return data, domains


def _difference_case(seed: int) -> tuple[dict, dict, list]:
    ldata, ldom = _gen_case(seed, dup_heavy=True)
    rng = np.random.default_rng(seed + 10_000)
    n_r = int(rng.integers(0, 40))
    rdata = {}
    for name, vals in ldata.items():
        kind = name.split("_")[-1]
        rdata[name] = _gen_column(rng, kind, n_r, 3,
                                  0.3 if any(v is None for v in vals) else 0.0)
    return ldata, rdata, ldom


def _grids() -> list[int]:
    w = pool_width()
    return sorted({1, w, 4 * w})


# =============================================================================
# frames of both packages, pandas oracles, comparison
# =============================================================================
def _frame(pkg: str, data: dict, domains: list, float_empty: bool = False) -> object:
    p = PKG[pkg]
    doms = [getattr(p["Dm"], d) for d in domains]
    f = p["F"].from_pydict(data, domains=doms, **p["kw"])
    if float_empty and f.nrows == 0 and data:
        # a 0-row right side as the reference's suite builds it: float32
        # storage whatever the domain
        z = np.zeros(0, dtype=np.float32)
        f = p["F"]([p["C"](z if pkg == "ref" else torch.from_numpy(z), d) for d in doms],
                   p["RL"](0), p["lab"](list(data)))
    return f


def _frames(data: dict, domains: list, float_empty: bool = False) -> dict:
    return {pkg: _frame(pkg, data, domains, float_empty) for pkg in PKG}


def _to_pandas(data: dict) -> pd.DataFrame:
    if not data:
        return pd.DataFrame()
    return pd.DataFrame({k: pd.Series(v, dtype=object) for k, v in data.items()})


def _pd_lists(pdf: pd.DataFrame) -> tuple[list, dict]:
    return list(pdf.index), {c: list(pdf[c]) for c in pdf.columns}


def _oracle_dedup(data: dict, subset) -> tuple[list, dict]:
    pdf = _to_pandas(data)
    out = pdf.drop_duplicates(subset=list(subset)) if subset else pdf.drop_duplicates()
    return _pd_lists(out)


def _oracle_difference(ldata: dict, rdata: dict) -> tuple[list, dict]:
    """Full-row anti-join through pandas (null == null, as pandas hashes)."""
    lp, rp = _to_pandas(ldata), _to_pandas(rdata)
    rset = set(rp.itertuples(index=False, name=None))
    keep = [t not in rset for t in lp.itertuples(index=False, name=None)]
    if lp.shape[1] == 0:
        keep = [len(rp) == 0] * len(lp)
    return _pd_lists(lp[np.asarray(keep, dtype=bool)] if len(lp) else lp)


def _lists(f) -> tuple[list, dict]:
    return f.row_labels.to_list(), f.to_pydict()


def _same(got: tuple, want: tuple, ctx: str) -> None:
    """Labels, column names and nulls bit-equal; ints and strings equal;
    floats to rtol=atol=1e-4."""
    gi, gc = got
    wi, wc = want
    assert gi == wi, f"{ctx}: row labels {gi} != {wi}"
    assert list(gc) == list(wc), f"{ctx}: columns {list(gc)} != {list(wc)}"
    for name in wc:
        a, b = gc[name], wc[name]
        assert [x is None for x in a] == [x is None for x in b], f"{ctx}/{name}: nulls"
        fa = [x for x in a if x is not None]
        fb = [x for x in b if x is not None]
        if any(isinstance(x, float) for x in fa + fb):
            np.testing.assert_allclose(np.asarray(fa, np.float64), np.asarray(fb, np.float64),
                                       rtol=1e-4, atol=1e-4, err_msg=f"{ctx}/{name}")
        else:
            assert fa == fb, f"{ctx}/{name}: {fa} != {fb}"


def _eval(pkg: str, plan, frames: dict, rp: int, optimize: bool = True,
          rparts: dict | None = None):
    """``plan`` in one package with every input on ``rp`` row blocks
    (``rparts`` overrides per input): (labels, values) and the stats."""
    p = PKG[pkg]
    store = {fid: p["PF"].from_frame(f[pkg], row_parts=(rparts or {}).get(fid, rp))
             for fid, f in frames.items()}
    ex = p["Ex"](store, optimize=optimize)
    return _lists(ex.evaluate(plan(p["alg"])).to_frame()), ex.stats


def _sweep(plan, frames: dict, expected, ctx: str, monkeypatch, ref_raises: bool = False):
    """The port on every grid, fused and per-node, and on the serial path,
    against pandas; the reference on every grid against the port (or, where
    ``ref_raises``, raising the reference's ``IndexError``)."""
    for rp in _grids():
        for optimize in (True, False):
            got, _ = _eval("port", plan, frames, rp, optimize)
            _same(got, expected, f"{ctx}[grid={rp},opt={optimize}]")
        if ref_raises:
            with pytest.raises(IndexError):
                _eval("ref", plan, frames, rp)
        else:
            ref, _ = _eval("ref", plan, frames, rp)
            _same(got, ref, f"{ctx}[grid={rp},ref]")
        monkeypatch.setenv("REPRO_BLOCK_DEDUP", "0")
        try:
            got, _ = _eval("port", plan, frames, rp)
        finally:
            monkeypatch.delenv("REPRO_BLOCK_DEDUP")
        _same(got, expected, f"{ctx}[grid={rp},serial]")


def _dedup_plan(subset):
    return lambda alg: alg.DropDuplicates(alg.Source("src"), list(subset) if subset else None)


def _difference_plan(alg):
    return alg.Difference(alg.Source("l"), alg.Source("r"))


def _check_dedup(seed: int, monkeypatch, subset_from_seed: bool = False, **gen_kw) -> None:
    data, domains = _gen_case(seed, **gen_kw)
    subset = None
    if subset_from_seed:
        names = list(data)
        subset = tuple(names[:1 + seed % len(names)])
    _sweep(_dedup_plan(subset), {"src": _frames(data, domains)},
           _oracle_dedup(data, subset), f"dedup[seed={seed},subset={subset}]", monkeypatch)


def _right_has_float_coded(rdata: dict, domains: list) -> bool:
    """The reference's failing class: a 0-row right side (float32 storage)
    with a coded column."""
    return not any(len(v) for v in rdata.values()) and "STR" in domains


def _check_difference(seed: int, monkeypatch) -> None:
    ldata, rdata, dom = _difference_case(seed)
    frames = {"l": _frames(ldata, dom), "r": _frames(rdata, dom, float_empty=True)}
    _sweep(_difference_plan, frames, _oracle_difference(ldata, rdata),
           f"difference[seed={seed}]", monkeypatch,
           ref_raises=_right_has_float_coded(rdata, dom))


# =============================================================================
# the seeded sweep
# =============================================================================
@pytest.mark.parametrize("seed", range(10))
def test_dedup_matches_reference_and_pandas(seed, monkeypatch):
    _check_dedup(seed, monkeypatch)


@pytest.mark.parametrize("seed", range(10))
def test_difference_matches_reference_and_pandas(seed, monkeypatch):
    _check_difference(seed, monkeypatch)


@pytest.mark.parametrize("seed", range(6))
def test_dedup_subset_matches_reference_and_pandas(seed, monkeypatch):
    _check_dedup(seed + 100, monkeypatch, subset_from_seed=True)


@pytest.mark.parametrize("seed", (3, 17))
def test_dedup_duplicate_free(seed, monkeypatch):
    _check_dedup(seed, monkeypatch, dup_heavy=False, nrows=40)


@pytest.mark.parametrize("seed", (5, 23))
def test_dedup_duplicate_heavy(seed, monkeypatch):
    _check_dedup(seed, monkeypatch, dup_heavy=True, nrows=50)


# =============================================================================
# a 0-row right side with a coded column: the reference raises, pandas and
# the port agree
# =============================================================================
@pytest.mark.parametrize("seed", (137, 276, 371))
def test_difference_empty_coded_right_matches_pandas(seed, monkeypatch):
    ldata, rdata, dom = _difference_case(seed)
    assert _right_has_float_coded(rdata, dom)
    _check_difference(seed, monkeypatch)


def test_difference_smallest_empty_coded_right(monkeypatch):
    """{"s": ["aa"]} against a 0-row STR column stored as float32: pandas
    returns the left frame, and so does the port."""
    ldata, rdata = {"s": ["aa"]}, {"s": []}
    frames = {"l": _frames(ldata, ["STR"]), "r": _frames(rdata, ["STR"], float_empty=True)}
    assert frames["r"]["port"].col("s").data.dtype == torch.float32
    expected = _oracle_difference(ldata, rdata)
    assert expected == ([0], {"s": ["aa"]})
    _sweep(_difference_plan, frames, expected, "difference-empty-coded", monkeypatch,
           ref_raises=True)


# =============================================================================
# edges: 0-row / 0-col
# =============================================================================
def _empty_cols_frames(nrows: int) -> dict:
    return {pkg: PKG[pkg]["F"]([], PKG[pkg]["RL"](nrows), PKG[pkg]["lab"]([]))
            for pkg in PKG}


def test_dedup_zero_rows(monkeypatch):
    data = {"k": [], "x": []}
    _sweep(_dedup_plan(None), {"src": _frames(data, ["INT", "FLOAT"])},
           _oracle_dedup(data, None), "dedup-0row", monkeypatch)


def test_dedup_zero_cols(monkeypatch):
    expected = _pd_lists(pd.DataFrame(index=range(4)).drop_duplicates())
    assert expected[0] == [0, 1, 2, 3]
    _sweep(_dedup_plan(None), {"src": _empty_cols_frames(4)}, expected, "dedup-0col",
           monkeypatch)


def test_difference_zero_rows_left(monkeypatch):
    ldata, rdata = {"k": [], "x": []}, {"k": [1], "x": [0.5]}
    frames = {"l": _frames(ldata, ["INT", "FLOAT"]), "r": _frames(rdata, ["INT", "FLOAT"])}
    _sweep(_difference_plan, frames, _oracle_difference(ldata, rdata), "diff-0row-left",
           monkeypatch)


def test_difference_empty_right_keeps_left(monkeypatch):
    ldata, rdata = {"k": [1, 2, 2], "x": [0.5, 1.5, 1.5]}, {"k": [], "x": []}
    frames = {"l": _frames(ldata, ["INT", "FLOAT"]), "r": _frames(rdata, ["INT", "FLOAT"])}
    _sweep(_difference_plan, frames, _oracle_difference(ldata, rdata), "diff-empty-right",
           monkeypatch)


def test_difference_zero_cols():
    l, r = _empty_cols_frames(3), _empty_cols_frames(2)
    for pkg in PKG:
        p = PKG[pkg]
        store = {"l": p["PF"].from_frame(l[pkg]), "r": p["PF"].from_frame(r[pkg])}
        out = p["Ex"](store).evaluate(_difference_plan(p["alg"])).to_frame()
        assert out.shape == (0, 0), pkg


# =============================================================================
# null keys; coded columns across dictionaries
# =============================================================================
def test_dedup_null_keys(monkeypatch):
    data = {"k": [None, 1, None, 1, None], "s": ["aa", None, "aa", None, "bb"]}
    _sweep(_dedup_plan(None), {"src": _frames(data, ["INT", "STR"])},
           _oracle_dedup(data, None), "dedup-nulls", monkeypatch)


def test_difference_null_keys(monkeypatch):
    ldata = {"k": [None, 1, 2], "x": [0.5, None, 1.5]}
    rdata = {"k": [None, 2], "x": [0.5, 1.5]}
    frames = {"l": _frames(ldata, ["INT", "FLOAT"]), "r": _frames(rdata, ["INT", "FLOAT"])}
    _sweep(_difference_plan, frames, _oracle_difference(ldata, rdata), "diff-nulls",
           monkeypatch)


def test_difference_cross_dictionary_coded(monkeypatch):
    """Same strings, different dictionary orders: equality by value."""
    ldata = {"s": ["aa", "bb", "cc", "bb"], "k": [1, 2, 3, 2]}
    rdata = {"s": ["cc", "bb"], "k": [3, 2]}
    frames = {"l": _frames(ldata, ["STR", "INT"]), "r": _frames(rdata, ["STR", "INT"])}
    assert frames["l"]["port"].col("s").dictionary != frames["r"]["port"].col("s").dictionary
    _sweep(_difference_plan, frames, _oracle_difference(ldata, rdata), "diff-crossdict",
           monkeypatch)


def test_difference_cross_dictionary_disjoint_values(monkeypatch):
    ldata, rdata = {"s": ["aa", "bb", "aa"]}, {"s": ["zz", "bb"]}
    frames = {"l": _frames(ldata, ["STR"]), "r": _frames(rdata, ["STR"])}
    _sweep(_difference_plan, frames, _oracle_difference(ldata, rdata), "diff-disjointdict",
           monkeypatch)


def test_dedup_subset_coded_column(monkeypatch):
    data = {"s": ["aa", "bb", "aa", None, "bb", None], "x": [0.5, 1.5, 2.5, 3.5, 4.5, 5.5]}
    _sweep(_dedup_plan(("s",)), {"src": _frames(data, ["STR", "FLOAT"])},
           _oracle_dedup(data, ("s",)), "dedup-subset-coded", monkeypatch)


# =============================================================================
# int64 keys past 2^53
# =============================================================================
def _wide_frames(values: list, extra: dict | None = None) -> dict:
    out = {}
    for pkg, p in PKG.items():
        k = np.asarray(values, dtype=np.int64)
        cols = [p["C"](k if pkg == "ref" else torch.from_numpy(k), p["Dm"].INT)]
        names = ["k"]
        for n, (vals, dom) in (extra or {}).items():
            v = np.asarray(vals, dtype=np.float32)
            cols.append(p["C"](v if pkg == "ref" else torch.from_numpy(v),
                               getattr(p["Dm"], dom)))
            names.append(n)
        out[pkg] = p["F"](cols, p["RL"](len(values)), p["lab"](names))
    return out


def _both(plan, frames: dict, rp: int, rparts: dict | None = None) -> tuple:
    """(ref, port) results of ``plan``."""
    return tuple(_eval(pkg, plan, frames, rp, rparts=rparts)[0] for pkg in PKG)


def test_wide_int_dedup_distinguishes_above_2_53(monkeypatch):
    frames = {"src": _wide_frames([2**53, 2**53 + 1, 2**53, 2**53 + 1])}
    for rp in _grids():
        ref, port = _both(_dedup_plan(None), frames, rp)
        assert port == ref and port[1]["k"] == [2**53, 2**53 + 1], rp
        monkeypatch.setenv("REPRO_BLOCK_DEDUP", "0")
        try:
            got, _ = _eval("port", _dedup_plan(None), frames, rp)
        finally:
            monkeypatch.delenv("REPRO_BLOCK_DEDUP")
        assert got == port, rp


def test_wide_int_difference_narrow_other_side():
    """The right side alone would not flag the column wide: the joint
    decision across both inputs and every block must hash alike."""
    frames = {"l": _wide_frames([2**53, 2**53 + 1, 5]), "r": _wide_frames([2**53, 5])}
    for rp in _grids():
        ref, port = _both(_difference_plan, frames, rp, {"r": 1})
        assert port == ref and port[1]["k"] == [2**53 + 1], rp


def test_wide_int_join_no_false_match():
    frames = {"l": _wide_frames([2**53, 2**53 + 1], {"x": ([1.0, 2.0], "FLOAT")}),
              "r": _wide_frames([2**53], {"y": ([9.0], "FLOAT")})}
    plan = lambda alg: alg.Join(alg.Source("l"), alg.Source("r"), on=["k"], how="inner")
    ref, port = _both(plan, frames, 1)
    assert port == ref and port[1]["k"] == [2**53] and port[1]["x"] == [1.0]


def test_wide_int_against_float_column_keeps_fractional_distinct():
    """5 == 5.0 drops; 1 != 1.5 and 2^53 + 1 survive."""
    r = {pkg: p["F"]([p["C"](np.asarray([1.5, 5.0], np.float32) if pkg == "ref"
                             else torch.tensor([1.5, 5.0]), p["Dm"].FLOAT)],
                     p["RL"](2), p["lab"](["k"])) for pkg, p in PKG.items()}
    frames = {"l": _wide_frames([1, 5, 2**53 + 1]), "r": r}
    for rp in (1, 2, 3):
        ref, port = _both(_difference_plan, frames, rp, {"r": 1})
        assert port == ref and port[1]["k"] == [1, 2**53 + 1], rp


def test_factorization_tasks_not_counted_as_row_blocks():
    """Per-column factorization tasks do not count as row blocks."""
    data = {"k": [1, 2, 1, 2], "v": [1.5, 2.5, 1.5, 2.5], "s": ["ax", "bx", "ax", "bx"]}
    frames = {"src": _frames(data, ["INT", "FLOAT", "STR"])}
    for pkg in PKG:
        _, stats = _eval(pkg, _dedup_plan(None), frames, 2)
        assert (stats.dispatched_blocks, stats.dedup_blocks) == (4, 2), pkg


# =============================================================================
# fused producer / consumer chains (+ counters)
# =============================================================================
def _scale_udf(pkg: str, name: str = "x"):
    p = PKG[pkg]

    def fn(cols, frame):
        out = dict(cols)
        c = cols[name]
        # ×2 is exact in float32 and float64, so the pandas mirror is trivial
        out[name] = p["C"](c.data * np.float32(2.0) if pkg == "ref" else c.data * 2.0,
                           p["Dm"].FLOAT, c.mask, None)
        return out
    return p["alg"].Udf(name=f"dedup_diff_scale_{name}", fn=fn,
                        deps=frozenset([name]), elementwise=True)


def _pkg_of(alg) -> str:
    return "ref" if alg is ralg else "port"


def _chain_case(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = 40
    return {"k": _gen_column(rng, "int", n, 3, 0.1),
            "x": _gen_column(rng, "float", n, 3, 0.1),
            "s": _gen_column(rng, "coded", n, 3, 0.1)}


_CHAIN_DOMS = ["INT", "FLOAT", "STR"]


def _mapped(d: dict) -> dict:
    return dict(d, x=[None if v is None else v * 2 for v in d["x"]])


def _port_prepared(plan, frames: dict) -> tuple:
    store = {fid: TPF.from_frame(f["port"], row_parts=4) for fid, f in frames.items()}
    ex = TExecutor(store, optimize=True)
    return ex._prepared(plan(talg)), ex


@pytest.mark.parametrize("seed", (1, 9))
def test_fused_producer_chain_dedup(seed, monkeypatch):
    data = _chain_case(seed)
    pdf = _to_pandas(_mapped(data))
    keep = [v is not None and v > 0 for v in pdf["k"]]
    expected = _pd_lists(pdf[np.asarray(keep, dtype=bool)].drop_duplicates())
    plan = lambda alg: alg.DropDuplicates(
        alg.Selection(alg.Map(alg.Source("src"), _scale_udf(_pkg_of(alg))),
                      alg.col("k") > alg.lit(0)), None)
    frames = {"src": _frames(data, _CHAIN_DOMS)}
    _sweep(plan, frames, expected, f"fused-chain-dedup[{seed}]", monkeypatch)
    prepared, ex = _port_prepared(plan, frames)
    assert prepared.op == "fused_drop_duplicates"
    assert len(prepared.params["pre_stages"]) == 2
    assert prepared.params["grid"] == "workers"
    ex.evaluate(plan(talg))
    assert ex.stats.barrier_fused_groups == 1
    assert ex.stats.producer_stage_ops == 2
    assert ex.stats.dedup_blocks > 0 and ex.stats.dedup_key_rows > 0


def test_fused_producer_chains_difference_both_sides(monkeypatch):
    ldata, rdata = _chain_case(2), _chain_case(3)
    plan = lambda alg: alg.Difference(
        alg.Map(alg.Source("l"), _scale_udf(_pkg_of(alg))),
        alg.Map(alg.Source("r"), _scale_udf(_pkg_of(alg))))
    frames = {"l": _frames(ldata, _CHAIN_DOMS), "r": _frames(rdata, _CHAIN_DOMS)}
    _sweep(plan, frames, _oracle_difference(_mapped(ldata), _mapped(rdata)),
           "fused-diff-both", monkeypatch)
    prepared, ex = _port_prepared(plan, frames)
    assert prepared.op == "fused_difference"
    assert len(prepared.params["pre_stages"]) == 1
    assert len(prepared.params["right_pre_stages"]) == 1
    ex.evaluate(plan(talg))
    assert ex.stats.barrier_fused_groups == 1
    assert ex.stats.producer_stage_ops == 2


def test_fused_consumer_chain_filters_keep_mask_before_gather(monkeypatch):
    data = _chain_case(4)
    plan = lambda alg: alg.Projection(
        alg.Selection(alg.DropDuplicates(alg.Source("src"), None),
                      alg.col("k") > alg.lit(0)), ("k", "x"))
    pdf = _to_pandas(data).drop_duplicates()
    keep = [v is not None and v > 0 for v in pdf["k"]]
    expected = _pd_lists(pdf[np.asarray(keep, dtype=bool)][["k", "x"]])
    frames = {"src": _frames(data, _CHAIN_DOMS)}
    _sweep(plan, frames, expected, "consumer-dedup", monkeypatch)
    prepared, exf = _port_prepared(plan, frames)
    assert prepared.op == "fused_drop_duplicates"
    assert len(prepared.params["post_stages"]) == 2
    exf.evaluate(plan(talg))
    _, unfused = _eval("port", plan, frames, 4, optimize=False)
    # the consumer-fusion win: strictly fewer rows materialized than unfused
    assert 0 < exf.stats.gather_rows < unfused.gather_rows
    assert exf.stats.consumer_stage_ops == 2


def test_no_to_frame_on_dedup_inputs(monkeypatch):
    """The block-parallel paths never concatenate their inputs."""
    f = _frames(_chain_case(6), _CHAIN_DOMS)["port"]
    store = {"l": TPF.from_frame(f, row_parts=4), "r": TPF.from_frame(f, row_parts=3)}
    calls = []
    orig = TPF.to_frame

    def spy(self):
        calls.append(1)
        return orig(self)

    monkeypatch.setattr(TPF, "to_frame", spy)
    TExecutor(store).evaluate(talg.DropDuplicates(talg.Source("l"), None))
    TExecutor(store).evaluate(talg.Difference(talg.Source("l"), talg.Source("r")))
    assert not calls


def test_dedup_api_level():
    """Fluent-API round trip (session history and MQO path included), in an
    EAGER session of 3 row parts as the reference's fixture makes it."""
    s = T.Session(mode=T.EvalMode.EAGER, default_row_parts=3, device="cpu")
    try:
        df = T.from_pydict({"k": [1, 2, 1, 2, 3], "x": [0.5, 1.5, 0.5, 1.5, 2.5]}, session=s)
        assert df.drop_duplicates().collect().col("k").to_pylist() == [1, 2, 3]
        other = T.from_pydict({"k": [2], "x": [1.5]}, session=s)
        assert df.difference(other).collect().col("k").to_pylist() == [1, 1, 3]
        assert df.drop_duplicates(subset=["x"]).collect().col("k").to_pylist() == [1, 2, 3]
    finally:
        s.close()
