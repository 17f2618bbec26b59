"""Data model of the PyTorch port against the JAX package: dtypes and schema
induction, labels, Frame, the numpy spec that carries a frame across
packages, and the synthetic generators.  Everything here compares bit-equal
(metadata, schemas, codes, values)."""
import numpy as np
import pytest

from repro.core import dtypes as rd
from repro.core import labels as rl
from repro.core.frame import Frame as RFrame
from repro.data import synthetic as rsyn
from repro_torch import convert
from repro_torch.core import dtypes as td
from repro_torch.core import labels as tl
from repro_torch.core.frame import Frame as TFrame
from repro_torch.core.frame import host
from repro_torch.data import synthetic as tsyn


def assert_same_frame(ref, port):
    """Reference Frame vs port Frame: labels, schema, dictionaries, masks and
    values (at valid slots) all equal."""
    assert port.col_labels.to_list() == ref.col_labels.to_list()
    assert port.row_labels.to_list() == ref.row_labels.to_list()
    assert [d.value for d in port.schema] == [d.value for d in ref.schema]
    assert ((None if port.row_domains is None else [d.value for d in port.row_domains])
            == (None if ref.row_domains is None else [d.value for d in ref.row_domains]))
    for a, b in zip(ref.columns, port.columns):
        assert a.dictionary == b.dictionary
        assert (a.mask is None) == (b.mask is None)
        va = np.ones(len(a), bool) if a.mask is None else np.asarray(a.mask)
        np.testing.assert_array_equal(host(b.valid_mask()), va)
        da, db = np.asarray(a.data), host(b.data)
        assert da.dtype == db.dtype
        np.testing.assert_array_equal(db[va], da[va])


def spec_of_reference(f) -> dict:
    """The numpy spec of a reference Frame, in ``repro_torch.convert``'s
    format (the test side reads the reference; the port never does)."""
    def lab(l):
        if isinstance(l, rl.RangeLabels):
            return {"kind": "range", "length": l.length, "start": l.start}
        if isinstance(l, rl.IntLabels):
            return {"kind": "int", "values": np.asarray(l.values)}
        return {"kind": "coded", "codes": np.asarray(l.codes), "table": l.table,
                "domain": l.label_domain.value}
    return {
        "columns": [{"name": n, "data": np.asarray(c.data),
                     "mask": None if c.mask is None else np.asarray(c.mask),
                     "domain": c.domain.value, "dictionary": c.dictionary}
                    for n, c in zip(f.col_labels.to_list(), f.columns)],
        "row_labels": lab(f.row_labels), "col_labels": lab(f.col_labels),
        "row_domains": None if f.row_domains is None else [d.value for d in f.row_domains],
    }


PYDICTS = [
    {"a": [1, 2], "b": ["x", "y"], "c": [1.5, 2.5]},
    {"k": ["a", "b", "a", "c", "b", "a", None, "c"], "v": [3, 1, 4, 1, 5, 9, 2, 6],
     "w": [0.5, None, 1.5, 2.0, None, 3.0, 3.5, 4.0]},
    {"n": [None, None], "t": ["true", "no"], "i": ["1", "2"]},
    {"f": ["1.5", "2"], "mixed": ["apple", "1"], "ints": [1, 2]},
    {"iPhone 11 Pro": ["5.8-inch", "12MP", "120MP", "Yes"],
     "iPhone XR": ["6.1-inch", "12MP", "7MP", "No"]},
]


# ---- dtypes ------------------------------------------------------------------
@pytest.mark.parametrize("values", [
    ["1", "2", "3"], ["1.5", "2"], ["true", "false", "yes"], ["apple", "1"],
    [1, 2, None], [None, None], [1.0, 2.0], [True, False, None], [1.5, float("nan")],
])
def test_induce_schema_and_parse_match(values):
    assert td.induce_schema(values).value == rd.induce_schema(values).value
    p, q = rd.parse_column(values), td.parse_column(values, device="cpu")
    assert q.domain.value == p.domain.value and q.dictionary == p.dictionary
    assert (q.mask is None) == (p.mask is None)
    np.testing.assert_array_equal(host(q.data), np.asarray(p.data))
    if p.mask is not None:
        np.testing.assert_array_equal(host(q.mask), np.asarray(p.mask))


def test_parse_fallback_and_dictionary_order():
    assert td.parse_column(["1", "x"], td.Domain.INT, device="cpu").domain is td.Domain.STR
    p = td.parse_column(["b", "a", "b", "c"], device="cpu")
    assert p.dictionary == ("b", "a", "c")
    assert host(p.data).tolist() == [0, 1, 0, 2]


@pytest.mark.parametrize("dom", list(rd.Domain))
def test_storage_dtypes_match(dom):
    assert np.dtype(td.storage_dtype(td.Domain(dom.value))) == rd.storage_dtype(dom)
    assert (np.dtype(str(td.torch_dtype(td.Domain(dom.value))).split(".")[1])
            == rd.storage_dtype(dom))


def test_common_storage_matches():
    for doms in (["int", "float"], ["bool"], ["str", "int"], ["unspecified"], ["int", "bool"]):
        assert (td.common_storage([td.Domain(d) for d in doms]).value
                == rd.common_storage([rd.Domain(d) for d in doms]).value)


# ---- labels ------------------------------------------------------------------
@pytest.mark.parametrize("values", [[0, 1, 2], [3, 4], ["a", "b", "a", None], [2, 0, 1],
                                    [1.5, 2], []])
def test_labels_match(values):
    a, b = rl.labels_from_values(values), tl.labels_from_values(values)
    assert type(a).__name__ == type(b).__name__
    assert a.to_list() == b.to_list() and a.domain.value == b.domain.value
    if values:
        idx = np.array([len(values) - 1, 0])
        assert a.take(idx).to_list() == b.take(idx).to_list()
        assert a.concat(a).to_list() == b.concat(b).to_list()


# ---- frame -------------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(PYDICTS)))
def test_from_pydict_matches(i):
    d = PYDICTS[i]
    ref, port = RFrame.from_pydict(d), TFrame.from_pydict(d, device="cpu")
    assert_same_frame(ref, port)
    assert port.to_pydict() == ref.to_pydict()
    assert port.to_records() == ref.to_records()
    assert port.is_matrix() == ref.is_matrix()


@pytest.mark.parametrize("i", range(len(PYDICTS)))
def test_frame_row_ops_match(i):
    d = PYDICTS[i]
    ref, port = RFrame.from_pydict(d), TFrame.from_pydict(d, device="cpu")
    idx = np.array([1, 0, 1])
    assert_same_frame(ref.take_rows(idx), port.take_rows(idx))
    keep = np.arange(ref.nrows) % 2 == 0
    assert_same_frame(ref.filter_rows(keep), port.filter_rows(keep))
    assert_same_frame(ref.head(1), port.head(1))
    assert_same_frame(ref.tail(1), port.tail(1))
    assert_same_frame(ref.concat_rows(ref), port.concat_rows(port))
    assert_same_frame(ref.take_cols([0]), port.take_cols([0]))


def test_concat_rows_unifies_dictionaries():
    ra = RFrame.from_pydict({"k": ["x", "y"]}).concat_rows(RFrame.from_pydict({"k": ["z", "x"]}))
    ta = TFrame.from_pydict({"k": ["x", "y"]}, device="cpu").concat_rows(
        TFrame.from_pydict({"k": ["z", "x"]}, device="cpu"))
    assert_same_frame(ra, ta)
    assert ta.columns[0].dictionary == ("x", "y", "z")


@pytest.mark.parametrize("r,c,value", [(0, 0, "q"), (1, 0, "new"), (2, 1, 7), (6, 0, "z")])
def test_iloc_set_matches_and_copies(r, c, value):
    d = PYDICTS[1]
    ref, port = RFrame.from_pydict(d), TFrame.from_pydict(d, device="cpu")
    before = host(port.columns[c].data).copy()
    assert_same_frame(ref.iloc_set(r, c, value), port.iloc_set(r, c, value))
    assert port.iloc_get(r, c) == ref.iloc_get(r, c)
    np.testing.assert_array_equal(host(port.columns[c].data), before)   # not in place


def test_as_matrix_and_induce_match():
    d = {"a": [1, 2, 3], "b": [0.5, 1.5, None], "t": [True, False, True]}
    ref, port = RFrame.from_pydict(d), TFrame.from_pydict(d, device="cpu")
    rm, rdom = ref.as_matrix()
    tm, tdom = port.as_matrix()
    assert rdom.value == tdom.value
    np.testing.assert_array_equal(host(tm), np.asarray(rm))


# ---- convert -----------------------------------------------------------------
@pytest.mark.parametrize("i", range(len(PYDICTS)))
def test_convert_round_trip_both_ways(i):
    ref = RFrame.from_pydict(PYDICTS[i], row_labels=None if i else ["r0", "r1"])
    port = convert.frame_from_arrays(spec_of_reference(ref), device="cpu")
    assert_same_frame(ref, port)
    back = convert.frame_to_arrays(port)
    want = spec_of_reference(ref)
    assert back["row_labels"].keys() == want["row_labels"].keys()
    assert back["row_domains"] == want["row_domains"]
    for a, b in zip(back["columns"], want["columns"]):
        assert (a["name"], a["domain"], a["dictionary"]) == (b["name"], b["domain"], b["dictionary"])
        np.testing.assert_array_equal(a["data"], b["data"])
        assert (a["mask"] is None) == (b["mask"] is None)
    assert_same_frame(ref, convert.frame_from_arrays(back, device="cpu"))


def test_convert_carries_row_domains_and_int_labels():
    ref = RFrame.from_pydict({"a": [1, 2, 3], "b": [0.5, 1.5, 2.5]})
    ref = RFrame(ref.columns, rl.IntLabels(np.array([7, 3, 5])), ref.col_labels,
                 (rd.Domain.INT, rd.Domain.FLOAT, rd.Domain.INT))
    assert_same_frame(ref, convert.frame_from_arrays(spec_of_reference(ref), device="cpu"))


# ---- synthetic data --------------------------------------------------------------
@pytest.mark.parametrize("n,seed", [(2000, 0), (333, 1), (7, 5)])
def test_taxi_like_frame_matches(n, seed):
    assert_same_frame(rsyn.taxi_like_frame(n, seed=seed),
                      tsyn.taxi_like_frame(n, seed=seed, device="cpu"))


@pytest.mark.parametrize("n,cols,seed", [(100, 64, 0), (17, 3, 2)])
def test_numeric_matrix_frame_matches(n, cols, seed):
    assert_same_frame(rsyn.numeric_matrix_frame(n, cols, seed=seed),
                      tsyn.numeric_matrix_frame(n, cols, seed=seed, device="cpu"))


def test_as_matrix_of_transposed_columns_is_one_view():
    from repro_torch.core.frame import Column, _strided_matrix
    from repro_torch.core.labels import RangeLabels
    import torch
    mat = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    cols = [Column(v, td.Domain.FLOAT) for v in mat.t().contiguous().unbind(1)]
    f = TFrame(cols, RangeLabels(6), RangeLabels(4))
    got, _ = f.as_matrix(td.Domain.FLOAT)
    assert torch.equal(got, mat.t()) and got._base is not None        # a view, no copy
    # columns that are not evenly spaced views of one tensor are stacked
    assert _strided_matrix(cols[::-1], torch.float32) is None
    assert _strided_matrix([Column(mat[:, 0].clone(), td.Domain.FLOAT)] + cols[1:2],
                           torch.float32) is None
    rev = TFrame(cols[::-1], RangeLabels(6), RangeLabels(4))
    assert torch.equal(rev.as_matrix(td.Domain.FLOAT)[0], mat.t().flip(1))
