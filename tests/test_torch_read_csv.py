"""The port's streaming ``read_csv`` against the JAX package's and pandas.

The cases of ``tests/test_read_csv_differential.py``: quoted separators and
doubled quotes, CRLF, empty versus missing in both NA modes, masked
numerics, schema induction voted across chunks, chunk-boundary invariance,
``usecols`` pushdown, other separators, the errors (embedded newline, extra
fields, the seed parser's unsupported arguments), blank lines, a header-only
file and the seed parser (``REPRO_CSV_STREAM=0``).  Every file goes through
both packages: the port's values, masks, dictionaries, labels and schema
equal the reference's bit for bit, and both match ``pandas.read_csv`` with
the reference suite's normalisation (float32 values to rel 1e-6, None for
NaN).  The port's columns land on the session's device as tensors in the
storage dtypes: INT and STR codes int32, FLOAT float32, BOOL bool.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from torch_pairs import BOTH, IDS, PORT, REF, port_guards

pd = pytest.importorskip("pandas")
assert port_guards


@pytest.fixture
def sessions():
    ss = {P.name: P.Session(mode=P.EvalMode.LAZY, **P.kw) for P in BOTH}
    yield ss
    for s in ss.values():
        s.close()


def _read(P, sessions, path, **kw):
    return P.api.read_csv(path, session=sessions[P.name], **kw)


def _norm(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return None
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    return v


def _assert_matches_pandas(df, pdf, float_rtol=1e-6):
    assert df.columns == list(pdf.columns)
    ours = df.to_pydict()
    for name in pdf.columns:
        mine = [_norm(v) for v in ours[name]]
        theirs = [_norm(v) for v in pdf[name].tolist()]
        assert len(mine) == len(theirs), name
        for i, (a, b) in enumerate(zip(mine, theirs)):
            if a is None or b is None:
                assert a is None and b is None, (name, i, a, b)
            elif isinstance(b, float) and not isinstance(b, bool):
                assert a == pytest.approx(b, rel=float_rtol), (name, i)
            else:
                assert a == b, (name, i, a, b)


def _frame_state(f) -> tuple:
    """Everything a Frame holds, as host values (bit-level for arrays)."""
    from repro_torch.core.frame import host
    cols = []
    for c in f.columns:
        d = host(c.data)
        m = None if c.mask is None else host(c.mask).tobytes()
        cols.append((c.domain.value, d.dtype.str, d.tobytes(), m,
                     c.dictionary))
    return (f.row_labels.to_list(), f.col_labels.to_list(), cols)


def _both(sessions, path, pandas_kw=None, **kw):
    """Read with both packages; the port equals the reference bit for bit
    and both match pandas.  Returns the port's DataFrame."""
    ref = _read(REF, sessions, path, **kw)
    got = _read(PORT, sessions, path, **kw)
    assert _frame_state(got.collect()) == _frame_state(ref.collect())
    assert got.dtypes == ref.dtypes
    _assert_matches_pandas(got, pd.read_csv(path, **(pandas_kw or kw)))
    return got


def _write(tmp_path, text, name="t.csv", binary=False):
    p = tmp_path / name
    if binary:
        p.write_bytes(text)
    else:
        p.write_text(text)
    return str(p)


# =============================================================================
# quoting, line endings, empty versus missing
# =============================================================================
def test_quoted_separator_fields(tmp_path, sessions):
    _both(sessions, _write(tmp_path, 'a,b,c\n1,"x,y",3\n2,"p,q,r",4\n3,plain,5\n'))


def test_quoted_quotes_and_mixed_quoting(tmp_path, sessions):
    p = _write(tmp_path, 'a,s\n1,"say ""hi"", ok"\n2,"tail"\n3,bare\n')
    assert pd.read_csv(p)["s"].tolist()[0] == 'say "hi", ok'
    _both(sessions, p)


def test_crlf_line_endings(tmp_path, sessions):
    _both(sessions, _write(tmp_path, b'a,b\r\n1,x\r\n2,y\r\n3,z\r\n',
                           binary=True))


def test_empty_vs_missing_default_na(tmp_path, sessions):
    _both(sessions, _write(tmp_path, 'a,b,c\n"",x,\n1,,z\n2,"",w\n'))


def test_empty_vs_missing_keep_default_na_false(tmp_path, sessions):
    p = _write(tmp_path, 'a,b\n"",x\n1,\n2,y\n')
    got = _both(sessions, p, keep_default_na=False)
    assert got.to_pydict()["a"] == ["", "1", "2"]


def test_missing_numeric_becomes_masked_not_zero(tmp_path, sessions):
    got = _both(sessions, _write(tmp_path, 'x,y\n1,2.5\n,4.25\n5,\n'))
    assert got.to_pydict()["x"] == [1, None, 5]


# =============================================================================
# schema induction
# =============================================================================
def test_schema_induction_and_device_storage(tmp_path, sessions):
    p = _write(tmp_path, "i,f,b,s\n1,1.5,true,alpha\n2,2.25,false,beta\n"
                         "3,-3.75,true,alpha\n")
    got = _both(sessions, p)
    assert got.dtypes == ["int", "float", "bool", "str"]
    f = got.collect()
    for c, dt in zip(f.columns, (torch.int32, torch.float32, torch.bool,
                                 torch.int32)):
        assert isinstance(c.data, torch.Tensor) and c.data.dtype == dt
        assert c.data.device == torch.device("cpu")


def test_mixed_chunk_domains_vote_like_global_induction(tmp_path, sessions,
                                                        monkeypatch):
    lines = ["v,w"] + [f"{i % 7},{i % 5}" for i in range(3000)]
    lines.append("2.5,tail")
    p = _write(tmp_path, "\n".join(lines) + "\n")
    monkeypatch.setenv("REPRO_CSV_CHUNK_BYTES", "512")
    got = _both(sessions, p)
    assert got.dtypes[0] == "float" and got.dtypes[1] == "str"


def test_all_null_and_late_typed_columns(tmp_path, sessions, monkeypatch):
    """A column with no value anywhere, and chunks that are all-null in a
    column another chunk types."""
    lines = ["a,b,c"] + [f"{i},," for i in range(400)]
    lines += [f"{i},{i * 0.5},t" for i in range(400, 420)]
    p = _write(tmp_path, "\n".join(lines) + "\n")
    monkeypatch.setenv("REPRO_CSV_CHUNK_BYTES", "256")
    ref = _read(REF, sessions, p)
    got = _read(PORT, sessions, p)
    assert _frame_state(got.collect()) == _frame_state(ref.collect())


@pytest.mark.parametrize("chunk", [64, 777, 10 ** 9])
def test_chunk_boundary_invariance(tmp_path, sessions, monkeypatch, chunk):
    rng = np.random.default_rng(5)
    lines = ["k,v,s"]
    for i in range(500):
        s = f'"s,{i % 13}"' if i % 3 == 0 else f"s{i % 13}"
        lines.append(f"{i % 9},{rng.integers(0, 100)},{s}")
    p = _write(tmp_path, "\n".join(lines) + "\n")
    whole = _read(PORT, sessions, p).to_pydict()
    monkeypatch.setenv("REPRO_CSV_CHUNK_BYTES", str(chunk))
    got = _both(sessions, p)
    assert got.to_pydict() == whole


# =============================================================================
# projection pushdown + misc
# =============================================================================
def test_usecols_pushdown(tmp_path, sessions):
    p = _write(tmp_path, 'a,b,c,d\n1,x,2.5,t\n2,y,3.5,f\n')
    _both(sessions, p, usecols=["a", "c"])
    assert _read(PORT, sessions, p, usecols=["c", "a"]).columns == ["a", "c"]
    with pytest.raises(KeyError):
        _read(PORT, sessions, p, usecols=["a", "nope"])


def test_alternate_separator(tmp_path, sessions):
    _both(sessions, _write(tmp_path, 'a;b\n1;"x;y"\n2;z\n'), sep=";")


def test_multichar_separator_with_quotes(tmp_path, sessions):
    p = _write(tmp_path, 'a||b||c\n1||"x||y"||3\n2||z||4\n')
    for P in BOTH:
        assert _read(P, sessions, p, sep="||").to_pydict() == {
            "a": [1, 2], "b": ["x||y", "z"], "c": [3, 4]}


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_embedded_newline_in_quoted_field_raises(P, tmp_path, sessions):
    p = _write(tmp_path, 'a,b\n1,"x\ny"\n2,z\n')
    with pytest.raises(ValueError, match="line break"):
        _read(P, sessions, p).collect()


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_seed_path_rejects_unsupported_args(P, tmp_path, sessions,
                                            monkeypatch):
    p = _write(tmp_path, 'a,b\n1,x\n')
    monkeypatch.setenv("REPRO_CSV_STREAM", "0")
    with pytest.raises(ValueError, match="seed parser"):
        _read(P, sessions, p, usecols=["a"])
    with pytest.raises(ValueError, match="seed parser"):
        _read(P, sessions, p, keep_default_na=False)
    assert _read(P, sessions, p).to_pydict() == {"a": [1], "b": ["x"]}


def test_extra_fields_raise_short_rows_pad(tmp_path, sessions):
    p = _write(tmp_path, 'a,b\n1,x\n2,y,z\n')
    for P in BOTH:
        with pytest.raises(ValueError, match="expected 2 fields"):
            _read(P, sessions, p).collect()
    _both(sessions, _write(tmp_path, 'a,b\n1,x\n2\n3,z\n', name="short.csv"))


def test_blank_lines_skipped(tmp_path, sessions):
    _both(sessions, _write(tmp_path, 'a,b\n1,x\n\n2,y\n\n\n3,z\n'))


def test_header_only_file(tmp_path, sessions):
    p = _write(tmp_path, 'a,b,c\n')
    for P in BOTH:
        df = _read(P, sessions, p)
        assert df.columns == ["a", "b", "c"] and len(df) == 0


def test_matches_seed_parser_on_plain_files(tmp_path, sessions, monkeypatch):
    """On plain files (no quotes, LF, no empty-vs-missing) the streaming
    parser equals the seed parser, and both equal the reference's."""
    rng = np.random.default_rng(9)
    lines = ["k,v,x,s"]
    for i in range(2000):
        lines.append(f"{i % 8},{rng.integers(0, 50)},"
                     f"{rng.integers(0, 12) * 0.25},s{i % 12:02d}")
    p = _write(tmp_path, "\n".join(lines) + "\n")
    a = _both(sessions, p)
    b = PORT.api._read_csv_seed(p, session=sessions["port"])
    assert a.to_pydict() == b.to_pydict()
    assert a.collect().row_labels.to_list() == b.collect().row_labels.to_list()
    assert a.dtypes == b.dtypes
    monkeypatch.setenv("REPRO_CSV_STREAM", "0")
    seed = {P.name: _read(P, sessions, p) for P in BOTH}
    assert _frame_state(seed["port"].collect()) == \
        _frame_state(seed["ref"].collect())


def test_chunk_blocks_are_store_partitions(tmp_path, sessions, monkeypatch):
    """Each byte-range chunk becomes one row block of the frame, with the
    reference's block boundaries."""
    p = _write(tmp_path, "a,b\n" + "".join(f"{i},{i % 3}\n"
                                            for i in range(3000)))
    monkeypatch.setenv("REPRO_CSV_CHUNK_BYTES", "1000")
    for P in BOTH:
        df = _read(P, sessions, p)
        fid = df._node.params["frame_id"]
        pf = sessions[P.name].frames[fid]
        assert pf.row_parts > 10
        sizes = pf.row_sizes
        if P is REF:
            ref_sizes = sizes
    assert sizes == ref_sizes


def test_read_csv_charges_the_budgeted_session_store(tmp_path):
    """A divergence held on purpose: the port parses inside the session's
    config scope, as every Session entry point runs, so a budgeted
    session's own store takes the chunks and spills them as they parse.
    The reference's ``read_csv`` runs outside that scope: its chunks land
    in the process store (unbudgeted here) and the session's budget never
    sees them.  The values agree."""
    from torch_pairs import write_csv
    csv = tmp_path / "big.csv"
    write_csv(csv, 20_000)
    out = {}
    for P in BOTH:
        s = P.Session(mode=P.EvalMode.LAZY, mem_budget_bytes=40_000,
                      spill_dir=str(tmp_path / P.name), **P.kw)
        try:
            df = P.api.read_csv(str(csv), session=s)
            st = s.config.store.stats
            biggest = max((h.nbytes for h in s.config.store._handles), default=0)
            out[P.name] = (df.to_pydict(), st.spills, st.peak_resident_bytes)
        finally:
            s.close()
    assert out["port"][0] == out["ref"][0]
    assert out["ref"][1:] == (0, 0)          # the budget never saw the chunks
    assert out["port"][1] > 0                # the port's spilled as they parsed
    assert out["port"][2] <= 40_000 + PORT.schedule.pool_width() * biggest
