"""The port's progressive aggregation (paper §6.1.3) against the JAX
package's: ``tests/test_approx.py``'s cases with the same seeded frames.
Every estimate — value, interval, rows seen, final flag — equals the
reference's bit for bit, since both sum each block's column on the host in
float64; the first-k groups come out in the same input order."""
from __future__ import annotations

import numpy as np
import pytest

from torch_pairs import BOTH, PORT, REF, port_guards

assert port_guards


def _pf(P, n=10_000, parts=8, seed=0):
    rng = np.random.default_rng(seed)
    f = P.Frame.from_pydict({"v": rng.standard_normal(n).tolist(),
                             "k": rng.choice(["a", "b", "c", "d"], n).tolist()},
                            **P.kw)
    return P.PF.from_frame(f, row_parts=parts), f


def _estimates(P, func, seed, column="v", **kw):
    pf, _ = _pf(P, seed=seed, **kw)
    return [(e.value, e.ci_low, e.ci_high, e.rows_seen, e.rows_total, e.final)
            for e in P.approx.progressive_aggregate(pf, column, func)]


@pytest.mark.parametrize("func", ["sum", "count", "mean"])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_estimates_equal_reference(func, seed):
    got = _estimates(PORT, func, seed)
    assert got == _estimates(REF, func, seed)
    assert len(got) == 8 and got[-1][5]


def test_progressive_mean_converges_with_shrinking_ci():
    pf, f = _pf(PORT)
    ests = list(PORT.approx.progressive_aggregate(pf, "v", "mean"))
    assert len(ests) == pf.row_parts
    widths = [e.ci_high - e.ci_low for e in ests[:-1]]
    assert widths[0] >= widths[-1]
    exact = float(np.mean(f.col("v").data.numpy()))
    assert abs(ests[-1].value - exact) < 1e-5 and ests[-1].final


def test_progressive_sum_final_exact():
    pf, f = _pf(PORT, seed=3)
    *_, last = PORT.approx.progressive_aggregate(pf, "v", "sum")
    np.testing.assert_allclose(last.value, float(np.sum(f.col("v").data.numpy())),
                               rtol=1e-4, atol=1e-3)


def test_progressive_estimates_cover_truth():
    pf, f = _pf(PORT, seed=7)
    exact = float(np.mean(f.col("v").data.numpy()))
    ests = list(PORT.approx.progressive_aggregate(pf, "v", "mean"))
    assert sum(1 for e in ests if e.ci_low <= exact <= e.ci_high) >= \
        pf.row_parts - 3
    assert abs(ests[-1].value - exact) < 1e-4


def test_masked_column_and_uneven_blocks_equal_reference():
    """Nulls are left out of the sums and the counts alike."""
    got = {}
    for P in BOTH:
        rng = np.random.default_rng(5)
        vals = [None if m else float(v) for v, m in
                zip(rng.integers(0, 40, 997) * 0.5, rng.random(997) < 0.3)]
        f = P.Frame.from_pydict({"x": vals}, **P.kw)
        pf = P.PF.from_frame(f, row_parts=5)
        got[P.name] = [[(e.value, e.ci_low, e.ci_high, e.rows_seen, e.final)
                        for e in P.approx.progressive_aggregate(pf, "x", fn)]
                       for fn in ("sum", "count", "mean")]
    assert got["port"] == got["ref"]


def test_first_k_groups_input_order():
    for P in BOTH:
        f = P.Frame.from_pydict({"k": ["x", "y", "x", "z", "w"]}, **P.kw)
        pf = P.PF.from_frame(f, row_parts=2)
        assert P.approx.first_k_groups(pf, "k", 3) == ["x", "y", "z"]
    pf_t, _ = _pf(PORT, seed=1)
    pf_r, _ = _pf(REF, seed=1)
    assert PORT.approx.first_k_groups(pf_t, "k", 4) == \
        REF.approx.first_k_groups(pf_r, "k", 4)
