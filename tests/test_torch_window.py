"""WINDOW of the PyTorch port against the JAX package.

Every function of ``WINDOW_FUNCS`` runs as one WINDOW node through
``physical.run_node`` in both packages, over row grids {1, W, 4W} (W = pool
width), on a taxi-like frame (1% nulls per float column) and on a frame
whose null runs and constant runs cross block seams.  Labels, schemas and
masks compare bit-equal; cummax / cummin / diff / shift values too (they do
no rounding the two packages could order differently); cumsum, cumprod and
rolling use rtol=atol=1e-4, as tests/test_kernels.py does for the scan.
"""
import numpy as np
import pytest

from repro.core import algebra as ralg
from repro.core import physical as rphys
from repro.core.frame import Frame as RFrame
from repro.core.partition import PartitionedFrame as RPF
from repro.core.schedule import pool_width
from repro.data.synthetic import taxi_like_frame as r_taxi
from repro_torch.core import algebra as talg
from repro_torch.core import physical as tphys
from repro_torch.core.frame import Frame as TFrame
from repro_torch.core.frame import host
from repro_torch.core.partition import PartitionedFrame as TPF
from repro_torch.data import taxi_like_frame as t_taxi
from repro_torch.kernels import window_scan as ws_mod

N = 3000
EXACT = {"cummax", "cummin", "diff", "shift"}


def _grids():
    w = pool_width()
    return sorted({1, w, 4 * w})


def _frames_match(ref, port, exact: bool):
    assert port.col_labels.to_list() == ref.col_labels.to_list()
    assert port.row_labels.to_list() == ref.row_labels.to_list()
    assert [d.value for d in port.schema] == [d.value for d in ref.schema]
    for a, b in zip(ref.columns, port.columns):
        assert a.dictionary == b.dictionary
        va = np.ones(len(a), bool) if a.mask is None else np.asarray(a.mask)
        np.testing.assert_array_equal(host(b.valid_mask()), va)
        da, db = np.asarray(a.data)[va], host(b.data)[va]
        if exact or da.dtype.kind != "f":
            np.testing.assert_array_equal(db, da)
        else:
            np.testing.assert_allclose(db, da, rtol=1e-4, atol=1e-4)


def _run(alg, run_node, pf, func, cols, size=None, periods=1):
    node = alg.Window(alg.Source("w", 0, 0), func, cols, size=size, periods=periods)
    return run_node(node, [pf]).to_frame()


def _seam_data(n=1000):
    """Null runs and constant runs that cross block seams at every grid."""
    rng = np.random.default_rng(3)
    v = (rng.standard_normal(n) * 3).round(2)
    g = np.where(np.arange(n) % 250 < 140, 2.5, v)          # tied runs
    ints = rng.integers(-5, 6, n)
    valid = np.ones(n, bool)
    valid[90:230] = False
    valid[600:603] = False
    return {"v": [None if not ok else float(x) for x, ok in zip(v, valid)],
            "g": [float(x) for x in g],
            "i": [None if 400 <= k < 520 else int(x) for k, x in enumerate(ints)]}


PARAMS = [
    ("cumsum", {}), ("cummax", {}), ("cummin", {}), ("cumprod", {}),
    ("diff", {"periods": 1}), ("diff", {"periods": 3}), ("shift", {"periods": 1}),
    ("shift", {"periods": 130}), ("rolling_sum", {"size": 10}),
    ("rolling_mean", {"size": 4}), ("rolling_mean", {"size": 150}),
]


def _ids(p):
    func, kw = p
    return func + "".join(f"-{k}{v}" for k, v in kw.items())


@pytest.mark.parametrize("func,kw", PARAMS, ids=[_ids(p) for p in PARAMS])
@pytest.mark.parametrize("grid", _grids())
def test_window_taxi_matches_reference(func, kw, grid):
    cols = None if func != "cumprod" else ["passenger_count"]
    rpf = RPF.from_frame(r_taxi(N, seed=0), row_parts=grid)
    tpf = TPF.from_frame(t_taxi(N, seed=0, device="cpu"), row_parts=grid)
    _frames_match(_run(ralg, rphys.run_node, rpf, func, cols, **kw),
                  _run(talg, tphys.run_node, tpf, func, cols, **kw), func in EXACT)


@pytest.mark.parametrize("func,kw", PARAMS, ids=[_ids(p) for p in PARAMS])
@pytest.mark.parametrize("grid", _grids())
def test_window_seams_match_reference(func, kw, grid):
    d = _seam_data()
    cols = ["v", "i"] if func != "cumprod" else ["g"]
    rpf = RPF.from_frame(RFrame.from_pydict(d), row_parts=grid)
    tpf = TPF.from_frame(TFrame.from_pydict(d, device="cpu"), row_parts=grid)
    _frames_match(_run(ralg, rphys.run_node, rpf, func, cols, **kw),
                  _run(talg, tphys.run_node, tpf, func, cols, **kw), func in EXACT)


def test_window_grid_does_not_change_the_port_result():
    """The carry composition is exact for max/min: every grid gives the
    same bits, and the scan launches nothing on the CPU."""
    ws_mod.counter.reset()
    frames = [_run(talg, tphys.run_node,
                   TPF.from_frame(t_taxi(N, seed=2, device="cpu"), row_parts=g),
                   "cummax", None) for g in _grids()]
    for f in frames[1:]:
        _frames_match(frames[0], f, exact=True)
    assert ws_mod.counter.launches == 0


def test_rolling_mean_follows_the_reference_null_rule():
    """rolling = cumsum − shift(cumsum, w), where a null at row i−w takes
    nothing off: row 3's window [null, 3.0] gives 6.0, the whole prefix sum,
    where pandas gives NaN.  The reference's rule, kept as it is (ROADMAP
    "Known divergences")."""
    d = {"v": [1.0, None, 2.0, 3.0, 4.0]}
    port = _run(talg, tphys.run_node, TPF.from_frame(TFrame.from_pydict(d, device="cpu")),
                "rolling_sum", ["v"], size=2)
    ref = _run(ralg, rphys.run_node, RPF.from_frame(RFrame.from_pydict(d)),
               "rolling_sum", ["v"], size=2)
    _frames_match(ref, port, exact=False)
    assert port.col("v").to_pylist() == [None, None, 2.0, 6.0, 7.0]


def test_fused_window_stages_name_their_roadmap_item():
    """FUSED_WINDOW's stages (ROADMAP item M5) run: a pre-stage rename and
    a post-stage selection, as in the reference."""
    d = {"v": [1.0, 2.0, -4.0, 3.5]}
    out = []
    for alg, phys, PF, F, kw in ((ralg, rphys, RPF, RFrame, {}),
                                 (talg, tphys, TPF, TFrame, {"device": "cpu"})):
        pre = (alg.Stage("rename", {"mapping": (("v", "w"),)}),)
        post = (alg.Stage("selection", {"predicate": alg.col("w") > alg.lit(0.0)}),)
        pf = PF.from_frame(F.from_pydict(d, **kw), row_parts=2)
        out.append(phys._window(pf, "cumsum", None, None, 1, pre=pre, post=post).to_frame())
    _frames_match(out[0], out[1], exact=True)
    assert out[1].col("w").to_pylist() == [1.0, 3.0, 2.5]
