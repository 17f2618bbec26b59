"""Shuffle-native SORT and JOIN of the PyTorch port against the JAX package.

The cases of ``tests/test_shuffle_differential.py`` that need neither fusion
nor a memory budget, run through an ``Executor`` of each package.  Every
port result — values, masks and row labels — is held bit-identical against
the reference's shuffled path AND the port's own serial ``REPRO_SHUFFLE=0``
oracle, over row grids {1, W, 4W} × optimize on/off; the exchange counters
(``shuffle_buckets`` / ``shuffle_bytes`` / ``skew_splits``) must equal the
reference's.  Fused variants are in ``tests/test_torch_fusion.py``.  The
out-of-core cases of ``tests/test_shuffle_differential.py:484-`` close the
file: a JOIN whose inputs are 4x the memory budget, bit-identical to the
reference's unbudgeted run with the port's peak residency within budget +
one block, and seeded corrupt / missing spill files during a budgeted
shuffled JOIN recomputed through the exchange's lineage.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import repro.core.algebra as ralg
from repro.core import shuffle as rshuffle
from repro.core.dtypes import Domain as RDomain
from repro.core.executor import Executor as RExecutor
from repro.core.frame import Column as RColumn
from repro.core.frame import Frame as RFrame
from repro.core.labels import RangeLabels as RRange
from repro.core.labels import labels_from_values as rlabels
from repro.core.partition import PartitionedFrame as RPF
from repro_torch.core import algebra as talg
from repro_torch.core import shuffle as tshuffle
from repro_torch.core.dtypes import Domain as TDomain
from repro_torch.core.executor import Executor as TExecutor
from repro_torch.core.frame import Column as TColumn
from repro_torch.core.frame import Frame as TFrame
from repro_torch.core.labels import RangeLabels as TRange
from repro_torch.core.labels import labels_from_values as tlabels
from repro_torch.core.partition import PartitionedFrame as TPF
from repro_torch.core.schedule import pool_width
from torch_pairs import BOTH, PORT, port_guards, reset_pools, reset_stores

assert port_guards

HOWS = ("inner", "left", "right", "outer")
STATS = ("shuffle_buckets", "shuffle_bytes", "skew_splits", "gather_rows")


@pytest.fixture(autouse=True)
def _shuffle_env(monkeypatch):
    for knob in ("REPRO_SHUFFLE", "REPRO_SHUFFLE_BUCKETS",
                 "REPRO_SHUFFLE_SKEW_FACTOR"):
        monkeypatch.delenv(knob, raising=False)
    for mod in (rshuffle, tshuffle):
        mod.configure(clear=True)
    yield monkeypatch
    for mod in (rshuffle, tshuffle):
        mod.configure(clear=True)


# =============================================================================
# helpers
# =============================================================================
def _grids() -> list[int]:
    w = pool_width()
    return sorted({1, w, 4 * w})


def _canon(v):
    if isinstance(v, float) and math.isnan(v):
        return "NaN"
    return v


def _lists(f) -> tuple[list, dict]:
    return (f.row_labels.to_list(),
            {k: [_canon(v) for v in vals] for k, vals in f.to_pydict().items()})


def _pydict_frames(data: dict) -> dict:
    return {"ref": RFrame.from_pydict(data), "port": TFrame.from_pydict(data, device="cpu")}


def _run(pkg, plan, frames, rp, optimize=True):
    """Evaluate ``plan(alg)`` in one package over frames split into ``rp``
    row blocks; (labels, values) and the executor's counters."""
    PF, Ex, alg = (RPF, RExecutor, ralg) if pkg == "ref" else (TPF, TExecutor, talg)
    store = {fid: PF.from_frame(f[pkg], row_parts=rp) for fid, f in frames.items()}
    ex = Ex(store, optimize=optimize)
    out = _lists(ex.evaluate(plan(alg)).to_frame())
    return out, {k: getattr(ex.stats, k) for k in STATS}


def _sweep(plan, frames: dict, monkeypatch) -> tuple[list, dict]:
    """The port's shuffled result on every grid × optimize setting equals
    the reference's shuffled result and the port's serial oracle; the
    exchange counters equal the reference's.  Returns the result."""
    for rp in _grids():
        ref, ref_stats = _run("ref", plan, frames, rp)
        for optimize in (True, False):
            got, stats = _run("port", plan, frames, rp, optimize)
            assert got == ref, f"grid={rp} optimize={optimize}"
            assert stats == ref_stats, f"grid={rp} optimize={optimize}"
    monkeypatch.setenv("REPRO_SHUFFLE", "0")
    try:
        serial, stats = _run("port", plan, frames, 2, optimize=False)
    finally:
        monkeypatch.delenv("REPRO_SHUFFLE")
    assert serial == ref
    assert stats["shuffle_buckets"] == stats["shuffle_bytes"] == 0
    return ref


def _join_case(seed: int, *, nulls: bool, nl=None, nr=None):
    rng = np.random.default_rng(seed)
    nl = int(rng.integers(1, 60)) if nl is None else nl
    nr = int(rng.integers(0, 60)) or 1 if nr is None else nr
    pool = int(rng.choice([3, 8, 40]))

    def keys(n):
        ks = rng.integers(0, pool, n).tolist()
        if nulls:
            mask = rng.random(n) < 0.25
            ks = [None if m else k for k, m in zip(ks, mask)]
        return ks

    ldata = {"k": keys(nl), "a": (rng.integers(0, 100, nl) * 0.25).tolist()}
    rdata = {"k": keys(nr), "b": (rng.integers(0, 100, nr) * 0.5).tolist()}
    return {"l": _pydict_frames(ldata), "r": _pydict_frames(rdata)}


def _join_plan(how, on=("k",), left_on=None, right_on=None):
    return lambda alg: alg.Join(alg.Source("l"), alg.Source("r"),
                                on=list(on) if on else None, how=how,
                                left_on=left_on, right_on=right_on)


def _sort_case(seed: int, *, nulls: bool, n=50):
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, 8, n).tolist()
    if nulls:
        mask = rng.random(n) < 0.25
        ks = [None if m else k for k, m in zip(ks, mask)]
    data = {"k": ks, "x": (rng.integers(0, 6, n) * 0.5).tolist(),
            "s": [None if i % 7 == 3 else "abcde"[int(v)] for i, v in
                  enumerate(rng.integers(0, 5, n))],
            "p": list(range(n))}
    return {"s": _pydict_frames(data)}


def _sort_plan(by, ascending, source="s"):
    return lambda alg: alg.Sort(alg.Source(source), list(by), ascending)


# =============================================================================
# JOIN
# =============================================================================
@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("seed", (0, 1))
def test_join_matches_reference_and_serial(how, seed, monkeypatch):
    _sweep(_join_plan(how), _join_case(seed, nulls=False), monkeypatch)


@pytest.mark.parametrize("how", HOWS)
def test_join_null_keys_match(how, monkeypatch):
    _sweep(_join_plan(how), _join_case(7, nulls=True), monkeypatch)


def test_cross_join_matches(monkeypatch):
    ref = _sweep(_join_plan("inner", on=None),
                 _join_case(3, nulls=False, nl=17, nr=9), monkeypatch)
    assert len(ref[0]) == 17 * 9


def test_join_left_on_right_on_matches(monkeypatch):
    """left_on/right_on keeps BOTH key columns (drop_right is empty)."""
    frames = _join_case(11, nulls=False)
    r = frames["r"]
    frames["r"] = {"ref": RFrame(r["ref"].columns, r["ref"].row_labels, rlabels(["k2", "b"])),
                   "port": TFrame(r["port"].columns, r["port"].row_labels,
                                  tlabels(["k2", "b"]))}
    ref = _sweep(_join_plan("inner", on=None, left_on=["k"], right_on=["k2"]),
                 frames, monkeypatch)
    assert list(ref[1]) == ["k", "a", "k2", "b"]


def _int64_frame(pkg, keys, vals, names):
    F, C, Dm, RL, lab = ((RFrame, RColumn, RDomain, RRange, rlabels) if pkg == "ref"
                         else (TFrame, TColumn, TDomain, TRange, tlabels))
    k, v = np.asarray(keys, dtype=np.int64), np.asarray(vals, dtype=np.float64)
    if pkg == "port":
        k, v = torch.from_numpy(k), torch.from_numpy(v)
    return F([C(k, Dm.INT), C(v, Dm.FLOAT)], RL(len(keys)), lab(names))


@pytest.mark.parametrize("how", HOWS)
def test_join_wide_int_keys_2p53(how, monkeypatch):
    """Keys past 2^53 lose float64 exactness — the wide-int hash path keeps
    2^53+1 and 2^53+2 distinct, shuffled and serial alike."""
    base = 1 << 53
    lk, rk = [base + 1, base + 2, base + 3, base + 1, 5], [base + 2, base + 1, base + 4, 5]
    frames = {"l": {p: _int64_frame(p, lk, np.arange(5.0), ["k", "a"]) for p in ("ref", "port")},
              "r": {p: _int64_frame(p, rk, np.arange(4.0), ["k", "b"]) for p in ("ref", "port")}}
    ref = _sweep(_join_plan(how), frames, monkeypatch)
    if how == "inner":
        assert len(ref[0]) == 4


def test_join_duplicate_key_tie_order(monkeypatch):
    frames = {"l": _pydict_frames({"k": [1, 1, 1, 1], "a": [0.0, 1.0, 2.0, 3.0]}),
              "r": _pydict_frames({"k": [1, 1, 1], "b": [10.0, 20.0, 30.0]})}
    ref = _sweep(_join_plan("inner"), frames, monkeypatch)
    assert ref[1]["a"] == [0.0] * 3 + [1.0] * 3 + [2.0] * 3 + [3.0] * 3
    assert ref[1]["b"] == [10.0, 20.0, 30.0] * 4


def test_join_skew_split_on_hot_key(monkeypatch):
    monkeypatch.setenv("REPRO_SHUFFLE_BUCKETS", "8")
    rng = np.random.default_rng(0)
    n = 400
    frames = {"l": _pydict_frames({"k": [1] * (n - 10) + rng.integers(2, 50, 10).tolist(),
                                   "a": (rng.integers(0, 9, n) * 0.5).tolist()}),
              "r": _pydict_frames({"k": [1] * (n - 10) + rng.integers(2, 50, 10).tolist(),
                                   "b": (rng.integers(0, 9, n) * 0.25).tolist()})}
    _sweep(_join_plan("outer"), frames, monkeypatch)
    _, stats = _run("port", _join_plan("outer"), frames, 4)
    assert stats["skew_splits"] > 0


def test_join_shuffle_stats_exact(monkeypatch):
    monkeypatch.setenv("REPRO_SHUFFLE_BUCKETS", "3")
    nl, nr = 40, 25
    frames = _join_case(1, nulls=False, nl=nl, nr=nr)
    _, stats = _run("port", _join_plan("inner"), frames, 4)
    assert stats["shuffle_buckets"] == 2 * 3
    assert stats["shuffle_bytes"] == (nl + nr) * 2 * 8
    _, ref_stats = _run("ref", _join_plan("inner"), frames, 4)
    assert stats == ref_stats


def test_cross_join_needs_no_exchange():
    frames = {"l": _pydict_frames({"a": [1.0, 2.0, 3.0]}),
              "r": _pydict_frames({"b": [1.0, 2.0]})}
    _, stats = _run("port", _join_plan("inner", on=None), frames, 2)
    assert stats["shuffle_buckets"] == stats["shuffle_bytes"] == 0


# =============================================================================
# SORT
# =============================================================================
@pytest.mark.parametrize("ascending", (True, False))
@pytest.mark.parametrize("nulls", (False, True))
def test_sort_matches_reference_and_serial(ascending, nulls, monkeypatch):
    _sweep(_sort_plan(["k", "x"], ascending), _sort_case(2, nulls=nulls), monkeypatch)


@pytest.mark.parametrize("ascending", (True, False))
def test_sort_multi_key_with_str_key(ascending, monkeypatch):
    """A coded key sorts by value rank (nulls last) with a numeric tie-break."""
    ref = _sweep(_sort_plan(["s", "x", "k"], ascending), _sort_case(5, nulls=True),
                 monkeypatch)
    s = [v for v in ref[1]["s"] if v is not None]
    assert s == sorted(s, reverse=not ascending)
    assert ref[1]["s"][len(s):] == [None] * (len(ref[1]["s"]) - len(s))


def test_sort_all_equal_keys_is_stable(monkeypatch):
    frames = {"s": _pydict_frames({"k": [7] * 40, "p": list(range(40))})}
    ref = _sweep(_sort_plan(["k"], True), frames, monkeypatch)
    assert ref[1]["p"] == list(range(40))


def test_sort_skew_split_on_hot_value(monkeypatch):
    monkeypatch.setenv("REPRO_SHUFFLE_BUCKETS", "8")
    rng = np.random.default_rng(1)
    n = 400
    frames = {"s": _pydict_frames({"k": [3] * (n - 8) + list(range(8)),
                                   "x": rng.normal(size=n).tolist(),
                                   "p": list(range(n))})}
    _sweep(_sort_plan(["k", "x"], True), frames, monkeypatch)
    _, stats = _run("port", _sort_plan(["k", "x"], True), frames, 4)
    assert stats["skew_splits"] > 0


def test_sort_shuffle_stats_exact(monkeypatch):
    monkeypatch.setenv("REPRO_SHUFFLE_BUCKETS", "3")
    n = 48
    rng = np.random.default_rng(0)
    frames = {"s": _pydict_frames({"k": rng.normal(size=n).tolist(), "p": list(range(n))})}
    _, stats = _run("port", _sort_plan(["k"], True), frames, 4)
    assert stats["shuffle_buckets"] == 3
    assert stats["shuffle_bytes"] == n * 2 * 8
    assert stats["skew_splits"] == 0


# =============================================================================
# no whole-frame concatenation; fused consumer stages
# =============================================================================
def test_no_to_frame_on_join_sort_inputs(monkeypatch):
    """Shuffled JOIN and SORT never concatenate an input."""
    frames = _join_case(8, nulls=True, nl=45, nr=35)
    store = {"l": TPF.from_frame(frames["l"]["port"], row_parts=4),
             "r": TPF.from_frame(frames["r"]["port"], row_parts=3)}
    calls = []
    orig = TPF.to_frame

    def spy(self):
        calls.append(1)
        return orig(self)

    monkeypatch.setattr(TPF, "to_frame", spy)
    for plan in [_join_plan(h) for h in HOWS] + [_join_plan("inner", on=None),
                                                 _sort_plan(["k", "a"], True, "l"),
                                                 _sort_plan(["a"], False, "l")]:
        TExecutor(store).evaluate(plan(talg))
    assert not calls


def test_fused_join_and_sort_stages_name_their_roadmap_item():
    """The consumer stages of FUSED_JOIN / FUSED_SORT (ROADMAP item M5) run
    through the exchange and equal the reference's, labels included."""
    frames = _join_case(0, nulls=False)
    params = {"on": ["k"], "how": "inner", "left_on": None, "right_on": None}
    got = []
    for pkg, alg, mod, PF in (("ref", ralg, rshuffle, RPF), ("port", talg, tshuffle, TPF)):
        pf = PF.from_frame(frames["l"][pkg], row_parts=3)
        stages = (alg.Stage("selection", {"predicate": alg.col("a") > alg.lit(10.0)}),
                  alg.Stage("projection", {"cols": ("k",)}))
        got.append((_lists(mod.shuffled_join(pf, pf, params, stages).to_frame()),
                    _lists(mod.shuffled_sort(pf, ["k"], True, stages).to_frame())))
    assert got[1] == got[0]
    assert list(got[1][1][1]) == ["k"]


# =============================================================================
# out-of-core: 4x-budget join; chaos during the exchange
# =============================================================================
def _big_join_frames(P, n=6000, selective=True):
    """``tests/test_shuffle_differential.py``'s inputs: sized to dominate
    the budget, key ranges mostly disjoint so the output stays small."""
    rng = np.random.default_rng(0)
    lhi, rlo, rhi = (3000, 2900, 5900) if selective else (500, 0, 500)
    lf = P.Frame([P.Column(P.arr(np.asarray(rng.integers(0, lhi, n),
                                            dtype=np.int64)), P.Domain.INT),
                  P.Column(P.arr(rng.normal(size=n)), P.Domain.FLOAT),
                  P.Column(P.arr(rng.normal(size=n)), P.Domain.FLOAT)],
                 P.RangeLabels(n), P.labels(["k", "a", "a2"]))
    rf = P.Frame([P.Column(P.arr(np.asarray(rng.integers(rlo, rhi, n),
                                            dtype=np.int64)), P.Domain.INT),
                  P.Column(P.arr(rng.normal(size=n)), P.Domain.FLOAT)],
                 P.RangeLabels(n), P.labels(["k", "b"]))
    return lf, rf


def _big_join(P, how, **kw):
    lf, rf = _big_join_frames(P, **kw)
    store = {"l": P.PF.from_frame(lf, row_parts=8),
             "r": P.PF.from_frame(rf, row_parts=8)}
    total = store["l"].nbytes() + store["r"].nbytes()
    ex = P.Executor(store)
    out = ex.evaluate(P.alg.Join(P.alg.Source("l"), P.alg.Source("r"),
                                 on=["k"], how=how))
    return _lists(out.to_frame()), total, ex.stats, store


@pytest.fixture
def budget_env(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_POOL_WORKERS", "2")
    monkeypatch.setenv("REPRO_SPILL_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_RETRY_BACKOFF_MS", "1")
    for knob in ("REPRO_MEM_BUDGET", "REPRO_FAULT_PLAN", "REPRO_FAULT_SEED"):
        monkeypatch.delenv(knob, raising=False)
    for P in BOTH:
        P.faults.reset()
    reset_pools()
    reset_stores()
    yield monkeypatch
    for knob in ("REPRO_MEM_BUDGET", "REPRO_FAULT_PLAN", "REPRO_FAULT_SEED"):
        monkeypatch.delenv(knob, raising=False)
    for P in BOTH:
        P.faults.reset()
    reset_stores()
    reset_pools()


@pytest.mark.spill
def test_join_4x_budget_completes_within_bound(budget_env):
    ref, total_ref, _, _ = _big_join(BOTH[0], "inner")
    base, total, st0, _ = _big_join(PORT, "inner")
    assert base == ref and total == total_ref
    assert st0.spills == 0 and st0.peak_resident_bytes == 0
    budget = total // 4
    budget_env.setenv("REPRO_MEM_BUDGET", str(budget))
    reset_stores()
    got, _, st, _keep = _big_join(PORT, "inner")
    assert got == ref
    assert st.spills > 0 and st.faults > 0
    store = PORT.store.get_store()
    one_block = PORT.schedule.budget_max_block_bytes()
    biggest = max((h.nbytes for h in store._handles), default=0)
    assert store.stats.peak_resident_bytes <= budget + max(one_block, biggest)


@pytest.mark.spill
@pytest.mark.parametrize("kind", ("corrupt", "missing"))
def test_chaos_spill_fault_during_exchange_recomputes(kind, budget_env):
    ref, total, _, _ = _big_join(BOTH[0], "left", n=4000, selective=False)
    budget_env.setenv("REPRO_MEM_BUDGET", str(total // 4))
    budget_env.setenv("REPRO_FAULT_PLAN", f"{kind}:0.4")
    budget_env.setenv("REPRO_FAULT_SEED", "7")
    reset_stores()
    got, _, st, _ = _big_join(PORT, "left", n=4000, selective=False)
    assert got == ref                        # recovered bit-identical
    assert PORT.faults.injected_total() > 0  # the chaos fired
    assert st.recomputed_blocks > 0          # and lineage recovered it
    assert st.recomputed_blocks == PORT.store.get_store().stats.recomputed_blocks
