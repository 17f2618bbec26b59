"""The port's out-of-core block store against the JAX package's.

The cases of ``tests/test_store.py``, each run on both packages with the
same seeded input: residency states, budget-governed spill and fault,
pin scopes, benefit-density eviction, spill-file cleanup, the reentrant
finalizer, wide int64 host columns, zero-copy planning over handles, the
budget equivalence sweep and the CSV pipeline over data 4x the budget.
Results are bit-equal to the reference's and to the port's unbudgeted run;
the store counters are equal to the reference's wherever its run is
deterministic (one pool worker, or no dispatch at all).  The port's spill
file is also held to the reference's format: the ``RSPL1`` magic, the
``<IQ`` (crc32, length) header over an uncompressed npz payload, and a
flipped payload byte that raises ``SpillIntegrityError``.
"""
from __future__ import annotations

import gc
import os
import struct
import threading
import weakref
import zlib

import numpy as np
import pytest
import torch

from torch_pairs import (BOTH, IDS, PORT, REF, frame, pipeline_plan, port_guards,
                         reset_pools, reset_stores, write_csv)

pytestmark = pytest.mark.spill
assert port_guards


@pytest.fixture
def fresh_store(monkeypatch, tmp_path):
    for knob in ("REPRO_MEM_BUDGET", "REPRO_FAULT_PLAN", "REPRO_POOL_WORKERS"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("REPRO_SPILL_DIR", str(tmp_path))
    reset_stores()
    yield monkeypatch
    reset_stores()
    reset_pools()


def _budget(monkeypatch, nbytes) -> None:
    monkeypatch.setenv("REPRO_MEM_BUDGET", str(nbytes))
    reset_stores()


def _stats(P) -> tuple:
    st = P.store.get_store().stats
    return tuple(getattr(st, k) for k in st.__slots__)


# =============================================================================
# store unit behaviour
# =============================================================================
@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_budget_zero_is_untracked_fast_path(P, fresh_store):
    f = frame(P)
    h = P.store.as_handle(f)
    assert isinstance(h, P.store.BlockHandle)
    assert not h.is_tracked and h.is_resident
    assert h.frame() is f
    assert P.store.get_store().stats.spills == 0


def _roundtrip(P, mp):
    f = frame(P, 200)
    _budget(mp, f.nbytes() + 16)
    h1 = P.store.as_handle(frame(P, 200, seed=1))
    h2 = P.store.as_handle(frame(P, 200, seed=2))      # evicts h1
    states = [(h1.is_resident, h2.is_resident)]
    back = h1.frame()                                  # h2 spills for room
    states.append((h1.is_resident, h2.is_resident))
    ref = frame(P, 200, seed=1)
    assert back.to_pydict() == ref.to_pydict()
    assert back.row_labels.to_list() == ref.row_labels.to_list()
    assert back.col("s").dictionary == ref.col("s").dictionary
    st = P.store.get_store().stats
    assert st.peak_resident_bytes <= P.store.get_store().budget + ref.nbytes()
    return states, back.to_pydict(), _stats(P)


def test_spill_and_fault_roundtrip(fresh_store):
    ref = _roundtrip(REF, fresh_store)
    got = _roundtrip(PORT, fresh_store)
    assert got == ref
    assert got[0] == [(False, True), (True, False)]
    assert got[2][:2] == (2, 1)                        # two spills, one fault


def test_fault_lands_on_the_block_device(fresh_store):
    """A faulted block's columns are tensors again, on the frame's device,
    with the storage dtypes they were spilled with."""
    f = frame(PORT, 200)
    _budget(fresh_store, f.nbytes() + 16)
    h1 = PORT.store.as_handle(frame(PORT, 200, seed=1))
    h2 = PORT.store.as_handle(frame(PORT, 200, seed=2))
    assert not h1.is_resident
    back = h1.frame()
    for c, dt in zip(back.columns, (torch.int32, torch.float32, torch.int32)):
        assert isinstance(c.data, torch.Tensor) and c.data.dtype == dt
        assert c.data.device == torch.device("cpu")
    del h2


def test_spill_frees_a_registered_blocks_memory(fresh_store, tmp_path):
    """``Session.register_frame`` cuts a frame into row ranges that are views
    of its columns (``Frame.take_rows``).  Under a budget the store keeps a
    copy of each block that owns its memory, so a spill frees the block's
    bytes instead of leaving them held by the frame's storage (in the JAX
    package a slice is a copy already).  The source frame keeps its own."""
    from torch.multiprocessing.reductions import StorageWeakRef
    src = frame(PORT, 800)
    s = PORT.Session(mem_budget_bytes=2 * (src.nbytes() // 4) + 16,
                     spill_dir=str(tmp_path), device="cpu")
    store, seen = s.config.store, []
    put = store.put

    def spy(f, *a, **kw):
        h = put(f, *a, **kw)
        arrays = [x for c in h._frame.columns for x in (c.data, c.mask)
                  if x is not None]
        seen.append((h, [StorageWeakRef(x.untyped_storage()) for x in arrays],
                     all(x.untyped_storage().nbytes()
                         == x.numel() * x.element_size() for x in arrays)))
        return h

    fresh_store.setattr(store, "put", spy)
    try:
        node = s.register_frame(src, row_parts=4)
        gc.collect()
        assert len(seen) == 4 and store.stats.spills > 0
        for h, refs, owns in seen:
            assert owns
            assert all(r.expired() for r in refs) == (not h.is_resident)
        assert not any(StorageWeakRef(c.data.untyped_storage()).expired()
                       for c in src.columns)
        assert s.collect(node).to_pydict() == src.to_pydict()
    finally:
        s.close()


def test_budget_zero_blocks_stay_views(fresh_store):
    """Without a budget the store tracks and copies nothing: the registered
    blocks are views of the frame's storage, as before the store."""
    src = frame(PORT, 800)
    s = PORT.Session(device="cpu")
    try:
        pf = s.frames[s.register_frame(src, row_parts=4).params["frame_id"]]
        base = [c.data.untyped_storage().data_ptr() for c in src.columns]
        for row in pf.handles:
            f = row[0].frame()
            assert [c.data.untyped_storage().data_ptr() for c in f.columns] == base
    finally:
        s.close()


def _pinned(P, mp):
    _budget(mp, frame(P, 200, seed=1).nbytes() + 16)
    h1 = P.store.as_handle(frame(P, 200, seed=1))
    with h1.pinned():
        h2 = P.store.as_handle(frame(P, 200, seed=2))  # over budget, pinned
        inside = h1.is_resident
    h3 = P.store.as_handle(frame(P, 200, seed=3))
    out = (inside, h1.is_resident, _stats(P))
    del h2, h3
    return out


def test_pinned_blocks_never_evicted(fresh_store):
    ref = _pinned(REF, fresh_store)
    got = _pinned(PORT, fresh_store)
    assert got == ref
    assert got[:2] == (True, False)


def _eviction(P, mp):
    one = frame(P, 200).nbytes()
    _budget(mp, 2 * one + 16)
    h1 = P.store.as_handle(frame(P, 200, seed=1))
    h2 = P.store.as_handle(frame(P, 200, seed=2))
    h1.frame()                                         # h2 becomes LRU
    h3 = P.store.as_handle(frame(P, 200, seed=3))
    lru = (h1.is_resident, h2.is_resident)
    h1.benefit = 10.0                                  # benefit beats recency
    h2.frame()
    h4 = P.store.as_handle(frame(P, 200, seed=4))
    out = (lru, h1.is_resident, _stats(P))
    del h3, h4
    return out


def test_eviction_order_lru_then_benefit(fresh_store):
    ref = _eviction(REF, fresh_store)
    got = _eviction(PORT, fresh_store)
    assert got == ref
    assert got[:2] == ((True, False), True)


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_spill_files_cleaned_on_reset(P, fresh_store, tmp_path):
    _budget(fresh_store, frame(P, 200).nbytes() + 16)
    keep = [P.store.as_handle(frame(P, 200, seed=1)),
            P.store.as_handle(frame(P, 200, seed=2))]
    assert P.store.get_store().stats.spills >= 1
    assert any(tmp_path.rglob("blk*.npz"))
    P.store.reset_store()
    assert not any(tmp_path.rglob("blk*.npz"))
    del keep


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_handle_gc_deletes_spill_file(P, fresh_store, tmp_path):
    _budget(fresh_store, frame(P, 200).nbytes() + 16)
    h1 = P.store.as_handle(frame(P, 200, seed=1))
    h2 = P.store.as_handle(frame(P, 200, seed=2))
    assert not h1.is_resident
    files = list(tmp_path.rglob("blk*.npz"))
    assert files
    del h1
    gc.collect()
    assert not any(p.exists() for p in files)
    del h2


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_finalizer_under_store_lock_does_not_deadlock(P, fresh_store,
                                                      tmp_path):
    """A dead handle's finalizer takes the store lock, and the cyclic GC
    can run it on a thread already inside a locked store section."""
    store = P.store.BlockStore(10 ** 6, str(tmp_path))
    holder = [store.put(frame(P, 64))]
    holder.append(holder)
    del holder
    gc.collect()

    class Cyc:
        pass

    c = Cyc()
    c.h = store.put(frame(P, 64, seed=1))
    c.self = c
    del c
    gc.disable()
    try:
        done = []

        def inside():
            with store._lock:
                gc.collect()
            done.append(True)

        t = threading.Thread(target=inside, daemon=True)
        t.start()
        t.join(10)
        assert done, "finalizer deadlocked against the held store lock"
    finally:
        gc.enable()
    store.shutdown()


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_configure_same_settings_is_nondestructive(P, fresh_store):
    f = frame(P, 200)
    _budget(fresh_store, f.nbytes() + 16)
    before = P.store.get_store()
    h1 = P.store.as_handle(frame(P, 200, seed=1))
    h2 = P.store.as_handle(frame(P, 200, seed=2))
    assert not h1.is_resident
    try:
        assert P.store.configure(budget_bytes=f.nbytes() + 16) is before
        assert h1.frame().to_pydict() == frame(P, 200, seed=1).to_pydict()
        h2.frame()
        assert not h1.is_resident
        P.store.configure(budget_bytes=f.nbytes() + 32)
        with pytest.raises(RuntimeError, match="spill"):
            h1.frame()
    finally:
        P.store.unconfigure()
    assert P.store.get_store().budget == f.nbytes() + 16


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_wide_int64_survives_spill(P, fresh_store):
    big = np.asarray([2 ** 53 + 1, 2 ** 53 + 2, 5], dtype=np.int64)
    f = P.Frame([P.Column(big, P.Domain.INT)], P.RangeLabels(3),
                P.labels(["w"]))
    _budget(fresh_store, 1)
    h = P.store.as_handle(f)
    h2 = P.store.as_handle(frame(P, 50))
    assert not h.is_resident
    back = h.frame()
    # int64 host storage comes back as a host numpy array, never a tensor
    assert isinstance(back.col("w").data, np.ndarray)
    assert back.col("w").data.dtype == np.int64
    assert back.to_pydict() == {"w": [2 ** 53 + 1, 2 ** 53 + 2, 5]}
    del h2


# =============================================================================
# the spill file's format
# =============================================================================
def _spilled_file(P, mp):
    _budget(mp, frame(P, 200).nbytes() + 16)
    h = P.store.as_handle(frame(P, 200, seed=1))
    keep = P.store.as_handle(frame(P, 200, seed=2))
    assert not h.is_resident
    with open(h._rec.path, "rb") as f:
        return h, keep, f.read()


def test_spill_file_header_and_payload_match_reference(fresh_store):
    """``RSPL1\\n`` + ``<IQ`` (crc32, length) + an uncompressed npz whose
    column members equal the reference's bit for bit."""
    files = {}
    for P in BOTH:
        h, keep, raw = _spilled_file(P, fresh_store)
        assert raw[:6] == b"RSPL1\n"
        crc, n = struct.unpack_from("<IQ", raw, 6)
        payload = raw[6 + 12:]
        assert len(payload) == n
        assert zlib.crc32(payload) & 0xFFFFFFFF == crc
        import io
        with np.load(io.BytesIO(payload)) as z:
            files[P.name] = {k: z[k] for k in z.files if k != "__meta__"}
        del h, keep
    assert files["port"].keys() == files["ref"].keys() == {"d0", "d1", "d2"}
    for k, v in files["ref"].items():
        assert files["port"][k].dtype == v.dtype
        assert files["port"][k].tobytes() == v.tobytes()


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_flipped_payload_byte_raises_integrity_error(P, fresh_store):
    h, keep, raw = _spilled_file(P, fresh_store)
    path = h._rec.path
    with open(path, "r+b") as f:
        f.seek(len(raw) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(P.faults.SpillIntegrityError, match="CRC32"):
        P.store._load_frame(path)
    with pytest.raises(P.faults.SpillIntegrityError,
                       match="no recorded producer"):
        h.frame()
    assert P.store.get_store().stats.checksum_failures == 1
    del keep


@pytest.mark.parametrize("P", BOTH, ids=IDS)
def test_bad_magic_raises_integrity_error(P, fresh_store):
    h, keep, raw = _spilled_file(P, fresh_store)
    with open(h._rec.path, "r+b") as f:
        f.write(b"XSPL1\n")
    with pytest.raises(P.faults.SpillIntegrityError, match="header"):
        P.store._load_frame(h._rec.path)
    del keep


# =============================================================================
# zero-copy planning over handles
# =============================================================================
def _regroup(P, mp):
    one = frame(P, 100).nbytes()
    _budget(mp, 2 * one + 16)
    pf = P.PF([[P.store.as_handle(frame(P, 100, seed=i))] for i in range(4)])
    spilled = [h.is_resident for row in pf.handles for h in row]
    st = P.store.get_store().stats
    faults0 = st.faults
    same = pf.repartition(row_parts=4)
    assert same.row_sizes == pf.row_sizes
    assert pf.nbytes() == 4 * one
    assert pf.prefix(150).row_parts == 2
    assert st.faults == faults0
    assert same.handles[0][0] is pf.handles[0][0]
    return spilled, _stats(P)


def test_regroup_passthrough_never_faults(fresh_store):
    ref = _regroup(REF, fresh_store)
    got = _regroup(PORT, fresh_store)
    assert got == ref
    assert not all(got[0])


def _union(P, mp):
    one = frame(P, 100).nbytes()
    _budget(mp, one + 16)
    a = P.PF([[P.store.as_handle(frame(P, 100, seed=1))]])
    b = P.PF([[P.store.as_handle(frame(P, 100, seed=2))]])
    st = P.store.get_store().stats
    faults0 = st.faults
    ex = P.Executor({"a": a, "b": b}, optimize=False)
    out = ex.evaluate(P.alg.Union(P.alg.Source("a", 100, 3),
                                  P.alg.Source("b", 100, 3)))
    assert st.faults == faults0
    return out.nrows, _stats(P)


def test_union_is_metadata_only(fresh_store):
    assert _union(PORT, fresh_store) == _union(REF, fresh_store)


# =============================================================================
# equivalence sweep: grids {1, W, 4W} × budget {0, tiny}
# =============================================================================
def _sweep_run(P, rp, fused, name):
    f = frame(P, 4000, seed=7)
    pf = P.PF.from_frame(f, row_parts=rp)
    ex = P.Executor({"f": pf}, optimize=fused)
    out = ex.evaluate(pipeline_plan(P, P.alg.Source("f", 4000, 3), name))
    return out.to_frame().to_pydict(), ex.stats


@pytest.mark.parametrize("grid", [1, None, "4w"])
@pytest.mark.parametrize("fused", [True, False])
def test_budget_equivalence_sweep(grid, fused, fresh_store):
    fresh_store.setenv("REPRO_POOL_WORKERS", "2")
    reset_pools()
    w = PORT.schedule.pool_width()
    rp = {1: 1, None: w, "4w": 4 * w}[grid]
    ref, st_ref = _sweep_run(REF, rp, fused, "store_sweep_scale")
    base, st_base = _sweep_run(PORT, rp, fused, "store_sweep_scale")
    assert base == ref
    assert st_base.spills == st_base.faults == 0
    _budget(fresh_store, max(frame(PORT, 4000, seed=7).nbytes() // 4, 1))
    got, st = _sweep_run(PORT, rp, fused, "store_sweep_scale")
    assert got == ref                       # bit-identical under the budget
    if rp > 1:
        assert st.spills > 0


def test_budget_sweep_counters_equal_reference_on_one_worker(fresh_store):
    """With one pool worker the eviction order is deterministic, so the
    port's store moves exactly the blocks and bytes the reference's does."""
    fresh_store.setenv("REPRO_POOL_WORKERS", "1")
    reset_pools()
    _budget(fresh_store, max(frame(PORT, 4000, seed=7).nbytes() // 4, 1))
    ref, st_ref = _sweep_run(REF, 8, True, "store_det")
    got, st = _sweep_run(PORT, 8, True, "store_det")
    assert got == ref
    assert st.spills > 0
    assert _stats(PORT) == _stats(REF)
    for k in ("spills", "faults", "spilled_bytes", "peak_resident_bytes"):
        assert getattr(st, k) == getattr(st_ref, k), k


# =============================================================================
# acceptance: pipeline over data 4x the budget (+ pandas oracle)
# =============================================================================
def _csv_pipeline(P, csv):
    s = P.Session(mode=P.EvalMode.LAZY, **P.kw)
    try:
        df = P.api.read_csv(str(csv), session=s)
        df["y"] = df["x"] * 2.0 + 1.0
        out = (df[df["v"] > 10].groupby("k")
               .agg({"y": "sum", "x": "mean"}).drop_duplicates())
        res = out.collect().to_pydict()
        total = s.frames["frame_0"].nbytes()
        biggest = max((h.nbytes for h in P.store.get_store()._handles),
                      default=0)
        return res, total, s.executor.stats, biggest
    finally:
        s.close()


def test_outofcore_pipeline_4x_budget(fresh_store, tmp_path):
    pd = pytest.importorskip("pandas")
    fresh_store.setenv("REPRO_POOL_WORKERS", "2")
    reset_pools()
    csv = tmp_path / "big.csv"
    write_csv(csv, 30_000)
    ref, total_ref, st_ref, _ = _csv_pipeline(REF, csv)
    base, total, st0, _ = _csv_pipeline(PORT, csv)
    assert base == ref and total == total_ref
    assert st0.spills == 0 and st0.peak_resident_bytes == 0

    budget = total // 4
    _budget(fresh_store, budget)
    got, _, st, ingest_block = _csv_pipeline(PORT, csv)
    assert got == ref
    assert st.spills > 0 and st.faults > 0 and st.spilled_bytes > 0
    store_stats = PORT.store.get_store().stats
    one_block = PORT.schedule.budget_max_block_bytes()
    assert ingest_block > 0
    assert store_stats.peak_resident_bytes <= budget + max(one_block,
                                                           ingest_block)
    pdf = pd.read_csv(csv)
    pdf["y"] = pdf["x"] * 2.0 + 1.0
    g = (pdf[pdf["v"] > 10].groupby("k", as_index=False)
         .agg(y=("y", "sum"), x=("x", "mean")))
    np.testing.assert_array_equal(np.asarray(got["k"]), g["k"].to_numpy())
    np.testing.assert_allclose(np.asarray(got["y"]), g["y"].to_numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got["x"]), g["x"].to_numpy(),
                               rtol=1e-5)


def test_peak_within_budget_plus_one_block_per_worker(fresh_store):
    """The bound of the store's docstring, on a 4-worker pool over 16
    blocks: resident ≤ budget + one in-flight block per worker."""
    fresh_store.setenv("REPRO_POOL_WORKERS", "4")
    reset_pools()
    f = frame(PORT, 8000, seed=11)
    budget = f.nbytes() // 4
    _budget(fresh_store, budget)
    pf = PORT.PF.from_frame(f, row_parts=16)
    block = max(h.nbytes for row in pf.handles for h in row)
    ex = PORT.Executor({"f": pf}, optimize=True)
    out = ex.evaluate(pipeline_plan(PORT, PORT.alg.Source("f", 8000, 3),
                                    "store_peak"))
    st = PORT.store.get_store().stats
    assert st.spills > 0 and st.faults > 0
    biggest = max(block, PORT.schedule.budget_max_block_bytes())
    assert st.peak_resident_bytes <= budget + 4 * biggest
    ref_pf = REF.PF.from_frame(frame(REF, 8000, seed=11), row_parts=16)
    ref = REF.Executor({"f": ref_pf}, optimize=True).evaluate(
        pipeline_plan(REF, REF.alg.Source("f", 8000, 3), "store_peak"))
    assert out.to_frame().to_pydict() == ref.to_frame().to_pydict()


class _LiveBytes:
    """The bytes of the tensors the store has taken in (put or faulted back),
    for as long as they are alive: what the device holds of them, which the
    store's counter alone does not show (a block dropped on a spill stays
    allocated while anything still refers to its tensors)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seen: set = set()
        self.live = self.peak = 0

    def _free(self, key, n):
        with self.lock:
            self.seen.discard(key)
            self.live -= n

    def track(self, f):
        for c in f.columns:
            for a in (c.data, c.mask):
                if not isinstance(a, torch.Tensor):
                    continue
                st = a.untyped_storage()
                key, n = st.data_ptr(), st.nbytes()
                with self.lock:
                    if key in self.seen:
                        continue
                    self.seen.add(key)
                    self.live += n
                    self.peak = max(self.peak, self.live)
                weakref.finalize(a, self._free, key, n)
        return f


def _ooc_statement(df, stmt):
    if stmt == "agg_fused":
        return df[df["x"] > 0.5].groupby("k").agg({"x": ["sum", "mean", "max"]})
    if stmt == "cumsum":
        return df.cumsum(cols=["x"])
    if stmt == "sort":
        return df.sort_values("x")
    rates = PORT.core.DataFrame({"k": list(range(8)), "r": [0.5 * i for i in range(8)]},
                                session=df._session)
    return df.merge(rates, on="k")


@pytest.mark.parametrize("stmt", ["agg_fused", "cumsum", "sort", "merge"])
def test_budgeted_statement_holds_device_memory_to_the_bound(stmt, fresh_store,
                                                              tmp_path):
    """Over the ingest and a budgeted statement on the engine's
    memory-governed paths (``collect()``'s concatenation of the result
    aside), the tensors the store took in that are still alive stay within
    budget + one block per worker — the store's own bound, held by the
    memory itself and not only by its counter.  The result equals the
    unbudgeted run's."""
    fresh_store.setenv("REPRO_POOL_WORKERS", "2")
    fresh_store.setenv("REPRO_ADAPT_GRID", "0")
    reset_pools()
    live = _LiveBytes()
    load, owned = PORT.store._load_frame, PORT.store._owned
    fresh_store.setattr(PORT.store, "_load_frame", lambda p: live.track(load(p)))
    fresh_store.setattr(PORT.store, "_owned", lambda f: live.track(owned(f)))
    src = frame(PORT, 6000, seed=5)
    lazy = PORT.EvalMode.LAZY
    plain = PORT.Session(mode=lazy, device="cpu")
    try:
        df = PORT.core.DataFrame(session=plain,
                                 node=plain.register_frame(src, row_parts=12))
        want = _ooc_statement(df, stmt).collect().to_pydict()
    finally:
        plain.close()
    budget = src.nbytes() // 3
    s = PORT.Session(mode=lazy, mem_budget_bytes=budget, spill_dir=str(tmp_path),
                     device="cpu")
    try:
        df = PORT.core.DataFrame(session=s, node=s.register_frame(src, row_parts=12))
        node = _ooc_statement(df, stmt)._node
        with PORT.config.scope(s.config):     # collect() without its concat
            out = s.executor.evaluate(node)
        store = s.config.store
        biggest = max(h.nbytes for h in list(store._handles))
        assert store.stats.spills > 0 and store.stats.faults > 0
        assert live.peak <= budget + 2 * biggest, (live.peak, budget, biggest)
        assert out.to_frame().to_pydict() == want
    finally:
        s.close()


def test_read_csv_larger_than_budget_streams_to_spill(fresh_store, tmp_path):
    pd = pytest.importorskip("pandas")
    fresh_store.setenv("REPRO_POOL_WORKERS", "2")
    reset_pools()
    csv = tmp_path / "huge.csv"
    write_csv(csv, 20_000)
    _budget(fresh_store, 40000)
    s = PORT.Session(mode=PORT.EvalMode.LAZY, **PORT.kw)
    try:
        df = PORT.api.read_csv(str(csv), session=s)
        pf = s.frames["frame_0"]
        st = PORT.store.get_store().stats
        assert pf.nbytes() > 40000
        assert st.spills > 0
        assert st.peak_resident_bytes <= 40000 + max(
            h.nbytes for h in PORT.store.get_store()._handles)
        assert not all(h.is_resident for row in pf.handles for h in row)
        assert len(df) == 20_000
        got = df[["k"]].collect().to_pydict()["k"]
        assert got == pd.read_csv(csv)["k"].tolist()
    finally:
        s.close()


# =============================================================================
# executor attribution + shared budget
# =============================================================================
def _attribution(P):
    f = frame(P, 4000, seed=9)
    pf = P.PF.from_frame(f, row_parts=8)
    ex = P.Executor({"f": pf}, optimize=True)
    plan = pipeline_plan(P, P.alg.Source("f", 4000, 3), "store_attr")
    out1 = ex.evaluate(plan)
    assert ex.stats.faults > 0
    assert 0 < ex.stats.peak_resident_bytes
    assert (ex.stats.peak_resident_bytes
            <= P.store.get_store().stats.peak_resident_bytes)
    ent = ex.cache[ex._prepared(plan).cache_key()]
    assert ent.benefit_density() > 0
    for row in ent.result.handles:
        for h in row:
            if h.is_tracked:
                assert h.benefit >= ent.benefit_density() * 0.99
    out2 = ex.evaluate(plan)
    assert ex.stats.cache_hits >= 1
    assert out2.to_frame().to_pydict() == out1.to_frame().to_pydict()
    return out1.to_frame().to_pydict()


def test_execstats_attribution_and_shared_budget(fresh_store):
    fresh_store.setenv("REPRO_POOL_WORKERS", "2")
    reset_pools()
    _budget(fresh_store, max(frame(PORT, 4000, seed=9).nbytes() // 3, 1))
    assert _attribution(PORT) == _attribution(REF)


def _dispatch_order(P, mp):
    one = frame(P, 100).nbytes()
    _budget(mp, 2 * one + 16)
    handles = [P.store.as_handle(frame(P, 100, seed=i)) for i in range(4)]
    spilled_idx = {i for i, h in enumerate(handles) if not h.is_resident}
    assert spilled_idx
    seen = []

    def probe(h):
        seen.append(h)
        return P.store.resolve(h).nrows

    out = P.schedule.dispatch_blocks(probe, handles)
    assert out == [100] * 4
    ranks = [1 if handles.index(h) in spilled_idx else 0 for h in seen]
    assert ranks == sorted(ranks)
    return sorted(spilled_idx), [handles.index(h) for h in seen]


def test_residency_aware_dispatch_order(fresh_store):
    """Resident blocks run before spilled ones; results stay in block order
    (one worker, so the order is deterministic)."""
    fresh_store.setenv("REPRO_POOL_WORKERS", "1")
    reset_pools()
    assert _dispatch_order(PORT, fresh_store) == _dispatch_order(
        REF, fresh_store)
