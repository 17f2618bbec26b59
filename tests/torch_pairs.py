"""Shared pieces of the port's out-of-core, fault, service, trace and approx
differential tests (``tests/test_torch_{store,read_csv,faults,service,trace,
approx}.py`` and the budget cases of ``tests/test_torch_shuffle.py``).

``REF`` and ``PORT`` name the same modules of the JAX package and of the
PyTorch port, so one scenario function runs on both and its results compare
directly.  The port runs on the CPU in these tests (``PORT.kw``).

``port_guards`` is the port's counterpart of ``tests/conftest.py``'s two
autouse guards, which watch only the reference's process store and tracer:
with no ``spill`` marker no test may spill the port's process store, and
with no ``trace`` marker no test may record a span in the port's tracer.
Each test file imports it, which makes it autouse there.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import repro.core as _rcore
import repro_torch.core as _tcore
from repro.core import (algebra as _ralg, api as _rapi, approx as _rapprox,
                        config as _rconfig, executor as _rexec,
                        faults as _rfaults, schedule as _rsched,
                        service as _rservice, store as _rstore,
                        trace as _rtrace)
from repro.core.dtypes import Domain as _RDomain
from repro.core.frame import Column as _RColumn, Frame as _RFrame
from repro.core.labels import (RangeLabels as _RRange,
                               labels_from_values as _rlabels)
from repro.core.partition import PartitionedFrame as _RPF
from repro_torch.core import (algebra as _talg, api as _tapi,
                              approx as _tapprox, config as _tconfig,
                              executor as _texec, faults as _tfaults,
                              schedule as _tsched, service as _tservice,
                              store as _tstore, trace as _ttrace)
from repro_torch.core.dtypes import Domain as _TDomain
from repro_torch.core.frame import Column as _TColumn, Frame as _TFrame
from repro_torch.core.labels import (RangeLabels as _TRange,
                                     labels_from_values as _tlabels)
from repro_torch.core.partition import PartitionedFrame as _TPF


def _ns(name, core, alg, api, approx, config, executor, faults, schedule,
        service, store, trace, Domain, Column, Frame, RangeLabels, labels,
        PF, arr, kw):
    return types.SimpleNamespace(
        name=name, core=core, alg=alg, api=api, approx=approx, config=config,
        executor=executor, faults=faults, schedule=schedule, service=service,
        store=store, trace=trace, Domain=Domain, Column=Column, Frame=Frame,
        RangeLabels=RangeLabels, labels=labels, PF=PF, arr=arr, kw=kw,
        Executor=executor.Executor, ExecStats=executor.ExecStats,
        Session=core.Session, EvalMode=core.EvalMode,
        QueryService=service.QueryService)


REF = _ns("ref", _rcore, _ralg, _rapi, _rapprox, _rconfig, _rexec, _rfaults,
          _rsched, _rservice, _rstore, _rtrace, _RDomain, _RColumn, _RFrame,
          _RRange, _rlabels, _RPF, np.asarray, {})
PORT = _ns("port", _tcore, _talg, _tapi, _tapprox, _tconfig, _texec,
           _tfaults, _tsched, _tservice, _tstore, _ttrace, _TDomain, _TColumn,
           _TFrame, _TRange, _tlabels, _TPF,
           lambda a: torch.from_numpy(np.array(a)), {"device": "cpu"})
BOTH = (REF, PORT)
IDS = ("ref", "port")


@pytest.fixture(autouse=True)
def port_guards(request):
    """The port's no-unexpected-spills and zero-spans guards."""
    st = _tstore.get_store()
    spills = st.stats.spills
    spans = _ttrace.recorded_total()
    yield
    if request.node.get_closest_marker("spill") is None:
        cur = _tstore.get_store()
        after = cur.stats.spills if cur is st else 0
        assert after == spills, (
            f"unexpected port block-store spills during "
            f"{request.node.nodeid}: {after - spills}")
    if request.node.get_closest_marker("trace") is None:
        assert _ttrace.recorded_total() == spans, (
            f"unexpected port trace spans during {request.node.nodeid}")


def reset_stores() -> None:
    for P in BOTH:
        P.store.reset_store()


def reset_pools() -> None:
    for P in BOTH:
        P.schedule.reset_pool()


def frame(P, n=100, seed=0, *, strings=True):
    """The reference tests' ``_frame``: INT keys in [0, 8), FLOAT multiples
    of 0.25 (exact, so partial-combine order cannot move a bit) and a coded
    STR column."""
    rng = np.random.default_rng(seed)
    cols = [P.Column(P.arr(rng.integers(0, 8, n, dtype=np.int32)),
                     P.Domain.INT),
            P.Column(P.arr((rng.integers(0, 12, n) * np.float32(0.25))
                           .astype(np.float32)), P.Domain.FLOAT)]
    names = ["k", "x"]
    if strings:
        cols.append(P.Column(P.arr(rng.integers(0, 5, n, dtype=np.int32)),
                             P.Domain.STR, None, ("a", "b", "c", "d", "e")))
        names.append("s")
    return P.Frame(cols, P.RangeLabels(n), P.labels(names))


def scale_udf(P, name, scale=2.0):
    def fn(cols, frame, scale=scale):
        out = dict(cols)
        c = cols["x"]
        out["x"] = P.Column(c.data * scale + 1.0, P.Domain.FLOAT, c.mask,
                            None)
        return out

    return P.alg.Udf(name=name, fn=fn, deps=frozenset(["x"]),
                     elementwise=True)


def groupby_plan(P, src, name, scale=2.0, xs="x"):
    """MAP → SELECTION → GROUPBY(sum, count): the reference suites' plan."""
    alg = P.alg
    return alg.GroupBy(
        alg.Selection(alg.Map(src, scale_udf(P, name, scale)),
                      alg.col("k") < alg.lit(6)),
        ("k",), [("x", "sum", xs), ("x", "count", "n")])


def pipeline_plan(P, src, name):
    """``groupby_plan`` then DROP-DUPLICATES."""
    return P.alg.DropDuplicates(groupby_plan(P, src, name), None)


def write_csv(path, n, seed=3, *, strings=True):
    """The reference suites' CSV: k, v ints, x multiples of 0.25, s codes."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 8, n)
    v = rng.integers(0, 50, n)
    x = rng.integers(0, 12, n) * 0.25
    s = rng.integers(0, 12, n)
    with open(path, "w") as f:
        f.write("k,v,x,s\n" if strings else "k,v,x\n")
        for i in range(n):
            tail = f",s{s[i]:02d}" if strings else ""
            f.write(f"{k[i]},{v[i]},{x[i]}{tail}\n")
