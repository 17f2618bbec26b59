"""The port's spans on the profiler's timeline and in the ring.

A span site is live while the tracer is on or a torch profiler records.
Under the profiler each ``with`` span opens ``repro:<name>`` as a
``record_function`` range on its thread; with the tracer off those ranges
are all there is (``recorded_total()`` does not move).  These tests run the
yi-6b smoke config's prefill, a small engine statement, the serve engine and
a compiled-UDF probe on the CPU, and read the ranges from the profiler's
Chrome trace export, as ``perfbench/ranges.py`` reads them on the card.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.core import trace
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.models.model import build_model
from torch_pairs import PORT, frame, groupby_plan, port_guards, reset_pools

assert port_guards

PREFIX = trace.RANGE_PREFIX


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for knob in ("REPRO_TRACE", "REPRO_TRACE_RING", "REPRO_JIT_UDFS"):
        monkeypatch.delenv(knob, raising=False)
    trace.reset()
    yield monkeypatch
    trace.reset()


@pytest.fixture(scope="module")
def yi():
    cfg = get_smoke_config("yi-6b")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(3, cfg.vocab, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    return cfg, model, params, tokens


def _profiled(fn, tmp_path, all_threads: bool = False) -> list:
    """The Chrome trace events of ``fn()`` run under a CPU profiler."""
    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _ranges(events) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIX)]


def _forest(ranges) -> list:
    """The ranges of each thread nested by time: [(name, [children])]."""
    roots = []
    for tid in sorted({e["tid"] for e in ranges}, key=str):
        stack: list = []
        for e in sorted((e for e in ranges if e["tid"] == tid),
                        key=lambda e: (float(e["ts"]), -float(e["dur"]))):
            t0 = float(e["ts"])
            while stack and stack[-1][0] < t0:
                stack.pop()
            node = (e["name"][len(PREFIX):], [])
            (stack[-1][1][1] if stack else roots).append(node)
            stack.append((t0 + float(e["dur"]), node))
    return roots


def _expected_prefill(n_layers: int):
    attention = ("attention", [("qkv", [("rope", []), ("rope", [])]),
                               ("kernel:flash_attention", []), ("wo", [])])
    block = ("block", [("norm", []), attention, ("norm", []), ("mlp", [])])
    return ("prefill", [("embed", [])] + [block] * n_layers
            + [("unembed", [("norm", [])])])


def _ring_tree(tr) -> list:
    """The ring's spans as the same (name, [children]) forest, children in
    start order."""
    spans = sorted(tr.snapshot(), key=lambda s: (s.t0, s.id))
    nodes = {s.id: (s.name, []) for s in spans}
    roots = []
    for s in spans:
        (nodes[s.parent][1] if s.parent in nodes else roots).append(nodes[s.id])
    return roots


# =============================================================================
# the LM path's ranges
# =============================================================================
def test_prefill_ranges_nest_as_specified(yi, tmp_path):
    """One prefill under a CPU profiler with the tracer off: the ranges nest
    as the model's spans are placed, one ``block`` a layer, and nothing is
    recorded in any ring."""
    cfg, model, params, tokens = yi
    before = trace.recorded_total()
    events = _profiled(lambda: model.prefill(params, tokens), tmp_path)
    assert trace.recorded_total() == before
    assert _forest(_ranges(events)) == [_expected_prefill(cfg.n_layers)]


@pytest.mark.trace
def test_ring_holds_the_same_tree_with_layer_index(yi):
    cfg, model, params, tokens = yi
    tr = trace.Tracer(session_id="lm")
    trace.configure(tr)
    try:
        model.prefill(params, tokens)
    finally:
        trace.reset()
    assert _ring_tree(tr) == [_expected_prefill(cfg.n_layers)]
    blocks = [s for s in tr.snapshot() if s.name == "block"]
    assert [s.args for s in sorted(blocks, key=lambda s: s.t0)] == [
        {"index": i, "kind": "attn"} for i in range(cfg.n_layers)]
    assert {s.cat for s in tr.snapshot()} == {"model", "kernel"}
    assert len({s.stmt for s in tr.snapshot()}) == 1 and tr.open_spans() == 0


@pytest.mark.trace
@pytest.mark.parametrize("entry", ["prefill", "forward", "decode_step"])
def test_norm_spans_have_no_child_in_the_ring(yi, entry):
    """The rmsnorm kernel launches in ``norm`` itself (``kernels/ops.py``
    opens no ``kernel:rmsnorm`` for it): in the ring, each of the 2 x layers
    + 1 ``norm`` spans of a prefill, a forward and a decode step is a
    leaf."""
    cfg, model, params, tokens = yi
    tr = trace.Tracer(session_id="norm")
    trace.configure(tr)
    try:
        if entry == "decode_step":
            model.decode_step(params, tokens[:, 0], model.cache_init(tokens.shape[0], 8))
        else:
            getattr(model, entry)(params, tokens)
    finally:
        trace.reset()
    spans = tr.snapshot()
    norms = {s.id for s in spans if s.name == "norm"}
    assert len(norms) == 2 * cfg.n_layers + 1
    assert [s.name for s in spans if s.parent in norms] == []


@pytest.mark.trace
def test_ring_and_ranges_together(yi, tmp_path):
    """Tracer and profiler both on: the ring keeps the spans and the
    profiler shows the same ranges."""
    cfg, model, params, tokens = yi
    tr = trace.Tracer(session_id="both")
    trace.configure(tr)
    try:
        events = _profiled(lambda: model.prefill(params, tokens), tmp_path)
    finally:
        trace.reset()
    want = [_expected_prefill(cfg.n_layers)]
    assert _forest(_ranges(events)) == want and _ring_tree(tr) == want


def _opstats(model, params, tokens) -> dict:
    out = analyze(lambda: model.prefill(params, tokens)).to_dict()
    return json.loads(json.dumps(out, default=str))


@pytest.mark.trace
def test_hlo_analysis_counts_no_range(yi, tmp_path):
    """``launch.hlo_analysis.analyze`` of the smoke prefill counts the same
    operators with the tracer on, and under a profiler, as with both off: no
    range opens under its dispatch modes."""
    cfg, model, params, tokens = yi
    off = _opstats(model, params, tokens)
    trace.configure(trace.Tracer(session_id="hlo"))
    try:
        on = _opstats(model, params, tokens)
    finally:
        trace.reset()
    got = {}
    events = _profiled(lambda: got.update(_opstats(model, params, tokens)), tmp_path)
    assert on == off and got == off
    assert not _ranges(events)
    assert not any("record_function" in k for k in off["top_bytes"])


@pytest.mark.trace
def test_serve_engine_spans(yi):
    """``serve.admit`` a step, ``serve.step`` around the decode with the
    model's spans inside it, ``serve.sync`` inside the step."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, model, params, _ = yi
    eng = ServeEngine(model, params, max_batch=2, max_seq=16)
    eng.submit(Request(0, [5, 6, 7], max_new_tokens=2))
    tr = trace.Tracer(session_id="serve")
    trace.configure(tr)
    try:
        eng.run_until_done(max_steps=20)
    finally:
        trace.reset()
    steps = int(eng.metrics["steps"])
    spans = tr.snapshot()
    by_id = {s.id: s for s in spans}
    count = collections.Counter(s.name for s in spans)
    assert count["serve.step"] == count["serve.sync"] == steps > 0
    assert count["serve.admit"] == steps + 1          # the last call admits, finds none
    for s in spans:
        if s.name == "serve.sync":
            assert by_id[s.parent].name == "serve.step"
        if s.name in ("embed", "block", "unembed"):
            assert by_id[s.parent].name == "serve.step"
    assert count["block"] == steps * cfg.n_layers
    assert count["kernel:decode_attention"] == steps * cfg.n_layers


# =============================================================================
# the engine's spans on the profiler's timeline
# =============================================================================
def test_engine_statement_ranges_on_pool_threads(clean, tmp_path):
    """A small statement under a profiler that records every thread, the
    tracer off: ``statement:<op>``, ``eval:<op>`` and ``dispatch:<label>``
    on the caller, ``chunk:<label>`` on the pool threads, and no span kept."""
    clean.setenv("REPRO_POOL_WORKERS", "2")
    reset_pools()
    s = PORT.Session(mode=PORT.EvalMode.LAZY, **PORT.kw)
    before = trace.recorded_total()
    try:
        src = s.register_frame(frame(PORT, 200, seed=1, strings=False), row_parts=4)
        plan = groupby_plan(PORT, src, "spans_scale")
        events = _profiled(lambda: s.collect(plan), tmp_path, all_threads=True)
    finally:
        s.close()
        reset_pools()
    assert trace.recorded_total() == before
    ranges = _ranges(events)
    names = {e["name"][len(PREFIX):] for e in ranges}
    assert "statement:groupby" in names and "plan_prep" in names
    assert any(n.startswith("eval:") for n in names)
    assert any(n.startswith("dispatch:") for n in names)
    chunks = [e for e in ranges if e["name"].startswith(PREFIX + "chunk:")]
    stmt = [e for e in ranges if e["name"] == PREFIX + "statement:groupby"]
    assert chunks and len(stmt) == 1
    assert {e["tid"] for e in chunks} - {stmt[0]["tid"]}
    roots = [n for n in _forest(ranges) if n[0].startswith("statement:")]
    assert [r[0] for r in roots] == ["statement:groupby"]


# =============================================================================
# the compiled-UDF probe
# =============================================================================
@pytest.mark.trace
@pytest.mark.parametrize("case", ["trace error", "adopted"])
def test_jit_probe_span(case, clean):
    """One ``jit_probe`` span a probe with its kind, outcome and compile
    seconds, nothing compiled: an untraceable UDF is refused at its trace;
    a traceable one is adopted with the traced graph standing in for the
    compile."""
    from repro_torch.core import algebra as talg
    from repro_torch.core import physical as tphysical
    from repro_torch.core.dtypes import Domain
    from repro_torch.core.frame import Column, Frame, host
    clean.setenv("REPRO_JIT_UDFS", "1")
    tphysical._MAP_JIT.clear()
    tphysical.reset_jit_stats()
    if case == "adopted":
        clean.setattr(tphysical, "_compile_program", lambda gm: gm)
        fn = lambda c, fr: {"a": Column(c["a"].data * 2.0 + 1.0, Domain.FLOAT)}  # noqa: E731
    else:
        fn = lambda c, fr: {  # noqa: E731
            "a": Column(torch.tensor(c["a"].data.tolist()) * 2.0 + 1.0, Domain.FLOAT)}
    udf = talg.Udf(name=f"probe_{case}", elementwise=True, fn=fn)
    data = Frame.from_pydict({"a": [0.5, 1.5, 2.5]}, device="cpu")
    tr = trace.Tracer(session_id="jit")
    trace.configure(tr)
    try:
        got = tphysical._run_map_stages(data, [udf])
    finally:
        trace.reset()
        tphysical._MAP_JIT.clear()
    assert host(got.col("a").data).tolist() == [2.0, 4.0, 6.0]
    probes = [s for s in tr.snapshot() if s.name == "jit_probe"]
    assert len(probes) == 1 and probes[0].cat == "jit"
    args = probes[0].args
    assert (args["kind"], args["outcome"]) == ("map", case)
    assert args["compile_s"] == 0.0 if case == "trace error" else args["compile_s"] > 0.0
    assert tphysical.jit_stats()["chains"][-1][2] == case


# =============================================================================
# the off path and the export's clock
# =============================================================================
def _peak_bytes(loop) -> int:
    """Traced memory's rise to its peak over ``loop(10_000)``: a block
    allocated and freed each turn shows once, at its size."""
    loop(10)
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        loop(10_000)
        return tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()


def test_off_site_allocates_nothing():
    """Tracer and profiler off: ``scope`` hands back one shared null context,
    a site allocates nothing (10,000 sites peak no higher than the same loop
    around a null context; ``os.environ.get``, which encodes its key each
    call, would) and records nothing."""
    assert trace.current() is None and trace.live() is None
    assert trace.scope("norm", "model") is trace.scope("mlp", "model")
    null = contextlib.nullcontext()

    def sites(n):
        for _ in itertools.repeat(None, n):
            with trace.scope("norm", "model") as sp:
                assert sp is None

    def empty(n):
        for _ in itertools.repeat(None, n):
            with null as sp:
                assert sp is None

    def environ(n):
        for _ in itertools.repeat(None, n):
            os.environ.get("REPRO_TRACE", "")

    before = trace.recorded_total()
    floor = _peak_bytes(empty)
    assert _peak_bytes(sites) <= floor < _peak_bytes(environ)
    assert trace.recorded_total() == before


@pytest.mark.trace
def test_export_states_its_clock():
    tr = trace.Tracer(session_id="clock")
    with tr.span("x"):
        pass
    clock = tr.chrome_trace()["otherData"]["clock"]
    anchor = clock["anchor"]
    assert set(anchor) == {"perf_counter_ns", "time_ns"}
    assert all(isinstance(v, int) and v > 0 for v in anchor.values())
    # the anchor maps the ring's clock onto wall time
    wall = tr.snapshot()[0].t0 - anchor["perf_counter_ns"] + anchor["time_ns"]
    assert abs(wall - time.time_ns()) < 60e9
    assert trace.validate_chrome_trace(tr.chrome_trace()) >= 1


def test_no_profiler_flag_means_no_ranges():
    """``live`` answers None with both off, RANGES while a profiler records."""
    assert trace.live() is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.live() is trace.RANGES
    assert trace.live() is None
