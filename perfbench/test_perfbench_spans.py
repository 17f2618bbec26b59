"""The program's ranges in the traced window: attribution of device time to
the innermost ``repro:`` range, the four metrics that read it (on Chrome
trace events written by hand), and on a card, how much of the window the
ranges cover."""
import pytest

from perfbench import devtrace, harness, ranges
from perfbench.conftest import cells


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid,
            "args": args}


def launch(ts, corr, tid=1):
    return x("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, correlation=corr)


def nested_window():
    return [
        x("kernel", "spin_kernel", 0, 50),
        x("user_annotation", "perfbench:0", 100, 200),
        x("user_annotation", "repro:prefill", 110, 180),
        x("user_annotation", "repro:block", 120, 80),
        x("user_annotation", "repro:mlp", 150, 40),
        x("user_annotation", "repro:chunk:x", 155, 15, tid=2),   # another thread
        launch(160, 1),                                  # in mlp, on thread 1
        x("kernel", "gemm", 210, 10, correlation=1),     # runs after mlp closed
        launch(161, 2, tid=2),                           # in chunk:x, on thread 2
        x("kernel", "copy", 222, 4, correlation=2),
        launch(195, 3),                                  # block's own, after mlp
        x("kernel", "add", 230, 6, correlation=3),
        x("gpu_memcpy", "Memcpy DtoH", 250, 8, correlation=4),   # no launch record
        launch(295, 5),                                  # outside every program range
        x("kernel", "tail", 296, 3, correlation=5),
    ]


def test_innermost_range_on_the_launching_thread_at_launch():
    got = ranges.attribute(nested_window())
    assert list(got) == [0]
    got = got[0]
    assert set(got) == {"repro:mlp", "repro:chunk:x", "repro:block", "repro:prefill"}
    assert got["repro:mlp"] == pytest.approx(10e-6)        # launched in mlp, ran later
    assert got["repro:chunk:x"] == pytest.approx(4e-6)     # thread 2's innermost
    assert got["repro:block"] == pytest.approx(6e-6)       # self time, mlp closed
    assert got["repro:prefill"] == pytest.approx(8e-6)     # where it ran: prefill
    # the trace reads the same window as before: all 31 us in the unit
    assert devtrace.parse(nested_window(), [{"label": "prefill"}]).device_s(0) \
        == pytest.approx(31e-6)


def test_without_program_ranges_nothing_is_attributed():
    events = [e for e in nested_window() if not e["name"].startswith(ranges.RANGE)]
    assert ranges.attribute(events) == {}
    assert devtrace.parse(events, [{}]).device_s(0) == pytest.approx(31e-6)


def test_the_events_are_found_beside_the_trace_they_made():
    prof = devtrace.Profiler(None, 0, 1)
    prof.events = nested_window()
    tr = prof.trace([{}])
    run = run_of(tr)
    assert ranges.seconds(run, "repro:mlp") == {0: pytest.approx(10e-6)}
    assert ranges.seconds(run, "repro:rope") == {0: 0.0}
    # a frame that holds a profiler but not the run's trace is passed over
    other = run_of(devtrace.parse(nested_window(), [{}]))
    assert ranges.of(other) is None and ranges.seconds(other, "repro:mlp") is None


# -----------------------------------------------------------------------------
# the four metrics on a hand-made window: a model of hidden 8, ff 16, 4 heads
# over 2 KV heads (head_dim 2), 2 layers; one traced unit of 2 x 3 tokens
# -----------------------------------------------------------------------------
CFG = {"hidden_size": 8, "intermediate_size": 16, "num_attention_heads": 4,
       "num_key_value_heads": 2, "num_hidden_layers": 2}
PEAKS = {"bf16_flops": 1e12, "hbm_bytes": 1e9}
# device microseconds launched in each range
SECONDS = {"repro:mlp": 4, "repro:norm": 2, "repro:rope": 3, "repro:kernel:flash_attention": 5}
METRICS = ("mlp_roofline.prefill", "norm_roofline.prefill", "rope_roofline.prefill",
           "flash_roofline.prefill")


def window_with(ranges: bool):
    events = [x("kernel", "spin_kernel", 0, 50), x("user_annotation", "perfbench:0", 100, 100)]
    t = 110
    for corr, (name, us) in enumerate(SECONDS.items(), 1):
        if ranges:
            events.append(x("user_annotation", name, t, 5))
        events += [launch(t + 1, corr), x("kernel", f"k{corr}", t + 2, us, correlation=corr)]
        t += 20
    return events


def run_of(trace, peaks=PEAKS):
    cell = harness.Cell("yi-6b.prefill-long", 1, CFG, {}, None)
    units = [{"batch": 2, "seq": 3, "tokens": 6}]
    return harness.Run(cell, units, 1.0, 0.0, {}, trace, peaks, units)


def read_as_harness(metric, events, peaks=PEAKS):
    """``metric`` read as the harness reads it: from a frame that holds the
    profiler that took the window and the trace it made."""
    prof = devtrace.Profiler(None, 0, 1)
    prof.events = events
    tr = prof.trace([{}])
    return harness.reader(metric).read(run_of(tr, peaks))


def test_metrics_against_hand_counts():
    got = {m: read_as_harness(m, window_with(True)) for m in METRICS}
    # MLP: 6 x 8 x 16 = 768 FLOPs a token a layer, x 2 layers x 6 tokens = 9,216
    assert got["mlp_roofline.prefill"] == pytest.approx(100 * 9216 / 1e12 / 4e-6)
    # norms: 4 x 8 = 32 bytes a row; 2 x 2 layers x 6 tokens + 2 final rows = 26 rows
    assert got["norm_roofline.prefill"] == pytest.approx(100 * 832 / 1e9 / 2e-6)
    # RoPE: 4 x (4 + 2) x 2 = 48 bytes a token a layer, x 2 x 6 = 576
    assert got["rope_roofline.prefill"] == pytest.approx(100 * 576 / 1e9 / 3e-6)
    # flash: 4 x 4 heads x 2 x 2 rows x 3 x 4 / 2 pairs = 384 a layer, x 2 = 768
    assert got["flash_roofline.prefill"] == pytest.approx(100 * 768 / 1e12 / 5e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_metrics_read_none_without_something_to_read(metric):
    read = harness.reader(metric).read
    assert read(run_of(None)) is None                                          # untraced
    assert read_as_harness(metric, window_with(False)) is None                 # no ranges
    assert read_as_harness(metric, window_with(True), peaks=None) is None      # no peaks
    # a trace whose events no calling frame holds
    assert read(run_of(devtrace.parse(window_with(True), [{}]))) is None


def test_the_metrics_are_declared_for_the_cell():
    bench = harness.benchmark()
    declared = {m["name"]: m for m in harness.metrics_for(bench, "yi-6b.prefill-long", True)}
    for name in METRICS:
        m = declared[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "%", "higher", "device_trace", "prefill_tokens_per_s")


@pytest.mark.card
@pytest.mark.parametrize("name", cells())
def test_program_ranges_cover_the_traced_window(name, card, tiny):
    """A traced window of the cut cell on the card: at least 95% of its
    device time (the lead-in left out) is launched in some ``repro:``
    range."""
    import torch
    c = tiny(name)
    drive = harness.runner(c.traffic["kind"])
    state = drive.setup(harness.Context(c, 2**34 + 9, card, True))
    k = int(c.traffic["trace_units"])
    prof = devtrace.Profiler(torch, 0, k)
    units = harness.run_count(range(k), lambda i: drive.unit(state, i), prof)
    tr = prof.trace(units)
    assert tr is not None
    total = sum(s for _, s in tr.device_ops(10**6))
    ranged = sum(sum(by.values()) for by in ranges.attribute(prof.events).values())
    assert total > 0 and ranged >= 0.95 * total, (ranged, total)
