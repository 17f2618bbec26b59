"""The traced window's reading, on Chrome trace events written by hand."""
from perfbench import devtrace as profile


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def window():
    return [
        x("kernel", "spin_kernel", 0, 50),                        # the lead-in
        x("user_annotation", "perfbench:0", 100, 100),
        x("user_annotation", "perfbench:1", 210, 90),
        x("cuda_runtime", "cudaLaunchKernel", 120, 2, correlation=7),
        x("kernel", "seg_reg", 150, 20, correlation=7),
        x("cuda_runtime", "cudaLaunchKernel", 195, 2, correlation=8),
        x("kernel", "scan_one_pass", 205, 30, correlation=8),     # runs in unit 1, launched in 0
        x("gpu_memcpy", "Memcpy DtoH", 250, 10, correlation=9),   # no launch record: where it ran
        x("cpu_op", "aten::nonzero", 260, 30, tid=2),
    ]


def test_busy_window_and_attribution():
    units = [{"label": "groupby"}, {"label": "cumsum"}]
    tr = profile.parse(window(), units)
    assert tr.window_s == 200e-6
    assert abs(tr.busy_s - 60e-6) < 1e-12
    assert tr.units() == [0, 1]
    assert abs(tr.device_s(0) - 50e-6) < 1e-12
    assert abs(tr.device_s(0, ("scan_one_pass",)) - 30e-6) < 1e-12
    assert abs(tr.device_s(1) - 10e-6) < 1e-12
    assert tr.device_ops(1) == [["scan_one_pass", 30e-6]]
    gaps = dict(tr.idle_gaps(10))
    assert abs(sum(gaps.values()) - 140e-6) < 1e-12
    assert abs(gaps["cumsum / aten::nonzero"] - 40e-6) < 1e-12


def test_a_window_without_device_records_is_lost():
    events = [e for e in window() if e["cat"] not in profile.DEVICE_CATS]
    assert profile.parse(events, [{}, {}]) is None
    lead_in_lost = [e for e in window() if e["name"] != "spin_kernel"]
    assert profile.parse(lead_in_lost, [{}, {}]) is None
