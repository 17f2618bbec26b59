"""Whole runs of each cell at its cut size on a CUDA card, untraced and
traced: the program's CUDA kernels, the reference on the card, and the
profiler window with its per-layer metrics.  Skip without a card."""
import pytest

from perfbench import harness
from perfbench.conftest import cells


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", cells())
def test_cut_cell_on_the_card(name, trace, card, tiny):
    bench = harness.benchmark()
    out = harness.run_cell(name, 2**34 + 5, 2.0, trace, bench=bench, the_cell=tiny(name))
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["memory_peak_bytes"] > 0
    want = {m["name"] for m in harness.metrics_for(bench, name, trace)}
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        for m, v in out["metrics"].items():
            if "roofline" in m or "mfu" in m:
                assert 0 < v["value"] <= 105, (m, v)
