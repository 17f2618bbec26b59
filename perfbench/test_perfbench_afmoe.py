"""The AFMoE cell's yardstick (``cost_afmoe``) against numbers worked by
hand, and its four per-layer metrics on Chrome trace events written by
hand: their values, and None where there is nothing to read."""
import json
from pathlib import Path

import pytest

from perfbench import cost_afmoe, devtrace, harness
from perfbench.test_perfbench_spans import launch, x

HERE = Path(__file__).resolve().parent
TRINITY = json.loads((HERE / "configs" / "trinity-mini.json").read_text())
CELL = "trinity-mini.prefill-long"
METRICS = ("mfu.prefill-afmoe", "moe_roofline.prefill-afmoe", "experts_roofline.prefill-afmoe",
           "flash_roofline.prefill-afmoe")


def test_trinity_parameters():
    # a layer's attention: q, gate, o 2048 x 4096 and k, v 2048 x 512 = 27,262,976;
    # an expert 3 x 2048 x 1024 = 6,291,456; a MoE layer 128 of them, the shared one,
    # the router 2048 x 128 and its bias 128; the 2 dense layers 3 x 2048 x 6144; four
    # norms of 2048 and two of 128 a layer and the final one; both embeddings
    assert cost_afmoe.attention_params(TRINITY) == 27_262_976
    moe_layer = 129 * 6_291_456 + 262_144 + 128
    total = (32 * 27_262_976 + 30 * moe_layer + 2 * 37_748_736 + 32 * 8448 + 2048
             + 2 * 200_192 * 2048)
    assert cost_afmoe.params(TRINITY) == (total, total - 30 * 120 * 6_291_456)
    assert cost_afmoe.params(TRINITY) == (26_123_974_400, 3_474_732_800)


def test_trinity_prefill_flops_a_token():
    # per token: attention's products 2 x 32 x 27,262,976; the dense SwiGLU 2 x 6 x 2048 x 6144;
    # the router 30 x 2 x 2048 x 128; routed and shared experts 30 x 9 x 6 x 2048 x 1024
    per_token = 1_744_830_464 + 150_994_944 + 15_728_640 + 3_397_386_240
    # S = 4096: a sliding layer's pairs 2048 x 2049 / 2 + 2048 x 2048, a full one's
    # 4096 x 4097 / 2; 4 x 32 x 128 FLOPs a pair; the unembedding once a sequence
    pairs = 24 * 6_292_480 + 8 * 8_390_656
    assert cost_afmoe.visible_pairs(4096, 2048) == 6_292_480
    assert cost_afmoe.visible_pairs(1024, 2048) == 1024 * 1025 // 2
    assert cost_afmoe.flash_flops(TRINITY, 1, 4096) == 16_384 * pairs
    want = 4096 * per_token + 16_384 * pairs + 2 * 200_192 * 2048
    assert cost_afmoe.prefill_flops(TRINITY, 1, 4096) == want == 25_320_323_284_992
    assert cost_afmoe.prefill_flops(TRINITY, 4, 4096) == 4 * want
    assert cost_afmoe.moe_flops(TRINITY, 1, 1) == 3_397_386_240
    assert cost_afmoe.experts_flops(TRINITY, 1, 1) == 30 * 8 * 6 * 2048 * 1024


# -----------------------------------------------------------------------------
# the metrics on a hand-made window: hidden 8, 2 heads over 1 KV head of 4, 2 layers
# (one sliding of window 2, one full), no dense layer, 4 experts of 4 (top 2) and one
# shared, vocab 10; one traced unit of 2 x 3 tokens
# -----------------------------------------------------------------------------
CFG = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4,
       "num_hidden_layers": 2, "layer_types": ["sliding_attention", "full_attention"],
       "sliding_window": 2, "num_dense_layers": 0, "intermediate_size": 16,
       "moe_intermediate_size": 4, "num_experts": 4, "num_experts_per_tok": 2,
       "num_shared_experts": 1, "vocab_size": 10}
PEAKS = {"bf16_flops": 1e12, "hbm_bytes": 1e9}
# device microseconds launched in each range
SECONDS = {"repro:moe": 1, "repro:route": 2, "repro:experts": 4, "repro:combine": 3,
           "repro:shared": 5, "repro:kernel:flash_attention": 6}


def window_with(ranges: bool):
    events = [x("kernel", "spin_kernel", 0, 50), x("user_annotation", "perfbench:0", 100, 200)]
    t = 110
    for corr, (name, us) in enumerate(SECONDS.items(), 1):
        if ranges:
            events.append(x("user_annotation", name, t, 5))
        events += [launch(t + 1, corr), x("kernel", f"k{corr}", t + 2, us, correlation=corr)]
        t += 20
    return events


def run_of(trace, peaks=PEAKS):
    cell = harness.Cell(CELL, 1, CFG, {}, None)
    units = [{"batch": 2, "seq": 3, "tokens": 6}]
    return harness.Run(cell, units, 1.0, 0.0, {}, trace, peaks, units)


def read_as_harness(metric, events, peaks=PEAKS):
    prof = devtrace.Profiler(None, 0, 1)
    prof.events = events
    tr = prof.trace([{}])
    return harness.reader(metric).read(run_of(tr, peaks))


def test_metrics_against_hand_counts():
    got = {m: read_as_harness(m, window_with(True)) for m in METRICS}
    # routed experts: 6 x 8 x 4 = 192 a route, 2 routes a token, 2 MoE layers, 6 tokens
    assert got["experts_roofline.prefill-afmoe"] == pytest.approx(100 * 4608 / 1e12 / 4e-6)
    # with the shared expert: 3 x 192 a token a layer = 6,912, over all five MoE ranges
    assert got["moe_roofline.prefill-afmoe"] == pytest.approx(100 * 6912 / 1e12 / 15e-6)
    # K6: 4 x 2 x 4 = 32 a pair; a row of 3: 1 + 2 + 2 windowed and 6 causal pairs
    assert got["flash_roofline.prefill-afmoe"] == pytest.approx(100 * 32 * 11 * 2 / 1e12 / 6e-6)
    # everything a token: attention 3 x 8 x 8 + 2 x 8 x 4 = 256, x 2 x 2 layers; the router
    # 2 x 8 x 4 x 2; the experts 6,912 / 6; pairs as above; the unembedding 2 x 10 x 8 a row
    mfu = 6 * (1024 + 128) + 6912 + 704 + 2 * 160
    window = devtrace.parse(window_with(True), [{}]).window_s
    assert got["mfu.prefill-afmoe"] == pytest.approx(100 * mfu / 1e12 / window)


@pytest.mark.parametrize("metric", METRICS)
def test_metrics_read_none_without_something_to_read(metric):
    read = harness.reader(metric).read
    assert read(run_of(None)) is None                                          # untraced
    assert read_as_harness(metric, window_with(True), peaks=None) is None      # no peaks
    if metric != "mfu.prefill-afmoe":                                          # a range metric
        assert read_as_harness(metric, window_with(False)) is None             # no ranges
        assert read(run_of(devtrace.parse(window_with(True), [{}]))) is None   # no events


def test_the_metrics_are_declared_for_the_cell_alone():
    bench = harness.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        m = declared[name]
        assert (m["unit"], m["better"], m["source"], m["moves"], m["workloads"]) == (
            "%", "higher", "device_trace", "prefill_tokens_per_s", [CELL])
    assert CELL in next(m for m in bench["end_to_end"]
                        if m["name"] == "prefill_tokens_per_s")["workloads"]
