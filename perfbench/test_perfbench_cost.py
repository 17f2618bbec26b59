"""The benchmark's FLOP and byte counts against numbers worked by hand."""
import json
from pathlib import Path

from perfbench import cost

HERE = Path(__file__).resolve().parent
YI = json.loads((HERE / "configs" / "yi-6b.json").read_text())


def test_yi_layer_weights():
    # q, o: 4096 x 4096 each; k, v: 4096 x 512 each; gate, up, down: 4096 x 11008
    assert cost.layer_linear_params(YI) == 2 * 16_777_216 + 2 * 2_097_152 + 3 * 45_088_768
    assert cost.layer_linear_params(YI) == 173_015_040


def test_yi_prefill_flops_a_token():
    # 2 x 32 x 173,015,040 = 11,072,962,560 a token in the layers; causal
    # attention 4 x 32 layers x 32 heads x 128 = 524,288 a visible pair,
    # (S + 1) / 2 pairs a token; the unembedding 2 x 64,000 x 4,096 once a row
    per_token_1k = 11_072_962_560 + 524_288 * 1025 // 2 + 524_288_000 // 1024
    assert cost.prefill_flops(YI, 1, 1024) == 1024 * 11_072_962_560 + 524_288 * 524_800 + 524_288_000
    assert cost.prefill_flops(YI, 1, 1024) / 1024 == per_token_1k == 11_342_172_160
    assert cost.prefill_flops(YI, 4, 4096) / (4 * 4096) == 11_072_962_560 + 524_288 * 2048.5 + 128_000
    assert cost.prefill_flops(YI, 4, 4096) / (4 * 4096) == 12_147_094_528


def test_flash_attention():
    # one layer, 4 x 1024 causal: 32 heads x 128 x 4 multiply-adds... 67,174,400 pairs
    assert 4 * 1024 * 1025 // 2 * 32 == 67_174_400
    assert cost.flash_flops(YI, 4, 1024) == 4 * 128 * 67_174_400


def test_peaks():
    assert cost.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert cost.peaks("cpu") is None
