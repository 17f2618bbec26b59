"""The benchmark's yardstick: published peaks, and the operations and bytes
of the work each cell asks for, computed from shapes alone.

Nothing here reads the program: a later change to the program cannot move
these numbers.  A roofline share is the least time the card could take for
the work (the larger of operations over the peak rate and bytes over the
memory bandwidth) over the device time measured for it.
"""
from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "tf32_flops": 495e12,
                              "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks(kind: str) -> dict | None:
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name()``), or None for a card not in the table."""
    return PEAKS.get(kind)


# -----------------------------------------------------------------------------
# dense decoder LMs (config keys as in perfbench/configs/*.json)
# -----------------------------------------------------------------------------
def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def layer_linear_params(cfg: dict) -> int:
    """Weights of one layer's matrix products: q, k, v, o and the SwiGLU's
    gate, up and down projections (norm scales are element-wise)."""
    d, hd = cfg["hidden_size"], head_dim(cfg)
    h, kv, ff = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["intermediate_size"]
    return 2 * d * h * hd + 2 * d * kv * hd + 3 * d * ff


def attention_flops_per_pair(cfg: dict) -> int:
    """Operations of one (query, key) pair over all layers and heads: q.k and
    p.v, two operations a multiply-add, head_dim wide each."""
    return 4 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] * head_dim(cfg)


def unembed_flops(cfg: dict) -> int:
    return 2 * cfg["vocab_size"] * cfg["hidden_size"]


def prefill_flops(cfg: dict, batch: int, seq: int) -> int:
    """One ``prefill`` of ``batch`` x ``seq`` tokens: every layer's products
    over every token, causal attention over the seq (seq + 1) / 2 visible
    pairs of each row, and the unembedding of the last position only."""
    linear = 2 * cfg["num_hidden_layers"] * layer_linear_params(cfg) * batch * seq
    pairs = batch * seq * (seq + 1) // 2
    return linear + attention_flops_per_pair(cfg) * pairs + unembed_flops(cfg) * batch


def flash_flops(cfg: dict, batch: int, seq: int) -> int:
    """K6's work in one layer of a causal prefill: q.k and p.v over the
    visible pairs of every head."""
    return 4 * cfg["num_attention_heads"] * head_dim(cfg) * batch * seq * (seq + 1) // 2
