"""The yardstick of an AFMoE decoder LM (``configs/trinity-mini.json``'s
keys): its parameters, and the operations of a prefill and of each part
the per-layer metrics read, from shapes alone.  Two operations a
multiply-add; nothing here reads the program."""
from __future__ import annotations


def _moe_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] - cfg["num_dense_layers"]


def _sliding_layers(cfg: dict) -> int:
    return sum(t == "sliding_attention" for t in cfg["layer_types"][:cfg["num_hidden_layers"]])


def attention_params(cfg: dict) -> int:
    """One layer's q, gate and o (d x H·hd each) and k, v (d x KV·hd)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    return 3 * d * cfg["num_attention_heads"] * hd + 2 * d * cfg["num_key_value_heads"] * hd


def expert_params(cfg: dict) -> int:
    """One expert's gate, up and down: 3·d·moe_intermediate_size."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def params(cfg: dict) -> tuple[int, int]:
    """(total, active a token): attention, the dense layers' SwiGLU, the
    routed experts (num_experts_per_tok of them active), the shared experts,
    the router and its bias, every norm scale, both embeddings."""
    d, e, hd = cfg["hidden_size"], cfg["num_experts"], cfg["head_dim"]
    dense = cfg["num_dense_layers"] * 3 * d * cfg["intermediate_size"]
    per_moe = cfg["num_shared_experts"] * expert_params(cfg) + d * e + e
    norms = cfg["num_hidden_layers"] * (4 * d + 2 * hd) + d
    common = (cfg["num_hidden_layers"] * attention_params(cfg) + dense + norms
              + 2 * cfg["vocab_size"] * d + _moe_layers(cfg) * per_moe)
    total = common + _moe_layers(cfg) * e * expert_params(cfg)
    active = common + _moe_layers(cfg) * cfg["num_experts_per_tok"] * expert_params(cfg)
    return total, active


def visible_pairs(seq: int, window: int | None) -> int:
    """(query, key) pairs of one head of a causal sequence, keys within
    ``window`` of the query where given."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def flash_flops(cfg: dict, batch: int, seq: int) -> int:
    """K6's work in every layer of a prefill: q·k and p·v, head_dim wide,
    over the visible pairs of each head (windowed on the sliding layers)."""
    per_pair = 4 * cfg["num_attention_heads"] * cfg["head_dim"]
    pairs = (_sliding_layers(cfg) * visible_pairs(seq, cfg["sliding_window"])
             + (cfg["num_hidden_layers"] - _sliding_layers(cfg)) * visible_pairs(seq, None))
    return per_pair * pairs * batch


def experts_flops(cfg: dict, batch: int, seq: int) -> int:
    """The routed experts' products in every MoE layer:
    6·d·moe_intermediate_size for each of a token's num_experts_per_tok."""
    return (2 * expert_params(cfg) * cfg["num_experts_per_tok"] * _moe_layers(cfg)
            * batch * seq)


def moe_flops(cfg: dict, batch: int, seq: int) -> int:
    """The routed and the shared experts' products in every MoE layer (the
    router's left out)."""
    shared = 2 * expert_params(cfg) * cfg["num_shared_experts"] * _moe_layers(cfg)
    return experts_flops(cfg, batch, seq) + shared * batch * seq


def prefill_flops(cfg: dict, batch: int, seq: int) -> int:
    """One prefill of ``batch`` x ``seq`` tokens: every layer's products
    (attention's five, the gate among them; the dense SwiGLU or the router
    and the routed and shared experts) over every token, attention over the
    visible pairs, and the unembedding of the last position only."""
    d = cfg["hidden_size"]
    dense = 6 * d * cfg["intermediate_size"] * cfg["num_dense_layers"]
    router = 2 * d * cfg["num_experts"] * _moe_layers(cfg)
    linear = 2 * cfg["num_hidden_layers"] * attention_params(cfg) + dense + router
    return (linear * batch * seq + moe_flops(cfg, batch, seq) + flash_flops(cfg, batch, seq)
            + 2 * cfg["vocab_size"] * d * batch)
