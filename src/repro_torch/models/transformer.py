"""Transformer stack assembly: parameter init, forward / prefill, and the
serving path (cache structure + one decode step).

The reference (``repro/models/transformer.py``) scans ``repeats`` stacked
superblocks and unrolls a tail.  Here the layers are a Python list in layer
order and run as a Python loop — no scan, no remat: PyTorch runs eagerly.

Supported in this slice: block kinds ``attn``/``global`` with the
``swiglu``/``gelu`` MLPs, RMSNorm or LayerNorm, RoPE.  The other kinds, MoE,
encoders and sinusoidal positions raise ``NotImplementedError`` naming their
ROADMAP item.

Decode routing: ``_decode_block`` sends attention through the decode kernel
K7 (``kernels.ops.decode_attention``) when ``cfg.attn_impl`` is "auto" or
"pallas", and through the masked-einsum path for "xla"/"chunked".  The
reference's ``_decode_block`` always takes the einsum path; the function
computed is the same (ROADMAP, known divergences).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from . import attention, layers
from ..configs.base import ArchConfig


def check_supported(cfg: ArchConfig) -> None:
    """Raise on what this slice of the port does not run."""
    bad = sorted(set(cfg.pattern) - {"attn", "global"})
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported yet (ROADMAP M10: "
            "rglru/rwkv with the linear-scan kernel K5, then local/cross/dec blocks)")
    if cfg.mlp not in ("swiglu", "gelu"):
        raise NotImplementedError(
            f"{cfg.name}: mlp={cfg.mlp!r} is not ported yet (ROADMAP M10: MoE and "
            "rwkv channel-mix)")
    if cfg.encoder_layers or cfg.cross_memory_len or not cfg.use_rope:
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention memory and sinusoidal positions "
            "are not ported yet (ROADMAP M10: cross/dec blocks)")


# =============================================================================
# parameter init
# =============================================================================
def _norm_init(cfg: ArchConfig, device):
    return layers.rmsnorm_init(cfg.d_model, device) if cfg.norm == "rmsnorm" \
        else layers.layernorm_init(cfg.d_model, device)


def _norm_apply(cfg: ArchConfig, p, x):
    return layers.rmsnorm(p, x) if cfg.norm == "rmsnorm" else layers.layernorm(p, x)


def _block_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    p: dict[str, Any] = {"ln1": _norm_init(cfg, gen.device), "ln2": _norm_init(cfg, gen.device)}
    p["attn"] = attention.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                    cfg.head_dim_, cfg.qkv_bias)
    if cfg.mlp == "gelu":
        p["mlp"] = layers.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff)
    else:
        p["mlp"] = layers.swiglu_init(gen, cfg.d_model, cfg.d_ff)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """{"embed", "final_norm", "unembed"?, "layers": [per-layer dicts]} on
    ``gen``'s device."""
    check_supported(cfg)
    params: dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.vocab, cfg.d_model),
        "final_norm": _norm_init(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = layers.embed_init(gen, cfg.vocab, cfg.d_model)
    params["layers"] = [_block_init(gen, cfg) for _ in range(cfg.n_layers)]
    return params


# =============================================================================
# forward blocks
# =============================================================================
def _pick_impl(cfg: ArchConfig, seq_len: int) -> str:
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    return "chunked" if seq_len > 2048 else "xla"


def _mlp_apply(cfg: ArchConfig, p, h):
    return layers.gelu_mlp(p, h) if cfg.mlp == "gelu" else layers.swiglu(p, h)


def _block_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, impl: str) -> torch.Tensor:
    h = _norm_apply(cfg, p["ln1"], x)
    x = x + attention.self_attention(p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                     head_dim=cfg.head_dim_, causal=True, impl=impl,
                                     use_rope=cfg.use_rope)
    return x + _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x))


def _embed(params: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = layers.embed(params["embed"], tokens) * math.sqrt(cfg.d_model)
    return x.to(torch.bfloat16)


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = _norm_apply(cfg, params["final_norm"], x)
    return layers.unembed(params.get("unembed", params["embed"]), x)


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            memory: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) → (logits (B,S,V) f32, moe_aux scalar (0: no MoE here))."""
    impl = _pick_impl(cfg, tokens.shape[1])
    x = _embed(params, tokens, cfg)
    for p in params["layers"]:
        x = _block_apply(p, x, cfg, impl)
    return _logits(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            memory: torch.Tensor | None = None) -> torch.Tensor:
    """Prefill = forward pass producing last-position logits."""
    logits, _ = forward(params, tokens, cfg, memory)
    return logits[:, -1]


# =============================================================================
# serving: cache structure + decode
# =============================================================================
def cache_init(cfg: ArchConfig, batch: int, s_max: int, device) -> dict:
    """{"layers": [{"k", "v"} (B, s_max, KVH, Dh) bf16 per layer],
    "length": (B,) int32}."""
    check_supported(cfg)
    return {"layers": [attention.cache_init(batch, s_max, cfg.n_kv, cfg.head_dim_, device)
                       for _ in range(cfg.n_layers)],
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _decode_impl(cfg: ArchConfig) -> str:
    return "pallas" if cfg.attn_impl in ("auto", "pallas") else "xla"


def _decode_block(p: dict, x, cache: dict, length, cfg: ArchConfig):
    h = _norm_apply(cfg, p["ln1"], x)
    y, cache = attention.decode_self_attention(
        p["attn"], h, cache, length, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim_, impl=_decode_impl(cfg), use_rope=cfg.use_rope)
    x = x + y
    return x + _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x)), cache


def decode_step(params: dict, token: torch.Tensor, cache: dict, cfg: ArchConfig,
                memory: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """token (B,) one decode step → (logits (B,V) f32, cache).  The layers'
    caches are written in place; the returned dict carries them and the new
    lengths."""
    length = cache["length"]
    x = _embed(params, token[:, None], cfg)
    new_layers = []
    for p, c in zip(params["layers"], cache["layers"]):
        x, c = _decode_block(p, x, c, length, cfg)
        new_layers.append(c)
    logits = _logits(params, x, cfg)[:, 0]
    return logits, {"layers": new_layers, "length": length + 1}
