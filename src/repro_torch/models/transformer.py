"""Transformer stack assembly: parameter init, forward / prefill, and the
serving path (cache structure + one decode step).

The reference (``repro/models/transformer.py``) scans ``repeats`` stacked
superblocks and unrolls a tail.  Here the layers are a Python list in layer
order and run as a Python loop — no scan: PyTorch runs eagerly.  Layer i is
of kind ``cfg.pattern[i % len(cfg.pattern)]``, as in the reference's
repeats-then-tail order; a superblock is one pattern group of layers in the
repeats, layers ``r * P .. r * P + P - 1``.

Supported in this slice: block kinds ``attn``/``global``/``local`` (a
windowed causal attention) and ``rglru`` (Griffin's recurrent block) with
the ``swiglu``/``gelu`` MLPs, RMSNorm or LayerNorm, RoPE.  The other kinds,
MoE, encoders and sinusoidal positions raise ``NotImplementedError`` naming
their ROADMAP item.

Kernel routing (ROADMAP Queue 3, the port's wiring differences): when
``cfg.attn_impl`` is "auto" or "pallas", ``forward`` / ``prefill`` send
every attention through the flash kernel K6 (``kernels.ops.flash_attention``)
and ``_decode_block`` sends the ``attn``/``global`` layers' decode attention
through K7 (``kernels.ops.decode_attention``); "xla" and "chunked" keep the
masked-einsum paths, the oracles.  The reference's "auto" picks xla or
chunked by length and its decode always takes the einsum path; the function
computed is the same.  ``local`` decode keeps the einsum path over its ring
buffer, as the reference's does.  The ``rglru`` forward runs K5
(``kernels.ops.linear_scan``) whatever ``attn_impl`` says.

Training (``train_forward``, the forward ``Model.loss_fn`` differentiates)
takes the reference's route: attention picked as its ``_pick_impl(cfg,
seq_len)`` picks it ("xla" at 2,048 tokens or fewer, "chunked" above, or
``cfg.attn_impl`` when that is "xla" or "chunked"), because K6 has no
backward in either package; ``attn_impl="pallas"`` raises.  K5 runs forward
and backward (its autograd Function).  With ``cfg.remat`` each superblock
runs under ``torch.utils.checkpoint`` (non-reentrant), which saves its input
alone and recomputes it in the backward, as the reference's
``jax.checkpoint(..., policy=nothing_saveable)``; the tail layers are not
wrapped.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from . import attention, layers, recurrent
from ..configs.base import ArchConfig

KINDS = ("attn", "global", "local", "rglru")


def check_supported(cfg: ArchConfig) -> None:
    """Raise on what this slice of the port does not run."""
    bad = sorted(set(cfg.pattern) - set(KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {bad} are not ported yet (ROADMAP M10e: rwkv "
            "with its channel mix, cross/dec blocks)")
    if cfg.mlp not in ("swiglu", "gelu"):
        raise NotImplementedError(
            f"{cfg.name}: mlp={cfg.mlp!r} is not ported yet (ROADMAP M10e: MoE and "
            "rwkv channel-mix)")
    if cfg.encoder_layers or cfg.cross_memory_len or not cfg.use_rope:
        raise NotImplementedError(
            f"{cfg.name}: encoders, cross-attention memory and sinusoidal positions "
            "are not ported yet (ROADMAP M10e: cross/dec blocks)")


def layer_kinds(cfg: ArchConfig) -> list[str]:
    return [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]


# =============================================================================
# parameter init
# =============================================================================
def _norm_init(cfg: ArchConfig, device):
    return layers.rmsnorm_init(cfg.d_model, device) if cfg.norm == "rmsnorm" \
        else layers.layernorm_init(cfg.d_model, device)


def _norm_apply(cfg: ArchConfig, p, x):
    return layers.rmsnorm(p, x) if cfg.norm == "rmsnorm" else layers.layernorm(p, x)


def _block_init(gen: torch.Generator, kind: str, cfg: ArchConfig) -> dict:
    p: dict[str, Any] = {"ln1": _norm_init(cfg, gen.device), "ln2": _norm_init(cfg, gen.device)}
    if kind == "rglru":
        p["rglru"] = recurrent.rglru_block_init(gen, cfg.d_model, cfg.rnn_width_)
    else:
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
    params["layers"] = [_block_init(gen, kind, cfg) for kind in layer_kinds(cfg)]
    return params


# =============================================================================
# forward blocks
# =============================================================================
def _pick_impl(cfg: ArchConfig) -> str:
    """"pallas" (the kernels) for "auto" / "pallas", else the einsum path
    named; decode's einsum path is the same for "xla" and "chunked"."""
    return "pallas" if cfg.attn_impl in ("auto", "pallas") else cfg.attn_impl


def _mlp_apply(cfg: ArchConfig, p, h):
    return layers.gelu_mlp(p, h) if cfg.mlp == "gelu" else layers.swiglu(p, h)


def _block_apply(kind: str, p: dict, x: torch.Tensor, cfg: ArchConfig,
                 impl: str) -> torch.Tensor:
    h = _norm_apply(cfg, p["ln1"], x)
    if kind == "rglru":
        y = recurrent.rglru_block(p["rglru"], h)
    else:
        y = attention.self_attention(p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                     head_dim=cfg.head_dim_, causal=True,
                                     window=cfg.window if kind == "local" else None,
                                     impl=impl, use_rope=cfg.use_rope)
    x = x + y
    return x + _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x))


def _embed(params: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = layers.embed(params["embed"], tokens) * math.sqrt(cfg.d_model)
    return x.to(torch.bfloat16)


def logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The final norm and the unembedding of hidden states (..., d) → f32."""
    x = _norm_apply(cfg, params["final_norm"], x)
    return layers.unembed(params.get("unembed", params["embed"]), x)


def hidden(params: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """tokens (B,S) → the last block's output (B,S,d), before the final
    norm."""
    impl = _pick_impl(cfg)
    x = _embed(params, tokens, cfg)
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        x = _block_apply(kind, p, x, cfg, impl)
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            memory: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) → (logits (B,S,V) f32, moe_aux scalar (0: no MoE here))."""
    x = hidden(params, tokens, cfg)
    return logits(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            memory: torch.Tensor | None = None) -> torch.Tensor:
    """Prefill = the forward pass's last-position logits (B,V).  Only that
    position is unembedded: the same row as ``forward``'s, without the
    (B,S,V) float32 logits (8.4 GB for recurrentgemma-9b at B 2, S 4096)."""
    return logits(params, hidden(params, tokens, cfg)[:, -1], cfg)


# =============================================================================
# training forward
# =============================================================================
def _train_impl(cfg: ArchConfig, seq_len: int) -> str:
    """The reference's ``_pick_impl(cfg, seq_len)``: the einsum paths the
    loss differentiates."""
    if cfg.attn_impl == "pallas":
        raise RuntimeError(
            f"{cfg.name}: attn_impl='pallas' cannot train: flash_attention (K6) has no "
            "backward, in this port or in the JAX package; use 'auto', 'xla' or 'chunked'")
    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    return "chunked" if seq_len > 2048 else "xla"


def train_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                  memory: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) → (logits (B,S,V) f32, moe_aux scalar (0: no MoE here)),
    recorded for autograd: superblocks under ``checkpoint`` when
    ``cfg.remat``, the tail unwrapped."""
    impl = _train_impl(cfg, tokens.shape[1])
    if cfg.remat and cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"{cfg.name}: remat_policy={cfg.remat_policy!r} is not ported (the port's remat "
            "saves nothing inside a superblock, as the reference's 'nothing' policy)")
    period = len(cfg.pattern)
    repeats, _ = cfg.repeats_and_tail()

    def superblock(x, *block_params):
        for kind, p in zip(cfg.pattern, block_params):
            x = _block_apply(kind, p, x, cfg, impl)
        return x

    x = _embed(params, tokens, cfg)
    for r in range(repeats):
        group = params["layers"][r * period:(r + 1) * period]
        x = (checkpoint(superblock, x, *group, use_reentrant=False) if cfg.remat
             else superblock(x, *group))
    for i, p in enumerate(params["layers"][repeats * period:]):
        x = _block_apply(cfg.pattern[i], p, x, cfg, impl)
    return logits(params, x, cfg), torch.zeros((), dtype=torch.float32, device=x.device)


# =============================================================================
# serving: cache structure + decode
# =============================================================================
def _layer_cache_init(kind: str, cfg: ArchConfig, batch: int, s_max: int, device) -> dict:
    if kind == "rglru":
        return recurrent.rglru_decode_init(batch, cfg.rnn_width_, device)
    slots = min(s_max, cfg.window or s_max) if kind == "local" else s_max
    return attention.cache_init(batch, slots, cfg.n_kv, cfg.head_dim_, device)


def cache_init(cfg: ArchConfig, batch: int, s_max: int, device) -> dict:
    """{"layers": [per-layer state], "length": (B,) int32}.  A layer's state
    is {"k", "v"} (B, slots, KVH, Dh) bf16, with s_max slots for attn/global
    and a ring of min(s_max, window) for local; or {"h" (B, dr) f32,
    "conv_buf" (B, 3, dr) bf16} for rglru."""
    check_supported(cfg)
    return {"layers": [_layer_cache_init(kind, cfg, batch, s_max, device)
                       for kind in layer_kinds(cfg)],
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _decode_local(p: dict, h, cache: dict, length, cfg: ArchConfig):
    """Local-window decode over a ring buffer of w = min(s_max, window)
    slots (the reference's ``_decode_local``): the new K/V go to slot
    length % w, written in place, and attention runs on the einsum path over
    the min(length + 1, w) filled slots, whose order does not matter."""
    b = h.shape[0]
    w = cache["k"].shape[1]
    q, k, v = attention._project_qkv(p, h, cfg.n_heads, cfg.n_kv, cfg.head_dim_,
                                     length[:, None], cfg.use_rope)
    rows = torch.arange(b, device=h.device)
    slot = torch.remainder(length, w).long()
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    out = attention.multihead_attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                                        causal=False, impl="xla",
                                        kv_len=torch.clamp(length + 1, max=w))
    return out.reshape(b, 1, cfg.n_heads * cfg.head_dim_) @ p["wo"], cache


def _decode_block(kind: str, p: dict, x, cache: dict, length, cfg: ArchConfig):
    h = _norm_apply(cfg, p["ln1"], x)
    if kind == "rglru":
        y, cache = recurrent.rglru_decode(p["rglru"], h, cache)
    elif kind == "local":
        y, cache = _decode_local(p["attn"], h, cache, length, cfg)
    else:
        y, cache = attention.decode_self_attention(
            p["attn"], h, cache, length, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.head_dim_, impl=_pick_impl(cfg), use_rope=cfg.use_rope)
    x = x + y
    return x + _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x)), cache


def decode_step(params: dict, token: torch.Tensor, cache: dict, cfg: ArchConfig,
                memory: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """token (B,) one decode step → (logits (B,V) f32, cache).  The layers'
    states are written in place; the returned dict carries them and the new
    lengths."""
    length = cache["length"]
    x = _embed(params, token[:, None], cfg)
    new_layers = []
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], cache["layers"]):
        x, c = _decode_block(kind, p, x, c, length, cfg)
        new_layers.append(c)
    return logits(params, x, cfg)[:, 0], {"layers": new_layers, "length": length + 1}
