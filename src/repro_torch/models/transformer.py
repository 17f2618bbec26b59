"""Transformer stack assembly: parameter init, forward / prefill, the
encoder, and the serving path (cache structure + one decode step).

The reference (``repro/models/transformer.py``) scans ``repeats`` stacked
superblocks and unrolls a tail.  Here the layers are a Python list in layer
order and run as a Python loop — no scan: PyTorch runs eagerly.  Layer i is
of kind ``cfg.pattern[i % len(cfg.pattern)]``, as in the reference's
repeats-then-tail order; a superblock is one pattern group of layers in the
repeats, layers ``r * P .. r * P + P - 1``.

Block kinds: ``attn``/``global``/``local`` (a windowed causal attention),
``cross`` (attends to a memory: VLM image layers), ``dec`` (a whisper
decoder layer: causal self-attention, then cross-attention to the encoded
memory), ``rglru`` (Griffin's recurrent block) and ``rwkv`` (RWKV6
time-mix); MLPs ``swiglu``, ``gelu``, ``moe`` (``moe.moe_apply``, whose
auxiliary loss the forward sums) and ``rwkv_cmix``; RMSNorm or LayerNorm;
RoPE, or sinusoidal positions added to the embedding when ``use_rope`` is
false.  Configs with ``encoder_layers`` carry a whisper-style encoder
(``encode``) that the forward runs over the memory it is given.

Kernel routing (ROADMAP Queue 3, the port's wiring differences): when
``cfg.attn_impl`` is "auto" or "pallas", ``forward`` / ``prefill`` send
every attention — causal self-attention, the encoder's non-causal
self-attention and cross-attention — through the flash kernel K6
(``kernels.ops.flash_attention``), and ``_decode_block`` sends the decode
self-attention of ``attn``/``global``/``dec`` layers and the decode
cross-attention of ``cross``/``dec`` layers through K7
(``kernels.ops.decode_attention``; cross with every length M); "xla" and
"chunked" keep the masked-einsum paths, the oracles.  The reference's
"auto" picks xla or chunked by length and its decode always takes the
einsum path; the function computed is the same.  ``local`` decode keeps
the einsum path over its ring buffer, as the reference's does.  The
``rglru`` forward runs K5 (``kernels.ops.linear_scan``) whatever
``attn_impl`` says; ``rwkv`` runs no kernel, in either package.

Training (``train_forward``, the forward ``Model.loss_fn`` differentiates)
takes the reference's route: attention picked as its ``_pick_impl(cfg,
seq_len)`` picks it ("xla" at 2,048 tokens or fewer, "chunked" above, or
``cfg.attn_impl`` when that is "xla" or "chunked"), because K6 has no
backward in either package; ``attn_impl="pallas"`` raises.  K5 runs forward
and backward (its autograd Function).  With ``cfg.remat`` each superblock
runs under ``torch.utils.checkpoint`` (non-reentrant); the tail layers are
not wrapped.  ``remat_policy`` "nothing" saves the superblock's inputs
alone, as the reference's ``nothing_saveable``; "dots" also saves the
outputs of its matmuls without batch dimensions (``aten.mm``: the
projections and MLPs, not attention's or the experts' batched products),
as the reference's ``dots_with_no_batch_dims_saveable``.

Spans (``core.trace.scope``; profiler ranges ``repro:<name>`` while one
records): ``prefill`` around a prefill, ``embed``, ``block`` around each
layer (``args``: its index and kind; the names carry no index),
``unembed`` around the final norm and the unembedding; the layers' own
``norm``, ``attention``, ``mlp`` ... nest inside.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import attention, layers, moe, recurrent
from .sharding_ctx import constrain_hidden
from ..configs.base import ArchConfig
from ..core import trace

KINDS = ("attn", "global", "local", "cross", "dec", "rglru", "rwkv")
MLPS = ("swiglu", "gelu", "moe", "rwkv_cmix")


def check_supported(cfg: ArchConfig) -> None:
    """Raise on a block kind or MLP no config of the reference has."""
    bad = sorted(set(cfg.pattern) - set(KINDS))
    if bad:
        raise ValueError(f"{cfg.name}: unknown block kinds {bad} (known: {KINDS})")
    if cfg.mlp not in MLPS:
        raise ValueError(f"{cfg.name}: unknown mlp {cfg.mlp!r} (known: {MLPS})")


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


def _attn_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return attention.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim_,
                               cfg.qkv_bias)


def _block_init(gen: torch.Generator, kind: str, cfg: ArchConfig) -> dict:
    p: dict[str, Any] = {"ln1": _norm_init(cfg, gen.device), "ln2": _norm_init(cfg, gen.device)}
    if kind == "cross":
        p["cross"] = _attn_init(gen, cfg)
    elif kind == "dec":
        p["attn"] = _attn_init(gen, cfg)
        p["lnx"] = _norm_init(cfg, gen.device)
        p["cross"] = _attn_init(gen, cfg)
    elif kind == "rglru":
        p["rglru"] = recurrent.rglru_block_init(gen, cfg.d_model, cfg.rnn_width_)
    elif kind == "rwkv":
        p["rwkv"] = recurrent.rwkv6_block_init(gen, cfg.d_model, cfg.rwkv_head_dim)
    else:
        p["attn"] = _attn_init(gen, cfg)
    if cfg.mlp == "moe":
        p["mlp"] = moe.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts)
    elif cfg.mlp == "gelu":
        p["mlp"] = layers.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff)
    elif cfg.mlp == "rwkv_cmix":
        p["mlp"] = recurrent.rwkv_cmix_init(gen, cfg.d_model, cfg.d_ff)
    else:
        p["mlp"] = layers.swiglu_init(gen, cfg.d_model, cfg.d_ff)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """{"embed", "final_norm", "unembed"?, "layers": [per-layer dicts],
    "encoder"?: {"enc_layers": [attn blocks], "final_norm"}} on ``gen``'s
    device."""
    check_supported(cfg)
    params: dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.vocab, cfg.d_model),
        "final_norm": _norm_init(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = layers.embed_init(gen, cfg.vocab, cfg.d_model)
    params["layers"] = [_block_init(gen, kind, cfg) for kind in layer_kinds(cfg)]
    if cfg.encoder_layers:
        params["encoder"] = {
            "enc_layers": [_block_init(gen, "attn", cfg) for _ in range(cfg.encoder_layers)],
            "final_norm": _norm_init(cfg, gen.device),
        }
    return params


# =============================================================================
# forward blocks
# =============================================================================
def _pick_impl(cfg: ArchConfig) -> str:
    """"pallas" (the kernels) for "auto" / "pallas", else the einsum path
    named; decode's einsum path is the same for "xla" and "chunked"."""
    return "pallas" if cfg.attn_impl in ("auto", "pallas") else cfg.attn_impl


def _mlp_apply(cfg: ArchConfig, p, h, x_prev=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(the MLP's output, the MoE aux loss or None)."""
    if cfg.mlp == "moe":
        m, aux = moe.moe_apply(p, h, n_experts=cfg.n_experts, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor, n_groups=cfg.moe_groups)
        return m, aux["load_balance_loss"] * 0.01 + aux["router_z_loss"] * 1e-3
    if cfg.mlp == "gelu":
        return layers.gelu_mlp(p, h), None
    if cfg.mlp == "rwkv_cmix":
        return recurrent.rwkv_cmix(p, h, x_prev=x_prev), None
    return layers.swiglu(p, h), None


def _cross(cfg: ArchConfig, p, h, memory, impl):
    return attention.cross_attention(p, h, memory, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                     head_dim=cfg.head_dim_, impl=impl)


def _block_apply(kind: str, p: dict, x: torch.Tensor, cfg: ArchConfig, memory, impl: str,
                 causal: bool = True, index: int = 0) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(x, the MoE aux loss or None) of layer ``index``."""
    with trace.scope("block", "model") as sp:
        if sp is not None:
            sp.args = {"index": index, "kind": kind}
        h = _norm_apply(cfg, p["ln1"], x)
        if kind == "rglru":
            y = recurrent.rglru_block(p["rglru"], h)
        elif kind == "rwkv":
            y = (recurrent.rwkv6_chunked if cfg.rwkv_chunked else recurrent.rwkv6_block)(
                p["rwkv"], h, head_dim=cfg.rwkv_head_dim)
        elif kind == "cross":
            y = _cross(cfg, p["cross"], h, memory, impl)
        else:
            y = attention.self_attention(p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                         head_dim=cfg.head_dim_, causal=causal or kind == "dec",
                                         window=cfg.window if kind == "local" else None,
                                         impl=impl, use_rope=cfg.use_rope)
            if kind == "dec":
                x = x + y
                y = _cross(cfg, p["cross"], _norm_apply(cfg, p["lnx"], x), memory, impl)
        x = x + y
        m, aux = _mlp_apply(cfg, p["mlp"], _norm_apply(cfg, p["ln2"], x))
        return x + m, aux


@functools.lru_cache(maxsize=8)
def _sinusoid_np(s: int, d: int):
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def _sinusoid(s: int, d: int, device) -> torch.Tensor:
    return torch.from_numpy(_sinusoid_np(s, d)).to(device)


def _sinusoid_at(length: torch.Tensor, d: int) -> torch.Tensor:
    """(B,) positions → their (B, d) sinusoidal rows, computed in float32
    as the reference's decode computes them (not read off the float64
    table)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=length.device)
    ang = length[:, None].float() / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed(params: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = layers.embed(params["embed"], tokens) * math.sqrt(cfg.d_model)
    return x.to(torch.bfloat16)


def _embed_seq(params: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """tokens (B,S) → (B,S,d) bf16, with the sinusoidal table of positions
    0..S-1 added when the config has no RoPE."""
    x = _embed(params, tokens, cfg)
    if not cfg.use_rope:
        x = x + _sinusoid(tokens.shape[1], cfg.d_model, x.device).to(x.dtype)
    return x


def encode(enc_params: dict, frames: torch.Tensor, cfg: ArchConfig,
           impl: str | None = None) -> torch.Tensor:
    """Whisper-style encoder over stubbed frame embeddings (B,F,d): the
    sinusoidal table added in bf16, then non-causal attn blocks and the
    encoder's final norm.  ``impl`` defaults to the forward's pick."""
    impl = _pick_impl(cfg) if impl is None else impl
    x = frames.to(torch.bfloat16) + _sinusoid(frames.shape[1], cfg.d_model,
                                              frames.device).to(torch.bfloat16)
    for i, p in enumerate(enc_params["enc_layers"]):
        x, _ = _block_apply("attn", p, x, cfg, None, impl, causal=False, index=i)
    return _norm_apply(cfg, enc_params["final_norm"], x)


def _encoded(params: dict, memory, cfg: ArchConfig, impl: str):
    """The memory the blocks attend to: encoded when the config has an
    encoder, as given otherwise."""
    if cfg.encoder_layers and memory is not None:
        return encode(params["encoder"], memory, cfg, impl)
    return memory


def _add_aux(total: torch.Tensor, aux) -> torch.Tensor:
    return total if aux is None else total + aux


def logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The final norm and the unembedding of hidden states (..., d) → f32."""
    with trace.scope("unembed", "model"):
        x = _norm_apply(cfg, params["final_norm"], x)
        return layers.unembed(params.get("unembed", params["embed"]), x)


def _blocks(params: dict, x: torch.Tensor, cfg: ArchConfig, memory, impl: str,
            wrap=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Every layer over x → (x, the MoE aux loss), summed as the reference
    sums it: within each superblock, then the superblocks and the tail
    layers.  ``wrap(fn, *args)`` runs each superblock (remat); the tail is
    not wrapped.  Under ``sharding_ctx.activation_sharding`` the hidden state
    is pinned on entry and after every superblock layer, where the
    reference pins it (not in the tail)."""
    period = len(cfg.pattern)
    repeats, _ = cfg.repeats_and_tail()

    def superblock(first, x, memory, *block_params):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, (kind, p) in enumerate(zip(cfg.pattern, block_params)):
            x, a = _block_apply(kind, p, x, cfg, memory, impl, index=first + j)
            x = constrain_hidden(x)
            aux = _add_aux(aux, a)
        return x, aux

    x = constrain_hidden(x)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(repeats):
        group = params["layers"][r * period:(r + 1) * period]
        x, aux = (wrap or (lambda fn, *a: fn(*a)))(superblock, r * period, x, memory, *group)
        total = total + aux
    for i, p in enumerate(params["layers"][repeats * period:]):
        x, aux = _block_apply(cfg.pattern[i], p, x, cfg, memory, impl,
                              index=repeats * period + i)
        total = _add_aux(total, aux)
    return x, total


def _stack(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
           memory=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(the last block's output (B,S,d), the MoE aux loss)."""
    impl = _pick_impl(cfg)
    with trace.scope("embed", "model"):
        x = _embed_seq(params, tokens, cfg)
    return _blocks(params, x, cfg, _encoded(params, memory, cfg, impl), impl)


def hidden(params: dict, tokens: torch.Tensor, cfg: ArchConfig, memory=None) -> torch.Tensor:
    """tokens (B,S) → the last block's output (B,S,d), before the final
    norm."""
    return _stack(params, tokens, cfg, memory)[0]


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            memory: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) → (logits (B,S,V) f32, moe_aux scalar).  ``memory``
    (B,M,d): frame embeddings, encoded here, for a config with an encoder;
    else the memory cross layers attend to as it is."""
    x, aux = _stack(params, tokens, cfg, memory)
    return logits(params, x, cfg), aux


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            memory: torch.Tensor | None = None) -> torch.Tensor:
    """Prefill = the forward pass's last-position logits (B,V).  Only that
    position is unembedded: the same row as ``forward``'s, without the
    (B,S,V) float32 logits (8.4 GB for recurrentgemma-9b at B 2, S 4096)."""
    with trace.scope("prefill", "model"):
        return logits(params, hidden(params, tokens, cfg, memory)[:, -1], cfg)


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


# the reference's dots_with_no_batch_dims_saveable: matmuls without batch
# dimensions; every x @ W of a (B, S, d) activation reaches aten.mm
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def train_forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
                  memory: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) → (logits (B,S,V) f32, moe_aux scalar), recorded for
    autograd: superblocks under ``checkpoint`` when ``cfg.remat``, the tail
    and the encoder unwrapped, as in the reference."""
    impl = _train_impl(cfg, tokens.shape[1])
    kw = dict(use_reentrant=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = _dots_context
    with trace.scope("embed", "model"):
        x = _embed_seq(params, tokens, cfg)
    if cfg.encoder_layers and memory is not None:
        memory = encode(params["encoder"], memory, cfg, _train_impl(cfg, memory.shape[1]))
    wrap = (lambda fn, *args: checkpoint(fn, *args, **kw)) if cfg.remat else None
    x, total = _blocks(params, x, cfg, memory, impl, wrap)
    return logits(params, x, cfg), total


# =============================================================================
# serving: cache structure + decode
# =============================================================================
def _layer_cache_init(kind: str, cfg: ArchConfig, batch: int, s_max: int, device) -> dict:
    if kind == "rglru":
        return recurrent.rglru_decode_init(batch, cfg.rnn_width_, device)
    if kind == "rwkv":
        c = recurrent.rwkv6_decode_init(batch, cfg.d_model, device, cfg.rwkv_head_dim)
        c["cmix_prev"] = torch.zeros((batch, cfg.d_model), dtype=torch.bfloat16, device=device)
        return c
    if kind == "cross":
        return {}
    slots = min(s_max, cfg.window or s_max) if kind == "local" else s_max
    return attention.cache_init(batch, slots, cfg.n_kv, cfg.head_dim_, device)


def cache_init(cfg: ArchConfig, batch: int, s_max: int, device) -> dict:
    """{"layers": [per-layer state], "length": (B,) int32}.  A layer's state
    is {"k", "v"} (B, slots, KVH, Dh) bf16, with s_max slots for
    attn/global/dec and a ring of min(s_max, window) for local; {"h" (B, dr)
    f32, "conv_buf" (B, 3, dr) bf16} for rglru; {"S" (B, H, Dh, Dh) f32,
    "x_prev" and "cmix_prev" (B, d) bf16} for rwkv; {} for cross."""
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
    slot = torch.remainder(length, w)
    attention.put_slot(cache["k"], k[:, 0], slot)
    attention.put_slot(cache["v"], v[:, 0], slot)
    out = attention.multihead_attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                                        causal=False, impl="xla",
                                        kv_len=torch.clamp(length + 1, max=w))
    return out.reshape(b, 1, cfg.n_heads * cfg.head_dim_) @ p["wo"], cache


def _decode_block(kind: str, p: dict, x, cache: dict, length, cfg: ArchConfig, memory,
                  index: int = 0):
    with trace.scope("block", "model") as sp:
        if sp is not None:
            sp.args = {"index": index, "kind": kind}
        impl = _pick_impl(cfg)
        dims = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim_)
        h = _norm_apply(cfg, p["ln1"], x)
        if kind == "rglru":
            y, cache = recurrent.rglru_decode(p["rglru"], h, cache)
        elif kind == "rwkv":
            y, cache = recurrent.rwkv6_decode(p["rwkv"], h, cache, head_dim=cfg.rwkv_head_dim)
        elif kind == "local":
            y, cache = _decode_local(p["attn"], h, cache, length, cfg)
        elif kind == "cross":
            y = attention.decode_cross_attention(p["cross"], h, memory, impl=impl, **dims)
        else:
            y, cache = attention.decode_self_attention(p["attn"], h, cache, length, impl=impl,
                                                       use_rope=cfg.use_rope, **dims)
            if kind == "dec":
                x = x + y
                y = attention.decode_cross_attention(p["cross"], _norm_apply(cfg, p["lnx"], x),
                                                     memory, impl=impl, **dims)
        x = x + y
        h2 = _norm_apply(cfg, p["ln2"], x)
        x_prev = None
        if cfg.mlp == "rwkv_cmix" and kind == "rwkv":
            x_prev = cache["cmix_prev"][:, None].to(h2.dtype)
        m, _ = _mlp_apply(cfg, p["mlp"], h2, x_prev)
        if kind == "rwkv":
            cache["cmix_prev"].copy_(h2[:, 0])
        return x + m, cache


def decode_step(params: dict, token: torch.Tensor, cache: dict, cfg: ArchConfig,
                memory: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """token (B,) one decode step → (logits (B,V) f32, cache).  The layers'
    states are written in place; the returned dict carries them and the new
    lengths.  ``memory`` (B,M,d) must be already encoded, as the
    reference's: decode never runs the encoder.  Without RoPE, each slot's
    sinusoidal position is that of its length (``_sinusoid_at``).  The hidden
    state is pinned (``constrain_hidden``) where the reference's scanned
    decode pins it: after the embedding and after each layer of the
    repeats."""
    length = cache["length"]
    with trace.scope("embed", "model"):
        x = _embed(params, token[:, None], cfg)
        if not cfg.use_rope:
            x = x + _sinusoid_at(length, cfg.d_model)[:, None].to(x.dtype)
    x = constrain_hidden(x)
    scanned = cfg.repeats_and_tail()[0] * len(cfg.pattern)
    new_layers = []
    for i, (kind, p, c) in enumerate(zip(layer_kinds(cfg), params["layers"], cache["layers"])):
        x, c = _decode_block(kind, p, x, c, length, cfg, memory, index=i)
        if i < scanned:
            x = constrain_hidden(x)
        new_layers.append(c)
    return logits(params, x, cfg)[:, 0], {"layers": new_layers, "length": length + 1}
