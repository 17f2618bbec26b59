"""Attention: GQA self-attention (RoPE, optional QKV bias, optional local
window), cross-attention, and KV-cache decode.

Execution paths, selected by ``impl`` as in the reference
(``repro/models/attention.py``):
  * "xla"     — einsum attention with explicit masks; fine for short S.
  * "chunked" — query-chunked attention: never materializes S×S.
  * "pallas"  — the fused kernels, each the CUDA kernel on a CUDA tensor
                and its plain version on the CPU: the forward's
                ``multihead_attention`` calls ``kernels.ops.flash_attention``
                (K6) on the un-repeated KV heads (``cross_attention``
                too, non-causal), and ``decode_self_attention`` and
                ``decode_cross_attention`` call
                ``kernels.ops.decode_attention`` (K7).

Shapes: x (B, S, d); params store the q/k/v projections (d, H·Dh).  KV
caches are (B, S_max, K, Dh) with a per-slot length (B,).

AFMoE's additions (``configs/trinity_mini.py``) follow the parameters a
layer holds, as the QKV bias does: ``q_norm`` / ``k_norm`` (each (Dh,)
float32) RMS-normalise every q and k head before RoPE; ``wg`` (d, H·Dh)
gates the heads, out · σ(x Wg), before the output projection.  RoPE is the
caller's choice (``use_rope``): AFMoE's full layers take none.

Spans (``core.trace.scope``): ``attention`` around each entry point,
``qkv`` around the projections (RoPE's ``rope`` and QK-norm's ``norm``
inside; the gate's product too), ``attn_gate`` around the gate's sigmoid
and multiply, ``wo`` around the output projection; the kernels' own
``kernel:<entry>`` come from ``kernels.ops``.
"""
from __future__ import annotations

import math

import torch

from . import layers
from ..core import trace
from .sharding_ctx import constrain_heads
from ..kernels import ops as kops

NEG = -1e30


def attn_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
              head_dim: int, qkv_bias: bool = False,
              dtype=layers.DEFAULT_PARAM_DTYPE) -> dict:
    p = {"wq": layers.dense_init(gen, d_model, n_heads * head_dim, dtype),
         "wk": layers.dense_init(gen, d_model, n_kv * head_dim, dtype),
         "wv": layers.dense_init(gen, d_model, n_kv * head_dim, dtype),
         "wo": layers.dense_init(gen, n_heads * head_dim, d_model, dtype)}
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype, device=gen.device)
    return p


def _project_qkv(params, x, n_heads, n_kv, head_dim, positions, use_rope=True,
                 norm_eps=1e-6):
    b, s, _ = x.shape
    with trace.scope("qkv", "model"):
        q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
        if "bq" in params:
            q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
        q = constrain_heads(q.reshape(b, s, n_heads, head_dim))
        k = constrain_heads(k.reshape(b, s, n_kv, head_dim))
        v = constrain_heads(v.reshape(b, s, n_kv, head_dim))
        if "q_norm" in params:
            q = layers.rmsnorm(params["q_norm"], q, norm_eps)
            k = layers.rmsnorm(params["k_norm"], k, norm_eps)
        if use_rope:
            q = layers.rope(q, positions)
            k = layers.rope(k, positions)
        return q, k, v


def _out_proj(out: torch.Tensor, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Attention's heads (B, S, H, Dh) of the layer input x (B, S, d),
    gated where the layer has a gate, through the output projection."""
    b, s, _ = x.shape
    out = out.reshape(b, s, -1)
    if "wg" in params:
        with trace.scope("qkv", "model"):
            g = x @ params["wg"]
        with trace.scope("attn_gate", "model"):
            out = out * torch.sigmoid(g)
    with trace.scope("wo", "model"):
        return out @ params["wo"]


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


# -----------------------------------------------------------------------------
# core attention
# -----------------------------------------------------------------------------
def _mask(sq: int, sk: int, causal: bool, window, device, rows=None):
    """(sq, sk) visibility, query ends aligned to key ends; ``rows`` (a range
    of query rows) takes those rows only."""
    rows = range(sq) if rows is None else rows
    qpos = torch.arange(rows.start, rows.stop, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((len(rows), sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _masked_softmax_attention(q, k, v, mask, kv_len):
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    m = mask[None, None]
    if kv_len is not None:
        kpos = torch.arange(k.shape[1], device=q.device)
        m = m & (kpos[None, None, None, :] < kv_len[:, None, None, None])
    logits = torch.where(m, logits, NEG)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _xla_attention(q, k, v, *, causal: bool, window: int | None, kv_len=None):
    """q (B,Sq,H,D); k/v (B,Sk,H,D) — full-mask einsum path (f32 softmax)."""
    mask = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    return _masked_softmax_attention(q, k, v, mask, kv_len)


def _chunked_attention(q, k, v, *, causal: bool, window: int | None,
                       chunk: int = 1024, kv_len=None):
    """Query-chunked attention: O(chunk·Sk) live memory, never S×S."""
    sq, sk = q.shape[1], k.shape[1]
    if sq <= chunk:
        return _xla_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    outs = []
    for c0 in range(0, sq, chunk):
        qi = q[:, c0:c0 + chunk]
        mask = _mask(sq, sk, causal, window, q.device, range(c0, c0 + qi.shape[1]))
        outs.append(_masked_softmax_attention(qi, k, v, mask, kv_len))
    return torch.cat(outs, dim=1)


def _pallas_attention(q, k, v, *, causal: bool, window: int | None):
    """K6 over q (B,Sq,H,D) and k/v (B,Sk,Hkv,D) as they are: the kernel
    reads the KV heads through their strides, so neither the reference's
    KV repeat (repro/models/attention.py:143) nor its (B·H, S, D)
    transposes (:131-133) become copies."""
    return kops.flash_attention(q, k, v, causal=causal, window=window)


def multihead_attention(q, k, v, *, causal=True, window=None, impl="xla", kv_len=None):
    """q (B,Sq,H,D), k/v (B,Sk,Hkv,D) — dispatches; the einsum paths
    GQA-expand kv first.  On DTensors the einsum paths run on each device's
    batch rows and heads (``kernels.ops.attention_on_shards``): left to
    DTensor, the einsum's flattened (batch, head) dim keeps only the batch's
    sharding and every device would compute every head."""
    if impl == "pallas" and kv_len is None:
        return _pallas_attention(q, k, v, causal=causal, window=window)
    if hasattr(q, "device_mesh"):
        return kops.attention_on_shards(
            lambda q, k, v, *n: _einsum_attention(q, k, v, causal=causal, window=window,
                                                  impl=impl, kv_len=n[0] if n else None),
            q, (k, v), q_head=2, kv_head=2, length=kv_len)
    return _einsum_attention(q, k, v, causal=causal, window=window, impl=impl, kv_len=kv_len)


def _einsum_attention(q, k, v, *, causal, window, impl, kv_len):
    groups = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
    if impl == "chunked":
        return _chunked_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    return _xla_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)


# -----------------------------------------------------------------------------
# block-level entry points
# -----------------------------------------------------------------------------
def self_attention(params: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
                   head_dim: int, causal: bool = True, window: int | None = None,
                   impl: str = "xla", positions: torch.Tensor | None = None,
                   use_rope: bool = True, norm_eps: float = 1e-6) -> torch.Tensor:
    b, s, _ = x.shape
    with trace.scope("attention", "model"):
        if positions is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
        q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions, use_rope,
                               norm_eps)
        out = multihead_attention(q, k, v, causal=causal, window=window, impl=impl)
        return _out_proj(out, params, x)


def _project_memory(params, x, memory, n_heads, n_kv, head_dim):
    """q from x (B,S,d), k and v from memory (B,M,d): the cross layer's
    projections (the reference's take no bias)."""
    b, s, _ = x.shape
    m = memory.shape[1]
    with trace.scope("qkv", "model"):
        q = constrain_heads((x @ params["wq"]).reshape(b, s, n_heads, head_dim))
        k = constrain_heads((memory @ params["wk"]).reshape(b, m, n_kv, head_dim))
        v = constrain_heads((memory @ params["wv"]).reshape(b, m, n_kv, head_dim))
        return q, k, v


def cross_attention(params: dict, x: torch.Tensor, memory: torch.Tensor, *,
                    n_heads: int, n_kv: int, head_dim: int, impl: str = "xla") -> torch.Tensor:
    """x (B,S,d) attends to memory (B,M,d), non-causal — VLM image layers /
    enc-dec.  "pallas" runs K6 over the un-repeated KV heads."""
    with trace.scope("attention", "model"):
        q, k, v = _project_memory(params, x, memory, n_heads, n_kv, head_dim)
        out = multihead_attention(q, k, v, causal=False, impl=impl)
        return _out_proj(out, params, x)


def decode_cross_attention(params: dict, x: torch.Tensor, memory: torch.Tensor, *,
                           n_heads: int, n_kv: int, head_dim: int,
                           impl: str = "xla") -> torch.Tensor:
    """Cross-attention of one decode token, x (B,1,d), to memory (B,M,d).
    The reference calls ``cross_attention`` (the einsum path) here; "pallas"
    sends it through K7 with every length M, the same function as K6 at Sq
    = 1 without the idle rows of a 64-row query tile."""
    if impl != "pallas":
        return cross_attention(params, x, memory, n_heads=n_heads, n_kv=n_kv,
                               head_dim=head_dim, impl="xla")
    b, m = x.shape[0], memory.shape[1]
    with trace.scope("attention", "model"):
        q, k, v = _project_memory(params, x, memory, n_heads, n_kv, head_dim)
        full = torch.full((b,), m, dtype=torch.int32, device=x.device)
        out = kops.decode_attention(q.reshape(b, n_heads, head_dim), k, v, full)
        return _out_proj(out, params, x)


# -----------------------------------------------------------------------------
# KV cache (decode path)
# -----------------------------------------------------------------------------
def cache_init(batch: int, s_max: int, n_kv: int, head_dim: int, device,
               dtype=torch.bfloat16) -> dict:
    return {"k": torch.zeros((batch, s_max, n_kv, head_dim), dtype=dtype, device=device),
            "v": torch.zeros((batch, s_max, n_kv, head_dim), dtype=dtype, device=device)}


def _write_slot(cache: torch.Tensor, new: torch.Tensor, length: torch.Tensor) -> None:
    """cache[b, length[b]] = new[b] where length[b] < S, else nothing — the
    reference's one-hot blend (attention.py:202-204) for finite caches, in
    place and without a host sync: a past-the-end slot writes row S-1's own
    value back, so nothing is indexed out of range.  A DTensor cache is
    written on its shards (``put_slot``)."""
    if hasattr(cache, "device_mesh"):
        put_slot(cache, new, length)
        return
    s = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    slot = length.clamp(0, s - 1).long()
    keep = cache[rows, slot]
    inside = (length >= 0) & (length < s)
    cache[rows, slot] = torch.where(inside[:, None, None], new.to(cache.dtype), keep)


def put_slot(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> None:
    """cache[b, slot[b]] = new[b] in place, slot in [0, S).  A DTensor cache
    (batch and sequence possibly sharded: flash-decode SP) is written on
    each device's shard, where the slot falls in its range of positions;
    nothing moves between devices.  (DTensor has no rule for the in-place
    ``index_put_`` on a sharded sequence dim, and gathering the cache to
    write one row would move it whole every layer.)"""
    if not hasattr(cache, "device_mesh"):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, slot.long()] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache.device_mesh
    if any(isinstance(p, Shard) and p.dim > 1 or p.is_partial() for p in cache.placements):
        raise ValueError(f"put_slot: a cache sharded as {cache.placements}")
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    seq_index = 0
    for i, p in enumerate(cache.placements):
        if p == Shard(1):
            seq_index = seq_index * mesh.size(i) + coord[i]
    rows_pl = [Shard(0) if p == Shard(0) else Replicate() for p in cache.placements]

    def local(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, rows_pl).to_local()

    shard, new, slot = cache.to_local(), local(new), local(slot)
    width = shard.shape[1]
    pos = slot - seq_index * width
    inside = (pos >= 0) & (pos < width)
    rows = torch.arange(shard.shape[0], device=shard.device)
    at = pos.clamp(0, width - 1).long()
    keep = shard[rows, at]
    shard[rows, at] = torch.where(inside[:, None, None], new.to(shard.dtype), keep)


def decode_self_attention(params: dict, x: torch.Tensor, cache: dict,
                          length: torch.Tensor, *, n_heads: int, n_kv: int,
                          head_dim: int, window: int | None = None,
                          impl: str = "xla", use_rope: bool = True, norm_eps: float = 1e-6):
    """One-token decode step.  x (B,1,d); cache k/v (B,Smax,K,Dh); ``length``
    (B,) valid-slot counts.  Returns (out (B,1,d), cache).  Unlike the
    reference, the cache is written in place (the same dict comes back): a
    functional copy would move the whole cache every layer of every step."""
    b = x.shape[0]
    with trace.scope("attention", "model"):
        positions = length[:, None]                               # (B,1)
        q, k, v = _project_qkv(params, x, n_heads, n_kv, head_dim, positions, use_rope,
                               norm_eps)
        _write_slot(cache["k"], k[:, 0], length)
        _write_slot(cache["v"], v[:, 0], length)
        kv_len = length + 1
        if impl == "pallas":
            # K7 takes one element type; the serving path's q and cache are
            # both bf16, so the cast copies nothing there
            out = kops.decode_attention(q.reshape(b, n_heads, head_dim),
                                        cache["k"].to(q.dtype), cache["v"].to(q.dtype), kv_len)
        else:
            out = multihead_attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                                      causal=False, window=window, impl="xla",
                                      kv_len=kv_len)
        return _out_proj(out, params, x), cache
