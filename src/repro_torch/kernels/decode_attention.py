"""Single-token GQA decode attention over a KV cache: the serving step's
attention, for every batch slot at once.

``decode_attention`` dispatches on the device of its tensors: CPU tensors
take the plain PyTorch version below, CUDA tensors a hand-written kernel
that replaces the TPU kernel ``repro/kernels/decode_attention.py:_decode_single``
(split-key online softmax with a fixed-order combine, bit-identical from run
to run; see the notes in the sources).  One entry point; ``route(dtype)``
picks the kernel by dtype alone, and ``counter.routes`` counts launches by
route:

- bf16, the serving route "tc": the tensor cores in one launch, a cluster of
  ``splits(S)`` <= 8 CTAs a (slot, KV head) that combine through
  distributed shared memory (``csrc/decode_attention_tc.cu``); D must be a
  multiple of 16 (128 or 256 in every model the port runs), else
  ``ValueError``.
- float32, route "fma": the CUDA cores, ``fma_splits(S)`` CTAs a (slot, KV
  head) and a combining launch (``csrc/decode_attention.cu``).

Shapes: q (B, H, D) one token's query heads per slot; caches (B, S, KVH, D);
lengths (B,) valid cache slots per slot; → (B, H, D) in q's dtype.  The
single-sequence call of the reference, q (H, D), caches (S, KVH, D) and an
int or 0-d length, is the B = 1 case.  H = KVH * G.  Softmax and
accumulation in float32; the scale defaults to 1/sqrt(D); a length past S
makes all S slots valid.  Where no slot is valid (length 0) the kernel gives
0, the value the Pallas kernel's ``l == 0`` guard is written for (its finite
-1e30 mask never lets the guard fire), and the plain version the mean of V,
as ``repro.kernels.ref.decode_attention`` does (ROADMAP, known divergences);
decode always has length >= 1.

**Partials** (``decode_attention_partials``): the same launch on one piece
of a cache (a device's rows where the cache's sequence is sharded: the
flash-decode SP of ``launch/sharding.cache_specs_tree``) returns, per
(slot, head), the unnormalised output O, the row max M in the log2 domain
and the sum of weights L, all float32, instead of the output: the tc kernel
writes its cluster fold's result before the division, the fma kernel its
split combine's.  ``combine_partials`` folds the pieces' partials in piece
order as the tc kernel folds its CTAs; ``kernels.ops`` runs it across
devices.  Routes "tc_partials" and "fma_partials".

On meta tensors (the dry-run) nothing runs: the lengths have no values, so
every one of the S slots counts as valid, and the call charges 4 x D FLOPs
a (slot, head, valid row), the valid K and V rows, q, the output and the
lengths each moved once, and returns an empty meta output.
"""
from __future__ import annotations

import torch

from . import _build
from ._util import LaunchCounter, charge, cuda_stream, on_cpu, on_device, on_meta, refuse_grad

__all__ = ["decode_attention", "decode_attention_plain", "decode_attention_partials",
           "decode_attention_partials_plain", "combine_partials", "piece_lengths", "counter",
           "route", "splits", "split_keys", "fma_splits", "SPLIT_KEYS"]

SPLIT_KEYS = 128           # cache positions a CTA takes (fma: always; tc: up to 8 CTAs)
MAX_SPLITS = 8             # the tc kernel's cluster: at most the portable 8 CTAs
KEY_STEP = 64              # 4 warps x 16-key sub-tiles: a tc CTA's keys are a multiple
MAX_HEAD_DIM = 256
MAX_GROUP = 64
_NEG = -1e30
_LOG2E = 1.4426950408889634
_DTYPES = (torch.float32, torch.bfloat16)
counter = LaunchCounter()


def splits(s: int) -> int:
    """CTAs of the tc kernel's cluster a (slot, KV head): min(8, ceil(S /
    128)), a function of S alone, so no slot's result depends on another's
    length."""
    return max(1, min(MAX_SPLITS, -(-s // SPLIT_KEYS)))


def split_keys(s: int) -> int:
    """Keys a CTA of the tc kernel: CTA r owns [r * keys, (r + 1) * keys),
    keys a multiple of 64, so the splits cover [0, S) once."""
    return -(-max(1, -(-s // splits(s))) // KEY_STEP) * KEY_STEP


def fma_splits(s: int) -> int:
    """CTAs the fma kernel gives each (slot, KV head): ceil(S / 128)."""
    return max(1, -(-s // SPLIT_KEYS))


def route(dtype: torch.dtype) -> str:
    """The kernel a call takes on the card, by dtype alone: "tc" (bf16) or
    "fma" (float32)."""
    return "tc" if dtype == torch.bfloat16 else "fma"


def _cp_async_operand(t: torch.Tensor) -> torch.Tensor:
    """q or a cache as the tc kernel reads it: ``t`` where its base is
    16-byte aligned and its strides but the last multiples of 8 elements,
    else a contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _batched(q, k_cache, v_cache, length):
    """The reference's single-sequence call as B = 1; lengths as (B,)."""
    single = q.dim() == 2
    if single:
        q, k_cache, v_cache = q[None], k_cache[None], v_cache[None]
    if not isinstance(length, torch.Tensor):
        length = torch.full((q.shape[0],), int(length), dtype=torch.int32,
                            device=q.device)
    return single, q, k_cache, v_cache, length.reshape(-1)


def decode_attention_plain(q, k_cache, v_cache, length, *, scale=None):
    """Plain PyTorch version, on any device: ``ref.decode_attention`` (f32
    einsum, a -1e30 mask, softmax) over a batch of slots."""
    single, q, k, v, length = _batched(q, k_cache, v_cache, length)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, kvh, h // kvh, d).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < length.to(q.device)[:, None]
    logits = torch.where(valid[:, None, None, :], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float()).reshape(b, h, d).to(q.dtype)
    return out[0] if single else out


def _charge(qb, kb):
    """The analytic counts of a call on meta tensors: every one of the S
    slots counts as valid."""
    b, h, d = qb.shape
    keys = b * kb.shape[1]
    size = qb.element_size()
    charge("decode_attention", 4 * keys * h * d,
           2 * keys * kb.shape[2] * d * size + 2 * b * h * d * size + b * 4)


def _checked(qb, kb, vb, lb):
    """The kernels' preconditions (raise ValueError), and the lengths as a
    contiguous int32 vector."""
    b, h, d = qb.shape
    if kb.dim() != 4 or kb.shape != vb.shape or kb.shape[0] != b or kb.shape[3] != d:
        raise ValueError(f"decode_attention: need q (B, H, D) and caches (B, S, KVH, D), "
                         f"got {tuple(qb.shape)}, {tuple(kb.shape)}, {tuple(vb.shape)}")
    kvh = kb.shape[2]
    if h % kvh or h // kvh > MAX_GROUP or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: need H a multiple of KVH, a group of at most "
                         f"{MAX_GROUP} and D in [1, {MAX_HEAD_DIM}], got H={h} KVH={kvh} D={d}")
    if qb.dtype not in _DTYPES or not qb.dtype == kb.dtype == vb.dtype:
        raise ValueError(f"decode_attention: need q and the caches all float32 or all "
                         f"bfloat16, got {qb.dtype}, {kb.dtype}, {vb.dtype}")
    if lb.shape != (b,) or lb.dtype != torch.int32:
        raise ValueError(f"decode_attention: need lengths ({b},) int32, got "
                         f"{tuple(lb.shape)} {lb.dtype}")
    if qb.stride(2) != 1 or kb.stride(3) != 1 or vb.stride(3) != 1:
        raise ValueError("decode_attention: the head dimension must be contiguous")
    if route(qb.dtype) == "tc" and d % 16:
        raise ValueError(f"decode_attention: bf16 runs on the tensor cores and needs D a "
                         f"multiple of 16, got D={d}")
    return lb.contiguous()


def _launch(qb, kb, vb, lb, scale, out, part_o=None, part_ml=None) -> str:
    """One launch of the route ``route(q.dtype)`` (``out`` written, or in the
    partials mode ``part_o`` and ``part_ml``); returns the route counted."""
    b, h, d = qb.shape
    s, kvh = kb.shape[1], kb.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    lib = _build.library()
    if route(qb.dtype) == "tc":
        qb, kb, vb = _cp_async_operand(qb), _cp_async_operand(kb), _cp_async_operand(vb)
        ns, keys = splits(s), split_keys(s)
        with on_device(qb):
            rc = lib.repro_decode_attention_tc(
                qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), lb.data_ptr(), ptr(out),
                ptr(part_o), ptr(part_ml), b, h, kvh, d, s, qb.stride(0), qb.stride(1),
                kb.stride(0), kb.stride(1), kb.stride(2), vb.stride(0), vb.stride(1),
                vb.stride(2), ns, keys, float(scale) * _LOG2E, cuda_stream(qb))
        _build.check(rc, "decode_attention")
        return "tc"
    ns = fma_splits(s)
    g = h // kvh
    part_acc = torch.empty((b, kvh, ns, g, d), dtype=torch.float32, device=qb.device)
    split_ml = torch.empty((b, kvh, ns, g, 2), dtype=torch.float32, device=qb.device)
    with on_device(qb):
        rc = lib.repro_decode_attention(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), lb.data_ptr(),
            part_acc.data_ptr(), split_ml.data_ptr(), ptr(out), ptr(part_o), ptr(part_ml),
            b, h, kvh, d, s, qb.stride(0), qb.stride(1), kb.stride(0), kb.stride(1),
            kb.stride(2), vb.stride(0), vb.stride(1), vb.stride(2), ns, float(scale),
            cuda_stream(qb))
    _build.check(rc, "decode_attention")
    return "fma"


def decode_attention(q, k_cache, v_cache, length, *, scale=None):
    """q (B, H, D), caches (B, S, KVH, D), lengths (B,) → (B, H, D); or the
    single-sequence q (H, D), caches (S, KVH, D), int length → (H, D)."""
    refuse_grad("decode_attention", "K7", q, k_cache, v_cache)
    single, qb, kb, vb, lb = _batched(q, k_cache, v_cache, length)
    if on_meta("decode_attention", qb, kb, vb, lb):
        _charge(qb, kb)
        out = torch.empty(qb.shape, dtype=qb.dtype, device="meta")
        return out[0] if single else out
    if on_cpu("decode_attention", qb, kb, vb, lb):
        return decode_attention_plain(q, k_cache, v_cache, length, scale=scale)
    lb = _checked(qb, kb, vb, lb)
    out = torch.empty(qb.shape, dtype=qb.dtype, device=qb.device)
    counter.bump(_launch(qb, kb, vb, lb, scale, out))
    return out[0] if single else out


# =============================================================================
# partials: one piece of the cache (a device's rows of a sequence-sharded
# cache), combined across the pieces afterwards
# =============================================================================
def decode_attention_partials_plain(q, k_cache, v_cache, length, *, scale=None):
    """Plain PyTorch version of the partials mode, on any device: per (slot,
    head) the unnormalised output O (float32, (B, H, D)), the row max M of
    the scores in the log2 domain (scores x scale x log2(e); (B, H)) and the
    sum of weights L = sum 2^(s - M) ((B, H)), over the valid rows of this
    cache.  M is -inf, L and O 0 where no row is valid."""
    _, q, k, v, length = _batched(q, k_cache, v_cache, length)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, kvh, h // kvh, d).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale * _LOG2E
    valid = torch.arange(s, device=q.device)[None, :] < length.to(q.device)[:, None]
    logits = torch.where(valid[:, None, None, :], logits, -torch.inf)
    m = logits.amax(dim=-1)
    p = torch.exp2(logits - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(b, h, d), m.reshape(b, h), p.sum(dim=-1).reshape(b, h)


def decode_attention_partials(q, k_cache, v_cache, length, *, scale=None):
    """K7's partials mode: q (B, H, D), caches (B, S, KVH, D), lengths (B,)
    → (O (B, H, D), M (B, H), L (B, H)) float32, as
    ``decode_attention_partials_plain``, in one launch of the route
    ``route(q.dtype)`` (counted as "tc_partials" / "fma_partials");
    ``combine_partials`` folds the partials of a cache's pieces.  On meta
    tensors it charges the analytic counts of these rows."""
    refuse_grad("decode_attention", "K7", q, k_cache, v_cache)
    _, qb, kb, vb, lb = _batched(q, k_cache, v_cache, length)
    b, h, d = qb.shape
    if on_meta("decode_attention", qb, kb, vb, lb):
        _charge(qb, kb)
        return (torch.empty((b, h, d), dtype=torch.float32, device="meta"),
                torch.empty((b, h), dtype=torch.float32, device="meta"),
                torch.empty((b, h), dtype=torch.float32, device="meta"))
    if on_cpu("decode_attention", qb, kb, vb, lb):
        return decode_attention_partials_plain(qb, kb, vb, lb, scale=scale)
    lb = _checked(qb, kb, vb, lb)
    part_o = torch.empty((b, h, d), dtype=torch.float32, device=qb.device)
    part_ml = torch.empty((b, h, 2), dtype=torch.float32, device=qb.device)
    counter.bump(_launch(qb, kb, vb, lb, scale, None, part_o, part_ml) + "_partials")
    return part_o, part_ml[..., 0], part_ml[..., 1]


def piece_lengths(length: torch.Tensor, offset: int, rows: int) -> torch.Tensor:
    """The lengths a piece of ``rows`` cache rows from row ``offset`` sees:
    clamp(length - offset, 0, rows), int32."""
    return (length.to(torch.int64) - offset).clamp(0, rows).to(torch.int32)


def _fma32(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``p + c`` rounded once to float32, as ``fmaf`` rounds: ``p`` a
    product of two float32 values (exact in float64), ``c`` float32 values
    held in float64.  TwoSum gives the float64 sum ``s`` and its error
    exactly; an inexact ``s`` is moved to its odd neighbour toward the
    exact sum (round to odd), which keeps enough bits that rounding it to
    float32 rounds the exact sum (no double rounding)."""
    s = p + c
    pp = s - c
    e = (p - pp) + (c - (s - pp))
    odd = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, float("inf")), e)
    return torch.where(odd, torch.nextafter(s, toward), s).float()


def combine_partials(parts, dtype: torch.dtype) -> torch.Tensor:
    """The attention output from the partials of a cache's pieces, in piece
    (rank) order, as the tc kernel's cluster fold combines its CTAs: M* the
    largest M of the pieces with L > 0; a_r = 2^(M_r - M*); acc =
    fmaf(O_r, a_r, acc) and den = fmaf(L_r, a_r, den) in piece order from
    0, each step rounded once to float32 (``_fma32``); out = acc / den
    rounded once to ``dtype``, 0 where no piece has a valid row.  Plain
    elementwise work, B x H x (D + 1) floats a piece, in a fixed order (no
    atomics), on any device: about 12 small launches a piece."""
    ms = torch.stack([m for _, m, _ in parts])
    ls = torch.stack([l for _, _, l in parts])
    top = torch.where(ls > 0, ms, -torch.inf).amax(dim=0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    a = torch.where(ls > 0, torch.exp2(ms - top), 0.0).double()[..., None]
    # O and L side by side: one fold of (D + 1) columns a piece
    prods = torch.stack([torch.cat([o, l[..., None]], dim=-1) for o, _, l in parts]).double() * a
    acc = torch.zeros_like(prods[0])
    for p in prods:
        acc = _fma32(p, acc).double()
    acc, den = acc[..., :-1].float(), acc[..., -1:].float()
    out = torch.where(den > 0, acc / den, 0.0)
    return out.to(dtype)
