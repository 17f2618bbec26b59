"""Single-token GQA decode attention over a KV cache: the serving step's
attention, for every batch slot at once.

``decode_attention`` dispatches on the device of its tensors: CPU tensors
take the plain PyTorch version below, CUDA tensors the hand-written kernel in
``csrc/decode_attention.cu`` (split-key online softmax with a fixed-order
combine, bit-identical from run to run; see the note there), which replaces
the TPU kernel ``repro/kernels/decode_attention.py:_decode_single``.

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
"""
from __future__ import annotations

import torch

from . import _build
from ._util import LaunchCounter, cuda_stream, on_cpu, on_device

__all__ = ["decode_attention", "decode_attention_plain", "counter", "splits",
           "SPLIT_KEYS"]

SPLIT_KEYS = 128           # the kernel's kSplitKeys: cache positions per CTA
MAX_HEAD_DIM = 256
MAX_GROUP = 64
_NEG = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
counter = LaunchCounter()


def splits(s: int) -> int:
    """CTAs the kernel gives each (slot, KV head): a function of S alone."""
    return max(1, -(-s // SPLIT_KEYS))


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


def decode_attention(q, k_cache, v_cache, length, *, scale=None):
    """q (B, H, D), caches (B, S, KVH, D), lengths (B,) → (B, H, D); or the
    single-sequence q (H, D), caches (S, KVH, D), int length → (H, D)."""
    single, qb, kb, vb, lb = _batched(q, k_cache, v_cache, length)
    if on_cpu("decode_attention", qb, kb, vb, lb):
        return decode_attention_plain(q, k_cache, v_cache, length, scale=scale)
    b, h, d = qb.shape
    if kb.dim() != 4 or kb.shape != vb.shape or kb.shape[0] != b or kb.shape[3] != d:
        raise ValueError(f"decode_attention: need q (B, H, D) and caches (B, S, KVH, D), "
                         f"got {tuple(qb.shape)}, {tuple(kb.shape)}, {tuple(vb.shape)}")
    s, kvh = kb.shape[1], kb.shape[2]
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
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    lb = lb.contiguous()
    ns = splits(s)
    g = h // kvh
    out = torch.empty((b, h, d), dtype=qb.dtype, device=qb.device)
    part_acc = torch.empty((b, kvh, ns, g, d), dtype=torch.float32, device=qb.device)
    part_ml = torch.empty((b, kvh, ns, g, 2), dtype=torch.float32, device=qb.device)
    lib = _build.library()
    with on_device(qb):
        rc = lib.repro_decode_attention(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), lb.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
            int(qb.dtype == torch.bfloat16), b, h, kvh, d, s, qb.stride(0), qb.stride(1),
            kb.stride(0), kb.stride(1), kb.stride(2),
            vb.stride(0), vb.stride(1), vb.stride(2), ns, float(scale),
            cuda_stream(qb))
    _build.check(rc, "decode_attention")
    counter.bump()
    return out[0] if single else out
