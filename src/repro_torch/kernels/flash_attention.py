"""Fused (flash) attention of the forward / prefill pass: causal and
local-window masks, GQA, query positions aligned to the end of the key axis.

``flash_attention`` dispatches on the device of its tensors: CPU tensors
take the plain PyTorch version below, CUDA tensors a hand-written kernel
that replaces the TPU kernel ``repro/kernels/flash_attention.py:_flash_single``
(one CTA per 64 query rows of a head, key tiles of the causal / window band
in order, online softmax in float32, bit-identical from run to run).  bf16
runs on the tensor cores (``csrc/flash_attention_tc.cu``: TMA loads, wgmma,
P split into two bf16 halves for P . V; route "tc"), float32 on the CUDA
cores (``csrc/flash_attention.cu``, FMA; route "fma").  The tensor-core
kernel loads through TMA, which needs 16-byte aligned bases and strides:
an operand that is not (an odd head dimension, a view at an odd offset) is
copied first into a contiguous tensor with its head dimension zero-padded
to a multiple of 16 (``tma_operand``), and the same kernel runs.

Shapes: the model's call, q (B, Sq, H, D) with k, v (B, Sk, KVH, D), read
through their strides (head h reads KV head h // (H / KVH)) → (B, Sq, H, D)
in q's dtype; the reference's call, q (H, Sq, D) with k, v (H, Sk, D), or
(Sq, D) with (Sk, D), is the B = 1 case → (H, Sq, D) / (Sq, D).  Query i
sits at key position i + Sk - Sq; ``causal`` keeps keys at or before it,
``window`` w keeps keys after position - w.  Scale 1/sqrt(D) by default;
softmax and accumulation in float32.  A row with no visible key (a causal
query placed before the first key, where Sq > Sk) is 0 from the kernel, the
value the Pallas kernel's ``l == 0`` guard is written for, and the mean of V
from the plain version, as from ``repro.kernels.ref.flash_attention``
(ROADMAP, known divergences).
"""
from __future__ import annotations

import torch

from . import _build
from ._util import LaunchCounter, cuda_stream, on_cpu, on_device

__all__ = ["flash_attention", "flash_attention_plain", "tma_operand", "counter", "TILE_Q"]

TILE_Q = 64                # the kernel's kTileQ: query rows per CTA
MAX_HEAD_DIM = 256
MAX_GRID = 65535           # grid.y (heads) and grid.z (batch rows)
_NEG = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
counter = LaunchCounter()


def _batched(q, k, v):
    """The reference's (H, S, D) / (S, D) call as (1, S, H, D) views."""
    if q.dim() == 4:
        return q, k, v
    if q.dim() == 2:
        q, k, v = q[None], k[None], v[None]
    if q.dim() != 3:
        raise ValueError(f"flash_attention: need q (B, Sq, H, D), (H, Sq, D) or (Sq, D), "
                         f"got {tuple(q.shape)}")
    return tuple(t.transpose(0, 1)[None] for t in (q, k, v))


def _unbatched(out, rank):
    if rank == 4:
        return out
    out = out[0].transpose(0, 1)
    return out if rank == 3 else out[0]


def _mask(sq: int, sk: int, causal: bool, window, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None, window=None):
    """Plain PyTorch version, on any device: ``ref.flash_attention`` (f32
    einsum, a -1e30 mask, softmax) with the KV heads grouped, not repeated."""
    rank = q.dim()
    qb, kb, vb = _batched(q, k, v)
    b, sq, h, d = qb.shape
    sk, kvh = kb.shape[1], kb.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = qb.float().reshape(b, sq, kvh, h // kvh, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kb.float()) * scale
    logits = torch.where(_mask(sq, sk, causal, window, q.device), logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, vb.float()).reshape(b, sq, h, d)
    return _unbatched(out.to(q.dtype), rank)


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, S, heads, D) as the tensor-core kernel loads it: ``t`` itself
    where a TMA tensor map can read it (a 16-byte aligned base; B, S and
    heads strides positive multiples of 16 bytes), else a contiguous copy
    with D zero-padded to a multiple of 16, of which the kernel reads the
    first D columns."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(st > 0 and st * size % 16 == 0 for st in t.stride()[:3]):
        return t
    b, s, h, d = t.shape
    padded = t.new_zeros((b, s, h, -(-d // 16) * 16))
    padded[..., :d] = t
    return padded


def flash_attention(q, k, v, *, causal: bool = True, scale=None, window=None):
    """q (B, Sq, H, D), k / v (B, Sk, KVH, D) → (B, Sq, H, D); or the
    reference's (H, Sq, D) / (Sq, D) call."""
    rank = q.dim()
    qb, kb, vb = _batched(q, k, v)
    if on_cpu("flash_attention", qb, kb, vb):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale, window=window)
    b, sq, h, d = qb.shape
    if kb.dim() != 4 or kb.shape != vb.shape or kb.shape[0] != b or kb.shape[3] != d:
        raise ValueError(f"flash_attention: need q (B, Sq, H, D) and k, v (B, Sk, KVH, D), "
                         f"got {tuple(qb.shape)}, {tuple(kb.shape)}, {tuple(vb.shape)}")
    sk, kvh = kb.shape[1], kb.shape[2]
    if h % kvh or not 0 < d <= MAX_HEAD_DIM or b > MAX_GRID or h > MAX_GRID:
        raise ValueError(f"flash_attention: need H a multiple of KVH, D in [1, "
                         f"{MAX_HEAD_DIM}] and B, H <= {MAX_GRID}, got B={b} H={h} "
                         f"KVH={kvh} D={d}")
    if qb.dtype not in _DTYPES or not qb.dtype == kb.dtype == vb.dtype:
        raise ValueError(f"flash_attention: need q, k and v all float32 or all bfloat16, "
                         f"got {qb.dtype}, {kb.dtype}, {vb.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, got {window}")
    if qb.stride(3) != 1 or kb.stride(3) != 1 or vb.stride(3) != 1:
        raise ValueError("flash_attention: the head dimension must be contiguous")
    out = torch.empty((b, sq, h, d), dtype=qb.dtype, device=qb.device)
    if out.numel() == 0 or sk == 0:     # no key at all: every row is 0
        return _unbatched(out.zero_(), rank)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    bf16 = qb.dtype == torch.bfloat16
    if bf16:
        qb, kb, vb = tma_operand(qb), tma_operand(kb), tma_operand(vb)
    lib = _build.library()
    with on_device(qb):
        rc = lib.repro_flash_attention(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
            int(bf16), b, h, kvh, d, sq, sk,
            qb.stride(0), qb.stride(1), qb.stride(2), kb.stride(0), kb.stride(1),
            kb.stride(2), vb.stride(0), vb.stride(1), vb.stride(2), int(causal),
            0 if window is None else int(window), float(scale), cuda_stream(qb))
    _build.check(rc, "flash_attention")
    counter.bump("tc" if bf16 else "fma")
    return _unbatched(out, rank)
