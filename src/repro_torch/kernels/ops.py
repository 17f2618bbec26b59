"""Engine-facing wrappers around the kernels.

Dispatch follows the tensors' device and nothing else: CPU tensors take the
plain PyTorch versions, CUDA tensors the hand-written kernels (or the wrapper
raises).  There is no environment override and no capability fallback.
Inputs are widened to the kernels' storage types here (``_util``).
"""
from __future__ import annotations

import torch

from ._util import narrow_from_kernel, widen_for_kernel
from .block_transpose import block_transpose as _transpose
from .decode_attention import decode_attention as _decode
from .flash_attention import flash_attention as _flash
from .linear_scan import linear_scan as _linscan
from .onehot_encode import onehot_encode as _onehot
from .segment_reduce import segment_reduce as _segred
from .window_scan import window_scan as _winscan

__all__ = ["transpose", "segment_reduce", "segment_reduce_multi",
           "window_scan", "linear_scan", "onehot_encode", "flash_attention",
           "decode_attention"]

_FLT_MAX = torch.finfo(torch.float32).max


def transpose(x: torch.Tensor) -> torch.Tensor:
    w, orig = widen_for_kernel(x)
    return narrow_from_kernel(_transpose(w), orig)


def segment_reduce(values, codes, num_segments: int, op: str = "sum"):
    return _segred(values.to(torch.float32), codes.to(torch.int32),
                   num_segments, op)


def segment_reduce_multi(vals, valids, codes: torch.Tensor, *, bases,
                         num_segments: int, presence: bool = False) -> tuple:
    """A whole per-block partial-aggregation stage: null masking, squaring,
    presence counting, and one ``segment_reduce`` per reduce op, with
    same-op columns stacked into the kernel's (M, C) batch.  ``bases[i]`` ∈
    {sum,count,sumsq,min,max} names the statistic computed from ``(vals[i],
    valids[i])``; ``valids[i]`` may be None (all valid).  Returns one
    (G,)-vector per base, plus a trailing presence vector when ``presence``.
    Runs eagerly, one launch per reduce op."""
    codes = codes.to(torch.int32)
    m = codes.shape[0]
    by_op: dict[str, list] = {}

    def put(op: str, pos: int, vec) -> None:
        by_op.setdefault(op, []).append((pos, vec))

    for i, base in enumerate(bases):
        v = vals[i].to(torch.float32)
        valid = valids[i]
        if base == "count":
            put("sum", i, torch.ones(m, dtype=torch.float32, device=codes.device)
                if valid is None else valid.to(torch.float32))
        elif base == "sum":
            put("sum", i, v if valid is None else torch.where(valid, v, 0.0))
        elif base == "sumsq":
            put("sum", i, v * v if valid is None else torch.where(valid, v * v, 0.0))
        elif base == "min":
            put("min", i, v if valid is None else torch.where(valid, v, _FLT_MAX))
        else:   # max
            put("max", i, v if valid is None else torch.where(valid, v, -_FLT_MAX))
    if presence:
        # segment presence = #rows with a valid (non-negative) code,
        # independent of value nulls
        put("sum", len(bases), torch.ones(m, dtype=torch.float32,
                                          device=codes.device))

    out: list = [None] * (len(bases) + (1 if presence else 0))
    for op, items in by_op.items():
        if len(items) == 1:
            out[items[0][0]] = _segred(items[0][1], codes, num_segments, op)
        else:
            mat = torch.stack([vec for _, vec in items], dim=1)
            res = _segred(mat, codes, num_segments, op)
            for j, (pos, _) in enumerate(items):
                out[pos] = res[:, j]
    return tuple(out)


def window_scan(x, op: str = "cumsum") -> torch.Tensor:
    return _winscan(x.to(torch.float32), op)


def linear_scan(a, b) -> torch.Tensor:
    return _linscan(a.to(torch.float32), b.to(torch.float32))


def onehot_encode(codes, num_classes: int) -> torch.Tensor:
    return _onehot(codes.to(torch.int32), num_classes)


def flash_attention(q, k, v, *, causal: bool = True, scale=None, window=None):
    return _flash(q, k, v, causal=causal, scale=scale, window=window)


def decode_attention(q, k_cache, v_cache, length, *, scale=None) -> torch.Tensor:
    return _decode(q, k_cache, v_cache, length, scale=scale)
