"""GROUPBY aggregation: per-segment sum / count / min / max.

``segment_reduce`` dispatches on the device of its tensors: CPU tensors take
the plain PyTorch version below, CUDA tensors the hand-written kernel in
``csrc/segment_reduce.cu`` (deterministic two-pass shared-memory tables; see
the note there), which replaces the TPU kernel
``repro/kernels/segment_reduce.py:_segment_reduce_padded``.

Semantics (both paths): values (M,) or (M, C) float32, codes (M,) int32;
code -1 (or any code outside [0, G)) contributes nothing; min/max propagate
NaN; a segment no row reaches gives 0 for sum/count, +inf for min and -inf
for max.
"""
from __future__ import annotations

import torch

from . import _build
from ._util import LaunchCounter, cuda_stream, on_cpu, on_device

__all__ = ["segment_reduce", "segment_reduce_plain", "counter", "plan",
           "slab_width"]

OPS = {"sum": 0, "count": 1, "min": 2, "max": 3}
counter = LaunchCounter()

_WARPS = 8
_SMEM_BYTES = 48 * 1024
_MIN_CHUNK_ROWS = 4096
_MAX_CHUNKS = 528                 # four CTAs per SM of an H100
_MAX_SCRATCH_FLOATS = 1 << 24     # (chunks, G, C) partials: at most 64 MiB
_MAX_G_TILES = 65535              # pass 1's grid.y


def _identity(op: str) -> float:
    return {"min": float("inf"), "max": float("-inf")}.get(op, 0.0)


def segment_reduce_plain(values: torch.Tensor, codes: torch.Tensor,
                         num_segments: int, op: str = "sum") -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    if op not in OPS:
        raise ValueError(op)
    squeeze = values.dim() == 1
    v = (values[:, None] if squeeze else values).to(torch.float32)
    g, c = num_segments, v.shape[1]
    codes = codes.to(torch.int64)
    keep = (codes >= 0) & (codes < g)
    idx, v = codes[keep], v[keep]
    if op in ("sum", "count"):
        # accumulated in float64 and rounded once, so that at millions of
        # rows per segment this version stays the accurate side of a
        # comparison with the kernel (a float32 running sum drifts by more
        # than 1e-5 * sum|v| there)
        out = torch.zeros((g, c), dtype=torch.float64, device=v.device)
        out.index_add_(0, idx, torch.ones_like(v, dtype=torch.float64)
                       if op == "count" else v.to(torch.float64))
        out = out.to(torch.float32)
    else:
        ident = _identity(op)
        nan = torch.isnan(v)
        filled = torch.where(nan, torch.full_like(v, ident), v)
        out = torch.full((g, c), ident, dtype=torch.float32, device=v.device)
        out.scatter_reduce_(0, idx[:, None].expand(-1, c), filled,
                            reduce="amin" if op == "min" else "amax",
                            include_self=True)
        hit = torch.zeros((g, c), dtype=torch.float32, device=v.device)
        hit.index_add_(0, idx, nan.to(torch.float32))
        out = torch.where(hit > 0, torch.full_like(out, float("nan")), out)
    return out[:, 0] if squeeze else out


def slab_width(g: int) -> int:
    """Most columns one launch takes: its warp tables of tile_g segments fit
    in shared memory, with tile_g large enough for at most _MAX_G_TILES
    g-tiles.  Wider values are reduced slab by slab."""
    return _SMEM_BYTES // (_WARPS * 4 * -(-g // _MAX_G_TILES))


def plan(m: int, c: int, g: int) -> tuple[int, int, int]:
    """(chunks, rows_per_chunk, tile_g) for the kernel's pass 1 over a slab
    of c <= slab_width(g) columns."""
    tile_g = min(g, _SMEM_BYTES // (_WARPS * c * 4))
    chunks = max(1, min(-(-m // _MIN_CHUNK_ROWS), _MAX_CHUNKS,
                        _MAX_SCRATCH_FLOATS // (g * c)))
    rows = max(1, -(-m // chunks))
    return chunks, rows, tile_g


def segment_reduce(values: torch.Tensor, codes: torch.Tensor,
                   num_segments: int, op: str = "sum") -> torch.Tensor:
    """Per-segment aggregate → (G,) or (G, C) float32."""
    if op not in OPS:
        raise ValueError(op)
    if on_cpu("segment_reduce", values, codes):
        return segment_reduce_plain(values, codes, num_segments, op)
    squeeze = values.dim() == 1
    v = values[:, None] if squeeze else values
    if v.dim() != 2 or v.dtype != torch.float32:
        raise ValueError(f"segment_reduce: values must be (M,) or (M, C) float32, "
                         f"got {tuple(values.shape)} {values.dtype}")
    if codes.dim() != 1 or codes.dtype != torch.int32 or codes.shape[0] != v.shape[0]:
        raise ValueError(f"segment_reduce: codes must be ({v.shape[0]},) int32, "
                         f"got {tuple(codes.shape)} {codes.dtype}")
    if num_segments < 1 or v.shape[1] < 1:
        raise ValueError("segment_reduce: need at least one segment and column")
    # the kernel reads row-major rows: a strided view is copied first
    v = v.contiguous()
    codes = codes.contiguous()
    m, c = v.shape
    g = int(num_segments)
    out = torch.empty((g, c), dtype=torch.float32, device=v.device)
    lib = _build.library()
    width = slab_width(g)
    # one launch per column slab, into that slab's columns of `out`; each
    # output element is folded by one launch, in the kernel's fixed order
    for lo in range(0, c, width):
        w = min(width, c - lo)
        chunks, rows, tile_g = plan(m, w, g)
        scratch = torch.empty((chunks, g, w), dtype=torch.float32, device=v.device)
        with on_device(v):
            rc = lib.repro_segment_reduce(
                v[:, lo:].data_ptr(), codes.data_ptr(), out[:, lo:].data_ptr(),
                scratch.data_ptr(), m, w, c, c, g, OPS[op], chunks, rows, tile_g,
                cuda_stream(v))
        _build.check(rc, "segment_reduce")
        counter.bump()
    return out[:, 0] if squeeze else out
