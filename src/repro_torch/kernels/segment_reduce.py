"""GROUPBY aggregation: per-segment sum / count / min / max.

``segment_reduce`` dispatches on the device of its tensors: CPU tensors take
the plain PyTorch version below, CUDA tensors the hand-written kernels in
``csrc/segment_reduce.cu``, which replace the TPU kernel
``repro/kernels/segment_reduce.py:_segment_reduce_padded``.  ``route(c, g)``
picks one of two from C and G alone:

- "reg", where G padded to a power of two >= 8 times C padded to 1, 2, 4 or
  8 is at most ``REG_ACCUMULATORS`` (the engine's G 6 x C 8 blocks, G <= 64
  at C 1): one launch; a thread's per-segment sums in registers over rows
  read one a lane, then the warps, the CTAs (``reg_plan``) and their
  partials folded in a fixed order, the last CTA to finish folding the
  partials.  Its ticket is one int a (device, stream), zeroed once here and
  left 0 by every launch.
- "table", every other shape (G 65,536, slabs of 1,536+ columns): per-warp
  tables in shared memory, in column slabs (``slab_width``, ``plan``), two
  launches a slab.

Both are deterministic: no float atomics and a fixed association order,
stated in the source.  ``emulated_sum`` is the "reg" route's sum, step for
step in float32 on the CPU; the kernel's sum equals it bit for bit, which
``chip_smoke.py`` checks on the card.  ``counter.routes`` counts launches by
route.

Semantics (both paths): values (M,) or (M, C) float32, codes (M,) int32;
code -1 (or any code outside [0, G)) contributes nothing; min/max propagate
NaN; a segment no row reaches gives 0 for sum/count, +inf for min and -inf
for max.
"""
from __future__ import annotations

import threading

import torch

from . import _build
from ._util import LaunchCounter, cuda_stream, on_cpu, on_device

__all__ = ["segment_reduce", "segment_reduce_plain", "emulated_sum", "counter", "route",
           "reg_plan", "reg_rows", "plan", "slab_width"]

OPS = {"sum": 0, "count": 1, "min": 2, "max": 3}
counter = LaunchCounter()

_WARPS = 8
_SMEM_BYTES = 48 * 1024
_MIN_CHUNK_ROWS = 4096
_MAX_CHUNKS = 528                 # four CTAs per SM of an H100
_MAX_SCRATCH_FLOATS = 1 << 24     # (chunks, G, C) partials: at most 64 MiB
_MAX_G_TILES = 65535              # pass 1's grid.y
REG_THREADS = 512                 # route "reg": the kernel's CTA size
REG_WARPS = REG_THREADS // 32
REG_CTAS = 132                    # at most one CTA an SM of an H100
REG_MIN_ROWS = 4096               # rows a CTA takes before the grid grows
REG_ACCUMULATORS = 64             # a thread's per-segment accumulators
REG_MAX_COLS = 8
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
_TICKET_LOCK = threading.Lock()


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


def _padded_g(g: int) -> int:
    """G as the "reg" kernel unrolls it: a power of two, at least 8."""
    return max(8, 1 << (g - 1).bit_length())


def _padded_c(c: int) -> int:
    """C as the "reg" kernel unrolls it: 1, 2, 4 or 8."""
    return 1 << (c - 1).bit_length()


def route(c: int, g: int) -> str:
    """The kernel a (C, G) aggregate takes: "reg" or "table"."""
    fits = c <= REG_MAX_COLS and _padded_g(g) * _padded_c(c) <= REG_ACCUMULATORS
    return "reg" if fits else "table"


def reg_rows(c: int, op: str = "sum") -> int:
    """Rows a lane of the "reg" kernel reads a step (its reg_rows)."""
    return 16 if op == "count" else (8 if _padded_c(c) <= 2 else 4)


def reg_plan(m: int) -> tuple[int, int]:
    """(ctas, rows a CTA) of the "reg" route, a function of M alone: CTA b
    owns rows [b * per, (b + 1) * per) cut to M; per a multiple of 32."""
    ctas = max(1, min(REG_CTAS, -(-m // REG_MIN_ROWS)))
    per = -(-max(1, -(-m // ctas)) // 32) * 32
    return ctas, per


def _butterfly(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The kernels' warp butterfly over a 32-long dim (x + shfl_xor(x, o)
    for o = 16 .. 1), lane 0's value."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x.index_select(dim, lane ^ o)
    return x.select(dim, 0)


def emulated_sum(values: torch.Tensor, codes: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The "reg" route's sum in its association order (the header of
    csrc/segment_reduce.cu), step for step in float32 on the CPU: each
    thread folds its rows in order through selects, a warp's lanes by the
    butterfly, a CTA's warps in warp order from 0, the CTAs' partials in CTA
    order from 0.  (M,) or (M, C) → (G,) or (G, C)."""
    squeeze = values.dim() == 1
    v = (values[:, None] if squeeze else values).detach().to("cpu", torch.float32)
    codes = codes.detach().to("cpu", torch.int64)
    m, c = v.shape
    g = int(num_segments)
    if route(c, g) != "reg":
        raise ValueError(f"emulated_sum: ({c} columns, G {g}) takes route table")
    ctas, per = reg_plan(m)
    u = reg_rows(c)
    steps = -(-per // (REG_THREADS * u))
    # the row a lane reads, by (CTA, step, warp, u, lane)
    b = torch.arange(ctas).view(-1, 1, 1, 1, 1)
    rows = (b * per + torch.arange(steps).view(1, -1, 1, 1, 1) * (REG_THREADS * u)
            + torch.arange(REG_WARPS).view(1, 1, -1, 1, 1) * (32 * u)
            + torch.arange(u).view(1, 1, 1, -1, 1) * 32 + torch.arange(32).view(1, 1, 1, 1, -1))
    ok = rows < torch.clamp((b + 1) * per, max=m)
    rows = torch.where(ok, rows, 0)
    code = torch.where(ok, codes[rows], -1) if m else torch.full(rows.shape, -1)
    vals = v[rows] if m else torch.zeros(rows.shape + (c,))
    slots = torch.arange(g)
    acc = torch.zeros(ctas, REG_WARPS, 32, g, c)
    for k in range(steps):
        for r in range(u):
            hit = (code[:, k, :, r, :, None] == slots)[..., None]       # (ctas, W, 32, g, 1)
            acc = torch.where(hit, acc + vals[:, k, :, r, :, None, :], acc)
    warps = _butterfly(acc, 2)                                          # (ctas, W, g, c)
    part = torch.zeros(ctas, g, c)
    for w in range(REG_WARPS):
        part = part + warps[:, w]
    out = torch.zeros(g, c)
    for i in range(ctas):
        out = out + part[i]
    return out[:, 0] if squeeze else out


def _ticket(v: torch.Tensor) -> torch.Tensor:
    """The "reg" kernel's ticket for v's device and PyTorch's current stream
    there: one int, zeroed on that stream when first asked for; every launch
    leaves it 0.  Launches on one stream run in order, so they share it."""
    key = (v.get_device(), cuda_stream(v))
    t = _TICKETS.get(key)
    if t is None:
        with _TICKET_LOCK:
            t = _TICKETS.get(key)
            if t is None:
                t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=v.device)
    return t


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
    if route(c, g) == "reg":
        ctas, per = reg_plan(m)
        acc = _padded_g(g) * (1 if op == "count" else _padded_c(c))
        part = torch.empty((ctas, acc), dtype=torch.float32, device=v.device)
        with on_device(v):
            rc = lib.repro_segment_reduce_reg(
                v.data_ptr(), codes.data_ptr(), out.data_ptr(), part.data_ptr(),
                _ticket(v).data_ptr(), m, c, c, g, OPS[op], ctas, per, cuda_stream(v))
        _build.check(rc, "segment_reduce")
        counter.bump("reg")
        return out[:, 0] if squeeze else out
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
        counter.bump("table")
    return out[:, 0] if squeeze else out
