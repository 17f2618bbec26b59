"""WINDOW's ordered scan: inclusive cumsum / cummax / cummin / cumprod
along axis 0.

``window_scan`` dispatches on the device of its tensor: a CPU tensor takes
the plain PyTorch version below, a CUDA tensor the hand-written kernel in
``csrc/window_scan.cu`` (a three-phase scan in a fixed association order,
bit-identical from run to run; see the note there), which replaces the TPU
kernel ``repro/kernels/window_scan.py:_window_scan_padded``.

Semantics (both paths): values (M,) or (M, N) float32, scanned per column;
max and min propagate NaN; the running value starts at 0, -inf, +inf or 1.
"""
from __future__ import annotations

import torch

from . import _build
from ._util import LaunchCounter, cuda_stream, on_cpu

__all__ = ["window_scan", "window_scan_plain", "counter", "chunks", "OPS"]

OPS = {"cumsum": 0, "cummax": 1, "cummin": 2, "cumprod": 3}
CHUNK_ROWS = 4096          # the kernel's kChunk: 256 threads x 16 rows
MAX_COLS = 65535           # grid.y
counter = LaunchCounter()


def window_scan_plain(x: torch.Tensor, op: str = "cumsum") -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    if op not in OPS:
        raise ValueError(op)
    x = x.to(torch.float32)
    if op in ("cumsum", "cumprod"):
        # accumulated in float64 and rounded once, so that at millions of
        # rows this version stays the accurate side of a comparison with the
        # kernel (a float32 running sum drifts by more than 1e-5 * sum|v|)
        scan = torch.cumsum if op == "cumsum" else torch.cumprod
        return scan(x.to(torch.float64), dim=0).to(torch.float32)
    return (torch.cummax if op == "cummax" else torch.cummin)(x, dim=0).values


def chunks(m: int) -> int:
    """Row chunks the kernel cuts M rows into (one CTA each per column)."""
    return -(-m // CHUNK_ROWS)


def window_scan(x: torch.Tensor, op: str = "cumsum") -> torch.Tensor:
    """Inclusive scan along axis 0 of (M,) or (M, N) float32 → same shape,
    contiguous.  A strided view (a column of a wider matrix) is read in
    place."""
    if op not in OPS:
        raise ValueError(op)
    if on_cpu("window_scan", x):
        return window_scan_plain(x, op)
    if x.dim() not in (1, 2) or x.dtype != torch.float32:
        raise ValueError(f"window_scan: need (M,) or (M, N) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    m = x.shape[0]
    n = 1 if x.dim() == 1 else x.shape[1]
    if n > MAX_COLS:
        raise ValueError(f"window_scan: at most {MAX_COLS} columns per call, got {n}")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    rs = x.stride(0)
    cs = 0 if x.dim() == 1 else x.stride(1)
    c = chunks(m)
    totals = torch.empty((n, c), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.repro_window_scan(x.data_ptr(), out.data_ptr(), totals.data_ptr(),
                                   m, n, rs, cs, OPS[op], c, cuda_stream(x))
    _build.check(rc, "window_scan")
    counter.bump()
    return out
