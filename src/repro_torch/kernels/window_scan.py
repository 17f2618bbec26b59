"""WINDOW's ordered scan: inclusive cumsum / cummax / cummin / cumprod
along axis 0.

``window_scan`` dispatches on the device of its tensor: a CPU tensor takes
the plain PyTorch version below, a CUDA tensor the hand-written kernel in
``csrc/window_scan.cu``, which replaces the TPU kernel
``repro/kernels/window_scan.py:_window_scan_padded``.  Its bound is device
memory: M * N * 4 bytes read and as many written.  The kernel is one
cooperative launch: the CTAs stage their (column group, row chunk) tiles in
shared memory, where they stay while the column fits (x is then read once),
turn the chunk totals into carries across a grid barrier, and fold each
tile from its carry.  The association order is a function of M and N alone,
so results are bit-identical from run to run; the note in the source states
it exactly.

The plan (``chunks``, ``CHUNK_ROWS``): a work item is 4096 elements, 4096
rows of the column when N == 1, else 512 rows of a group of ``GROUP`` = 8
neighbouring columns.  The scratch holds the chunk totals and the chunks'
carries, 2 * N * chunks floats, allocated with each call.
``emulated_cumsum`` is the kernel's association order for an (M,) cumsum,
step for step in float32 on the CPU: the kernel's cumsum equals it bit for
bit, which ``chip_smoke.py`` checks on the card.

Semantics (both paths): values (M,) or (M, N) float32, scanned per column;
max and min propagate NaN; the running value starts at 0, -inf, +inf or 1.
"""
from __future__ import annotations

import torch

from . import _build
from ._util import LaunchCounter, cuda_stream, on_cpu, on_device

__all__ = ["window_scan", "window_scan_plain", "emulated_cumsum", "counter", "chunks",
           "OPS"]

OPS = {"cumsum": 0, "cummax": 1, "cummin": 2, "cumprod": 3}
THREADS, RUN = 512, 8      # the kernel's CTA size and the rows a thread folds in order
CHUNK_ROWS = THREADS * RUN  # rows of a work item when N == 1
GROUP = 8                  # columns of a work item when N > 1 (4096 / 8 = 512 rows)
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


def chunks(m: int, n: int = 1) -> int:
    """Row chunks the kernel cuts each column of M rows into."""
    rows = CHUNK_ROWS if n == 1 else CHUNK_ROWS // GROUP
    return -(-m // rows)


def _tree(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's cta_exclusive for one column, cumsum, in float32 over a
    batch: (B, 512) thread values -> (exclusive prefix of each thread,
    total).  An inclusive shuffle scan of steps 1..16 in each warp, then the
    16 warp totals folded in warp order."""
    b = v.shape[0]
    inc = v.reshape(b, THREADS // 32, 32)
    for d in (1, 2, 4, 8, 16):
        inc = torch.cat([inc[:, :, :d], inc[:, :, :-d] + inc[:, :, d:]], dim=2)
    warp = inc[:, :, 31]
    prefix = torch.zeros(b, THREADS // 32)
    acc = warp[:, 0]
    for w in range(1, THREADS // 32):
        prefix[:, w] = acc
        acc = acc + warp[:, w]
    lane_excl = torch.cat([torch.zeros(b, THREADS // 32, 1), inc[:, :, :-1]], dim=2)
    excl = prefix[:, :, None] + lane_excl
    excl[:, :, 0] = prefix
    excl[:, 0, :] = lane_excl[:, 0, :]
    return excl.reshape(b, THREADS), acc


def emulated_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The kernel's association order for an (M,) float32 cumsum, step for
    step in float32 on the CPU (the header of csrc/window_scan.cu, points
    1-4), vectorised over chunks: 4096-row chunks of 512 runs of 8 rows;
    the chunk totals in 512 runs of ceil(chunks / 512), each folded from its
    first, the run totals through the same tree, each run walked from its
    prefix."""
    x = x.detach().to("cpu", torch.float32)
    m = x.shape[0]
    c = chunks(m)
    rows = torch.zeros(c * CHUNK_ROWS)
    rows[:m] = x
    rows = rows.reshape(c, THREADS, RUN)
    tot = rows[:, :, 0]
    for k in range(1, RUN):
        tot = tot + rows[:, :, k]
    thread_excl, chunk_tot = _tree(tot)
    per = -(-c // THREADS)
    runs = torch.zeros(THREADS * per)
    runs[:c] = chunk_tot
    runs = runs.reshape(THREADS, per)
    filled = (torch.arange(THREADS * per) < c).reshape(THREADS, per)
    run_tot = runs[:, 0].clone()
    for i in range(1, per):
        run_tot = torch.where(filled[:, i], run_tot + runs[:, i], run_tot)
    run_excl, _ = _tree(run_tot[None])
    carry = torch.empty(THREADS, per)
    acc = run_excl[0]
    for i in range(per):
        carry[:, i] = acc
        acc = acc + runs[:, i]
    acc = carry.reshape(-1)[:c, None] + thread_excl
    out = torch.empty_like(rows)
    for k in range(RUN):
        acc = acc + rows[:, :, k]
        out[:, :, k] = acc
    return out.reshape(-1)[:m]


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
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if m == 0 or n == 0:
        return out
    c = chunks(m, n)
    scratch = torch.empty(2 * n * c, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with on_device(x):
        rc = lib.repro_window_scan(x.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, n,
                                   x.stride(0), 0 if x.dim() == 1 else x.stride(1), OPS[op], c,
                                   cuda_stream(x))
    _build.check(rc, "window_scan")
    counter.bump()
    return out
