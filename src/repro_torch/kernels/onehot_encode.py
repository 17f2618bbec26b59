"""One-hot encoding — ``get_dummies``.

``onehot_encode`` dispatches on the device of its tensor: a CPU tensor takes
the plain PyTorch version below, a CUDA tensor the hand-written kernel in
``csrc/onehot_encode.cu``, which replaces the TPU kernel
``repro/kernels/onehot_encode.py:_onehot_padded``.  Its bound is device
memory, (M * G + M) * 4 bytes.  The kernel cuts the flat M * G output into
spans of ``SPAN`` elements, one a CTA: the CTA stages its rows' codes in
shared memory with 16-byte loads, then every thread stores whole float4
vectors of the span (``span_plan`` lists which elements each covers), so
every lane stores whatever G is.  Code -1, or any code outside [0, G),
gives an all-zero row.
"""
from __future__ import annotations

import torch

from . import _build
from ._util import LaunchCounter, cuda_stream, on_cpu, on_device

__all__ = ["onehot_encode", "onehot_encode_plain", "counter"]

SPAN = 8192          # output elements of a CTA: 256 threads x 8 float4
THREADS, VECS = 256, 8
counter = LaunchCounter()


def span_plan(m: int, g: int):
    """The kernel's split of an (M, G) output, in its own integer steps:
    yields (element, row, column, code slot, rows staged) for every element
    it stores, CTA by CTA, thread by thread.  The row and column come from
    one division at a thread's first vector and fixed steps after it; the
    code slot indexes the CTA's staged codes."""
    total, step = m * g, 4 * THREADS
    for e0 in range(0, total, SPAN):
        e1 = min(e0 + SPAN, total)
        r_lo = (e0 // g) & ~3
        nrows = (e1 - 1) // g - r_lo + 1
        for t in range(THREADS):
            e = e0 + 4 * t
            row, col = e // g - r_lo, e % g
            for _ in range(VECS):
                if e >= e1:
                    break
                r, c = row, col
                for j in range(min(4, e1 - e)):
                    yield e + j, r + r_lo, c, r, nrows
                    c += 1
                    if c == g:
                        c, r = 0, r + 1
                row, col = row + step // g, col + step % g
                if col >= g:
                    col, row = col - g, row + 1
                e += step


def onehot_encode_plain(codes: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Plain PyTorch version: compare against an arange."""
    cls = torch.arange(num_classes, dtype=codes.dtype, device=codes.device)
    return (codes[:, None] == cls[None, :]).to(torch.float32)


def onehot_encode(codes: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(M,) int32 codes → (M, num_classes) float32."""
    if on_cpu("onehot_encode", codes):
        return onehot_encode_plain(codes, num_classes)
    if codes.dim() != 1 or codes.dtype != torch.int32:
        raise ValueError(f"onehot_encode: codes must be (M,) int32, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    m, g = codes.shape[0], int(num_classes)
    out = codes.new_empty((m, g), dtype=torch.float32)
    if m == 0 or g == 0:
        return out
    codes = codes.contiguous()
    lib = _build.library()
    with on_device(codes):
        rc = lib.repro_onehot_encode(codes.data_ptr(), out.data_ptr(), m, g,
                                     cuda_stream(codes))
    _build.check(rc, "onehot_encode")
    counter.bump()
    return out
