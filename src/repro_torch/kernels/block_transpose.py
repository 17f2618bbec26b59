"""2-D transpose — the per-block step of the engine's TRANSPOSE.

``block_transpose`` dispatches on the device of its tensor: a CPU tensor
takes the plain PyTorch version below, a CUDA tensor the hand-written kernel
in ``csrc/block_transpose.cu`` (32x32 shared-memory tiles, raw 4-byte words,
bit-exact), which replaces the TPU kernel
``repro/kernels/block_transpose.py:_transpose_padded``.
"""
from __future__ import annotations

import torch

from . import _build
from ._util import LaunchCounter, cuda_stream, on_cpu, on_device

__all__ = ["block_transpose", "block_transpose_plain", "counter"]

counter = LaunchCounter()


def block_transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a materialized (N, M) transpose."""
    return x.t().contiguous()


def block_transpose(x: torch.Tensor) -> torch.Tensor:
    """(M, N) → (N, M) for 4-byte element types (float32, int32)."""
    if x.dim() != 2:
        raise ValueError(f"block_transpose: need a 2-D tensor, got {tuple(x.shape)}")
    if on_cpu("block_transpose", x):
        return block_transpose_plain(x)
    if x.element_size() != 4 or x.is_complex():
        raise ValueError(f"block_transpose: need 4-byte elements, got {x.dtype} "
                         "(widen with _util.widen_for_kernel first)")
    m, n = x.shape
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    # the kernel reads row-major rows: a strided view is copied first
    x = x.contiguous()
    lib = _build.library()
    with on_device(x):
        rc = lib.repro_block_transpose(x.data_ptr(), out.data_ptr(), m, n,
                                       cuda_stream(x))
    _build.check(rc, "block_transpose")
    counter.bump()
    return out
