"""First-order linear recurrence h_t = a_t * h_{t-1} + b_t along the time
axis (h_0 folded into b_0): the RG-LRU layer's recurrence.

``linear_scan`` dispatches on the device of its tensors: CPU tensors take
the plain PyTorch version below, CUDA tensors the hand-written kernel in
``csrc/linear_scan.cu`` (one launch: each CTA walks a slab of 32 channels
of one batch row through every time step in order, bit-equal to the plain
version; see the note there), which replaces the TPU kernel
``repro/kernels/linear_scan.py:_linear_scan_padded``.

Shapes: a, b (T, N) as the reference takes them, or (B, T, N), so that
``rglru_block`` makes one launch a layer where the reference vmaps over the
batch; → float32 of the same shape.  Everything is float32.
"""
from __future__ import annotations

import torch

from . import _build
from ._util import LaunchCounter, cuda_stream, on_cpu, on_device

__all__ = ["linear_scan", "linear_scan_plain", "counter", "chunks", "grid", "copy_bytes",
           "CHUNK_STEPS", "SLAB_CHANNELS"]

CHUNK_STEPS = 64           # the kernel's kSteps: time steps a tile of its copy ring
SLAB_CHANNELS = 32         # the kernel's kSlab: channels a CTA, one a lane
MAX_BATCH = 65535          # grid.y
counter = LaunchCounter()


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, on any device: the sequential float32
    recurrence of ``ref.linear_scan`` (one step at a time along axis -2), a
    multiply and an add, each rounded: the kernel's order exactly."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    out = torch.empty(b.shape, dtype=torch.float32, device=b.device)
    h = torch.zeros(b.shape[:-2] + b.shape[-1:], dtype=torch.float32, device=b.device)
    for t in range(b.shape[-2]):
        h = a[..., t, :] * h + b[..., t, :]
        out[..., t, :] = h
    return out


def chunks(t: int) -> int:
    """Time tiles the kernel's copy ring cuts T steps into: a function of T
    alone."""
    return -(-t // CHUNK_STEPS)


def grid(batch: int, n: int) -> tuple[int, int]:
    """The kernel's grid, (channel slabs, batch rows): one CTA a slab of
    SLAB_CHANNELS channels of one batch row, a function of the shape alone."""
    return -(-n // SLAB_CHANNELS), batch


def copy_bytes(n: int, strides: tuple[int, ...], addresses: tuple[int, ...]) -> int:
    """Bytes a cp.async of the kernel moves: 16 where N and every stride (in
    floats) are multiples of 4 and every base address is 16-byte aligned,
    else 4."""
    vec = n % 4 == 0 and all(s % 4 == 0 for s in strides) and all(p % 16 == 0 for p in addresses)
    return 16 if vec else 4


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b float32 (T, N) or (B, T, N), the channel axis contiguous, any
    batch and time strides → h, float32 of the same shape, contiguous."""
    if a.shape != b.shape or a.dim() not in (2, 3):
        raise ValueError(f"linear_scan: need a and b of one shape, (T, N) or (B, T, N), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if on_cpu("linear_scan", a, b):
        return linear_scan_plain(a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"linear_scan: need float32, got {a.dtype} and {b.dtype}")
    a3, b3 = (a, b) if a.dim() == 3 else (a[None], b[None])
    batch, t, n = a3.shape
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if a3.numel() == 0:
        return out
    if a3.stride(2) != 1 or b3.stride(2) != 1:
        raise ValueError("linear_scan: the channel axis must be contiguous")
    if batch > MAX_BATCH or n >= 2 ** 31:
        raise ValueError(f"linear_scan: at most {MAX_BATCH} batch rows and 2^31 - 1 "
                         f"channels, got {tuple(a3.shape)}")
    strides = (a3.stride(0), a3.stride(1), b3.stride(0), b3.stride(1))
    vec = copy_bytes(n, strides, (a3.data_ptr(), b3.data_ptr()))
    lib = _build.library()
    with on_device(a):
        rc = lib.repro_linear_scan(a3.data_ptr(), b3.data_ptr(), out.data_ptr(), batch, t, n,
                                   *strides, vec, cuda_stream(a))
    _build.check(rc, "linear_scan")
    counter.bump()
    return out
