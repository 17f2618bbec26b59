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

Gradient: ``linear_scan`` is a ``torch.autograd.Function``.  The JAX
package writes no backward kernel (its training differentiates
``ref.linear_scan``'s ``lax.scan``); here the backward is the same
recurrence reversed in time (``linear_scan_backward``):
``linear_scan_backward_plain`` on CPU tensors, and on CUDA tensors one
launch of the kernel's reverse walk (``repro_linear_scan_bwd``), both equal
to autograd through ``linear_scan_plain`` bit for bit, a zero's sign aside.
``counter.routes`` counts the launches by direction, "fwd" and "bwd".

On meta tensors (the dry-run) nothing runs: the forward charges 2 FLOPs and
3 x 4 bytes an element (a and b read, h written), the backward 3 FLOPs and
5 x 4 bytes (a, g and h read, both gradients written), and each returns
empty meta results.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._util import LaunchCounter, charge, cuda_stream, on_cpu, on_device, on_meta

__all__ = ["linear_scan", "linear_scan_plain", "linear_scan_backward",
           "linear_scan_backward_plain", "counter", "chunks", "grid", "copy_bytes",
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


def linear_scan_backward_plain(a: torch.Tensor, g: torch.Tensor,
                               h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, on any device: with g the
    gradient of h = linear_scan(a, b), the recurrence reversed in time,
    dh_t = g_t + a_{t+1} dh_{t+1} (dh_{T-1} = g_{T-1}), grad_b = dh and
    grad_a_t = dh_t h_{t-1} (h_{-1} = 0), each product and sum rounded once:
    the gradients autograd gives through ``linear_scan_plain``, bit for bit
    but for the sign of a zero (autograd sums the per-step slices of a
    gradient, which turns grad_a's -0 at t = 0 into +0; ``torch.equal``
    holds).  → (grad_a, grad_b), float32."""
    a, g, h = a.to(torch.float32), g.to(torch.float32), h.to(torch.float32)
    grad_a = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    grad_b = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    steps = h.shape[-2]
    dh = None
    for t in range(steps - 1, -1, -1):
        dh = g[..., t, :].clone() if dh is None else g[..., t, :] + a[..., t + 1, :] * dh
        grad_b[..., t, :] = dh
        grad_a[..., t, :] = dh * h[..., t - 1, :] if t else dh * torch.zeros_like(dh)
    return grad_a, grad_b


def _batched(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return tuple(t if t.dim() == 3 else t[None] for t in tensors)


def _strides(*tensors: torch.Tensor) -> tuple[int, ...]:
    return tuple(s for t in tensors for s in (t.stride(0), t.stride(1)))


def _check_launch(a3: torch.Tensor, *others: torch.Tensor) -> None:
    batch, _, n = a3.shape
    if any(t.stride(2) != 1 for t in (a3,) + others):
        raise ValueError("linear_scan: the channel axis must be contiguous")
    if batch > MAX_BATCH or n >= 2 ** 31:
        raise ValueError(f"linear_scan: at most {MAX_BATCH} batch rows and 2^31 - 1 "
                         f"channels, got {tuple(a3.shape)}")


def _walk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The forward kernel, one launch (route "fwd")."""
    a3, b3 = _batched(a, b)
    batch, t, n = a3.shape
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if a3.numel() == 0:
        return out
    _check_launch(a3, b3)
    strides = _strides(a3, b3)
    vec = copy_bytes(n, strides, (a3.data_ptr(), b3.data_ptr()))
    lib = _build.library()
    with on_device(a):
        rc = lib.repro_linear_scan(a3.data_ptr(), b3.data_ptr(), out.data_ptr(), batch, t, n,
                                   *strides, vec, cuda_stream(a))
    _build.check(rc, "linear_scan")
    counter.bump("fwd")
    return out


def linear_scan_backward(a: torch.Tensor, g: torch.Tensor,
                         h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(grad_a, grad_b) of h = linear_scan(a, b) given g, the gradient of
    h: ``linear_scan_backward_plain`` on CPU tensors, else the backward
    kernel, one launch (route "bwd"): the forward's walk reversed in
    time."""
    if on_meta("linear_scan", a, g, h):
        charge("linear_scan", 3 * h.numel(), 5 * 4 * h.numel())
        return (torch.empty(h.shape, dtype=torch.float32, device="meta"),
                torch.empty(h.shape, dtype=torch.float32, device="meta"))
    if on_cpu("linear_scan", a, g, h):
        return linear_scan_backward_plain(a, g, h)
    if g.stride(-1) != 1:
        g = g.contiguous()          # e.g. the expanded gradient of a sum
    a3, g3, h3 = _batched(a, g, h)
    batch, t, n = a3.shape
    grad_a = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    grad_b = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    if a3.numel() == 0:
        return grad_a, grad_b
    _check_launch(a3, g3, h3)
    strides = _strides(a3, g3, h3)
    vec = copy_bytes(n, strides, (a3.data_ptr(), g3.data_ptr(), h3.data_ptr()))
    lib = _build.library()
    with on_device(a):
        rc = lib.repro_linear_scan_bwd(a3.data_ptr(), g3.data_ptr(), h3.data_ptr(),
                                       grad_a.data_ptr(), grad_b.data_ptr(), batch, t, n,
                                       *strides, vec, cuda_stream(a))
    _build.check(rc, "linear_scan backward")
    counter.bump("bwd")
    return grad_a, grad_b


class _LinearScan(torch.autograd.Function):
    """h = linear_scan(a, b) with its gradient: the plain versions on CPU
    tensors, the two kernels on CUDA tensors."""

    @staticmethod
    def forward(ctx, a, b):
        if a.is_meta:
            charge("linear_scan", 2 * a.numel(), 3 * 4 * a.numel())
            h = torch.empty(a.shape, dtype=torch.float32, device="meta")
        else:
            h = linear_scan_plain(a, b) if a.device.type == "cpu" else _walk(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return linear_scan_backward(a, g, h)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b float32 (T, N) or (B, T, N), the channel axis contiguous, any
    batch and time strides → h, float32 of the same shape, contiguous;
    differentiable in a and b (the backward is one launch on CUDA)."""
    if a.shape != b.shape or a.dim() not in (2, 3):
        raise ValueError(f"linear_scan: need a and b of one shape, (T, N) or (B, T, N), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if on_meta("linear_scan", a, b):
        return _LinearScan.apply(a, b)
    if not on_cpu("linear_scan", a, b) and (a.dtype != torch.float32
                                            or b.dtype != torch.float32):
        raise ValueError(f"linear_scan: need float32, got {a.dtype} and {b.dtype}")
    return _LinearScan.apply(a, b)
