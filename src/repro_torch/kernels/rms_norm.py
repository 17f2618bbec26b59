"""RMSNorm of the last axis, out = (x · rsqrt(mean(x²) + eps)) · scale in x's
dtype, computed in float32: the norm of the model zoo's ``rmsnorm``
configurations (``models/layers.rmsnorm``).

``rmsnorm`` dispatches on the device of its tensors: CPU tensors and meta
tensors (the dry-run, whose accounting counts the plain version's operators)
take the plain PyTorch version below; tensors on one CUDA device take the
hand-written kernel in ``csrc/rms_norm.cu`` (one launch, one CTA a row, the
row held in registers between its sum of squares and its scaling; see the
note there), or raise on what it does not take; a mix of devices raises.
The kernel replaces no TPU kernel: the JAX package leaves the norm to XLA's
fusion.

Shapes: x (..., d), bfloat16 or float32, its last axis contiguous and its
leading axes folding into one row stride (a contiguous tensor, or
``x[:, -1]`` of one, is read in place); scale (d,) float32; d from 1 to
``MAX_D``.  → (..., d) in x's dtype, contiguous.

Gradient: on CUDA tensors that autograd records, a
``torch.autograd.Function`` whose backward recomputes ``rmsnorm_plain`` from
the saved x and scale and differentiates it with autograd: the gradients
autograd gives through the plain chain (the JAX package has no backward
kernel for the norm either).  A remat path that re-runs the forward launches
the kernel again.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._util import LaunchCounter, cuda_stream, fold_axes, on_cpu, on_device, on_meta

__all__ = ["rmsnorm", "rmsnorm_plain", "launch_shape", "chunk_elems", "rows_and_stride",
           "counter", "MAX_D"]

MAX_THREADS = 1024        # the kernel's kMaxThreads: threads a CTA
MAX_HELD = 32             # the kernel's kMaxHeld: floats of its row a thread holds
MAX_D = MAX_THREADS * MAX_HELD
MAX_ROWS = 2 ** 31 - 1    # grid.x
# Under two CTAs an SM of the H100's 132, each row is spread over up to 1,024
# threads; with more rows, over about 256, so that more CTAs share an SM.
FEW_ROWS = 264
_VEC = {torch.bfloat16: 8, torch.float32: 4}    # elements of one 16-byte load
counter = LaunchCounter()


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch version, on any device: the float32 chain, each
    operator rounded to float32, the result cast to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale
    return out.to(x.dtype)


def rows_and_stride(shape: tuple[int, ...], strides: tuple[int, ...]) -> tuple[int, int]:
    """(rows, row stride in elements) of a tensor's leading axes taken as
    one; raises where they do not fold into one stride."""
    folded = fold_axes(shape[:-1], strides[:-1])
    if folded is None:
        raise ValueError(f"rmsnorm: the leading axes of a {tuple(shape)} tensor with "
                         f"strides {tuple(strides)} do not fold into one row stride")
    rows, step = folded
    return rows, shape[-1] if step is None else step


def chunk_elems(dtype: torch.dtype, d: int, stride: int, addresses: tuple[int, ...]) -> int:
    """Elements a thread's load moves: 16 bytes' worth where d, the row
    stride and every base address allow it, else one."""
    vec = _VEC[dtype]
    if d % vec == 0 and stride % vec == 0 and all(p % 16 == 0 for p in addresses):
        return vec
    return 1


def launch_shape(rows: int, d: int, vec: int) -> tuple[int, int]:
    """(chunks a thread K, threads a CTA): K the fewest of 1, 2, 4, ... for
    which the row's d / vec chunks need at most 256 threads (1,024 under
    FEW_ROWS rows), with K · vec at most MAX_HELD; threads rounded up to a
    warp.  A function of rows, d and vec alone."""
    chunks = d // vec
    cap = MAX_THREADS if rows < FEW_ROWS else 256
    k = 1
    while -(-chunks // k) > cap and k * vec < MAX_HELD:
        k *= 2
    threads = -(-chunks // k)
    if threads > MAX_THREADS:
        raise ValueError(f"rmsnorm: d = {d} is past the kernel's {MAX_D}")
    return k, -(-threads // 32) * 32


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel, one launch."""
    if x.dtype not in _VEC:
        raise ValueError(f"rmsnorm: x must be bfloat16 or float32, got {x.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"rmsnorm: scale must be float32, got {scale.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if d == 0 or d > MAX_D or scale.shape != (d,):
        raise ValueError(f"rmsnorm: need x (..., d) with 1 <= d <= {MAX_D} and scale (d,), "
                         f"got {tuple(x.shape)} and {tuple(scale.shape)}")
    if d > 1 and x.stride(-1) != 1:
        raise ValueError("rmsnorm: the last axis must be contiguous")
    rows, stride = rows_and_stride(tuple(x.shape), tuple(x.stride()))
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    if rows > MAX_ROWS:
        raise ValueError(f"rmsnorm: at most {MAX_ROWS} rows, got {rows}")
    scale = scale.contiguous()
    vec = chunk_elems(x.dtype, d, stride, (x.data_ptr(), scale.data_ptr(), out.data_ptr()))
    k, threads = launch_shape(rows, d, vec)
    lib = _build.library()
    with on_device(x):
        rc = lib.repro_rms_norm(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                                stride, int(x.dtype == torch.bfloat16), vec, k, threads,
                                float(eps), cuda_stream(x))
    _build.check(rc, "rmsnorm")
    counter.bump()
    return out


class _RMSNorm(torch.autograd.Function):
    """The kernel forward; the backward is autograd's through
    ``rmsnorm_plain``, recomputed from the saved x and scale."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return _launch(x, scale, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        want = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w) for t, w in zip((x, scale), want)]
            out = rmsnorm_plain(leaves[0], leaves[1], ctx.eps)
            grads = iter(torch.autograd.grad(out, [t for t, w in zip(leaves, want) if w], g))
        return tuple(next(grads) if w else None for w in want) + (None,)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,) → x's RMSNorm in x's dtype; differentiable in
    x and scale."""
    if on_meta("rmsnorm", x, scale) or on_cpu("rmsnorm", x, scale):
        return rmsnorm_plain(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    # Function.apply adds host time even with nothing to record (12.7 us a
    # call against 0.1 us on an x86 core), 65 calls a prefill whose short
    # batches the host nearly paces
    return _launch(x, scale, eps)
