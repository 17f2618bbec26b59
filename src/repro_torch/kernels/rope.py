"""Rotary position embedding (rotate-half) of q or k, out = x rotated pair by
pair, pair i of x's first and second halves by the angle pos · θ^(−i / half),
in x's dtype, computed in float32: the RoPE of the model zoo's attention
(``models/layers.rope``, q then k in every RoPE layer).

``rope`` dispatches on the device of its tensors: CPU tensors and meta
tensors (the dry-run, whose accounting counts the plain version's operators)
take the plain PyTorch version below, the chain ``layers.rope`` ran before
the kernel; tensors on one CUDA device take the hand-written kernel in
``csrc/rope.cu`` (one launch: x read once, the rotation written once, each
(token, pair)'s cos and sin computed once for all its heads; see the note there),
or raise on what it does not take; a mix of devices raises.  The kernel
equals the plain version bit for bit: the same float32 frequencies (the
chain's own expression, computed once per (half, θ, device) and kept), the
same roundings.  It replaces no TPU kernel: the JAX package leaves RoPE to
XLA's fusion.

Shapes: x (..., S, H, D), bfloat16 or float32, D even, its last axis
contiguous and its axes before the heads folding into one token stride (a
contiguous tensor, or a view of one that keeps whole rows, is read in place;
the heads keep a stride of their own); positions (..., S), any integer dtype,
broadcasting to x's (..., S) (a prefill's ``arange(S).expand(B, S)``, a decode
step's ``length[:, None]``); D / 2 at most ``MAX_THREADS`` pieces.  → (..., S,
H, D) in x's dtype, contiguous.

Gradient: on CUDA tensors that autograd records, a
``torch.autograd.Function`` whose backward is the same kernel rotating by
−angle: equal, bit for bit, to autograd's gradient through ``rope_plain``.
A remat path that re-runs the forward launches the kernel again.
"""
from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from . import _build
from ._util import LaunchCounter, cuda_stream, fold_axes, on_cpu, on_device, on_meta
from .rms_norm import chunk_elems

__all__ = ["rope", "rope_plain", "launch_shape", "layout", "piece_elems", "frequencies",
           "counter", "MAX_THREADS"]

MAX_THREADS = 256         # the kernel's kMaxThreads: threads a CTA
_DTYPES = (torch.bfloat16, torch.float32)
_FREQ: dict = {}
counter = LaunchCounter()


def rope_plain(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Plain PyTorch version, on any device: the float32 chain, each
    operator rounded to float32, the result cast to x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freq              # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]                     # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def frequencies(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """θ^(−i / half) for i < half in float32, by ``rope_plain``'s own
    expression on ``device``; made once and kept."""
    key = (half, float(theta), device)
    freq = _FREQ.get(key)
    if freq is None:
        freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)
        _FREQ[key] = freq
    return freq


def launch_shape(tokens: int, pieces: int) -> tuple[int, int]:
    """(tokens a CTA, threads a CTA): a thread a piece of a token, as many
    tokens a CTA as fit MAX_THREADS threads, threads rounded up to a warp.
    A function of tokens and pieces alone."""
    if pieces > MAX_THREADS:
        raise ValueError(f"rope: {pieces} pieces a half-row is past the kernel's {MAX_THREADS}")
    per_cta = max(1, min(tokens, MAX_THREADS // pieces))
    return per_cta, -(-per_cta * pieces // 32) * 32


def layout(shape: tuple[int, ...], strides: tuple[int, ...]) -> tuple[int, int, int]:
    """(tokens, token stride, head stride) in elements of x (..., S, H, D):
    its axes before the heads taken as one; a stride that no axis of size
    > 1 has is 0.  Raises where those axes do not fold into one stride or
    the last axis is not contiguous."""
    if len(shape) < 3 or shape[-1] % 2:
        raise ValueError(f"rope: need x (..., S, H, D) with D even, got {tuple(shape)}")
    if shape[-1] > 1 and strides[-1] != 1:
        raise ValueError("rope: the last axis must be contiguous")
    folded = fold_axes(shape[:-2], strides[:-2])
    if folded is None:
        raise ValueError(f"rope: the axes before the heads of a {tuple(shape)} tensor with "
                         f"strides {tuple(strides)} do not fold into one token stride")
    return folded[0], folded[1] or 0, strides[-2] if shape[-2] > 1 else 0


def piece_elems(dtype: torch.dtype, half: int, x_tok: int, x_head: int,
                addresses: tuple[int, ...]) -> int:
    """Elements a thread's piece moves: 16 bytes' worth where half, both
    strides and every base address allow it, else one."""
    return chunk_elems(dtype, half, math.gcd(x_tok, x_head), addresses)


def _positions(positions: torch.Tensor, lead: torch.Size) -> tuple[torch.Tensor, int, int]:
    """(positions as int32 or int64 of x's (..., S), the stride of their
    leading axes taken as one, the stride of S)."""
    if positions.is_floating_point() or positions.is_complex() or positions.dtype == torch.bool:
        raise ValueError(f"rope: positions must be integers, got {positions.dtype}")
    try:
        p = positions.expand(lead)
    except RuntimeError:
        raise ValueError(f"rope: positions {tuple(positions.shape)} do not broadcast to x's "
                         f"(..., S) {tuple(lead)}") from None
    if p.dtype not in (torch.int32, torch.int64):
        p = p.to(torch.int64)
    folded = fold_axes(tuple(p.shape[:-1]), p.stride()[:-1])
    if folded is None:
        p = p.contiguous()
        folded = fold_axes(tuple(p.shape[:-1]), p.stride()[:-1])
    return p, folded[1] or 0, p.stride(-1)


def _launch(x: torch.Tensor, positions: torch.Tensor, theta: float,
            inverse: bool = False) -> torch.Tensor:
    """The kernel, one launch; ``inverse`` rotates by −angle."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"rope: x must be bfloat16 or float32, got {x.dtype}")
    tokens, x_tok, x_head = layout(tuple(x.shape), x.stride())
    p, p_lead, p_seq = _positions(positions, x.shape[:-2])
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    heads, half = x.shape[-2], x.shape[-1] // 2
    vec = piece_elems(x.dtype, half, x_tok, x_head, (x.data_ptr(), out.data_ptr()))
    per_cta, threads = launch_shape(tokens, half // vec)
    freq = frequencies(half, theta, x.device)
    lib = _build.library()
    with on_device(x):
        rc = lib.repro_rope(x.data_ptr(), p.data_ptr(), freq.data_ptr(), out.data_ptr(), tokens,
                            heads, half, x_tok, x_head, p.shape[-1], p_lead, p_seq,
                            int(x.dtype == torch.bfloat16), int(p.dtype == torch.int64), vec,
                            per_cta, threads, int(inverse), cuda_stream(x))
    _build.check(rc, "rope")
    counter.bump("bwd" if inverse else "fwd")
    return out


class _Rope(torch.autograd.Function):
    """The kernel forward; the backward is the kernel rotating the gradient
    by −angle."""

    @staticmethod
    def forward(ctx, x, positions, theta):
        ctx.theta = theta
        ctx.save_for_backward(positions)
        return _launch(x, positions, theta)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (positions,) = ctx.saved_tensors
        return _launch(g.contiguous(), positions, ctx.theta, inverse=True), None, None


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S) → x rotated in x's dtype;
    differentiable in x."""
    if on_meta("rope", x, positions) or on_cpu("rope", x, positions):
        return rope_plain(x, positions, theta)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rope.apply(x, positions, theta)
    # Function.apply costs host time even with nothing to record (12.7 us a
    # call), two calls a RoPE layer in prefills the host nearly paces
    return _launch(x, positions, theta)
