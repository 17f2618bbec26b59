"""Shared helpers for the kernel wrappers: storage-dtype widening at the
kernel boundary, device dispatch checks, launch counters, the folding of a
tensor's axes into one stride, and the analytic charge a wrapper makes on
meta tensors.

**Meta tensors** (the dry-run, ``launch/dryrun.py``) reach a kernel's
wrapper with shapes and no data.  No kernel launches and no plain version
runs: the plain version would count what the kernel never does (K6's S x S
probabilities).  The wrapper of K5, K6 or K7 returns an empty meta result
of its output's shape and ``charge``s the kernel's analytic FLOPs and bytes
(the counts of ``PERF.md``'s bound column) to the accounting that is
active, if any (``launch/hlo_analysis.analyze``).  The other kernels are on
no path the dry-run drives, and ``on_cpu`` refuses meta tensors for them
as it refuses any device but the CPU and CUDA.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading

import torch

__all__ = ["widen_for_kernel", "narrow_from_kernel", "on_cpu", "on_meta", "on_device",
           "cuda_stream", "refuse_grad", "LaunchCounter", "charge", "charging", "fold_axes"]


# The kernels move float32 and int32 words; bools and narrow ints are widened
# at the wrapper boundary and narrowed back after.
def widen_for_kernel(x: torch.Tensor) -> tuple[torch.Tensor, torch.dtype]:
    orig = x.dtype
    if x.dtype in (torch.bool, torch.int8, torch.int16):
        return x.to(torch.int32), orig
    if x.dtype == torch.float64:
        return x.to(torch.float32), orig
    return x, orig


def narrow_from_kernel(x: torch.Tensor, orig: torch.dtype) -> torch.Tensor:
    if x.dtype != orig:
        return x.to(orig)
    return x


def fold_axes(sizes: tuple[int, ...], strides: tuple[int, ...]) -> tuple[int, int | None] | None:
    """(count, stride) of axes taken as one, the last fastest: the product of
    their sizes and the stride of the innermost axis of size > 1 (None where
    there is none); None where they do not fold into one stride."""
    count, step, expect = 1, None, None
    for size, st in zip(reversed(sizes), reversed(strides)):
        if size == 1:
            continue
        if step is None:
            step = st
        elif st != expect:
            return None
        expect = st * size
        count *= size
    return count, step


def on_cpu(kernel: str, *tensors: torch.Tensor) -> bool:
    """Device dispatch for a kernel wrapper: True when every tensor lies on
    the CPU (the plain version runs), False when every tensor lies on one
    CUDA device (the kernel runs).  Anything else raises — there is no
    fallback from a CUDA tensor to the plain version.  Meta tensors take
    the analytic branch (``on_meta``) of K5, K6 and K7 before this is asked,
    and raise here in the other wrappers."""
    first = tensors[0]
    if first.is_cuda:
        dev = first.get_device()
        if all(t.is_cuda and t.get_device() == dev for t in tensors[1:]):
            return False
    elif all(t.device.type == "cpu" for t in tensors):
        return True
    raise ValueError(f"{kernel}: tensors must all be on the CPU or all on one "
                     f"CUDA device, got {sorted(str(t.device) for t in tensors)}")


def on_meta(kernel: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is a meta tensor (the wrapper returns an empty
    meta result and ``charge``s its counts); otherwise False, and a mix of
    devices is left to ``on_cpu``, which raises."""
    return all(t.is_meta for t in tensors)


# the accounting a meta call charges: a callable (kernel, flops, nbytes), or None
_CHARGE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_kernel_charge",
                                                         default=None)


@contextlib.contextmanager
def charging(sink):
    """Route the meta calls' ``charge``s to ``sink(kernel, flops, nbytes)``
    while active."""
    token = _CHARGE.set(sink)
    try:
        yield
    finally:
        _CHARGE.reset(token)


def charge(kernel: str, flops: float, nbytes: float) -> None:
    """A kernel's analytic FLOPs and bytes for one meta call, to the active
    accounting (none: nothing is recorded)."""
    sink = _CHARGE.get()
    if sink is not None:
        sink(kernel, float(flops), float(nbytes))


def refuse_grad(kernel: str, tag: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel without a backward would be recorded for one:
    grad mode on and an input requiring grad, on any device.  The kernel
    fills its output through ctypes, which autograd cannot see, so on the
    card the gradient would be lost without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} ({tag}) has no backward, in this port or in the JAX package; "
            "training takes the einsum attention paths (attn_impl 'xla' or 'chunked', "
            "which 'auto' picks for the loss)")


_SAME_DEVICE = contextlib.nullcontext()


def on_device(t: torch.Tensor):
    """The context a launch runs in: ``torch.cuda.device`` of ``t``'s device
    where that is not the current one, else nothing to enter."""
    dev = t.get_device()
    if dev == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(dev)


def cuda_stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the raw handle (no
    ``torch.cuda.Stream`` object is built).  The launch itself runs under
    ``on_device(t)``, so the stream and the runtime's current device
    agree."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


class LaunchCounter:
    """Counts kernel launches, and per route where a wrapper has more than
    one kernel.  Pool threads launch concurrently, so the increment is under
    a lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches = 0
        self.routes: dict[str, int] = {}

    def bump(self, route: str | None = None) -> None:
        with self._lock:
            self.launches += 1
            if route is not None:
                self.routes[route] = self.routes.get(route, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.routes = {}
