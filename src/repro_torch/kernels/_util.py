"""Shared helpers for the kernel wrappers: storage-dtype widening at the
kernel boundary, device dispatch checks, and launch counters."""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["widen_for_kernel", "narrow_from_kernel", "on_cpu", "on_device", "cuda_stream",
           "LaunchCounter"]


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


def on_cpu(kernel: str, *tensors: torch.Tensor) -> bool:
    """Device dispatch for a kernel wrapper: True when every tensor lies on
    the CPU (the plain version runs), False when every tensor lies on one
    CUDA device (the kernel runs).  Anything else raises — there is no
    fallback from a CUDA tensor to the plain version."""
    first = tensors[0]
    if first.is_cuda:
        dev = first.get_device()
        if all(t.is_cuda and t.get_device() == dev for t in tensors[1:]):
            return False
    elif all(t.device.type == "cpu" for t in tensors):
        return True
    raise ValueError(f"{kernel}: tensors must all be on the CPU or all on one "
                     f"CUDA device, got {sorted(str(t.device) for t in tensors)}")


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
