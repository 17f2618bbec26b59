"""One-hot encoding — ``get_dummies``.

``onehot_encode`` dispatches on the device of its tensor: a CPU tensor takes
the plain PyTorch version below, a CUDA tensor the hand-written kernel in
``csrc/onehot_encode.cu``, which replaces the TPU kernel
``repro/kernels/onehot_encode.py:_onehot_padded``.  Code -1, or any code
outside [0, G), gives an all-zero row.
"""
from __future__ import annotations

import torch

from . import _build
from ._util import LaunchCounter, cuda_stream, on_cpu

__all__ = ["onehot_encode", "onehot_encode_plain", "counter"]

counter = LaunchCounter()


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
    out = torch.empty((m, g), dtype=torch.float32, device=codes.device)
    if m == 0 or g == 0:
        return out
    codes = codes.contiguous()
    lib = _build.library()
    with torch.cuda.device(codes.device):
        rc = lib.repro_onehot_encode(codes.data_ptr(), out.data_ptr(), m, g,
                                     cuda_stream(codes))
    _build.check(rc, "onehot_encode")
    counter.bump()
    return out
