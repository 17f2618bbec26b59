"""Plain PyTorch versions of the ported kernels, under the reference's
names (``repro/kernels/ref.py``).  The CPU path of every wrapper runs these,
and the chip check compares each CUDA kernel with them."""
from __future__ import annotations

from .block_transpose import block_transpose_plain as transpose
from .decode_attention import decode_attention_plain as decode_attention
from .onehot_encode import onehot_encode_plain as onehot_encode
from .segment_reduce import segment_reduce_plain as segment_reduce
from .window_scan import window_scan_plain as window_scan

__all__ = ["transpose", "segment_reduce", "window_scan", "onehot_encode",
           "decode_attention"]
