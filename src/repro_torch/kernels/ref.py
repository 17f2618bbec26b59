"""Plain PyTorch versions of the ported kernels, under the reference's
names (``repro/kernels/ref.py``).  The CPU path of every wrapper runs these,
and the chip check compares each CUDA kernel with them."""
from __future__ import annotations

from .block_transpose import block_transpose_plain as transpose
from .decode_attention import decode_attention_plain as decode_attention
from .flash_attention import flash_attention_plain as flash_attention
from .linear_scan import linear_scan_plain as linear_scan
from .onehot_encode import onehot_encode_plain as onehot_encode
from .segment_reduce import segment_reduce_plain as segment_reduce
from .window_scan import window_scan_plain as window_scan

__all__ = ["transpose", "segment_reduce", "window_scan", "linear_scan", "onehot_encode",
           "flash_attention", "decode_attention"]
