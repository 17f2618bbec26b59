"""Hand-written Hopper (sm_90a) CUDA kernels for the engine's hot operators
and the LM's forward and decode steps, each beside its plain PyTorch
version:

  segment_reduce — GROUPBY partial aggregation
  block_transpose — TRANSPOSE's per-block transpose
  onehot_encode  — get_dummies
  window_scan    — WINDOW's ordered scans (cumsum / cummax / cummin / cumprod)
  linear_scan    — the RG-LRU recurrence h_t = a_t * h_{t-1} + b_t
  flash_attention — the forward / prefill pass's causal and windowed attention
  decode_attention — one decode token's GQA attention over the KV cache
  rms_norm       — the model zoo's RMSNorm (no TPU counterpart)
  rope           — the model zoo's rotary position embedding of q and k (no TPU
                   counterpart)

``ops`` is the engine-facing surface; ``ref`` holds the plain versions.  The
kernels build on first launch (``_build``), never at import.
"""
from . import ops, ref  # noqa: F401
