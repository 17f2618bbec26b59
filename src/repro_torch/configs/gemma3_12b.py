"""gemma3-12b [dense] — 48L d3840 16H (GQA kv=8) ff15360 vocab 262144.
5:1 local:global attention, 128k context; local window 1024.
[hf:google/gemma-3-1b-pt; unverified]

Runs ``long_500k``: decode cost is O(window) on the 40 local layers and
O(S) only on the 8 global layers — sub-quadratic in aggregate (see
DESIGN.md §Arch-applicability for the global-layer KV caveat)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv=8,
    d_ff=15360,
    vocab=262144,
    head_dim=256,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    mlp="swiglu",                # gemma uses GeGLU; swiglu stands in
    tie_embeddings=True,
    sub_quadratic=True,
    optimizer="adafactor",       # 262k-vocab embedding
    train_microbatches=4,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256, window=8)
