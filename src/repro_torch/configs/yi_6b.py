"""yi-6b [dense] — 32L d4096 32H (GQA kv=4) ff11008 vocab 64000.
Llama-architecture GQA.  [arXiv:2403.04652; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=4,
    d_ff=11008,
    vocab=64000,
    pattern=("attn",),
    mlp="swiglu",
    train_microbatches=2,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256)
