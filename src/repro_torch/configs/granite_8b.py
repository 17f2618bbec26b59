"""granite-8b [dense] — 36L d4096 32H (GQA kv=8) ff14336 vocab 49152.
Llama-architecture, code model.  [arXiv:2405.04324; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=49152,
    pattern=("attn",),
    mlp="swiglu",
    train_microbatches=2,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256)
