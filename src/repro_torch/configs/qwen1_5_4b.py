"""qwen1.5-4b [dense] — 40L d2560 20H (kv=20, MHA) ff6912 vocab 151936,
QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv=20,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    pattern=("attn",),
    mlp="swiglu",
    train_microbatches=2,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256)
