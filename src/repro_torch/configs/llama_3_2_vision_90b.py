"""llama-3.2-vision-90b [vlm] — 100L d8192 64H (GQA kv=8) ff28672 vocab 128256.
Cross-attention image layers every 5th layer; vision frontend is a STUB
(``input_specs()`` provides precomputed patch embeddings (B, 1600, d)).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=28672,
    vocab=128256,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    mlp="swiglu",
    cross_memory_len=1600,
    optimizer="adafactor",
    train_microbatches=8,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256, cross_memory_len=16)
