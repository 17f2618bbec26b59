"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H (GQA kv=4) expert-ff 1536
vocab 151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,                 # qwen3 uses explicit head_dim 128
    pattern=("attn",),
    mlp="moe",
    n_experts=128,
    top_k=8,
    optimizer="adafactor",        # AdamW f32 states don't fit 235B on 256 chips
    attn_impl="auto",
    train_microbatches=8,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=96, vocab=256, n_experts=8, top_k=2)
