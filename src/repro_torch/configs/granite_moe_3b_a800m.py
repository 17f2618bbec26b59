"""granite-moe-3b-a800m [moe] — 32L d1536 24H (GQA kv=8) expert-ff 512
vocab 49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv=8,
    d_ff=512,
    vocab=49155,
    pattern=("attn",),
    mlp="moe",
    n_experts=40,
    top_k=8,
    tie_embeddings=True,          # granite MoE ties embeddings
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=48, n_heads=4, n_kv=2, head_dim=12,
        d_ff=64, vocab=128, n_experts=5, top_k=2)
