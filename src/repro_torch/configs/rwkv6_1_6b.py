"""rwkv6-1.6b (Finch) [ssm] — 24L d2048 attention-free, cmix-ff 7168,
vocab 65536.  Data-dependent decay time-mixing + channel mixing.
[arXiv:2404.05892]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                 # heads = d_model / rwkv_head_dim
    n_kv=32,
    d_ff=7168,
    vocab=65536,
    pattern=("rwkv",),
    mlp="rwkv_cmix",
    rwkv_head_dim=64,
    use_rope=False,
    norm="layernorm",
    sub_quadratic=True,
    tie_embeddings=False,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=96,
        vocab=256, rwkv_head_dim=16)
