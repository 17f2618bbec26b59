"""recurrentgemma-9b [hybrid] — 38L d4096 16H (GQA kv=1, MQA) ff12288
vocab 256000.  RG-LRU + local attention, 1 attention per 2 recurrent
(Griffin pattern rec,rec,attn); local window 2048.  [arXiv:2402.19427]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                   # 12×(rglru,rglru,local) + (rglru, rglru)
    d_model=4096,
    n_heads=16,
    n_kv=1,
    d_ff=12288,
    vocab=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    mlp="gelu",                    # Griffin uses GeGLU; gelu-MLP stands in
    rnn_width=4096,
    sub_quadratic=True,
    tie_embeddings=True,
    optimizer="adafactor",         # 256k vocab embedding dominates state
    train_microbatches=4,
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv=1, head_dim=16,
        d_ff=128, vocab=256, rnn_width=64, window=8)
