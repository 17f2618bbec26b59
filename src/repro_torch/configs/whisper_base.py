"""whisper-base [audio] — 6L enc + 6L dec, d512 8H ff2048 vocab 51865.
Encoder–decoder; conv audio frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (B, 1500, d).  Assigned shapes are honored
mechanically on the decoder (real whisper caps decoder context at 448 —
noted in DESIGN.md).  [arXiv:2212.04356]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                  # decoder depth
    d_model=512,
    n_heads=8,
    n_kv=8,
    d_ff=2048,
    vocab=51865,
    pattern=("dec",),
    mlp="gelu",
    norm="layernorm",
    use_rope=False,              # sinusoidal positions
    encoder_layers=6,
    cross_memory_len=1500,       # 30 s of audio at 50 Hz after the conv stub
)


def smoke_config() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
        vocab=256, encoder_layers=2, cross_memory_len=16)
