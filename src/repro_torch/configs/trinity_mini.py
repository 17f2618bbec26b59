"""trinity-mini [moe] — 32L d2048 32H (GQA kv=4, head_dim 128) vocab 200192.
Arcee's AFMoE (26B-A3B): three sliding-window layers (window 2048, RoPE)
then one full-attention layer (no positions), eight times; two leading
dense SwiGLU layers (ff 6144), then 30 MoE layers of 128 experts (ff 1024),
8 a token by sigmoid scores with an expert bias that selects but does not
weigh, the 8 weights normalised and scaled by 2.826, beside one shared
expert; QK-norm and a sigmoid output gate in every attention, sandwich
norms (each sublayer's output normed before the residual add), RMSNorm eps
1e-5, the embedding scaled by sqrt(d) (muP), untied.
[hf:arcee-ai/Trinity-Mini config.json]

Not one of the JAX package's configs: ``AfmoeConfig`` adds the settings
the others lack as fields of its own, so ``dataclasses.asdict`` of the
ten is unchanged, and the registry lists it beside ``ARCH_IDS``."""
from __future__ import annotations

import dataclasses

from .base import ArchConfig


@dataclasses.dataclass(frozen=True)
class AfmoeConfig(ArchConfig):
    n_dense_layers: int = 2          # leading SwiGLU layers, width d_ff_dense
    d_ff_dense: int = 6144
    n_shared_experts: int = 1        # each of width d_ff, beside the routed ones
    route_scale: float = 2.826       # the normalised routed weights' scale
    moe_dispatch: str = "dropless"   # sigmoid scores, biased top-k, every route computed
    qk_norm: bool = True             # RMSNorm of each q and k head
    attn_gate: bool = True           # attention output · σ(x Wg), before Wo
    sandwich_norm: bool = True       # RMSNorm of each sublayer's output
    rope_global: bool = False        # RoPE on local layers only (full: NoPE)
    norm_eps: float = 1e-5

    def _mlp_params(self, dense: bool) -> tuple[int, int]:
        d = self.d_model
        if dense:
            return 3 * d * self.d_ff_dense, 3 * d * self.d_ff_dense
        expert = 3 * d * self.d_ff
        shared = self.n_shared_experts * expert
        return (self.n_experts * expert + shared + d * self.n_experts,
                self.top_k * expert + shared + d * self.n_experts)

    def param_count(self) -> tuple[int, int]:
        """(total, active-per-token): attention with its gate, the norms
        (two sandwich pairs a layer, QK-norm scales), the dense and MoE
        layers (router and expert bias included), both embeddings."""
        d, hd = self.d_model, self.head_dim_
        attn = 3 * d * self.n_heads * hd + 2 * d * self.n_kv * hd + 2 * hd
        total = active = 0
        for i in range(self.n_layers):
            t, a = self._mlp_params(i < self.n_dense_layers)
            bias = 0 if i < self.n_dense_layers else self.n_experts
            total += attn + t + 4 * d + bias
            active += attn + a + 4 * d + bias
        emb = 2 * self.vocab * d + d
        return total + emb, active + emb


CONFIG = AfmoeConfig(
    name="trinity-mini",
    family="moe",
    n_layers=32,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    d_ff=1024,
    vocab=200192,
    head_dim=128,
    pattern=("local", "local", "local", "attn"),
    window=2048,
    mlp="moe",
    n_experts=128,
    top_k=8,
    optimizer="adafactor",
)


def smoke_config() -> AfmoeConfig:
    """One whole period, one leading dense layer, 16 experts top-4, a
    window of 16; d 64 (the benchmark's cut cell scales its embedding by
    sqrt(64))."""
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=32,
        vocab=512, window=16, n_dense_layers=1, d_ff_dense=128, n_experts=16, top_k=4)
