"""Architecture config schema + input-shape sets.

One ``ArchConfig`` per assigned architecture lives in a sibling module; each
exposes ``CONFIG`` (full size) and ``smoke_config()`` (reduced,
CPU-runnable).  ``repro_torch.configs.registry`` maps ``--arch <id>`` to
them.  A copy of the JAX package's ``configs/`` (data only).

``pattern`` describes the repeating layer superblock; a stack is
``n_layers // len(pattern)`` scanned repeats plus an unrolled tail.
Block kinds: attn (global causal) · local (windowed causal) · cross
(attends to modality memory) · rglru (Griffin recurrent) · rwkv (RWKV6
time-mix; pairs with channel-mix MLP) · dec (whisper decoder layer:
self-attn + cross-attn + MLP).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 ⇒ d_model // n_heads
    qkv_bias: bool = False
    pattern: tuple = ("attn",)
    window: Optional[int] = None     # local-attention span
    mlp: str = "swiglu"              # swiglu | gelu | moe | rwkv_cmix
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    use_rope: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 16             # group-local dispatch (GShard groups)
    # modality stubs
    cross_memory_len: int = 0        # vlm patch / whisper frame count
    encoder_layers: int = 0          # whisper encoder depth
    # recurrent
    rnn_width: int = 0               # rglru (0 ⇒ d_model)
    rwkv_head_dim: int = 64
    rwkv_chunked: bool = False       # chunked linear-attention path (§Perf)
    # execution
    attn_impl: str = "auto"          # auto | xla | chunked | pallas
    remat: bool = True
    remat_policy: str = "nothing"    # nothing | dots (save matmul outputs:
                                     # no fwd-psum re-execution in bwd)
    scan_layers: bool = True         # False ⇒ python-loop (probe compiles)
    train_microbatches: int = 1      # grad-accumulation chunks per step
    sharding_mode: str = "auto"      # auto | tp | fsdp  (weight layout policy)
    optimizer: str = "adamw"         # adamw | adafactor
    tie_embeddings: bool = False
    sub_quadratic: bool = False      # eligible for long_500k
    param_dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def rnn_width_(self) -> int:
        return self.rnn_width or self.d_model

    def repeats_and_tail(self) -> tuple[int, int]:
        p = len(self.pattern)
        return self.n_layers // p, self.n_layers % p

    # ---- analytic parameter counts (roofline MODEL_FLOPS) -----------------
    def _block_params(self, kind: str) -> tuple[int, int]:
        """(total, active-per-token) parameters of one block of ``kind``."""
        d, hd = self.d_model, self.head_dim_
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv * hd) * 2
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv) * hd
        if self.mlp == "moe":
            mlp = self.n_experts * (3 * d * self.d_ff) + d * self.n_experts
            mlp_active = self.top_k * (3 * d * self.d_ff) + d * self.n_experts
        elif self.mlp == "gelu":
            mlp = mlp_active = 2 * d * self.d_ff + self.d_ff + d
        elif self.mlp == "rwkv_cmix":
            mlp = mlp_active = d * self.d_ff * 2 + d * d
        else:
            mlp = mlp_active = 3 * d * self.d_ff
        norms = 2 * d
        if kind in ("attn", "local", "cross"):
            core = attn
        elif kind == "dec":
            core = 2 * attn
            norms = 3 * d
        elif kind == "rglru":
            dr = self.rnn_width_
            core = 2 * d * dr + 2 * dr * dr + 4 * dr + dr * d
        else:  # rwkv time-mix
            core = 5 * d * d + d * 64 + 5 * d
        return core + mlp + norms, core + mlp_active + norms

    def param_count(self) -> tuple[int, int]:
        """(total, active-per-token) parameter counts."""
        total = active = 0
        for li in range(self.n_layers):
            kind = self.pattern[li % len(self.pattern)]
            t, a = self._block_params(kind)
            total += t
            active += a
        emb = self.vocab * self.d_model
        total += emb + self.d_model
        active += emb + self.d_model
        if not self.tie_embeddings:
            total += emb
            active += emb
        if self.encoder_layers:
            enc_t, _ = self._block_params("attn")
            total += self.encoder_layers * enc_t
            active += self.encoder_layers * enc_t
        return total, active


# -----------------------------------------------------------------------------
# the assigned input-shape sets (LM family)
# -----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) — see DESIGN.md §Arch-applicability."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k dense KV per layer out of scope"
    return True, ""
