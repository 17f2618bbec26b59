"""Recurrent blocks: RG-LRU (RecurrentGemma / Griffin), as the reference's
``repro/models/recurrent.py``.

RG-LRU keeps a diagonal state: h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t),
with a_t data-dependent through the recurrence gate.  The forward runs the
recurrence through ``kernels.ops.linear_scan`` (K5: the CUDA kernel on a
CUDA tensor, its plain version on the CPU), one call for the whole batch
where the reference vmaps over it.  Decode carries the state (h and the
convolution's last inputs) explicitly and steps it once a token, written in
place.

RWKV6 (Finch) and its channel mix are not ported yet (ROADMAP M10e).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers
from ..kernels import ops as kops

_C_RGLRU = 8.0


# =============================================================================
# RG-LRU (RecurrentGemma)
# =============================================================================
def rglru_block_init(gen: torch.Generator, d_model: int, d_rnn: int, conv_width: int = 4,
                     dtype=layers.DEFAULT_PARAM_DTYPE) -> dict:
    dev = gen.device
    conv = torch.randn((conv_width, d_rnn), generator=gen, dtype=torch.float32, device=dev)
    return {
        "w_x": layers.dense_init(gen, d_model, d_rnn, dtype),
        "w_gate_branch": layers.dense_init(gen, d_model, d_rnn, dtype),
        "conv": (conv * 0.02).to(dtype),
        "w_input_gate": layers.dense_init(gen, d_rnn, d_rnn, dtype),
        "w_rec_gate": layers.dense_init(gen, d_rnn, d_rnn, dtype),
        # Λ: the reference's np.linspace, computed in float64, stored float32
        "lam": torch.linspace(2.0, 5.0, d_rnn, dtype=torch.float64, device=dev).float(),
        "w_out": layers.dense_init(gen, d_rnn, d_model, dtype),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,C), w (W,C) depthwise causal conv: the taps summed in float32
    in tap order, rounded once to x's dtype."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + pad[:, i:i + s].float() * w[i].float()
    return out.to(x.dtype)


def _rglru_coeffs(params: dict, u: torch.Tensor):
    """u (B,S,dr) → recurrence coefficients a, b (f32): the gate matmuls in
    u's dtype, sigmoid / softplus / exp in float32."""
    uf = u.float()
    r = torch.sigmoid((u @ params["w_rec_gate"]).float())
    i = torch.sigmoid((u @ params["w_input_gate"]).float())
    log_a = -_C_RGLRU * r * F.softplus(params["lam"])
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * (i * uf)
    return a, b


def rglru_block(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Griffin recurrent block: conv → RG-LRU, gated by a GeLU branch."""
    u = x @ params["w_x"]
    gate = F.gelu((x @ params["w_gate_branch"]).float(), approximate="tanh")
    u = _causal_conv1d(u, params["conv"])
    a, b = _rglru_coeffs(params, u)
    h = kops.linear_scan(a, b)                                  # (B,S,dr) f32
    return (h * gate).to(x.dtype) @ params["w_out"]


def rglru_decode_init(batch: int, d_rnn: int, device, conv_width: int = 4) -> dict:
    return {"h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
            "conv_buf": torch.zeros((batch, conv_width - 1, d_rnn), dtype=torch.bfloat16,
                                    device=device)}


def rglru_decode(params: dict, x: torch.Tensor, state: dict):
    """x (B,1,d) single step → (out (B,1,d), state).  Unlike the reference,
    the state's tensors are written in place (the same dict comes back).
    The convolution's last position over the W buffered inputs sums its
    taps as the forward's does."""
    u = x @ params["w_x"]
    gate = F.gelu((x @ params["w_gate_branch"]).float(), approximate="tanh")
    buf = torch.cat([state["conv_buf"].to(u.dtype), u], dim=1)         # (B,W,dr)
    a, b = _rglru_coeffs(params, _causal_conv1d(buf, params["conv"])[:, -1:])
    h = a[:, 0] * state["h"] + b[:, 0]
    out = (h[:, None] * gate).to(x.dtype) @ params["w_out"]
    state["h"].copy_(h)
    state["conv_buf"].copy_(buf[:, 1:])
    return out, state


# =============================================================================
# RWKV6 (Finch): not ported yet
# =============================================================================
def _unported(*_args, **_kwargs):
    raise NotImplementedError("RWKV6 time-mix and channel-mix are not ported yet "
                              "(ROADMAP M10e)")


rwkv6_block_init = rwkv6_block = rwkv6_chunked = _unported
rwkv6_decode_init = rwkv6_decode = rwkv_cmix_init = rwkv_cmix = _unported
