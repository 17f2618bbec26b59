"""Recurrent blocks: RG-LRU (RecurrentGemma / Griffin) and RWKV6 (Finch), as
the reference's ``repro/models/recurrent.py``.

RG-LRU keeps a diagonal state: h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t),
with a_t data-dependent through the recurrence gate.  The forward runs the
recurrence through ``kernels.ops.linear_scan`` (K5: the CUDA kernel on a
CUDA tensor, its plain version on the CPU), one call for the whole batch
where the reference vmaps over it.  Decode carries the state (h and the
convolution's last inputs) explicitly and steps it once a token, written in
place.

RWKV6 keeps a matrix state per head: S_t = diag(w_t) S_{t-1} + kᵀ_t v_t,
with a data-dependent decay w_t and a current-token bonus u.  No kernel lies
on its path, in either package (the reference scans with ``lax.scan``): the
forward is a Python loop over time (``rwkv6_block``) or over chunks of 64
(``rwkv6_chunked``), in float32, and decode steps the state in place.
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
# RWKV6 (Finch)
# =============================================================================
def rwkv6_block_init(gen: torch.Generator, d_model: int, head_dim: int = 64,
                     dtype=layers.DEFAULT_PARAM_DTYPE) -> dict:
    """The time-mix's parameters.  d_model must be a multiple of head_dim:
    the reference builds a tree for any width and fails at its first
    forward, in a reshape; the port refuses at init."""
    if head_dim <= 0 or d_model % head_dim:
        raise ValueError(f"rwkv6: d_model {d_model} is not a multiple of head_dim {head_dim}")
    n_heads, lowrank, dev = d_model // head_dim, 32, gen.device

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * scale

    return {
        "mu": normal((5, d_model), 0.02),
        "w_r": layers.dense_init(gen, d_model, d_model, dtype),
        "w_k": layers.dense_init(gen, d_model, d_model, dtype),
        "w_v": layers.dense_init(gen, d_model, d_model, dtype),
        "w_g": layers.dense_init(gen, d_model, d_model, dtype),
        "w_o": layers.dense_init(gen, d_model, d_model, dtype),
        # data-dependent decay: low-rank ddlerp (Finch's token-shift decay)
        "decay_a": layers.dense_init(gen, d_model, lowrank, torch.float32),
        "decay_b": layers.dense_init(gen, lowrank, d_model, torch.float32),
        # the reference's np.linspace, computed in float64, stored float32
        "decay_base": torch.linspace(-6.0, -0.5, d_model, dtype=torch.float64,
                                     device=dev).float(),
        "bonus": normal((n_heads, head_dim), 0.02),
        "ln_out": layers.layernorm_init(d_model, dev),
    }


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) → the previous token's row at each position, 0 at the
    first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _rwkv6_inputs(params: dict, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shift mixes current with previous token (Finch ddlerp, simplified
    to static per-projection mix weights mu[0..4] for r, k, v, g, w): the
    mixes in float32, rounded to x's dtype for the projections."""
    mu = params["mu"]
    xr, xk, xv, xg, xw = ((x * (1 - mu[i]) + x_prev * mu[i]).to(x.dtype) for i in range(5))
    r, k, v = xr @ params["w_r"], xk @ params["w_k"], xv @ params["w_v"]
    g = F.silu((xg @ params["w_g"]).float())
    dd = torch.tanh(xw.float() @ params["decay_a"]) @ params["decay_b"]
    w = torch.exp(-torch.exp(params["decay_base"] + dd))          # (B,S,d) ∈ (0,1)
    return r, k, v, g, w


def _heads(t: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    return t.reshape(*t.shape[:-1], h, hd).float()


def _rwkv6_out(params: dict, out: torch.Tensor, g: torch.Tensor, dtype) -> torch.Tensor:
    """The heads' output (B,S,d) f32 → LayerNorm, the gate, W_o."""
    return (layers.layernorm(params["ln_out"], out) * g).to(dtype) @ params["w_o"]


def rwkv6_block(params: dict, x: torch.Tensor, *, head_dim: int = 64) -> torch.Tensor:
    """Time-mixing with matrix state, the sequential scan over time in
    float32: S_t = diag(w_t) S_{t-1} + kᵀ_t v_t, out_t = r_t (S_{t-1} + u ⊙
    kᵀ_t v_t)."""
    b, s, d = x.shape
    h = d // head_dim
    r, k, v, g, w = _rwkv6_inputs(params, x, _shift(x))
    rh, kh, vh, wh = (_heads(t, h, head_dim) for t in (r, k, v, w))
    u = params["bonus"][None, :, :, None]                         # (1,H,Dk,1)
    S = torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32, device=x.device)
    outs = []
    for t in range(s):
        kv = kh[:, t, :, :, None] * vh[:, t, :, None, :]          # (B,H,Dk,Dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", rh[:, t], S + u * kv))
        S = wh[:, t, :, :, None] * S + kv
    out = torch.stack(outs, 1).reshape(b, s, d)
    return _rwkv6_out(params, out, g, x.dtype)


def rwkv6_chunked(params: dict, x: torch.Tensor, *, head_dim: int = 64,
                  chunk: int = 64) -> torch.Tensor:
    """Chunked linear-attention formulation: O(T/c) steps of matmuls instead
    of O(T) elementwise steps, with the decay as a within-chunk cumulative
    sum of log w.  Not bit-equal to ``rwkv6_block`` (nor is the
    reference's)."""
    b, s, d = x.shape
    h = d // head_dim
    pad = (-s) % chunk
    xp = F.pad(x, (0, 0, 0, pad))
    sp = s + pad
    r, k, v, g, w = _rwkv6_inputs(params, xp, _shift(xp))
    nch = sp // chunk
    rs, ks, vs, ws = (t.reshape(b, nch, chunk, h, head_dim).float() for t in (r, k, v, w))
    u = params["bonus"]

    logw = torch.log(torch.clamp(ws, min=1e-12))
    cum = torch.cumsum(logw, dim=2)                                # within-chunk cumulative
    total = cum[:, :, -1]                                          # (B,N,H,Dk)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=x.device), -1)

    S = torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32, device=x.device)
    outs = []
    for c in range(nch):
        rc, kc, vc, lwc, cumc = rs[:, c], ks[:, c], vs[:, c], logw[:, c], cum[:, c]
        totc = total[:, c]
        # inter-chunk: r_t decayed against the state entering the chunk
        r_dec = rc * torch.exp(cumc - lwc)                         # r_t ⊙ Πw_{≤t-1}
        inter = torch.einsum("bthk,bhkv->bthv", r_dec, S)
        # intra-chunk: pairs j < t with decay Πw_{j+1..t-1}
        k_dec = kc * torch.exp(-cumc)                              # k_j / Πw_{≤j}
        att = torch.einsum("bthk,bjhk->bhtj", r_dec, k_dec) * tri[None, None]
        intra = torch.einsum("bhtj,bjhv->bthv", att, vc)
        # current-token bonus
        bonus = torch.einsum("bthk,hk,bthk->bth", rc, u, kc)
        outs.append(inter + intra + bonus[..., None] * vc)
        # state update: S' = diag(Πw_chunk) S + Σ_j (Πw_{j+1..end}) kᵀv
        k_tail = kc * torch.exp(totc[:, None] - cumc)              # Πw_{j+1..end}
        S = torch.exp(totc)[..., None] * S + torch.einsum("bjhk,bjhv->bhkv", k_tail, vc)
    out = torch.stack(outs, 1).reshape(b, sp, d)[:, :s]
    return _rwkv6_out(params, out, g[:, :s], x.dtype)


def rwkv_cmix_init(gen: torch.Generator, d_model: int, d_ff: int,
                   dtype=layers.DEFAULT_PARAM_DTYPE) -> dict:
    """RWKV6 channel-mixing (replaces the MLP in rwkv blocks)."""
    mu = torch.randn((2, d_model), generator=gen, dtype=torch.float32, device=gen.device)
    return {"mu": mu * 0.02,
            "w_k": layers.dense_init(gen, d_model, d_ff, dtype),
            "w_v": layers.dense_init(gen, d_ff, d_model, dtype),
            "w_r": layers.dense_init(gen, d_model, d_model, dtype)}


def rwkv_cmix(params: dict, x: torch.Tensor,
              x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """out = σ(W_r x_r) ⊙ W_v(relu(W_k x_k)²), with token-shift mixes."""
    if x_prev is None:
        x_prev = _shift(x)
    mu = params["mu"]
    xk = (x * (1 - mu[0]) + x_prev * mu[0]).to(x.dtype)
    xr = (x * (1 - mu[1]) + x_prev * mu[1]).to(x.dtype)
    k = torch.square(F.relu((xk @ params["w_k"]).float())).to(x.dtype)
    r = torch.sigmoid((xr @ params["w_r"]).float())
    return (r * (k @ params["w_v"]).float()).to(x.dtype)


def rwkv6_decode_init(batch: int, d_model: int, device, head_dim: int = 64) -> dict:
    h = d_model // head_dim
    return {"S": torch.zeros((batch, h, head_dim, head_dim), dtype=torch.float32, device=device),
            "x_prev": torch.zeros((batch, d_model), dtype=torch.bfloat16, device=device)}


def rwkv6_decode(params: dict, x: torch.Tensor, state: dict, *, head_dim: int = 64):
    """x (B,1,d) one step → (out (B,1,d), state), the state written in place
    (the same dict comes back), as ``rglru_decode``."""
    b, _, d = x.shape
    h = d // head_dim
    r, k, v, g, w = _rwkv6_inputs(params, x, state["x_prev"][:, None].to(x.dtype))
    rt, kt, vt, wt = (t.reshape(b, h, head_dim).float() for t in (r, k, v, w))
    kv = kt[..., None] * vt[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rt, state["S"] + params["bonus"][None, :, :, None] * kv)
    state["S"].copy_(wt[..., None] * state["S"] + kv)
    state["x_prev"].copy_(x[:, 0])
    return _rwkv6_out(params, out.reshape(b, 1, d), g, x.dtype), state
