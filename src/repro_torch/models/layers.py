"""Shared neural layers (plain functions on tensors, dict params).

Conventions, as in the reference (``repro/models/layers.py``):
  * params are nested dicts of tensors; init fns take an explicit
    ``torch.Generator`` (its device is where the weights are made)
  * compute dtype is bf16 by default with f32 norms/softmax/logits
  * weight matrices are stored (in_dim, out_dim), so the reference's
    arrays convert with no transpose
  * the norms, RoPE and the MLPs each run in a ``core.trace.scope`` span
    (``norm``, ``rope``, ``mlp``), a profiler range while one records; the
    rmsnorm kernel launches in ``norm`` itself, under no span of its own
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import trace
from ..kernels import ops as kops

DEFAULT_PARAM_DTYPE = torch.bfloat16


# -----------------------------------------------------------------------------
# init helpers: the reference's distributions (normal in f32, then the
# parameter dtype); the values differ from jax.random's
# -----------------------------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=DEFAULT_PARAM_DTYPE, scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=DEFAULT_PARAM_DTYPE) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * 0.02).to(dtype)


# -----------------------------------------------------------------------------
# norms
# -----------------------------------------------------------------------------
def rmsnorm_init(dim: int, device, dtype=torch.float32) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The float32 chain on CPU and meta tensors, the one-pass kernel on the
    card (``kernels/rms_norm.py``), run directly inside this ``norm`` span."""
    with trace.scope("norm", "model"):
        return kops.rmsnorm(x, params["scale"], eps)


def layernorm_init(dim: int, device, dtype=torch.float32) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    with trace.scope("norm", "model"):
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
        return out.to(x.dtype)


# -----------------------------------------------------------------------------
# rotary position embeddings
# -----------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: (..., S)."""
    with trace.scope("rope", "model"):
        d = x.shape[-1]
        half = d // 2
        freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
        angles = positions[..., :, None].float() * freq              # (..., S, half)
        cos = torch.cos(angles)[..., :, None, :]                     # (..., S, 1, half)
        sin = torch.sin(angles)[..., :, None, :]
        xf1, xf2 = x[..., :half].float(), x[..., half:].float()
        out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
        return out.to(x.dtype)


# -----------------------------------------------------------------------------
# MLPs (plain matmuls: the reference leaves them to XLA, outside any kernel)
# -----------------------------------------------------------------------------
def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=DEFAULT_PARAM_DTYPE) -> dict:
    return {"w_gate": dense_init(gen, d_model, d_ff, dtype),
            "w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype)}


def swiglu_ffn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU itself, in its caller's span (an MoE's shared experts)."""
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ params["w_down"]


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    with trace.scope("mlp", "model"):
        return swiglu_ffn(params, x)


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=DEFAULT_PARAM_DTYPE) -> dict:
    return {"w_up": dense_init(gen, d_model, d_ff, dtype),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
            "w_down": dense_init(gen, d_ff, d_model, dtype),
            "b_down": torch.zeros((d_model,), dtype=dtype, device=gen.device)}


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    with trace.scope("mlp", "model"):
        h = x @ params["w_up"] + params["b_up"]
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)   # jax.nn.gelu's default
        return h @ params["w_down"] + params["b_down"]


# -----------------------------------------------------------------------------
# embedding / unembedding
# -----------------------------------------------------------------------------
def embed(params: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return params[tokens]


def unembed(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (V, d)^T → (..., V) logits in f32."""
    return x.float() @ params.float().t()


# -----------------------------------------------------------------------------
# losses
# -----------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None, z_loss: float = 1e-4) -> torch.Tensor:
    """Next-token cross entropy with optional z-loss; logits (..., V) f32,
    labels (...) integer (widened to int64 for the gather), mask (...) or
    None → the scalar mean over the mask (at least 1)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * logz ** 2
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = math.prod(labels.shape)
    return nll.sum() / denom
