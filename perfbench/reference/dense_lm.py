"""Plain PyTorch reference of a dense decoder LM (GQA, RoPE, RMSNorm,
SwiGLU), in float32 with TF32 off, one layer at a time.

It runs the configuration file's equations, with its
``program_departures`` applied over the published values as the program
applies them, and with the weights the benchmark made
(``perfbench/weights.py``'s names and layout: matrices (in, out)):

    x = embed[tokens] * embedding_multiplier   (1 where the file states none)
    each layer:  h = rms(x) * ln1;  q, k, v = h Wq, h Wk, h Wv
                 q, k = rope(q), rope(k)   (rotate-half, theta = rope_theta)
                 x = x + softmax(q k^T / sqrt(head_dim), causal) v  Wo
                 h = rms(x) * ln2;  x = x + (silu(h Wg) * (h Wu)) Wd
    logits = (rms(x) * final_norm) unembed^T

with rms(x) = x / sqrt(mean(x^2) + rms_norm_eps) and query head j reading
KV head j // (heads / kv_heads).  The control computes every matrix product
of the layers and the unembedding from fp8 (e4m3) operands: weights scaled
per output channel, activations per token.

Readings: ``logit_err`` (the largest |program - reference| over the last
position's logits of the checked prefill batches) and ``top_gap`` (how far
the reference's logit of the program's top token lies below the
reference's best).
"""
from __future__ import annotations

import contextlib
import math

import torch

_F8 = torch.float8_e4m3fn
_F8_MAX = 448.0
_Q_ROWS = 1024


@contextlib.contextmanager
def _full_float32():
    """TF32 off for the block; flags already off are left untouched, so the
    process's settings come back as they were."""
    on = [f for f in (torch.backends.cuda.matmul, torch.backends.cudnn) if f.allow_tf32]
    for f in on:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f in on:
            f.allow_tf32 = True


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale a slice along ``dim``, back in f32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / _F8_MAX
    return (x / s).to(_F8).to(torch.float32) * s


def _mm(x: torch.Tensor, w: torch.Tensor, low: bool) -> torch.Tensor:
    """x (T, in) @ w (in, out) in float32; with ``low`` from fp8 operands."""
    w = w.float()
    if low:
        return _fp8(x, 1) @ _fp8(w, 0)
    return x @ w


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _rope(x, pos, theta):
    """x (T, H, D), rotate-half with frequencies theta^(-i / (D/2))."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = (pos.double()[:, None] * freq)[:, None, :]
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def _attention(q, k, v, groups: int):
    """Causal attention; q (T, H, D), k and v (T, KV, D); query rows in
    blocks."""
    t, h, d = q.shape
    k = k.repeat_interleave(groups, 1)
    v = v.repeat_interleave(groups, 1)
    out = torch.empty_like(q)
    kpos = torch.arange(t, device=q.device)
    for r0 in range(0, t, _Q_ROWS):
        qi = q[r0:r0 + _Q_ROWS]
        s = torch.einsum("qhd,khd->hqk", qi, k) / math.sqrt(d)
        qpos = torch.arange(r0, r0 + qi.shape[0], device=q.device)
        s = s.masked_fill(kpos[None, None, :] > qpos[None, :, None], float("-inf"))
        out[r0:r0 + _Q_ROWS] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    return out


def equations(cfg: dict) -> dict:
    """The configuration as it runs: the published values with the
    program's stated departures applied."""
    return {"embedding_multiplier": 1.0, **cfg, **cfg.get("program_departures", {})}


def logits_at(weights: dict, cfg: dict, tokens: torch.Tensor, rows, low: bool = False):
    """Reference logits (len(rows), vocab) of one sequence ``tokens`` (T,)
    at positions ``rows``."""
    cfg = equations(cfg)
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["hidden_size"]
    hd = d // h
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    with torch.no_grad(), _full_float32():
        tokens = tokens.long()
        t = tokens.shape[0]
        pos = torch.arange(t, device=tokens.device)
        x = weights["embed"][tokens].float() * cfg["embedding_multiplier"]
        for i in range(cfg["num_hidden_layers"]):
            p = f"layers.{i}."
            a = _rms(x, weights[p + "ln1"], eps)
            q = _rope(_mm(a, weights[p + "wq"], low).view(t, h, hd), pos, theta)
            k = _rope(_mm(a, weights[p + "wk"], low).view(t, kv, hd), pos, theta)
            v = _mm(a, weights[p + "wv"], low).view(t, kv, hd)
            o = _attention(q, k, v, h // kv).reshape(t, h * hd)
            x = x + _mm(o, weights[p + "wo"], low)
            a = _rms(x, weights[p + "ln2"], eps)
            g = torch.nn.functional.silu(_mm(a, weights[p + "w_gate"], low))
            x = x + _mm(g * _mm(a, weights[p + "w_up"], low), weights[p + "w_down"], low)
        x = _rms(x[torch.as_tensor(rows, device=x.device)], weights["final_norm"], eps)
        return _mm(x, weights["unembed"].t(), low)


def _prefill(payload, cfg, low: bool) -> dict:
    err = gap = 0.0
    for tokens, got in payload["batches"]:
        for b in range(tokens.shape[0]):
            s = tokens.shape[1]
            ref = logits_at(payload["weights"], cfg, tokens[b], [s - 1])[0]
            have = logits_at(payload["weights"], cfg, tokens[b], [s - 1], low=True)[0] \
                if low else got[b].float()
            err = max(err, float((have - ref).abs().max()))
            gap = max(gap, float(ref.max() - ref[have.argmax()]))
    return {"logit_err": err, "top_gap": gap}


def readings(payload: dict, config: dict, traffic: dict) -> dict:
    return _prefill(payload, config, low=False)


def control(payload: dict, config: dict, traffic: dict) -> dict:
    return _prefill(payload, config, low=True)
