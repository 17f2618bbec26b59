"""The weights of an AFMoE decoder LM (``configs/trinity-mini.json``), made
on the card from the seed.

Matrices are bf16, the type they are served in (the router too), laid out
(in, out), the experts' stacked (E, in, out), each normal with std
1/sqrt(fan_in): cut as views out of one flat buffer a fan-in, each filled
by ``normal_`` calls of 2^30 elements on a card generator.  The embedding
and the unembedding are 0.02 N(0, 1).  RMSNorm scales (the QK-norm's too)
are float32, 1 + 0.05 N(0, 1); the expert bias is float32, 0.02 N(0, 1).
The names are the reference's (``reference/afmoe_lm.py``).
"""
from __future__ import annotations

import math

import torch

from .harness import seed_ints

_CHUNK = 1 << 30     # elements a fill call, inside 32-bit indexing
_EMBED, _SCALE, _BIAS = "embed", "scale", "bias"


def shapes(cfg: dict) -> dict:
    """{name: (shape, group)}: a matrix's group is its fan-in; the others
    are ``_EMBED``, ``_SCALE`` (norm scales) and ``_BIAS`` (expert bias)."""
    d, v, hd = cfg["hidden_size"], cfg["vocab_size"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    ff, f, e = cfg["intermediate_size"], cfg["moe_intermediate_size"], cfg["num_experts"]
    fs = cfg["num_shared_experts"] * f
    out = {"embed": ((v, d), _EMBED), "unembed": ((v, d), _EMBED), "final_norm": ((d,), _SCALE)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        for n in ("ln1", "ln1_post", "ln2", "ln2_post"):
            out[p + n] = ((d,), _SCALE)
        out.update({p + "q_norm": ((hd,), _SCALE), p + "k_norm": ((hd,), _SCALE),
                    p + "wq": ((d, hq), d), p + "wk": ((d, hkv), d), p + "wv": ((d, hkv), d),
                    p + "wg": ((d, hq), d), p + "wo": ((hq, d), hq)})
        if i < cfg["num_dense_layers"]:
            out.update({p + "w_gate": ((d, ff), d), p + "w_up": ((d, ff), d),
                        p + "w_down": ((ff, d), ff)})
            continue
        out.update({p + "router": ((d, e), d), p + "expert_bias": ((e,), _BIAS),
                    p + "experts.w_gate": ((e, d, f), d), p + "experts.w_up": ((e, d, f), d),
                    p + "experts.w_down": ((e, f, d), f),
                    p + "shared.w_gate": ((d, fs), d), p + "shared.w_up": ((d, fs), d),
                    p + "shared.w_down": ((fs, d), fs)})
    return out


def make(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_ints(seed, 2)[1])
    spec = shapes(cfg)
    groups = [g for g in (_EMBED, _SCALE, _BIAS) if any(s[1] == g for s in spec.values())]
    groups += sorted({g for _, g in spec.values() if isinstance(g, int)})
    out = {}
    for group in groups:
        names = [n for n, (_, g) in spec.items() if g == group]
        sizes = [math.prod(spec[n][0]) for n in names]
        if group in (_SCALE, _BIAS):
            flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
            if group == _SCALE:
                flat.normal_(0.0, 0.05, generator=gen).add_(1.0)
            else:
                flat.normal_(0.0, 0.02, generator=gen)
        else:
            std = 0.02 if group == _EMBED else 1 / math.sqrt(group)
            flat = torch.empty(sum(sizes), dtype=torch.bfloat16, device=device)
            for chunk in flat.split(_CHUNK):
                chunk.normal_(0.0, std, generator=gen)
        for n, part in zip(names, torch.split(flat, sizes)):
            out[n] = part.view(spec[n][0])
    return out


def program_tree(w: dict, cfg: dict) -> dict:
    """The same tensors in repro_torch's parameter tree (no copies)."""
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        layer = {n: {"scale": w[p + n]} for n in ("ln1", "ln1_post", "ln2", "ln2_post")}
        layer["attn"] = {k: w[p + k] for k in ("wq", "wk", "wv", "wo", "wg")}
        layer["attn"].update(q_norm={"scale": w[p + "q_norm"]}, k_norm={"scale": w[p + "k_norm"]})
        if i < cfg["num_dense_layers"]:
            layer["mlp"] = {k: w[p + k] for k in ("w_gate", "w_up", "w_down")}
        else:
            mlp = {k: w[p + "experts." + k] for k in ("w_gate", "w_up", "w_down")}
            mlp.update(router=w[p + "router"], expert_bias=w[p + "expert_bias"],
                       shared={k: w[p + "shared." + k] for k in ("w_gate", "w_up", "w_down")})
            layer["mlp"] = mlp
        layers.append(layer)
    return {"embed": w["embed"], "unembed": w["unembed"],
            "final_norm": {"scale": w["final_norm"]}, "layers": layers}
