"""The weights of a dense decoder LM, made on the card from the seed.

Matrices are bf16, the type they are served in, laid out (in, out), and cut
as views out of three flat buffers, one a standard deviation, each filled by
``normal_`` calls of 2^30 elements on a card generator: 1/sqrt(hidden) for every matrix
that reads the hidden state (q, k, v, o, gate, up), 1/sqrt(intermediate)
for the down projections, 0.02 for the embedding and the unembedding.  Norm
scales are float32, 1 + 0.05 N(0, 1), one call.  The names are the
reference's (``reference/dense_lm.py``).
"""
from __future__ import annotations

import math

import torch

from .cost import head_dim
from .harness import seed_ints

_CHUNK = 1 << 30     # elements a fill call, inside 32-bit indexing


def shapes(cfg: dict) -> dict:
    """{name: (shape, group)}; group 0 std 1/sqrt(hidden), 1 the down
    projections, 2 the embeddings, 3 the norm scales."""
    d, ff, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hq = cfg["num_attention_heads"] * head_dim(cfg)
    hkv = cfg["num_key_value_heads"] * head_dim(cfg)
    out = {"embed": ((v, d), 2), "unembed": ((v, d), 2), "final_norm": ((d,), 3)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        out.update({p + "ln1": ((d,), 3), p + "ln2": ((d,), 3),
                    p + "wq": ((d, hq), 0), p + "wk": ((d, hkv), 0), p + "wv": ((d, hkv), 0),
                    p + "wo": ((hq, d), 0), p + "w_gate": ((d, ff), 0), p + "w_up": ((d, ff), 0),
                    p + "w_down": ((ff, d), 1)})
    return out


def make(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_ints(seed, 2)[1])
    spec = shapes(cfg)
    std = {0: 1 / math.sqrt(cfg["hidden_size"]), 1: 1 / math.sqrt(cfg["intermediate_size"]),
           2: 0.02}
    out = {}
    for group in (0, 1, 2, 3):
        names = [n for n, (_, g) in spec.items() if g == group]
        sizes = [math.prod(spec[n][0]) for n in names]
        if group == 3:
            flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
            flat.normal_(0.0, 0.05, generator=gen).add_(1.0)
        else:
            flat = torch.empty(sum(sizes), dtype=torch.bfloat16, device=device)
            for chunk in flat.split(_CHUNK):
                chunk.normal_(0.0, std[group], generator=gen)
        for n, part in zip(names, torch.split(flat, sizes)):
            out[n] = part.view(spec[n][0])
    return out


def program_tree(w: dict, cfg: dict) -> dict:
    """The same tensors in repro_torch's parameter tree (no copies)."""
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        layers.append({"ln1": {"scale": w[p + "ln1"]}, "ln2": {"scale": w[p + "ln2"]},
                       "attn": {k: w[p + k] for k in ("wq", "wk", "wv", "wo")},
                       "mlp": {k: w[p + k] for k in ("w_gate", "w_up", "w_down")}})
    return {"embed": w["embed"], "unembed": w["unembed"],
            "final_norm": {"scale": w["final_norm"]}, "layers": layers}
