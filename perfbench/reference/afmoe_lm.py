"""Plain PyTorch reference of an AFMoE decoder LM (Arcee's Trinity: sliding
and full gated attention with QK-norm, sandwich norms, leading dense
layers, then sigmoid-routed experts beside a shared expert), in float32
with TF32 off, one layer at a time.

It runs the configuration file's equations with the weights the benchmark
made (``perfbench/weights_afmoe.py``'s names and layout: matrices (in,
out), the experts' stacked (E, in, out)):

    x = embed[tokens] * embedding_multiplier   (sqrt(hidden_size) unless the
                                                file's departures state one)
    layer l (sliding where layer_types[l] says so, else full):
      h = rms(x) ln1
      q = rms_head(h Wq) q_norm,  k = rms_head(h Wk) k_norm,  v = h Wv
      sliding: q, k = rope(q), rope(k)   (rotate-half, theta = rope_theta);
      full: no positions
      a = softmax(q k^T / sqrt(head_dim), causal; sliding: key j visible to
          query i iff i - j < sliding_window) v
      x = x + rms((a * sigmoid(h Wg)) Wo) ln1_post
      u = rms(x) ln2
      m = swiglu(u) (intermediate_size) for l < num_dense_layers, else moe(u)
      x = x + rms(m) ln2_post
    logits = (rms(x) final_norm) unembed^T

    moe(u): s = sigmoid(u Wr) (E scores);  E_u = the num_experts_per_tok
            largest of s + expert_bias (ties to the lower index: the bias
            selects, it does not weigh);
            out = sum over e in E_u of route_scale * s_e / sum_{E_u} s *
                  swiglu_e(u)  (moe_intermediate_size)  +  shared(u)
            (num_shared_experts experts of that width, one SwiGLU of their
            summed width)

with rms(x) = x / sqrt(mean(x^2) + rms_norm_eps) over the last axis (each
head's head_dim for rms_head) and query head j reading KV head
j // (heads / kv_heads).  The control computes every matrix product from
fp8 (e4m3) operands, the router and the experts included: weights scaled
per output channel, activations per token.

Near-ties of the router.  Scores that nearly tie at the boundary of the
chosen set can be ordered otherwise by a bf16 program than by this float32
reference, and the two then run different experts for that token.  So
where the program's set (``payload``'s routes, recorded by the program on
the checked batches) differs from the reference's own, the reference takes
the program's set if the reference's scores admit it: its smallest
selection score lies at most ``DELTA`` below the largest of the experts
it leaves out.  A set the scores rule out sets ``logit_err`` to
``RULED_OUT``, which no limit admits.  The control is treated as the
program is: its fp8 run's own choices are given to the float32 run.

Readings: ``logit_err`` (the largest |program - reference| over the last
position's logits of the checked prefill batches) and ``top_gap`` (how far
the reference's logit of the program's top token lies below the
reference's best), as ``dense_lm`` reads them.
"""
from __future__ import annotations

import math

import torch

from .dense_lm import _Q_ROWS, _full_float32, _mm, _rms, _rope

# A bf16 program's set lies at most 0.02 inside the reference's boundary
# at the published widths (the reference's scores, sigmoid in float32: the
# program's lowest chosen score less the highest it leaves out, where the
# two sets differ; over the calibration seeds in PERF.md), and the
# control's fp8 sets reach 0.21: DELTA leaves room on both sides.
DELTA = 0.05
RULED_OUT = 1e9


def equations(cfg: dict) -> dict:
    """The configuration as it runs: the published values with the
    program's stated departures applied."""
    return {"embedding_multiplier": math.sqrt(cfg["hidden_size"]), **cfg,
            **cfg.get("program_departures", {})}


def _attention(q, k, v, groups: int, window: int | None):
    """Causal attention, keys within ``window`` of the query where given;
    q (T, H, D), k and v (T, KV, D); query rows in blocks."""
    t, _, d = q.shape
    k = k.repeat_interleave(groups, 1)
    v = v.repeat_interleave(groups, 1)
    out = torch.empty_like(q)
    kpos = torch.arange(t, device=q.device)
    for r0 in range(0, t, _Q_ROWS):
        qi = q[r0:r0 + _Q_ROWS]
        s = torch.einsum("qhd,khd->hqk", qi, k) / math.sqrt(d)
        qpos = torch.arange(r0, r0 + qi.shape[0], device=q.device)
        hide = kpos[None, :] > qpos[:, None]
        if window is not None:
            hide |= kpos[None, :] <= qpos[:, None] - window
        s = s.masked_fill(hide[None], float("-inf"))
        out[r0:r0 + _Q_ROWS] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    return out


def _swiglu(u, w_gate, w_up, w_down, low: bool):
    g = torch.nn.functional.silu(_mm(u, w_gate, low))
    return _mm(g * _mm(u, w_up, low), w_down, low)


def choose(sel: torch.Tensor, k: int, given: torch.Tensor | None):
    """(the chosen experts (T, k), whether every given set was admitted) of
    selection scores ``sel`` (T, E): the k largest (ties to the lower
    index), or the given set where it differs and the scores admit it."""
    own = torch.sort(sel, dim=-1, descending=True, stable=True).indices[:, :k]
    if given is None:
        return own, True
    given = given.to(own.device).long()
    differs = (own.sort(-1).values != given.sort(-1).values).any(-1)
    inside = torch.zeros_like(sel, dtype=torch.bool).scatter_(1, given, True)
    lowest_in = sel.masked_fill(~inside, float("inf")).amin(-1)
    highest_out = sel.masked_fill(inside, float("-inf")).amax(-1)
    admitted = lowest_in >= highest_out - DELTA
    chosen = torch.where(differs[:, None], given, own)
    return chosen, bool((admitted | ~differs).all())


def _moe(u, weights, p: str, cfg: dict, low: bool, given):
    """(moe(u) (T, d), the experts chosen (T, k), whether ``given`` was
    admitted)."""
    k, n = cfg["num_experts_per_tok"], cfg["num_experts"]
    s = torch.sigmoid(_mm(u, weights[p + "router"], low))
    chosen, ok = choose(s + weights[p + "expert_bias"].float(), k, given)
    w = s.gather(1, chosen)
    w = w * (cfg["route_scale"] / w.sum(-1, keepdim=True))
    out = torch.zeros_like(u)
    for e in range(n):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(u[tok], weights[p + "experts.w_gate"][e], weights[p + "experts.w_up"][e],
                        weights[p + "experts.w_down"][e], low)
            out.index_add_(0, tok, y * w[tok, slot][:, None])
    out = out + _swiglu(u, weights[p + "shared.w_gate"], weights[p + "shared.w_up"],
                        weights[p + "shared.w_down"], low)
    return out, chosen, ok


def forward(weights: dict, cfg: dict, tokens: torch.Tensor, rows, low: bool = False,
            routes=None):
    """(reference logits (len(rows), vocab) of one sequence ``tokens`` (T,)
    at positions ``rows``, the experts chosen in each MoE layer (a list of
    (T, k)), whether every given set was admitted).  ``routes``, a list
    of (T, k) a MoE layer, are the program's sets."""
    cfg = equations(cfg)
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    chosen, admitted = [], True
    with torch.no_grad(), _full_float32():
        tokens = tokens.long()
        t = tokens.shape[0]
        pos = torch.arange(t, device=tokens.device)
        x = weights["embed"][tokens].float() * cfg["embedding_multiplier"]
        for i in range(cfg["num_hidden_layers"]):
            p = f"layers.{i}."
            sliding = cfg["layer_types"][i] == "sliding_attention"
            a = _rms(x, weights[p + "ln1"], eps)
            q = _rms(_mm(a, weights[p + "wq"], low).view(t, h, hd), weights[p + "q_norm"], eps)
            k = _rms(_mm(a, weights[p + "wk"], low).view(t, kv, hd), weights[p + "k_norm"], eps)
            v = _mm(a, weights[p + "wv"], low).view(t, kv, hd)
            if sliding:
                q, k = _rope(q, pos, theta), _rope(k, pos, theta)
            o = _attention(q, k, v, h // kv, cfg["sliding_window"] if sliding else None)
            o = o.reshape(t, h * hd) * torch.sigmoid(_mm(a, weights[p + "wg"], low))
            x = x + _rms(_mm(o, weights[p + "wo"], low), weights[p + "ln1_post"], eps)
            u = _rms(x, weights[p + "ln2"], eps)
            if i < cfg["num_dense_layers"]:
                m = _swiglu(u, weights[p + "w_gate"], weights[p + "w_up"],
                            weights[p + "w_down"], low)
            else:
                given = routes[len(chosen)] if routes is not None else None
                m, c, ok = _moe(u, weights, p, cfg, low, given)
                chosen.append(c)
                admitted = admitted and ok
            x = x + _rms(m, weights[p + "ln2_post"], eps)
        x = _rms(x[torch.as_tensor(rows, device=x.device)], weights["final_norm"], eps)
        return _mm(x, weights["unembed"].t(), low), chosen, admitted


def _prefill(payload, cfg, low: bool) -> dict:
    cfg = payload.get("config", cfg)
    err = gap = 0.0
    for tokens, got, routes in payload["batches"]:
        b_, s = tokens.shape
        for b in range(b_):
            given = [r.view(b_, s, -1)[b] for r in routes]
            if low:
                # the control in the program's place: its own choices given
                have, given, _ = forward(payload["weights"], cfg, tokens[b], [s - 1], low=True)
                have = have[0]
            else:
                have = got[b].float()
            ref, _, admitted = forward(payload["weights"], cfg, tokens[b], [s - 1],
                                       routes=given)
            ref = ref[0]
            err = max(err, float((have - ref).abs().max()) if admitted else RULED_OUT)
            gap = max(gap, float(ref.max() - ref[have.argmax()]))
    return {"logit_err": err, "top_gap": gap}


def readings(payload: dict, config: dict, traffic: dict) -> dict:
    return _prefill(payload, config, low=False)


def control(payload: dict, config: dict, traffic: dict) -> dict:
    return _prefill(payload, config, low=True)
