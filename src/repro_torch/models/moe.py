"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch
(GShard / Switch style), as the reference's ``repro/models/moe.py``.

Dispatch avoids the O(T·E·C) combine tensor: slot positions come from a
cumulative sum over the (k·T, E) assignment one-hot, tokens are placed into
the expert buffers, and the combine is a gather weighted by the router
gates.  Aux losses: load-balancing (Switch) + router z-loss.

Where the port differs from the reference, and why the result does not:

- Top-k: ``jax.lax.top_k`` breaks ties toward the lower expert index and
  ``torch.topk`` promises no order, so the top k come from a stable
  descending sort (equal probabilities keep index order).
- Dispatch: the reference scatters with ``.at[e, s].add`` and sends a
  dropped route to (0, 0) with a zero source.  Kept (expert, slot) pairs are
  unique, so the port copies each kept row to its place, with no float
  atomics, and sends every dropped route to one spare row past the buffers
  that nothing reads.  The buffers are laid out (E, G·C, d), so the
  expert matmuls are one batched product over the experts.

The dropless path (``moe_dropless``, a config's ``moe_dispatch =
"dropless"``: AFMoE, ``configs/trinity_mini.py``) has no counterpart in the
reference.  Tokens choose by sigmoid scores with an expert bias (``route``).
Every route is computed: the T·k routes are sorted by expert
(a stable sort, so each expert's rows keep token order), the tokens
gathered in that order, and each projection is one grouped product
(``torch._grouped_mm``) over the experts' row ranges, whose ends stay on
the device: nothing waits on the host.  The combine gathers each token's k
rows back and sums them in one reduction, with no float atomics, so two
runs are bit-equal.  A token's output depends on its own routes alone, so
decode agrees with the forward (the capacity path's slots depend on the
other tokens of the group).  Spans: ``moe`` (args: layer index, tokens,
routes, experts; with the tracer on, not under the profiler alone, also
the most and fewest rows an expert took and how many took none, which
reads the device) holds ``route``, ``experts`` (the routed experts' three
grouped products and their SwiGLU), ``combine`` and ``shared`` (the
shared experts).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from . import layers
from ..core import trace


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype=layers.DEFAULT_PARAM_DTYPE, n_shared: int = 0,
             expert_bias: bool = False) -> dict:
    """The router (d, E) float32 and the experts' (E, d, ff) / (E, ff, d)
    matrices; with ``expert_bias`` a zero (E,) float32 bias of the
    selection, with ``n_shared`` a SwiGLU of n_shared · ff beside them
    (``shared``: n shared experts of width ff are one of that width)."""
    dev = gen.device

    def experts(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * scale).to(dtype)

    scale_in, scale_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    p = {
        "router": layers.dense_init(gen, d_model, n_experts, torch.float32),
        "w_gate": experts((n_experts, d_model, d_ff), scale_in),
        "w_up": experts((n_experts, d_model, d_ff), scale_in),
        "w_down": experts((n_experts, d_ff, d_model), scale_out),
    }
    if expert_bias:
        p["expert_bias"] = torch.zeros((n_experts,), dtype=torch.float32, device=dev)
    if n_shared:
        p["shared"] = layers.swiglu_init(gen, d_model, n_shared * d_ff, dtype)
    return p


def _gcd_groups(t: int, want: int) -> int:
    return max(1, math.gcd(t, want))


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index, as ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(xt: torch.Tensor, router: torch.Tensor, n_experts: int, top_k: int,
              capacity_factor: float):
    """Group-local routing and dispatch of xt (G, Tg, d): (buffers (E, G·C,
    d), keep, rows, gate_vals, logits, probs, expert_idx).  Every group has
    its own capacity and slot space, so this runs on any subset of the
    groups alone (the DTensor route runs it on each device's groups)."""
    g, tg, d = xt.shape
    logits = torch.einsum("gtd,de->gte", xt.float(), router)
    probs = torch.softmax(logits, dim=-1)                          # (G,Tg,E)
    gate_vals, expert_idx = _top_k(probs, top_k)                   # (G,Tg,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    capacity = int(math.ceil(tg * top_k / n_experts * capacity_factor))
    capacity = max(capacity, top_k)

    # slot positions within each group: cumsum over the (k·Tg, E) one-hot,
    # choice-major so primary routes win capacity
    flat_idx = expert_idx.transpose(1, 2).reshape(g, top_k * tg)   # (G,kTg)
    onehot = F.one_hot(flat_idx, n_experts)                        # (G,kTg,E)
    pos = torch.cumsum(onehot, dim=1) - 1
    slot_flat = torch.gather(pos, 2, flat_idx[..., None])[..., 0]
    slot = slot_flat.reshape(g, top_k, tg).transpose(1, 2)         # (G,Tg,k)
    keep = (slot < capacity).reshape(g, tg * top_k)

    # token-major routes: row t·k + j is token t's j-th choice
    e_flat = expert_idx.reshape(g, tg * top_k)
    s_flat = slot.reshape(g, tg * top_k)
    groups = torch.arange(g, device=xt.device)[:, None]
    rows = (e_flat * g + groups) * capacity + s_flat               # in (E, G, C)
    spare = n_experts * g * capacity
    src = xt.repeat_interleave(top_k, dim=1)                       # (G,Tg·k,d)
    buf = xt.new_zeros((spare + 1, d))
    buf = buf.index_copy(0, torch.where(keep, rows, spare).reshape(-1), src.reshape(-1, d))
    buffers = buf[:spare].reshape(n_experts, g * capacity, d)      # (E,G·C,d)
    return buffers, keep, rows, gate_vals, logits, probs, expert_idx


def _combine(out_buf: torch.Tensor, keep, rows, gate_vals) -> torch.Tensor:
    """out_buf (E, G·C, d) → (G, Tg, d): each token's kept routes gathered
    back and weighted by their gates."""
    g, tg, top_k = gate_vals.shape
    d = out_buf.shape[-1]
    out_buf = out_buf.reshape(-1, d)                               # (E·G·C,d)
    gathered = out_buf[torch.where(keep, rows, 0)]                 # (G,Tg·k,d)
    gathered = torch.where(keep[..., None], gathered, 0)
    w = gate_vals.reshape(g, tg * top_k)                           # token-major
    weighted = gathered * w[..., None].to(gathered.dtype)
    return weighted.reshape(g, tg, top_k, d).sum(dim=2)


def _experts(params: dict, buffers: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its buffer rows, one batched product."""
    gg = torch.bmm(buffers, params["w_gate"])
    uu = torch.bmm(buffers, params["w_up"])
    hh = F.silu(gg.float()).to(buffers.dtype) * uu
    return torch.bmm(hh, params["w_down"])                         # (E,G·C,d)


def _sharded_dispatch_combine(params, xt, n_experts, top_k, capacity_factor):
    """``_dispatch`` and ``_combine`` on each device's groups (DTensor
    ``xt``): the groups stay on the mesh dims that shard them, so dispatch
    moves no token and allocates only the local groups' buffers; the
    experts' products run on DTensors (EP over "model"), and the combine
    gathers each device's buffer rows back over the expert dim (the
    all-to-all's return, counted as an all-gather)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xt.device_mesh
    on_groups = [Shard(0) if p == Shard(0) else Replicate() for p in xt.placements]
    rows_of = [Shard(1) if p == Shard(0) else Replicate() for p in on_groups]
    rep = [Replicate()] * mesh.ndim
    xt = xt.redistribute(mesh, on_groups)
    router = params["router"].redistribute(mesh, rep)
    dispatch = local_map(
        lambda x, r: _dispatch(x, r, n_experts, top_k, capacity_factor),
        out_placements=(rows_of,) + (on_groups,) * 6, in_placements=(on_groups, rep),
        device_mesh=mesh)
    buffers, keep, rows, gate_vals, logits, probs, expert_idx = dispatch(xt, router)
    out_buf = _experts(params, buffers).redistribute(mesh, rows_of)
    combine = local_map(_combine, out_placements=on_groups,
                        in_placements=(rows_of, on_groups, on_groups, on_groups),
                        device_mesh=mesh)
    return combine(out_buf, keep, rows, gate_vals), logits, probs, expert_idx


def moe_apply(params: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25,
              n_groups: int = 16) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) → (B, S, d), aux {load_balance_loss, router_z_loss}.

    Dispatch is group-local (GShard "groups"): the tokens are split into G
    independent routing groups, each with its own capacity and slot space.
    Within a group the slot positions are choice-major, so every token's
    first choice is placed before any second choice.  On DTensors the
    dispatch and combine run on each device's groups
    (``_sharded_dispatch_combine``)."""
    b, s, d = x.shape
    t = b * s
    g = _gcd_groups(t, n_groups)
    tg = t // g
    xt = x.reshape(g, tg, d)
    if hasattr(xt, "device_mesh"):
        out, logits, probs, expert_idx = _sharded_dispatch_combine(
            params, xt, n_experts, top_k, capacity_factor)
    else:
        buffers, keep, rows, gate_vals, logits, probs, expert_idx = _dispatch(
            xt, params["router"], n_experts, top_k, capacity_factor)
        out = _combine(_experts(params, buffers), keep, rows, gate_vals)

    # aux losses
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx[..., 0], n_experts).float().mean(dim=(0, 1))
    load_balance = n_experts * torch.sum(me * ce)
    router_z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = {"load_balance_loss": load_balance, "router_z_loss": router_z}
    return out.reshape(b, s, d).to(x.dtype), aux


# =============================================================================
# dropless token choice (AFMoE)
# =============================================================================
_TAPE: list | None = None


@contextlib.contextmanager
def record_routes():
    """Collects each ``moe_dropless`` call's chosen experts, (T, k) int64 in
    choice order, in call order, into the list it yields."""
    global _TAPE
    outer, _TAPE = _TAPE, []
    try:
        yield _TAPE
    finally:
        _TAPE = outer


def route(params: dict, xt: torch.Tensor, top_k: int,
          route_scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(chosen (T, k) expert ids, their weights (T, k) float32) of the
    tokens xt (T, d).  Scores σ(x Wr) in float32; the top k of the scores
    plus ``expert_bias`` are chosen (ties to the lower index), the bias
    selecting but not weighing; the chosen scores are normalised to sum 1
    and scaled by ``route_scale``."""
    scores = torch.sigmoid(xt.float() @ params["router"].float())
    _, chosen = _top_k(scores + params["expert_bias"], top_k)
    w = scores.gather(1, chosen)
    return chosen, w * (route_scale / w.sum(-1, keepdim=True))


def moe_dropless(params: dict, x: torch.Tensor, *, top_k: int, route_scale: float = 1.0,
                 index: int = 0) -> torch.Tensor:
    """x (B, S, d) → (B, S, d) in x's dtype: each token's k routed experts,
    weighted as ``route`` weighs them, plus the shared experts, every
    route computed (see the module's note)."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    n_experts = params["w_gate"].shape[0]
    with trace.scope("moe", "model") as sp:
        with trace.scope("route", "model"):
            chosen, w = route(params, xt, top_k, route_scale)
            if _TAPE is not None:
                _TAPE.append(chosen)
            sorted_e, order = torch.sort(chosen.reshape(-1), stable=True)
            ends = torch.searchsorted(
                sorted_e, torch.arange(n_experts, device=x.device), right=True).to(torch.int32)
            rows = xt.index_select(0, order // top_k)              # (T·k, d), by expert
            w_rows = w.reshape(-1).index_select(0, order)
        if sp is not None:
            sp.args = {"index": index, "tokens": t, "routes": t * top_k, "experts": n_experts}
            if trace.current() is not None:
                counts = torch.diff(ends, prepend=ends.new_zeros(1))
                sp.args.update(rows_max=int(counts.max()), rows_min=int(counts.min()),
                               empty_experts=int((counts == 0).sum()))
        with trace.scope("experts", "model"):
            # each expert's row range [ends[e-1], ends[e]) times its matrices
            h = F.silu(torch._grouped_mm(rows, params["w_gate"], offs=ends))
            h.mul_(torch._grouped_mm(rows, params["w_up"], offs=ends))
            h.mul_(w_rows[:, None])
            y = torch._grouped_mm(h, params["w_down"], offs=ends)   # (T·k, d), by expert
        with trace.scope("combine", "model"):
            back = torch.empty_like(order).scatter_(
                0, order, torch.arange(order.numel(), device=x.device))
            routed = y.index_select(0, back).view(t, top_k, d).sum(1, dtype=torch.float32)
        with trace.scope("shared", "model"):
            out = routed + layers.swiglu_ffn(params["shared"], xt).float()
            return out.to(x.dtype).reshape(b, s, d)
