"""Sharding policies: parameter / optimizer / batch / cache specs per
(architecture x shape x mesh), as the reference's ``repro/launch/sharding.py``,
over the port's trees, and their placement on a torch ``DeviceMesh``.

Parallelism (the reference's rules, unchanged):
  * TP  — Megatron pairing: column-parallel in-projections P(None, "model"),
    row-parallel out-projections P("model", None) => two all-reduces a block.
  * DP  — batch over ("pod", "data"); gradients reduce over the DP axes.
  * FSDP — for params too big for TP alone, weights also shard the non-TP
    dim over "data" (gathered at use; ZeRO-3 style).
  * EP  — MoE expert dim over "model".
  * SP  — decode KV caches shard the *sequence* dim (flash-decode style);
    the batch dim shards DP when divisible.

Only inputs and parameters are given specs; DTensor propagates the rest.
Every rule degrades to None when a dim is not divisible by the axis.

**The port's trees.**  ``params["layers"][i]`` is one dict per layer (the
reference stacks the scanned layers of each pattern position under
``blocks`` with a leading repeats dim), so a layer's spec is the
reference's with its leading ``None`` dropped.  The decode cache is
``{"layers": [...], "length"}`` the same way; a local layer's ring holds
min(s_max, window) slots in both packages.  Adafactor's state keeps the
reference's stacked ``blocks`` / ``tail`` layout (``train/optimizer.py``),
so ``opt_state_specs`` matches it against the stacked units of
``optimizer.units``.

A spec is a ``P``: a tuple with one entry per tensor dim, each ``None``, an
axis name or a tuple of names.  ``to_placements`` turns one into DTensor
placements; ``distribute`` a whole tree into DTensors.
"""
from __future__ import annotations

from typing import Any

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..train.optimizer import units
from ..train.tree import get_path, leaves_with_paths, unflatten
from .mesh import axis_names, axis_size, dp_axes

FSDP_THRESHOLD_BYTES = 2 << 30    # params a device beyond this -> FSDP over "data"


class P(tuple):
    """A partition spec: ``P("data", None)``; entries None, a name or a
    tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _div(size: int, mesh, axes) -> bool:
    return axes is not None and size % axis_size(mesh, axes) == 0 and size > 0


def _maybe(size: int, mesh, axes):
    """axes if divisible else None."""
    if axes is None:
        return None
    ax = axes if isinstance(axes, tuple) else (axes,)
    return axes if _div(size, mesh, ax) else None


def use_fsdp(cfg: ArchConfig, mesh) -> bool:
    total, _ = cfg.param_count()
    bytes_per_chip_tp = total * 2 / axis_size(mesh, "model")
    return bytes_per_chip_tp > FSDP_THRESHOLD_BYTES


def effective_dp(cfg: ArchConfig, mesh) -> tuple[str, ...]:
    """Axes the batch shards over.  Pure-FSDP mode has no TP, so the "model"
    axis joins data parallelism (otherwise it would sit idle)."""
    base = dp_axes(mesh)
    if cfg.sharding_mode == "fsdp":
        return base + ("model",)
    return base


def _path_name(p) -> str:
    return f"#{p}" if isinstance(p, int) else str(p)


def _names(path: tuple) -> tuple[str, ...]:
    return tuple(_path_name(p) for p in path)


def _map_specs(tree: Any, spec_for) -> Any:
    """The tree's structure with each leaf replaced by ``spec_for(names,
    shape)``."""
    return unflatten(tree, [spec_for(_names(path), tuple(leaf.shape))
                            for path, leaf in leaves_with_paths(tree)])


# -----------------------------------------------------------------------------
# parameter specs
# -----------------------------------------------------------------------------
def param_specs(cfg: ArchConfig, params_shapes: Any, mesh) -> Any:
    """P tree matching the port's params tree (by leaf name and shape).

    sharding_mode:
      * "tp"   — Megatron TP over "model" only;
      * "fsdp" — no TP: every >= 2-D weight shards a dim over the flattened
        mesh axes (ZeRO-3; gathered at use);
      * "auto" — TP, plus FSDP over "data" when TP-sharded params exceed
        the per-device budget (the big archs).
    """
    if cfg.sharding_mode == "fsdp":
        return _fsdp_only_specs(params_shapes, mesh)
    fsdp_ax = "data" if cfg.sharding_mode != "tp" and use_fsdp(cfg, mesh) else None

    def col(io):                    # (in, out) column-parallel
        return P(_maybe(io[0], mesh, fsdp_ax), _maybe(io[1], mesh, "model"))

    def row(io):                    # (in, out) row-parallel
        return P(_maybe(io[0], mesh, "model"), _maybe(io[1], mesh, fsdp_ax))

    def replicated(shape):
        return P(*(None,) * len(shape))

    def spec_for(names: tuple, shape: tuple) -> P:
        name = names[-1] if names else ""
        if name in ("embed", "unembed"):
            return P(_maybe(shape[0], mesh, "model"), _maybe(shape[1], mesh, fsdp_ax))
        if name in ("w_gate", "w_up", "w_down") and len(shape) == 3:   # MoE (E, in, out)
            return P(_maybe(shape[0], mesh, "model"), None, _maybe(shape[2], mesh, fsdp_ax))
        if name == "router":
            return P(None, None)
        if name in ("wq", "wk", "wv") and len(shape) == 2:
            return col(shape)
        if name == "wo" and len(shape) == 2:
            return row(shape)
        if name in ("w_gate", "w_up", "w_k", "w_x", "w_gate_branch", "w_input_gate",
                    "w_rec_gate", "w_r", "w_g"):
            return col(shape) if len(shape) == 2 else replicated(shape)
        if name in ("w_down", "w_v", "w_out", "w_o"):
            return row(shape) if len(shape) == 2 else replicated(shape)
        return replicated(shape)    # norms, biases, small tensors

    return _map_specs(params_shapes, spec_for)


def _fsdp_only_specs(params_shapes: Any, mesh) -> Any:
    """Pure ZeRO-3: shard a dim of every weight over the *flattened* mesh
    axes; no tensor parallelism (the batch shards over every axis too)."""
    all_axes = axis_names(mesh)

    def spec_for(names, shape) -> P:
        if len(shape) < 2:
            return P(*(None,) * len(shape))
        entries: list = [None] * len(shape)
        for d in range(len(shape)):          # prefer dim 0; degrade by divisibility
            if _div(shape[d], mesh, all_axes):
                entries[d] = all_axes
                break
            if _div(shape[d], mesh, ("data",)):
                entries[d] = "data"
                break
        return P(*entries)

    return _map_specs(params_shapes, spec_for)


# -----------------------------------------------------------------------------
# optimizer-state specs (shape-matched against the parameter specs)
# -----------------------------------------------------------------------------
def opt_state_specs(param_specs_tree: Any, params_shapes: Any, state_shapes: Any,
                    period: int = 1) -> Any:
    """State specs: exact-shape leaves inherit the parameter's spec; factored
    Adafactor moments drop the reduced dim's entry; scalars replicate.
    A state leaf is matched by a sub-path of its own path: the port's
    parameter paths (AdamW's moments) or the reference's stacked units
    (Adafactor's ``blocks`` / ``tail``; ``period`` = len(cfg.pattern)), a
    stacked unit taking a leading ``None``."""
    by_path = {}
    for path, leaf in leaves_with_paths(params_shapes):
        by_path[_names(path)] = (tuple(leaf.shape), tuple(get_path(param_specs_tree, path)))
    for ref_path, members in units(params_shapes, period):
        shape = tuple(get_path(params_shapes, members[0]).shape)
        spec = tuple(get_path(param_specs_tree, members[0]))
        if ref_path[0] == "blocks":
            shape, spec = (len(members),) + shape, (None,) + spec
        by_path[_names(ref_path)] = (shape, spec)

    def spec_for_state(path: tuple, shape: tuple) -> P:
        for start in range(len(path)):
            for end in range(len(path), start, -1):
                key = path[start:end]
                if key in by_path:
                    pshape, pspec = by_path[key]
                    if shape == pshape:
                        return P(*pspec)
                    if shape == pshape[:-1]:                    # adafactor vr
                        return P(*pspec[:-1])
                    if shape == pshape[:-2] + pshape[-1:]:      # adafactor vc
                        return P(*(pspec[:-2] + pspec[-1:]))
        return P(*(None,) * len(shape))

    return _map_specs(state_shapes, spec_for_state)


# -----------------------------------------------------------------------------
# batch / cache specs
# -----------------------------------------------------------------------------
def _dp_entry(dp: tuple):
    return dp if len(dp) > 1 else dp[0]


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, specs_tree: Any) -> Any:
    dp = _dp_entry(effective_dp(cfg, mesh))
    bshard = _maybe(shape.global_batch, mesh, dp)

    def spec_for(names, leaf_shape):
        name = names[-1]
        if name in ("tokens", "labels", "mask"):
            return P(bshard, None)
        if name == "token":
            return P(bshard)
        if name == "memory":
            return P(bshard, None, None)
        return P(*(None,) * len(leaf_shape))

    return _map_specs(specs_tree, spec_for)


def cache_specs_tree(cfg: ArchConfig, shape: ShapeConfig, mesh, cache_shapes: Any) -> Any:
    """KV / state cache sharding: batch -> DP when divisible, sequence dim ->
    "model" (+ the DP axes when the batch is unshardable): flash-decode SP."""
    dp = _dp_entry(effective_dp(cfg, mesh) if cfg.sharding_mode == "fsdp" else dp_axes(mesh))
    b = shape.global_batch
    b_ok = _div(b, mesh, dp if isinstance(dp, tuple) else (dp,))
    seq_ax = "model" if b_ok else (dp + ("model",) if isinstance(dp, tuple) else (dp, "model"))

    def spec_for(names, body):
        name = names[-1]
        if name == "length":
            return P(None)
        if name in ("k", "v") and len(body) == 4:      # (B, S, K, Dh)
            return P(_maybe(b, mesh, dp), _maybe(body[1], mesh, seq_ax), None, None)
        if name == "S" and len(body) == 4:             # rwkv (B, H, dk, dv)
            return P(_maybe(b, mesh, dp), _maybe(body[1], mesh, "model"), None, None)
        if name == "h" and len(body) == 2:             # rglru (B, dr)
            return P(_maybe(b, mesh, dp), _maybe(body[1], mesh, "model"))
        if len(body) >= 1:
            return P(_maybe(body[0], mesh, dp), *(None,) * (len(body) - 1))
        return P()

    return _map_specs(cache_shapes, spec_for)


# -----------------------------------------------------------------------------
# placement on a DeviceMesh
# -----------------------------------------------------------------------------
def to_placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: each named axis becomes
    ``Shard(d)`` on its mesh dim (a tuple entry shards dim d over each of its
    axes, in mesh order, major first), every other mesh dim ``Replicate()``.
    The counterpart of the reference's ``to_named``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    placements: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            placements[names.index(ax)] = Shard(d)
    return placements


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` with every tensor leaf a DTensor placed by its spec: meta
    leaves become meta shards (nothing is allocated), others are chunked
    from the full tensor this process holds; a 0-d tensor that is not meta
    (a step counter) stays as it is, replicated by nature."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    out = []
    for path, leaf in leaves_with_paths(tree):
        if leaf.dim() == 0 and not leaf.is_meta:
            out.append(leaf)
            continue
        spec = get_path(specs, path)
        placements = to_placements(spec, mesh)
        if leaf.is_meta:
            local = torch.empty(_local_shape(leaf.shape, spec, mesh), dtype=leaf.dtype,
                                device="meta")
            t = DTensor.from_local(local, mesh, placements, run_check=False,
                                   shape=leaf.shape, stride=leaf.stride())
        else:
            t = distribute_tensor(leaf, mesh, placements)
        if leaf.requires_grad:
            t.requires_grad_(True)
        out.append(t)
    return unflatten(tree, out)


def _local_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    return tuple(s if e is None else s // axis_size(mesh, e if isinstance(e, tuple) else (e,))
                 for s, e in zip(tuple(shape), tuple(spec) + (None,) * (len(shape) - len(spec))))
