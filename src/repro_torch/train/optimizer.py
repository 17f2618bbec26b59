"""Optimizers: AdamW and Adafactor, as pure (init, update) pairs over the
port's parameter dict, as the reference's ``repro/train/optimizer.py``.

``update(grads, state, params, lr, period=1) -> (params, state)`` works
under ``torch.no_grad()`` in float32 and rounds each new parameter once to
its dtype.  The parameters are updated in place (the reference donates
them: no second copy of 15 GB of weights is kept) and come back as the same
dict; the optimizer state is new.

**The reference's grouping (Adafactor).**  The reference stacks the scanned
layers of each pattern position along a leading ``repeats`` axis
(``params["blocks"][pos]``) and keeps the tail layers and the top-level
tensors one by one; the port keeps one dict per layer.  Adafactor's
arithmetic depends on that shape: ``_factored`` is true for any tensor of
rank >= 2 whose last two axes are both > 1, so a stacked ``(repeats, d)``
norm scale or Λ gets factored moments, and the update-clipping RMS is taken
over the whole stacked tensor.  So Adafactor works on the reference's
grouping: the layers ``r * period + pos`` (``period = len(cfg.pattern)``,
``r < len(layers) // period``) of each position are stacked into one
tensor, updated, and written back into the per-layer tensors, and the tail
layers (``layers[repeats * period:]``) and the top-level tensors are taken
one at a time.  Its state is kept in the reference's layout — ``{"v":
{"embed": ..., "final_norm": ..., "blocks": [per position], "tail": [per
layer]}, "count"}`` — so it compares with the reference's by plain numpy.
AdamW is elementwise, so its moments are kept in the port's layout (the
parameters' own tree; ``convert.params_from_arrays`` maps the
reference's).  ``period`` is ``len(model.cfg.pattern)``; the trainer passes
it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .tree import get_path, leaves, leaves_with_paths, set_path, unflatten


class Optimizer(NamedTuple):
    init: Callable[..., Any]
    update: Callable[..., tuple[Any, Any]]
    # init(params, period=1) -> state
    # update(grads, state, params, lr, period=1) -> (params, state)


def _zeros_like(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def _count() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves(grads)))


def _clip_scale(grads, max_norm: float) -> torch.Tensor:
    gn = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """Each gradient scaled by min(1, max_norm / global norm), in float32,
    back in its dtype."""
    scale = _clip_scale(grads, max_norm)
    return unflatten(grads, [_clipped(g, scale) for g in leaves(grads)])


# =============================================================================
# the reference's grouping
# =============================================================================
def units(params: dict, period: int = 1) -> list[tuple[tuple, list]]:
    """The tensors the reference's optimizer sees, as ``(path in the
    reference's tree, [path in the port's tree of each member])``: each
    top-level tensor (one member), ``("blocks", pos, ...)`` (members: that
    position's layer in every repeat, stacked in repeat order) and
    ``("tail", i, ...)`` (one member)."""
    layers = params["layers"]
    repeats = len(layers) // period
    out = []
    for path, _ in leaves_with_paths({k: v for k, v in params.items() if k != "layers"}):
        out.append((path, [path]))
    for pos in range(period if repeats else 0):
        for sub, _ in leaves_with_paths(layers[pos]):
            out.append((("blocks", pos) + sub,
                        [("layers", r * period + pos) + sub for r in range(repeats)]))
    for i in range(len(layers) - repeats * period):
        for sub, _ in leaves_with_paths(layers[repeats * period + i]):
            out.append((("tail", i) + sub, [("layers", repeats * period + i) + sub]))
    return out


def _gather(tensors: list, stacked: bool) -> torch.Tensor:
    return torch.stack(tensors) if stacked else tensors[0]


# =============================================================================
# AdamW
# =============================================================================
def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: float = 1.0) -> Optimizer:
    def init(params, period: int = 1):
        return {"m": unflatten(params, [_zeros_like(p) for p in leaves(params)]),
                "v": unflatten(params, [_zeros_like(p) for p in leaves(params)]),
                "count": _count()}

    @torch.no_grad()
    def update(grads, state, params, lr, period: int = 1):
        scale = _clip_scale(grads, grad_clip)
        count = state["count"] + 1
        cf = count.to(torch.float32)
        new_m, new_v = [], []
        for g, m, v, p in zip(leaves(grads), leaves(state["m"]), leaves(state["v"]),
                              leaves(params)):
            gf = _clipped(g, scale).float()
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * gf * gf
            mhat = m / (1 - b1 ** cf)
            vhat = v / (1 - b2 ** cf)
            step = mhat / (torch.sqrt(vhat) + eps)
            pf = p.float()
            pf = pf - lr * (step + weight_decay * pf)
            p.copy_(pf.to(p.dtype))
            new_m.append(m)
            new_v.append(v)
        return params, {"m": unflatten(params, new_m), "v": unflatten(params, new_v),
                        "count": count}

    return Optimizer(init, update)


# =============================================================================
# Adafactor (factored second moment; no first moment by default)
# =============================================================================
def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0,
              grad_clip: float = 1.0) -> Optimizer:
    def init(params, period: int = 1):
        v: dict = {"blocks": [], "tail": []}
        for ref_path, members in units(params, period):
            first = get_path(params, members[0])
            shape = ((len(members),) if ref_path[0] == "blocks" else ()) + tuple(first.shape)
            dev = first.device
            if _factored(shape):
                st = {"vr": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                      "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                        device=dev)}
            else:
                st = {"v": torch.zeros(shape, dtype=torch.float32, device=dev)}
            set_path(v, ref_path, st)
        return {"v": v, "count": _count()}

    @torch.no_grad()
    def update(grads, state, params, lr, period: int = 1):
        scale = _clip_scale(grads, grad_clip)
        count = state["count"] + 1
        beta = 1.0 - count.to(torch.float32) ** -decay
        new_v: dict = {"blocks": [], "tail": []}
        for ref_path, members in units(params, period):
            stacked = ref_path[0] == "blocks"
            gf = _gather([_clipped(get_path(grads, m), scale) for m in members],
                         stacked).float()
            v = get_path(state["v"], ref_path)
            g2 = gf * gf + eps
            if _factored(gf.shape):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = torch.sqrt(
                    vr[..., None] / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)[..., None]
                    * vc[..., None, :])
                nv = {"vr": vr, "vc": vc}
            else:
                vv = beta * v["v"] + (1 - beta) * g2
                denom = torch.sqrt(vv)
                nv = {"v": vv}
            del g2
            step = gf / torch.clamp(denom, min=eps)
            del gf, denom
            # update clipping (RMS ≤ clip_threshold), over the whole unit
            rms = torch.sqrt(torch.mean(step * step) + eps)
            step = step / torch.clamp(rms / clip_threshold, min=1.0)
            pf = _gather([get_path(params, m) for m in members], stacked).float()
            pf = pf - lr * step - lr * weight_decay * pf
            del step
            for i, m in enumerate(members):
                p = get_path(params, m)
                p.copy_((pf[i] if stacked else pf).to(p.dtype))
            del pf
            set_path(new_v, ref_path, nv)
        return params, {"v": new_v, "count": count}

    return Optimizer(init, update)


def get_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor()
    raise ValueError(name)


__all__ = ["Optimizer", "adamw", "adafactor", "clip_by_global_norm", "get_optimizer",
           "global_norm", "units"]
