"""Carry a frame's state, or a model's parameters, across packages as plain
numpy and Python values.

A *spec* is a dict::

    {"columns": [{"name", "data": ndarray, "mask": ndarray | None,
                  "domain": str, "dictionary": tuple | None}, ...],
     "row_labels": labels, "col_labels": labels,
     "row_domains": [str, ...] | None}

where ``labels`` is ``{"kind": "range", "length", "start"}``, ``{"kind":
"int", "values": ndarray}`` or ``{"kind": "coded", "codes": ndarray,
"table": tuple, "domain": str}``.  Domains are their string values ("int",
"float", ...).  Only numpy arrays and Python values appear, so a spec made
from either package's frame builds the other's.

``params_from_arrays`` takes the reference model's parameter pytree with
numpy leaves (``jax.tree.map(np.asarray, params)``) and returns the port's.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.dtypes import Domain, resolve_device, to_device
from .core.frame import Column, Frame, host
from .core.labels import CodedLabels, IntLabels, Labels, RangeLabels

__all__ = ["frame_from_arrays", "frame_to_arrays", "params_from_arrays"]


def _labels_from(spec: dict) -> Labels:
    kind = spec["kind"]
    if kind == "range":
        return RangeLabels(int(spec["length"]), int(spec["start"]))
    if kind == "int":
        return IntLabels(np.asarray(spec["values"], dtype=np.int64))
    return CodedLabels(np.asarray(spec["codes"], dtype=np.int32),
                       tuple(spec["table"]), Domain(spec["domain"]))


def _labels_to(labels: Labels) -> dict:
    if isinstance(labels, RangeLabels):
        return {"kind": "range", "length": labels.length, "start": labels.start}
    if isinstance(labels, IntLabels):
        return {"kind": "int", "values": labels.values.copy()}
    return {"kind": "coded", "codes": labels.codes.copy(),
            "table": tuple(labels.table), "domain": labels.label_domain.value}


def frame_from_arrays(spec: dict[str, Any], device=None) -> Frame:
    """Build a port ``Frame`` on ``device`` (CUDA by default) from a spec."""
    dev = resolve_device(device)
    cols = []
    for c in spec["columns"]:
        mask = c["mask"]
        cols.append(Column(
            to_device(np.asarray(c["data"]), dev), Domain(c["domain"]),
            None if mask is None else to_device(np.asarray(mask, dtype=np.bool_), dev),
            None if c["dictionary"] is None else tuple(c["dictionary"])))
    rd = spec.get("row_domains")
    return Frame(cols, _labels_from(spec["row_labels"]),
                 _labels_from(spec["col_labels"]),
                 None if rd is None else tuple(Domain(d) for d in rd),
                 device=dev)


def frame_to_arrays(frame: Frame) -> dict[str, Any]:
    """The spec of a port ``Frame`` (host copies of every array)."""
    names = frame.col_labels.to_list()
    return {
        "columns": [{"name": n, "data": host(c.data).copy(),
                     "mask": None if c.mask is None else host(c.mask).copy(),
                     "domain": c.domain.value,
                     "dictionary": c.dictionary}
                    for n, c in zip(names, frame.columns)],
        "row_labels": _labels_to(frame.row_labels),
        "col_labels": _labels_to(frame.col_labels),
        "row_domains": (None if frame.row_domains is None
                        else [d.value for d in frame.row_domains]),
    }


def _param(a: np.ndarray, device) -> torch.Tensor:
    """A numpy leaf → a tensor of its own on ``device``.  A bfloat16 leaf
    (dtype name "bfloat16", from ml_dtypes) is taken bit-exact through its
    16-bit words; nothing here imports ml_dtypes."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device) for v in x]
    return _param(x, device)


def params_from_arrays(tree: dict[str, Any], cfg, device=None) -> dict[str, Any]:
    """The reference's parameters → the port's, on ``device`` (CUDA by
    default).  The reference stacks scanned layers along a leading repeats
    axis, one tree per pattern position (``params["blocks"][pos]``), and
    keeps the rest of the layers unstacked in ``params["tail"]``; the port
    keeps one dict per layer in layer order (``params["layers"]``).  Keys
    and (in, out) layouts are the reference's, so nothing is transposed:
    the encoder's unstacked ``{"enc_layers": [...], "final_norm"}``, the
    stacked experts (E, d, f) / (E, f, d) with their float32 router, the
    cross / lnx entries and the RWKV parameters come across as they are,
    every array bit-exact."""
    dev = resolve_device(device)
    repeats, _ = cfg.repeats_and_tail()
    layers = [_tree(_index(tree["blocks"][pi], r), dev)
              for r in range(repeats) for pi in range(len(cfg.pattern))]
    layers += [_tree(p, dev) for p in tree["tail"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {len(layers)} layers in the tree, "
                         f"config has {cfg.n_layers}")
    out = {k: _tree(v, dev) for k, v in tree.items() if k not in ("blocks", "tail")}
    out["layers"] = layers
    return out


def _index(x, r: int):
    if isinstance(x, dict):
        return {k: _index(v, r) for k, v in x.items()}
    return x[r]
