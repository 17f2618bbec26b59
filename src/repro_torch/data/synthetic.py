"""Synthetic tabular data shaped like the paper's NYC-taxicab benchmark
(Fig. 6 uses taxi trips replicated 1–11×), built straight from numpy arrays.

For a given seed both generators give the same numbers as the JAX package's
``repro/data/synthetic.py``: the same ``rng`` calls in the same order, the
same null masks (a null slot stores 0, as schema parsing leaves it) and the
same first-occurrence dictionary.  They skip the per-value Python lists,
which would take minutes at tens of millions of rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import Domain, resolve_device, to_device
from ..core.frame import Column, Frame
from ..core.labels import RangeLabels, labels_from_values

_PAYMENT = ("card", "cash", "dispute")


def _first_occurrence(idx: np.ndarray, k: int) -> tuple[np.ndarray, tuple]:
    """Codes and table of ``_PAYMENT[idx]`` in first-occurrence order."""
    present, first = np.unique(idx, return_index=True)
    order = present[np.argsort(first, kind="stable")]
    rank = np.full(k, -1, dtype=np.int32)
    rank[order] = np.arange(order.shape[0], dtype=np.int32)
    return rank[idx], tuple(_PAYMENT[i] for i in order)


def taxi_like_frame(n_rows: int, seed: int = 0, n_float_cols: int = 6, *,
                    device=None) -> Frame:
    """Columns mirroring the paper's benchmark data: a small-cardinality
    group key ("passenger_count"), floats with ~1% nulls, and a category.
    Built on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    passenger = rng.integers(1, 7, n_rows)
    # choice over a population of 3 draws the same indices whether the
    # population is the strings or range(3)
    pay_idx = rng.choice(len(_PAYMENT), n_rows)
    codes, table = _first_occurrence(pay_idx, len(_PAYMENT))
    cols = [Column(to_device(passenger.astype(np.int32), dev), Domain.INT),
            Column(to_device(codes, dev), Domain.STR, None, table)]
    names = ["passenger_count", "payment_type"]
    for j in range(n_float_cols):
        col = rng.standard_normal(n_rows)
        nulls = rng.random(n_rows) < 0.01
        data = np.where(nulls, 0.0, col).astype(np.float32)
        mask = None if not nulls.any() else to_device(~nulls, dev)
        cols.append(Column(to_device(data, dev), Domain.FLOAT, mask))
        names.append(f"f{j}")
    return Frame(cols, RangeLabels(n_rows), labels_from_values(names), device=dev)


def numeric_matrix_frame(n_rows: int, n_cols: int, seed: int = 0, *,
                         device=None) -> Frame:
    """Homogeneous float frame (matrix dataframe) — the transpose benchmark."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n_rows, n_cols)).astype(np.float32)
    return Frame.from_matrix(torch.from_numpy(mat).to(dev), Domain.FLOAT)
