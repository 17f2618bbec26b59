"""Row/column label vectors R_m and C_n (paper §3.2).

Labels are metadata over the same domains as data (unlike relational ``att``),
enabling TOLABELS / FROMLABELS to move values between data and metadata.
Two physical forms:

* ``RangeLabels`` — the default positional labels 0..m-1.  O(1) metadata; this
  is what keeps "billions of columns" after a TRANSPOSE cheap (the transposed
  frame's column labels are the old positional row labels).
* ``IntLabels`` — arbitrary integer labels as a host numpy vector.  This is
  what a filtered/gathered ``RangeLabels`` becomes: ``take``/``concat`` are
  vectorized numpy ops, never a per-row Python loop (the row-local fused
  pipelines filter blocks on every selection — label bookkeeping must not
  dominate the actual filter).
* ``CodedLabels`` — arbitrary labels dictionary-encoded: int32 codes (host
  numpy; labels are metadata and never need the device) + host code table.

Labels may repeat and may be null (paper §3.5: "labels can have duplicate
values or be null; so labels are not like primary keys").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np

from .dtypes import Domain

__all__ = ["Labels", "RangeLabels", "IntLabels", "CodedLabels", "labels_from_values"]


class Labels:
    """Abstract label vector."""

    def __len__(self) -> int:
        raise NotImplementedError

    def to_list(self) -> list:
        raise NotImplementedError

    def take(self, idx: np.ndarray) -> "Labels":
        raise NotImplementedError

    def concat(self, other: "Labels") -> "Labels":
        a, b = self.to_list(), other.to_list()
        return labels_from_values(a + b)

    def position_of(self, label: Any) -> int:
        """First position with the given label (named-notation lookup)."""
        lst = self.to_list()
        try:
            return lst.index(label)
        except ValueError as e:
            raise KeyError(label) from e

    def positions_of(self, labels: Iterable[Any]) -> list[int]:
        lst = self.to_list()
        index: dict = {}
        for i, v in enumerate(lst):
            index.setdefault(v, i)
        out = []
        for lab in labels:
            if lab not in index:
                raise KeyError(lab)
            out.append(index[lab])
        return out

    @property
    def domain(self) -> Domain:
        return Domain.STR


@dataclasses.dataclass(frozen=True)
class RangeLabels(Labels):
    """Positional labels ``start .. start+length-1`` — O(1) metadata."""

    length: int
    start: int = 0

    def __len__(self) -> int:
        return self.length

    def to_list(self) -> list:
        return list(range(self.start, self.start + self.length))

    def take(self, idx: np.ndarray) -> Labels:
        idx = np.asarray(idx)
        # A contiguous take of a range stays a range (keeps metadata O(1)).
        if idx.size and np.array_equal(idx, np.arange(idx[0], idx[0] + idx.size)):
            return RangeLabels(int(idx.size), self.start + int(idx[0]))
        # non-contiguous (filter/gather): stay vectorized — no per-row Python
        return IntLabels(self.start + idx.astype(np.int64))

    def concat(self, other: Labels) -> Labels:
        if (
            isinstance(other, RangeLabels)
            and other.start == self.start + self.length
        ):
            return RangeLabels(self.length + other.length, self.start)
        if isinstance(other, (RangeLabels, IntLabels)):
            mine = np.arange(self.start, self.start + self.length, dtype=np.int64)
            return IntLabels(mine).concat(other)
        return super().concat(other)

    def position_of(self, label: Any) -> int:
        if isinstance(label, (int, np.integer)):
            pos = int(label) - self.start
            if 0 <= pos < self.length:
                return pos
        raise KeyError(label)

    def positions_of(self, labels: Iterable[Any]) -> list[int]:
        return [self.position_of(l) for l in labels]

    @property
    def domain(self) -> Domain:
        return Domain.INT


class IntLabels(Labels):
    """Arbitrary integer labels backed by a host numpy vector — the vectorized
    form a ``RangeLabels`` collapses to after a filter or gather.  All label
    algebra (take / concat) is O(1) Python + one numpy op."""

    __slots__ = ("values",)

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values, dtype=np.int64)

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def to_list(self) -> list:
        return self.values.tolist()

    def take(self, idx: np.ndarray) -> Labels:
        return IntLabels(self.values[np.asarray(idx)])

    def concat(self, other: Labels) -> Labels:
        if isinstance(other, IntLabels):
            return IntLabels(np.concatenate([self.values, other.values]))
        if isinstance(other, RangeLabels):
            return IntLabels(np.concatenate([
                self.values,
                np.arange(other.start, other.start + other.length, dtype=np.int64)]))
        return super().concat(other)

    def position_of(self, label: Any) -> int:
        if isinstance(label, (int, np.integer)):
            hits = np.nonzero(self.values == int(label))[0]
            if hits.size:
                return int(hits[0])
        raise KeyError(label)

    # positions_of: inherit the base class's one-pass dict index — a per-label
    # nonzero scan would be O(k·n) on post-transpose many-column frames

    @property
    def domain(self) -> Domain:
        return Domain.INT


@dataclasses.dataclass(frozen=True)
class CodedLabels(Labels):
    """Dictionary-encoded labels: codes (host int32) + code table.

    ``table`` holds the distinct label *values* (any hashable host value);
    code -1 encodes a null label.
    """

    codes: np.ndarray  # (m,) int32, host
    table: tuple       # distinct values, first-occurrence order
    label_domain: Domain = Domain.STR  # recorded type (paper §3.5 label types)

    def __post_init__(self):
        object.__setattr__(self, "codes", np.asarray(self.codes, dtype=np.int32))

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def to_list(self) -> list:
        return [self.table[c] if c >= 0 else None for c in self.codes]

    def take(self, idx: np.ndarray) -> Labels:
        return CodedLabels(self.codes[np.asarray(idx)], self.table, self.label_domain)

    def concat(self, other: Labels) -> Labels:
        if isinstance(other, CodedLabels) and other.table == self.table:
            return CodedLabels(
                np.concatenate([self.codes, other.codes]), self.table, self.label_domain
            )
        return super().concat(other)

    def position_of(self, label: Any) -> int:
        try:
            code = self.table.index(label)
        except ValueError as e:
            raise KeyError(label) from e
        hits = np.nonzero(self.codes == code)[0]
        if hits.size == 0:
            raise KeyError(label)
        return int(hits[0])

    @property
    def domain(self) -> Domain:
        return self.label_domain


def labels_from_values(values: Sequence[Any], domain: Domain | None = None) -> Labels:
    """Build the cheapest label representation for ``values``."""
    vals = list(values)
    if all(isinstance(v, (int, np.integer)) for v in vals) and vals == list(
        range(vals[0] if vals else 0, (vals[0] if vals else 0) + len(vals))
    ):
        return RangeLabels(len(vals), int(vals[0]) if vals else 0)
    table: list = []
    index: dict = {}
    codes = np.zeros(len(vals), dtype=np.int32)
    for i, v in enumerate(vals):
        if v is None:
            codes[i] = -1
            continue
        if v not in index:
            index[v] = len(table)
            table.append(v)
        codes[i] = index[v]
    if domain is None:
        if all(isinstance(v, (int, np.integer)) for v in table):
            domain = Domain.INT
        elif all(isinstance(v, (int, float, np.integer, np.floating)) for v in table):
            domain = Domain.FLOAT
        else:
            domain = Domain.STR
    return CodedLabels(codes, tuple(table), domain)
