"""The dataframe value container: DF = (A_mn, R_m, C_n, D_n)  (paper §3.2).

``Frame`` is a *single-partition* dataframe instance: the unit that kernels
and per-block physical operators execute on.  Distribution happens one level
up (``partition.PartitionedFrame``).

Representation:
  * one 1-D torch tensor per column in its domain's storage dtype, on the
    frame's device (CUDA unless the caller asked for the CPU),
  * optional validity mask per column (None = all valid),
  * host-side code table per coded (Σ*/category) column,
  * row labels R_m and column labels C_n as ``labels.Labels`` metadata (host),
  * schema D_n as a tuple of ``Domain`` (UNSPECIFIED entries are induced on
    demand by S(·) — ``induce()``),
  * optional ``row_domains``: the pre-TRANSPOSE schema, letting a second
    TRANSPOSE recover the original D_n (paper §3.3).

Tensors held by a Frame are never updated in place: the executor's cache and
multi-query sharing hand one Frame to several statements.  The one host
exception is a groupby key column whose values exceed int32
(``physical._host_column``): it stays an int64 numpy array.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from .dtypes import (
    Domain,
    ParsedColumn,
    common_storage,
    induce_schema,
    parse_column,
    resolve_device,
    to_device,
    torch_dtype,
)
from .labels import Labels, RangeLabels, labels_from_values

__all__ = ["Column", "Frame", "host", "as_tensor", "infer_domain"]


def host(a) -> np.ndarray:
    """Host numpy view of a column array (device → host copy for tensors)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def as_tensor(v, device) -> torch.Tensor:
    """A UDF output (tensor, numpy array or list) as a tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return to_device(np.asarray(v), device)


def infer_domain(t: torch.Tensor) -> Domain:
    """Domain of a computed tensor from its dtype."""
    if t.dtype == torch.bool:
        return Domain.BOOL
    return Domain.FLOAT if t.dtype.is_floating_point else Domain.INT


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


@dataclasses.dataclass(frozen=True)
class Column:
    """One column of A_mn with its domain, validity mask, and code table."""

    data: torch.Tensor          # (m,) storage-dtype tensor
    domain: Domain
    mask: torch.Tensor | None = None   # (m,) bool, True = valid; None = all valid
    dictionary: tuple | None = None    # host code table when domain.is_coded

    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device if isinstance(self.data, torch.Tensor) else torch.device("cpu")

    # ---- host materialization -------------------------------------------
    def to_pylist(self) -> list:
        data = host(self.data)
        if self.domain.is_coded:
            table = self.dictionary or ()
            out = [table[c] if 0 <= c < len(table) else None for c in data.tolist()]
        elif self.domain is Domain.BOOL:
            out = data.astype(bool).tolist()
        elif self.domain is Domain.INT:
            out = data.astype(np.int64).tolist()
        else:
            out = data.astype(np.float64).tolist()
        if self.mask is not None:
            valid = host(self.mask)
            out = [v if ok else None for v, ok in zip(out, valid.tolist())]
        return out

    def valid_mask(self) -> torch.Tensor:
        if self.mask is not None:
            return self.mask
        return torch.ones(len(self), dtype=torch.bool, device=self.device)

    def value_at(self, i: int):
        """Decode a single position without materializing the column."""
        if self.mask is not None and not bool(self.mask[i]):
            return None
        v = self.data[i]
        if self.domain.is_coded:
            code = int(v)
            return self.dictionary[code] if 0 <= code < len(self.dictionary) else None
        if self.domain is Domain.BOOL:
            return bool(v)
        if self.domain is Domain.INT:
            return int(v)
        return float(v)

    def take(self, idx) -> "Column":
        """Gather rows; ``idx`` is a host int array, an int64 tensor on this
        column's device, or a ``slice``."""
        if isinstance(self.data, np.ndarray):
            i = host(idx) if not isinstance(idx, slice) else idx
            return Column(self.data[i], self.domain,
                          None if self.mask is None else host(self.mask)[i],
                          self.dictionary)
        if not isinstance(idx, (slice, torch.Tensor)):
            idx = _index(idx, self.device)
        if isinstance(idx, slice):
            return Column(self.data[idx], self.domain,
                          None if self.mask is None else self.mask[idx],
                          self.dictionary)
        return Column(self.data.index_select(0, idx), self.domain,
                      None if self.mask is None else self.mask.index_select(0, idx),
                      self.dictionary)

    def filter(self, keep) -> "Column":
        return self.take(np.nonzero(host(keep))[0])

    def astype_storage(self, target: Domain) -> torch.Tensor:
        """Numeric view of this column in ``target``'s storage dtype.

        Coded columns decode to their *codes* when the target is coded; when
        the target is numeric the codes are meaningless — the same failure
        mode pandas produces for numeric ops over objects.
        """
        dt = torch.int32 if target.is_coded else torch_dtype(target)
        if isinstance(self.data, np.ndarray):
            return torch.from_numpy(self.data).to(dt)
        return self.data.to(dt)


def _parsed_to_column(p: ParsedColumn) -> Column:
    return Column(p.data, p.domain, p.mask, p.dictionary)


def _strided_matrix(columns: Sequence[Column], dtype: torch.dtype) -> torch.Tensor | None:
    """The (m, n) matrix of ``columns`` as ONE strided view when every column
    is an equally spaced view of the same memory — the columns a TRANSPOSE
    made (``out.unbind(1)``) — else None.  Stacking hundreds of thousands of
    such strided columns costs one copy launch each on a GPU; the view costs
    one pointer check per column."""
    first = columns[0].data
    if len(columns) < 2 or not isinstance(first, torch.Tensor) or first.dim() != 1:
        return None
    ptr, row_stride = first.data_ptr(), first.stride(0)
    step = columns[1].data.data_ptr() - ptr if isinstance(columns[1].data, torch.Tensor) else 0
    size = first.element_size()
    if step <= 0 or step % size:
        return None
    for j, c in enumerate(columns):
        d = c.data
        if (not isinstance(d, torch.Tensor) or d.dtype != dtype
                or d.data_ptr() != ptr + j * step or d.stride(0) != row_stride):
            return None
    try:
        # bounds-checked against the first column's storage: columns that
        # merely sit in a row in memory, outside it, are refused here
        return first.as_strided((len(first), len(columns)), (row_stride, step // size))
    except RuntimeError:
        return None


def _contiguous_range(idx: np.ndarray) -> slice | None:
    n = int(idx.shape[0])
    if n and int(idx[-1]) - int(idx[0]) == n - 1 and (n == 1 or bool((np.diff(idx) == 1).all())):
        return slice(int(idx[0]), int(idx[0]) + n)
    return None


class Frame:
    """A single-partition dataframe (A_mn, R_m, C_n, D_n)."""

    def __init__(
        self,
        columns: Sequence[Column],
        row_labels: Labels,
        col_labels: Labels,
        row_domains: tuple[Domain, ...] | None = None,
        device: torch.device | str | None = None,
    ):
        self.columns = list(columns)
        self.row_labels = row_labels
        self.col_labels = col_labels
        # Pre-transpose schema carried along for recovery after a second
        # TRANSPOSE (paper §3.3 / §5 "types maintained at both row and column
        # level ... type inference faster after a transpose").
        self.row_domains = row_domains
        # device of a frame with no columns; otherwise its columns' device
        self._device = torch.device(device) if device is not None else None
        m = len(row_labels)
        for c in self.columns:
            assert len(c) == m, f"column length {len(c)} != nrows {m}"
        assert len(col_labels) == len(self.columns)

    @property
    def device(self) -> torch.device:
        for c in self.columns:
            if isinstance(c.data, torch.Tensor):
                return c.data.device
        return self._device or torch.device("cpu")

    def to(self, device) -> "Frame":
        """This frame on ``device``: each tensor copied there once (an int64
        host key column stays a numpy array)."""
        dev = torch.device(device)
        mv = lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a
        return Frame([Column(mv(c.data), c.domain, None if c.mask is None else mv(c.mask),
                             c.dictionary) for c in self.columns],
                     self.row_labels, self.col_labels, self.row_domains, device=dev)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @staticmethod
    def from_pydict(
        data: dict[str, Sequence[Any]],
        row_labels: Sequence[Any] | None = None,
        domains: Sequence[Domain] | None = None,
        *,
        device=None,
    ) -> "Frame":
        """Build a frame from host values on ``device`` (default: CUDA)."""
        dev = resolve_device(device)
        names = list(data.keys())
        cols = []
        for j, name in enumerate(names):
            dom = domains[j] if domains is not None else None
            cols.append(_parsed_to_column(parse_column(list(data[name]), dom, device=dev)))
        m = len(cols[0]) if cols else 0
        rl = labels_from_values(list(row_labels)) if row_labels is not None else RangeLabels(m)
        return Frame(cols, rl, labels_from_values(names), device=dev)

    @staticmethod
    def from_matrix(
        values: torch.Tensor,
        domain: Domain = Domain.FLOAT,
        row_labels: Labels | None = None,
        col_labels: Labels | None = None,
    ) -> "Frame":
        """Homogeneous ("matrix dataframe", paper §3.2) constructor: each
        column is a (strided) view of the one matrix, made in one call."""
        m, n = values.shape
        mat = values.to(torch_dtype(domain))
        cols = [Column(v, domain) for v in mat.unbind(1)]
        return Frame(
            cols,
            row_labels if row_labels is not None else RangeLabels(m),
            col_labels if col_labels is not None else RangeLabels(n),
            device=mat.device,
        )

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def nrows(self) -> int:
        return len(self.row_labels)

    @property
    def ncols(self) -> int:
        return len(self.columns)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def schema(self) -> tuple[Domain, ...]:
        return tuple(c.domain for c in self.columns)

    def induce(self) -> "Frame":
        """Apply S(·) to every UNSPECIFIED column (paper §3.2)."""
        if all(c.domain is not Domain.UNSPECIFIED for c in self.columns):
            return self
        cols = []
        for c in self.columns:
            if c.domain is not Domain.UNSPECIFIED:
                cols.append(c)
                continue
            vals = c.to_pylist()
            cols.append(_parsed_to_column(parse_column(vals, induce_schema(vals),
                                                       device=c.device)))
        return Frame(cols, self.row_labels, self.col_labels, self.row_domains,
                     device=self.device)

    def is_matrix(self) -> bool:
        """Matrix dataframe (§3.2): every column in a numeric field domain."""
        f = self.induce()
        return all(d.is_numeric for d in f.schema)

    # ------------------------------------------------------------------
    # matrix coercion (for TRANSPOSE / linear-algebra ops)
    # ------------------------------------------------------------------
    def as_matrix(self, target: Domain | None = None) -> tuple[torch.Tensor, Domain]:
        # explicit target ⇒ no schema induction needed (storage casting only)
        f = self if target is not None else self.induce()
        tgt = target or common_storage(f.schema)
        if tgt is Domain.UNSPECIFIED:
            tgt = Domain.FLOAT
        if not f.ncols:
            return torch.zeros((f.nrows, 0), dtype=torch_dtype(tgt), device=f.device), tgt
        strided = _strided_matrix(f.columns, torch_dtype(tgt))
        if strided is not None:
            return strided, tgt
        dev = f.device
        return torch.stack([c.astype_storage(tgt).to(dev) for c in f.columns], dim=1), tgt

    # ------------------------------------------------------------------
    # row/column selection
    # ------------------------------------------------------------------
    def take_rows(self, idx) -> "Frame":
        idx_np = np.asarray(idx, dtype=np.int64)
        rd = None
        if self.row_domains is not None and len(self.row_domains) == self.nrows:
            rd = tuple(self.row_domains[int(i)] for i in idx_np)
        # one index for every column: a contiguous range slices (views), a
        # gather moves the index to the device once
        sel = _contiguous_range(idx_np)
        if sel is None:
            sel = _index(idx_np, self.device)
        return Frame(
            [c.take(sel) for c in self.columns],
            self.row_labels.take(idx_np),
            self.col_labels,
            rd,
            device=self.device,
        )

    def filter_rows(self, keep) -> "Frame":
        return self.take_rows(np.nonzero(host(keep))[0])

    def take_cols(self, idx: Sequence[int]) -> "Frame":
        # row_domains is a per-ROW vector (the pre-transpose schema): column
        # selection leaves it intact.
        idx = list(idx)
        return Frame(
            [self.columns[j] for j in idx],
            self.row_labels,
            self.col_labels.take(np.asarray(idx, dtype=np.int64)),
            self.row_domains,
            device=self.device,
        )

    def col(self, name: Any) -> Column:
        return self.columns[self.col_labels.position_of(name)]

    def head(self, k: int) -> "Frame":
        return self.take_rows(np.arange(min(k, self.nrows)))

    def tail(self, k: int) -> "Frame":
        k = min(k, self.nrows)
        return self.take_rows(np.arange(self.nrows - k, self.nrows))

    # ------------------------------------------------------------------
    # concatenation (UNION building block — order preserved, paper Table 1)
    # ------------------------------------------------------------------
    def concat_rows(self, other: "Frame") -> "Frame":
        assert self.ncols == other.ncols, "UNION requires equal arity"
        cols = []
        for a, b in zip(self.columns, other.columns):
            a, b = _unify_pair(a, b)
            mask = None
            if a.mask is not None or b.mask is not None:
                mask = _concat_arrays(a.valid_mask(), b.valid_mask())
            cols.append(Column(_concat_arrays(a.data, b.data), a.domain, mask, a.dictionary))
        rd = None
        if (self.row_domains is not None and other.row_domains is not None
                and len(self.row_domains) == self.nrows
                and len(other.row_domains) == other.nrows):
            rd = self.row_domains + other.row_domains
        return Frame(cols, self.row_labels.concat(other.row_labels), self.col_labels, rd,
                     device=self.device)

    def concat_cols(self, other: "Frame") -> "Frame":
        assert self.nrows == other.nrows
        return Frame(
            self.columns + other.columns,
            self.row_labels,
            self.col_labels.concat(other.col_labels),
            device=self.device,
        )

    # ------------------------------------------------------------------
    # point access/update (ordered point updates, paper §2 C1)
    # ------------------------------------------------------------------
    def iloc_get(self, r: int, c: int) -> Any:
        return self.columns[c].value_at(r)

    def iloc_set(self, r: int, c: int, value: Any) -> "Frame":
        """A new frame with one value replaced; the held column is copied,
        never updated in place."""
        col = self.columns[c]
        data = col.data.clone() if isinstance(col.data, torch.Tensor) else col.data.copy()
        if col.domain.is_coded:
            table = list(col.dictionary or ())
            key = str(value)
            if key not in table:
                table.append(key)
            data[r] = table.index(key)
            new = Column(data, col.domain, _set_valid(col, r), tuple(table))
        else:
            data[r] = value
            new = Column(data, col.domain, _set_valid(col, r), None)
        cols = list(self.columns)
        cols[c] = new
        return Frame(cols, self.row_labels, self.col_labels, self.row_domains,
                     device=self.device)

    # ------------------------------------------------------------------
    # host views (display / testing)
    # ------------------------------------------------------------------
    def to_pydict(self) -> dict:
        return {
            name: col.to_pylist()
            for name, col in zip(self.col_labels.to_list(), self.columns)
        }

    def to_records(self) -> list[tuple]:
        cols = [c.to_pylist() for c in self.columns]
        return [tuple(col[i] for col in cols) for i in range(self.nrows)]

    def __repr__(self) -> str:
        names = self.col_labels.to_list()
        doms = [d.value for d in self.schema]
        return (
            f"Frame[{self.nrows}x{self.ncols}] cols={list(zip(names, doms))[:8]}"
            + ("…" if self.ncols > 8 else "")
        )

    # bytes of column payload (for the materialization-cache cost model)
    def nbytes(self) -> int:
        total = 0
        for c in self.columns:
            d = c.data
            total += d.numel() * d.element_size() if isinstance(d, torch.Tensor) else d.nbytes
            if c.mask is not None:
                total += c.mask.numel()
        return total


def _concat_arrays(a, b):
    """Row-axis concat on the columns' device; a host int64 key column stays
    on the host unless it meets a tensor."""
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return np.concatenate([a, b])
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a).to(b.device)
    if isinstance(b, np.ndarray):
        b = torch.from_numpy(b).to(a.device)
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.cat([a, b])


def _set_valid(col: Column, r: int):
    if col.mask is None:
        return None
    mask = col.mask.clone()
    mask[r] = True
    return mask


def _unify_pair(a: Column, b: Column) -> tuple[Column, Column]:
    """Make two columns concatenable: same domain + shared dictionary."""
    if a.domain is b.domain and a.dictionary == b.dictionary:
        return a, b
    if a.domain.is_coded or b.domain.is_coded:
        # Re-encode both against a merged dictionary.
        av, bv = a.to_pylist(), b.to_pylist()
        pa = parse_column([None if v is None else str(v) for v in av], Domain.STR,
                          device=a.device)
        table = list(pa.dictionary or ())
        index = {v: i for i, v in enumerate(table)}
        codes_b = np.zeros(len(bv), dtype=np.int32)
        mask_b = np.ones(len(bv), dtype=np.bool_)
        for i, v in enumerate(bv):
            if v is None:
                codes_b[i] = -1
                mask_b[i] = False
                continue
            key = str(v)
            if key not in index:
                index[key] = len(table)
                table.append(key)
            codes_b[i] = index[key]
        ca = Column(pa.data, Domain.STR, pa.mask, tuple(table))
        cb = Column(
            to_device(codes_b, a.device),
            Domain.STR,
            to_device(mask_b, a.device) if not mask_b.all() else None,
            tuple(table),
        )
        return ca, cb
    tgt = common_storage([a.domain, b.domain])
    return (
        Column(a.astype_storage(tgt), tgt, a.mask, None),
        Column(b.astype_storage(tgt), tgt, b.mask, None),
    )
