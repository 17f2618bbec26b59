"""Dataframe domains and the schema-induction function S(·).

Paper §3.2: ``Dom = {Σ*, int, float, bool, category}``; every column has a
domain that may be left unspecified and *induced post hoc* by a schema
induction function ``S : Σ*^m → Dom`` that examines the column's values.

Strings never reach the device.  Σ*-domain values are dictionary-encoded to
int32 codes on the host at ingest time; the code table lives in frame
metadata.  ``S`` therefore runs on host values (Python objects / numpy
arrays) and returns both the induced domain and the parsed representation,
a torch tensor on the requested device.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Sequence

import numpy as np
import torch

__all__ = [
    "Domain",
    "STR",
    "INT",
    "FLOAT",
    "BOOL",
    "CATEGORY",
    "UNSPECIFIED",
    "NULL",
    "storage_dtype",
    "induce_schema",
    "parse_column",
    "common_storage",
    "torch_dtype",
    "to_device",
    "resolve_device",
]

# Distinguished null value (paper: "Each domain contains a distinguished
# null value, sometimes written as NA").  We carry explicit validity masks on
# device; ``NULL`` is the host-side sentinel.
NULL = None


class Domain(enum.Enum):
    """The set *Dom* of column domains from the paper's data model."""

    STR = "str"            # Σ*  (dictionary-encoded int32 codes on device)
    INT = "int"            # int32 on device
    FLOAT = "float"        # float32 on device
    BOOL = "bool"          # bool on device
    CATEGORY = "category"  # dictionary-encoded int32 codes on device
    UNSPECIFIED = "unspecified"  # domain left unspecified; induced on demand

    # ---- storage properties -------------------------------------------------
    @property
    def is_coded(self) -> bool:
        """True if device storage is dictionary codes with a host code table."""
        return self in (Domain.STR, Domain.CATEGORY)

    @property
    def is_numeric(self) -> bool:
        return self in (Domain.INT, Domain.FLOAT, Domain.BOOL)

    def __repr__(self) -> str:  # compact reprs in schema printouts
        return self.value


STR = Domain.STR
INT = Domain.INT
FLOAT = Domain.FLOAT
BOOL = Domain.BOOL
CATEGORY = Domain.CATEGORY
UNSPECIFIED = Domain.UNSPECIFIED


def storage_dtype(domain: Domain) -> np.dtype:
    """Device dtype used to store values of ``domain``."""
    return {
        Domain.STR: np.dtype(np.int32),
        Domain.CATEGORY: np.dtype(np.int32),
        Domain.INT: np.dtype(np.int32),
        Domain.FLOAT: np.dtype(np.float32),
        Domain.BOOL: np.dtype(np.bool_),
        Domain.UNSPECIFIED: np.dtype(np.float32),
    }[domain]


_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32,
          np.dtype(np.bool_): torch.bool, np.dtype(np.int64): torch.int64,
          np.dtype(np.float64): torch.float64}


def torch_dtype(domain: Domain) -> torch.dtype:
    """Torch dtype of ``storage_dtype(domain)``."""
    return _TORCH[storage_dtype(domain)]


def common_storage(domains: Sequence[Domain]) -> Domain:
    """Common domain for matrix coercion (paper §3.3 TRANSPOSE semantics).

    Heterogeneous transposes coerce to the most general domain present.  Any
    coded (string-like) column forces STR; any float forces FLOAT over ints;
    bools widen to int.  Mirrors "In Python, everything is coerced to Object"
    — except our Object is the widest *numeric* representation plus code
    tables, so a second TRANSPOSE can recover the original schema
    (paper: "the schema induction function can always recover the original
    D_n after two transposes").
    """
    doms = set(d for d in domains if d is not Domain.UNSPECIFIED)
    if not doms:
        return Domain.UNSPECIFIED
    if any(d.is_coded for d in doms):
        return Domain.STR
    if Domain.FLOAT in doms:
        return Domain.FLOAT
    if Domain.INT in doms:
        return Domain.INT
    return Domain.BOOL


# -----------------------------------------------------------------------------
# Schema induction S(·)
# -----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParsedColumn:
    """Result of applying the parsing function p_i of the induced domain."""

    domain: Domain
    data: torch.Tensor        # (m,) tensor in storage dtype
    mask: torch.Tensor | None  # (m,) bool validity (True = valid); None = all valid
    dictionary: tuple | None  # host code table for coded domains


def _try_parse(values: list, caster, np_dtype) -> tuple[np.ndarray, np.ndarray] | None:
    out = np.zeros(len(values), dtype=np_dtype)
    mask = np.ones(len(values), dtype=np.bool_)
    for i, v in enumerate(values):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            mask[i] = False
            continue
        try:
            out[i] = caster(v)
        except (ValueError, TypeError):
            return None
    return out, mask


def _parse_bool(v: Any) -> bool:
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, str):
        low = v.strip().lower()
        if low in ("true", "yes", "t", "1"):
            return True
        if low in ("false", "no", "f", "0"):
            return False
    raise ValueError(v)


def _parse_int(v: Any) -> int:
    if isinstance(v, (bool, np.bool_)):
        raise ValueError(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        if float(v).is_integer():
            return int(v)
        raise ValueError(v)
    if isinstance(v, str):
        return int(v.strip())
    raise ValueError(v)


def _parse_float(v: Any) -> float:
    if isinstance(v, (bool, np.bool_)):
        raise ValueError(v)
    if isinstance(v, (int, float, np.integer, np.floating)):
        return float(v)
    if isinstance(v, str):
        return float(v.strip())
    raise ValueError(v)


def induce_schema(values: Sequence[Any]) -> Domain:
    """S(·): map an array of host values to the most specific domain in Dom.

    Paper §3.2: "S must examine every value in that column to determine the
    most specific domain from Dom that can be used to classify the data".
    Specificity order: bool ≺ int ≺ float ≺ category/str.
    """
    vals = list(values)
    non_null = [v for v in vals if v is not None and not (isinstance(v, float) and np.isnan(v))]
    if not non_null:
        return Domain.UNSPECIFIED
    if _try_parse(vals, _parse_bool, np.bool_) is not None:
        return Domain.BOOL
    if _try_parse(vals, _parse_int, np.int64) is not None:
        return Domain.INT
    if _try_parse(vals, _parse_float, np.float64) is not None:
        return Domain.FLOAT
    return Domain.STR


def encode_dictionary(values: Sequence[Any]) -> tuple[np.ndarray, np.ndarray, tuple]:
    """Dictionary-encode host values → (codes int32, mask, table).

    Codes follow first-occurrence order so the encoding is order-stable
    (the dataframe model is ordered; paper §3.2).
    """
    table: list = []
    index: dict = {}
    codes = np.zeros(len(values), dtype=np.int32)
    mask = np.ones(len(values), dtype=np.bool_)
    for i, v in enumerate(values):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            mask[i] = False
            codes[i] = -1
            continue
        key = str(v)
        if key not in index:
            index[key] = len(table)
            table.append(key)
        codes[i] = index[key]
    return codes, mask, tuple(table)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Without a GPU, the default raises instead of quietly running
    on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless told otherwise, and no CUDA "
            "device is available here; pass device='cpu' to run on the CPU")
    return dev


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host numpy array → a tensor of its own on ``device`` (one copy; the
    tensor never aliases the caller's array)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device, copy=True)


def parse_column(values: Sequence[Any], domain: Domain | None = None, *,
                 device) -> ParsedColumn:
    """Apply S(·) (if needed) and the domain's parsing function p_i; the
    parsed column lands on ``device``."""
    vals = list(values)
    dom = domain if domain is not None and domain is not Domain.UNSPECIFIED else induce_schema(vals)
    if dom is Domain.UNSPECIFIED:
        # all-null column: store zeros with an all-False mask
        data = np.zeros(len(vals), dtype=np.float32)
        mask = np.zeros(len(vals), dtype=np.bool_)
        return ParsedColumn(dom, to_device(data, device), to_device(mask, device), None)
    if dom.is_coded:
        codes, mask, table = encode_dictionary(vals)
        return ParsedColumn(dom, to_device(codes, device),
                            to_device(mask, device) if not mask.all() else None, table)
    caster = {Domain.BOOL: _parse_bool, Domain.INT: _parse_int, Domain.FLOAT: _parse_float}[dom]
    parsed = _try_parse(vals, caster, storage_dtype(dom))
    if parsed is None:
        # values do not actually parse in the requested domain → fall back to
        # Σ*.  NOTE: integers beyond int32 deliberately raise OverflowError
        # here rather than parse — int32 storage would wrap them.  Paths that
        # handle wide ints exactly build int64 HOST columns directly
        # (``physical._host_column`` for groupby key decode).
        return parse_column(vals, Domain.STR, device=device)
    data, mask = parsed
    return ParsedColumn(
        dom,
        to_device(data.astype(storage_dtype(dom)), device),
        to_device(mask, device) if not mask.all() else None,
        None,
    )
