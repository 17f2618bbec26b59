"""Per-device accounting of an eager run: the roofline terms of one step.

The reference (``repro/launch/hlo_analysis.py``) parses the optimized HLO
that XLA compiles for the mesh.  The port has no HLO: PyTorch runs eagerly,
so the counterpart watches the aten operators of one run (on meta tensors
in the dry-run: shapes, no data) and counts, **per device**:

  * FLOPs: every matrix product (mm, addmm, bmm, baddbmm, _scaled_mm;
    einsum and matmul reach these) — 2 x |result| x contracted dims;
    elementwise FLOPs are ignored, as MFU conventions do;
  * HBM bytes: per operator, operands plus result ("raw"); "fused" skips
    the elementwise set that a fusing compiler keeps out of memory
    (``_FUSES_AWAY``, the reference's list in aten's names); views and
    allocations move nothing and are skipped;
  * collective wire bytes, by kind, from the functional collectives
    (``_c10d_functional``) with the reference's ring factors: all-reduce
    2x, reduce-scatter counts its input;
  * the analytic counts the kernels K5, K6 and K7 charge on meta tensors
    (``kernels/_util.charge``), in FLOPs and both byte totals, and by
    kernel;
  * the peak bytes of live tensors on this device: arguments plus every
    operator's result that is no view, from its creation until the last
    Python reference to it goes (weakref finalizers).

**Per device, from the local shards.**  On DTensors the accounting reads
two levels.  A dispatch mode above DTensor sees each operator once, with
global shapes; its FLOPs are the global count divided by the devices that
split the work (the mesh dims on which the result is ``Shard`` or
``Partial``; ``Replicate`` dims repeat it), its bytes those of the local
shards of its operands and result.  A second mode below DTensor sees what
DTensor does on the shards, and from it takes the collectives alone
(DTensor's own propagation runs operators on global-shape meta tensors
there, which must not count).  Plain tensors count as they are.

A Python loop in eager runs every iteration, so there are no loop trip
counts to resolve; the reference's ``unresolved_loops`` becomes
``replicated_ops``: operators DTensor has no sharding rule for, which the
run gathered and ran replicated (``models/sharding_ctx``).

``Roofline`` turns the three per-device totals into seconds against the
data-sheet peaks of one NVIDIA H100 SXM (dense, 700 W).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels._util import charging

_COLLECTIVES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
                "broadcast": "collective-permute"}

# matrix products and the index of their (lhs, rhs) operands
_DOTS = {"mm": (0, 1), "addmm": (1, 2), "bmm": (0, 1), "baddbmm": (1, 2),
         "_scaled_mm": (0, 1)}

# allocations and bookkeeping that move no bytes
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
             "arange", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
             "scalar_tensor", "detach", "alias"}

# The reference's _FUSES_AWAY (elementwise / shape plumbing a fusing compile
# keeps out of HBM), in aten's names; an in-place variant ("add_") counts as
# its operator.
_FUSES_AWAY = {
    "add", "sub", "subtract", "rsub", "mul", "multiply", "div", "divide", "maximum",
    "minimum", "exp", "exp2", "log", "log2", "tanh", "rsqrt", "sqrt", "pow", "neg",
    "abs", "sign", "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "_to_copy", "expand", "reshape", "view",
    "clamp", "clamp_min", "clamp_max", "floor", "ceil", "sin", "cos", "isfinite",
    "isnan", "expm1", "log1p", "sigmoid", "atan2", "remainder", "fmod", "reciprocal",
    "bitwise_left_shift", "bitwise_right_shift", "__lshift__", "__rshift__",
    "masked_fill", "fill", "copy", "silu", "gelu", "square", "relu",
}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    """A DTensor's local shard, or the tensor itself."""
    return getattr(t, "_local_tensor", t)


def _is_dtensor(t) -> bool:
    return hasattr(t, "_local_tensor") and hasattr(t, "placements")


def _split(t) -> int:
    """Devices that split the work of an operator whose result is ``t``:
    the mesh dims where ``t`` is Shard or Partial."""
    if not _is_dtensor(t):
        return 1
    n = 1
    for i, p in enumerate(t.placements):
        if p.is_shard() or p.is_partial():
            n *= t.device_mesh.size(i)
    return n


def _is_view(func) -> bool:
    rets = func._schema.returns
    alias = rets[0].alias_info if rets else None
    return alias is not None and not alias.is_write


def _base_name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0        # every operator's operands + result (raw)
    hbm_bytes_fused: float = 0.0  # elementwise operators fused away
    wire_bytes: float = 0.0
    wire_bytes_f32: float = 0.0   # of those, float32 payloads
    collective_counts: dict = dataclasses.field(default_factory=dict)
    wire_bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    dot_count: float = 0.0
    replicated_ops: int = 0       # operators run replicated (no sharding rule)
    replicated_by_op: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)   # name -> calls, flops, bytes
    peak_live_bytes: float = 0.0
    arg_bytes: float = 0.0
    # profiling breakdowns: (op, shape) -> accumulated bytes / flops
    bytes_by_key: dict = dataclasses.field(default_factory=dict)
    flops_by_key: dict = dataclasses.field(default_factory=dict)
    # (kind, result shapes) -> wire bytes of the collectives
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    output: Any = dataclasses.field(default=None, repr=False)

    def top_bytes(self, n: int = 15) -> list[tuple[str, float]]:
        return sorted(self.bytes_by_key.items(), key=lambda kv: -kv[1])[:n]

    def top_flops(self, n: int = 15) -> list[tuple[str, float]]:
        return sorted(self.flops_by_key.items(), key=lambda kv: -kv[1])[:n]

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_fused": self.hbm_bytes_fused,
            "wire_bytes": self.wire_bytes,
            "wire_bytes_f32": self.wire_bytes_f32,
            "collective_counts": self.collective_counts,
            "wire_bytes_by_kind": self.wire_bytes_by_kind,
            "dot_count": self.dot_count,
            "replicated_ops": self.replicated_ops,
            "replicated_by_op": self.replicated_by_op,
            "kernels": self.kernels,
            "peak_live_bytes": self.peak_live_bytes,
            "top_bytes": self.top_bytes(),
            "top_flops": self.top_flops(),
            "collective_bytes_by_shape": [
                {"kind": kind, "shapes": [list(x) for x in shapes], "bytes": v}
                for (kind, shapes), v in self.collective_bytes.items()],
        }


class _Accounting:
    def __init__(self) -> None:
        self.stats = OpStats()
        self._live = 0
        self._seen: set[int] = set()

    # ---- memory -----------------------------------------------------------
    def hold(self, t: torch.Tensor) -> None:
        key = id(t)
        if key in self._seen:
            return
        self._seen.add(key)
        n = _bytes(t)
        self._live += n
        self.stats.peak_live_bytes = max(self.stats.peak_live_bytes, self._live)
        weakref.finalize(t, self._release, key, n)

    def _release(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self._live -= n

    # ---- charges ----------------------------------------------------------
    def _add(self, table: dict, key: str, v: float) -> None:
        table[key] = table.get(key, 0.0) + v

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        s = self.stats
        s.flops += flops
        s.hbm_bytes += nbytes
        s.hbm_bytes_fused += nbytes
        rec = s.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self._add(s.flops_by_key, f"kernel {name}", flops)
        self._add(s.bytes_by_key, f"kernel {name}", nbytes)

    def operator(self, func, args, kwargs, out) -> None:
        name = _base_name(func)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not _is_view(func):
            for t in outs:
                if not func._schema.is_mutable or t is not (args[0] if args else None):
                    self.hold(_local(t))
        if name in _NO_BYTES or _is_view(func):
            return
        s = self.stats
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        nbytes = sum(_bytes(_local(t)) for t in ins) + sum(_bytes(_local(t)) for t in outs)
        shape = tuple(_local(outs[0]).shape) if outs else ()
        if name in _DOTS and outs:
            lhs, rhs = (args[i] for i in _DOTS[name])
            fl = 2.0 * outs[0].numel() * lhs.shape[-1] / _split(outs[0])
            s.flops += fl
            s.dot_count += 1
            self._add(s.flops_by_key, f"{name} {shape}", fl)
        s.hbm_bytes += nbytes
        if name not in _FUSES_AWAY:
            s.hbm_bytes_fused += nbytes
            self._add(s.bytes_by_key, f"{name} {shape}", nbytes)

    def collective(self, func, args, out) -> None:
        name = func.overloadpacket.__name__
        kind = next((k for p, k in _COLLECTIVES.items() if name.startswith(p)), None)
        if kind is None:
            return
        s = self.stats
        result = sum(_bytes(t) for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))
        operand = sum(_bytes(t) for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor))
        nbytes = max(result, operand) if kind == "reduce-scatter" else result
        wire = (2.0 if kind == "all-reduce" else 1.0) * nbytes
        s.wire_bytes += wire
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for t in tree_flatten(out)[0]):
            s.wire_bytes_f32 += wire
        self._add(s.wire_bytes_by_kind, kind, wire)
        s.collective_counts[kind] = s.collective_counts.get(kind, 0) + 1
        s.hbm_bytes += result + operand
        shape = tuple(t.shape for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))
        self._add(s.bytes_by_key, f"{kind} {shape}", wire)
        self._add(s.collective_bytes, (kind, tuple(tuple(x) for x in shape)), wire)


def _is_collective(func) -> bool:
    return func.namespace.startswith("_c10d_functional") or func.namespace == "c10d"


class _Global(TorchDispatchMode):
    """Above DTensor: every operator once, global shapes, local shards."""

    def __init__(self, acct: _Accounting):
        super().__init__()
        self.acct = acct

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _is_collective(func):
            self.acct.operator(func, args, kwargs, out)
        return out


class _Shards(TorchDispatchMode):
    """Below DTensor: the collectives DTensor runs on the shards."""

    def __init__(self, acct: _Accounting):
        super().__init__()
        self.acct = acct

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented          # let DTensor run; its shard ops come back here
        out = func(*args, **kwargs)
        if _is_collective(func):
            self.acct.collective(func, args, out)
        return out


def analyze(fn: Callable, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` once under the accounting; the counts are
    per device (this process's shards).  The result is kept as
    ``OpStats.output``."""
    acct = _Accounting()
    for t in tree_flatten((args, kwargs))[0]:
        if isinstance(t, torch.Tensor):
            acct.hold(_local(t))
    acct.stats.arg_bytes = acct.stats.peak_live_bytes
    with _Shards(acct), _Global(acct), charging(acct.kernel):
        out = fn(*args, **kwargs)
    acct.stats.output = out
    return acct.stats


# Backwards-compatible shape for collective-only callers.
@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    counts: dict = dataclasses.field(default_factory=dict)
    replicated_ops: int = 0


def collective_bytes(fn: Callable, *args, **kwargs) -> CollectiveStats:
    s = analyze(fn, *args, **kwargs)
    return CollectiveStats(s.wire_bytes, s.collective_counts, s.replicated_ops)


# -----------------------------------------------------------------------------
# roofline terms: NVIDIA H100 80GB HBM3 (SXM), data sheet, dense, 700 W limit
# -----------------------------------------------------------------------------
PEAK_FLOPS = 989e12       # bf16 tensor-core FLOP/s per card (NVIDIA H100 SXM data sheet, dense)
HBM_BW = 3.35e12          # HBM3 bytes/s per card (NVIDIA H100 80GB HBM3 SXM data sheet)
LINK_BW = 450e9           # NVLink bytes/s each way per card (900 GB/s total, data sheet)


@dataclasses.dataclass
class Roofline:
    """The accounting's quantities are **per device**; ``model_flops`` is
    global (6·N·D train / 2·N·D inference).  Peaks: ``PEAK_FLOPS``,
    ``HBM_BW``, ``LINK_BW`` (one H100 SXM at its 700 W limit; a card set
    lower runs slower)."""

    hlo_flops: float
    hlo_bytes: float
    wire_bytes: float
    chips: int
    model_flops: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step-time bound (terms overlap: max, not sum)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        if not self.hlo_flops:
            return 0.0
        return (self.model_flops / self.chips) / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """(useful FLOPs a device / step-time bound) / peak — the MFU the
        accounted program admits (1.0: compute-bound, no waste)."""
        if self.step_s <= 0:
            return 0.0
        return (self.model_flops / self.chips / self.step_s) / PEAK_FLOPS

    def to_dict(self) -> dict:
        return {
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "wire_bytes_per_dev": self.wire_bytes,
            "chips": self.chips,
            "model_flops_global": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_s": self.step_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }
