"""Activation-sharding context: pins batch sharding through the network, as
the reference's ``repro/models/sharding_ctx.py``.

With FSDP-style weight sharding (weights sharded over the DP axis), a
sharding propagator may prefer resharding *activations* (replicating the
batch) over all-gathering weights.  Pinning the hidden state's placement at
block boundaries forces the intended plan: the batch stays on the DP mesh
dims, weights are all-gathered just in time (ZeRO-3 semantics).

The reference consults the context while jit traces; here it is consulted as
the eager forward / decode runs.  Without an active context, or on a tensor
that is not a DTensor, ``constrain_hidden`` returns its argument itself, so
tests and single-device runs are unaffected.

While the context is active, ``gather`` runs on the shards with its
gathered dim made whole (``_gather_on_shards``), ``new_zeros`` and its
kin keep their source's placement on the dims whose size they keep
(``_new_on_shards``), and an operator that
DTensor has no sharding rule for runs on arguments gathered one mesh dim at
a time until DTensor takes it (``_replicated``; the gathers are collectives
that an accounting below counts).  Each such operator is listed by name in
``replicated`` of the context's record; GSPMD has no such gaps, so the
reference has no counterpart.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_act_sharding",
                                                      default=None)


@dataclasses.dataclass
class ShardingRecord:
    """What the context saw: operators run replicated, by name and count."""
    replicated: dict = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def activation_sharding(mesh, dp_axes: tuple[str, ...]):
    """Pin activations' batch dim to ``dp_axes`` of ``mesh`` (a torch
    ``DeviceMesh``) while active; yields the context's ``ShardingRecord``."""
    record = ShardingRecord()
    token = _CTX.set((mesh, tuple(dp_axes), record))
    try:
        with _Fallback(record):
            yield record
    finally:
        _CTX.reset(token)


def _dp_size(mesh, dp) -> int:
    n = 1
    for a in dp:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain_hidden(x):
    """x (B, S, d) or (B, 1, d): pin B to the DP mesh dims when divisible
    (``Shard(0)`` on each, ``Replicate()`` elsewhere)."""
    ctx = _CTX.get()
    if ctx is None or not _is_dtensor(x):
        return x
    mesh, dp, _ = ctx
    if x.shape[0] % _dp_size(mesh, dp) != 0:
        return x
    from torch.distributed.tensor import Replicate, Shard
    placements = [Shard(0) if name in dp else Replicate() for name in mesh.mesh_dim_names]
    if list(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain_heads(t):
    """q / k / v (B, S, heads, head_dim): a mesh dim that splits the head
    dim, or the heads other than whole heads a device, is gathered (a KV
    projection whose columns "model" splits mid-head: yi-6b's 4 KV heads x
    128 over 16 devices).  Left to DTensor, such a split contracts the head
    dim across devices and all-reduces the (B, H, Sq, Sk) scores; gathered,
    it moves the (B, S, KVH, D) tensor once.  A plain tensor, or a mesh dim
    of size 1, is left as it is."""
    if not _is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    heads = t.ndim - 2
    pl = [Replicate() if mesh.size(i) > 1 and isinstance(p, Shard) and p.dim >= heads
          and not (type(p) is Shard and p.dim == heads) else p
          for i, p in enumerate(t.placements)]
    return t if pl == list(t.placements) else t.redistribute(mesh, pl)


# =============================================================================
# operators without a sharding rule
# =============================================================================
_NO_RULE = ("sharding strategy", "Sharding propagation failed", "placement changes",
            "is invalid for input of size")


def _no_rule(err: Exception) -> bool:
    """Whether DTensor refused an operator for want of a sharding rule (its
    messages vary across torch versions), failed inside its own sharding
    code (the innermost frame is DTensor's: a gap of its rules, such as
    2.11's for ``constant_pad_nd`` on a sharded width), or placed a view's
    result on more devices than its dim has rows (the view's local shape
    then fails)."""
    text = str(err)
    if any(m in text for m in _NO_RULE):
        return True
    tb = err.__traceback__
    while tb is not None and tb.tb_next is not None:
        tb = tb.tb_next
    return tb is not None and _DTENSOR_SRC in tb.tb_frame.f_code.co_filename


_DTENSOR_SRC = "torch/distributed/tensor/"


_NEW_LIKE = (torch.ops.aten.new_zeros.default, torch.ops.aten.new_empty.default,
             torch.ops.aten.new_ones.default, torch.ops.aten.new_full.default)


def _new_on_shards(func, args, kwargs):
    """``x.new_zeros(size)`` (and new_empty / new_ones / new_full) of a
    size of x's rank, placed as x is on every dim whose size it keeps.
    DTensor's own rule makes every such tensor whole on each device: the
    backward of ``gather`` (the loss's gold logits) would then hold the
    whole batch's (B, S, V) zeros on every device.  None: no dim kept
    sharded, DTensor's rule stands."""
    from torch.distributed.tensor import DTensor, Replicate
    x, size = args[0], list(args[1])
    if len(size) != x.ndim:
        return None
    pl = [p if p.is_shard() and size[p.dim] == x.shape[p.dim] else Replicate()
          for p in x.placements]
    if all(p.is_replicate() for p in pl):
        return None
    local = list(size)
    for p in pl:
        if p.is_shard():
            local[p.dim] = x._local_tensor.shape[p.dim]
    out = func(x._local_tensor, local, *args[2:], **kwargs)
    stride = torch.empty(size, device="meta").stride()
    return DTensor.from_local(out, x.device_mesh, pl, run_check=False,
                              shape=torch.Size(size), stride=stride)


def _gather_on_shards(func, args, kwargs, record: ShardingRecord):
    """``gather(input, dim, index)`` on DTensors, run on the shards: the
    gathered dim made whole (``Replicate`` where it was sharded), every other
    dim of the index placed as the input's.  DTensor's own rule answers a
    sharded gathered dim with a masked partial result that later operators
    fail on (on meta shards too)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    inp, dim, index = args[0], args[1] % args[0].ndim, args[2]
    record.replicated["gather"] = record.replicated.get("gather", 0) + 1
    mesh = inp.device_mesh
    pl = [p if p.is_shard() and not p.is_shard(dim) else Replicate() for p in inp.placements]
    fn = local_map(lambda x, i: func(x, dim, i, **kwargs), out_placements=pl,
                   in_placements=(pl, pl), device_mesh=mesh)
    return fn(inp.redistribute(mesh, pl), index.redistribute(mesh, pl))


class _Fallback(TorchDispatchMode):
    """Run an operator DTensor refuses (no sharding rule) on replicated
    local tensors; see the module's docstring."""

    def __init__(self, record: ShardingRecord):
        super().__init__()
        self.record = record
        # signature -> the mesh dim down to which a refused operator had to be
        # gathered: a repeat skips DTensor's refusals (a failed propagation is
        # not cached by DTensor and costs a full strategy search each time)
        self.levels: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func is torch.ops.aten.gather.default and isinstance(args[0], DTensor):
            return _gather_on_shards(func, args, kwargs, self.record)
        if func in _NEW_LIKE and isinstance(args[0], DTensor):
            out = _new_on_shards(func, args, kwargs)
            if out is not None:
                return out
        key = _signature(func, args, kwargs)
        level = self.levels.get(key)
        if level is None:
            try:
                return func(*args, **kwargs)
            except (NotImplementedError, RuntimeError, IndexError) as err:
                if not _no_rule(err):
                    raise
        out, self.levels[key] = _replicated(func, args, kwargs, self.record, level)
        return out


def _signature(func, args, kwargs) -> tuple:
    """What DTensor's propagation depends on: the operator, each DTensor's
    shape, dtype and placements, each tensor's shape and dtype, and every
    other argument."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    def part(a):
        if isinstance(a, DTensor):
            return ("D", tuple(a.shape), a.dtype, tuple(a.placements))
        if isinstance(a, torch.Tensor):
            return ("T", tuple(a.shape), a.dtype)
        return a
    return (func,) + tuple(part(a) for a in tree_flatten((args, kwargs))[0])


def _replicated(func, args, kwargs, record: ShardingRecord, known=None):
    """(the result, the level it took): ``func`` with its DTensor arguments
    gathered one mesh dim at a time, the last (innermost, "model") first,
    until DTensor takes it (level: that mesh dim); where even whole tensors
    are refused, on the full local tensors (level -1).  ``known`` is a level
    an earlier call of the same signature took: gathered down to it at
    once.  An in-place operator's result is written back into its first
    argument's shards."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
    name = str(func.overloadpacket.__name__)
    record.replicated[name] = record.replicated.get(name, 0) + 1
    first = next(a for a in tree_flatten((args, kwargs))[0] if isinstance(a, DTensor))
    mesh = first.device_mesh
    mutated = func._schema.is_mutable and isinstance(args[0], DTensor)
    cur = (args, kwargs)
    for i in reversed(range(mesh.ndim)):
        def whole_on(a, i=i):
            if isinstance(a, DTensor) and not a.placements[i].is_replicate():
                pl = list(a.placements)
                pl[i] = Replicate()
                return a.redistribute(mesh, pl)
            return a
        cur = tree_map(whole_on, cur)
        if known is not None and i > known:
            continue
        try:
            out = func(*cur[0], **cur[1])
        except (NotImplementedError, RuntimeError, IndexError) as err:
            if not _no_rule(err):
                raise
            continue
        if mutated and cur[0][0] is not args[0]:
            args[0].copy_(cur[0][0].redistribute(mesh, args[0].placements))
            return args[0], i
        return out, i

    rep = [Replicate()] * mesh.ndim
    local = tree_map(lambda a: a.to_local() if isinstance(a, DTensor) else a, cur)
    out = func(*local[0], **local[1])

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        d = DTensor.from_local(t, mesh, rep, run_check=False)
        return d.redistribute(mesh, first.placements) if d.shape == first.shape else d

    if mutated:
        args[0].copy_(wrap(out if isinstance(out, torch.Tensor) else out[0]))
        return args[0], -1
    flat_out, spec = tree_flatten(out)
    return tree_unflatten([wrap(t) for t in flat_out], spec), -1
