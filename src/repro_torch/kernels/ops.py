"""Engine-facing wrappers around the kernels.

Dispatch follows the tensors' device and nothing else: CPU tensors take the
plain PyTorch versions, CUDA tensors the hand-written kernels (or the wrapper
raises).  There is no environment override and no capability fallback.
Inputs are widened to the kernels' storage types here (``_util``).

**DTensors.**  K5, K6 and K7 also take DTensors (a model whose parameters
``launch.sharding.distribute`` placed on a ``DeviceMesh``): the kernel runs
on each device's shards through ``torch.distributed.tensor.experimental.
local_map``, with the output placed as the query (K6, K7) or ``a`` (K5) is.
A placement that keeps the kernel from running on the shards is
redistributed first, and an accounting below counts that as a collective:
a sharded head dim, a Partial, a sharded sequence dim of K6's keys.  Heads
may stay sharded: where the KV heads
divide as the query heads do, both stay sharded; where they do not (yi-6b's
4 KV heads over 16 devices), the KV heads are gathered and each device
takes the ones its query heads read.  Mesh dims of size 1 are left as they
are, so on a (1, 1) mesh nothing moves and the kernel sees the whole
tensors.

**The decode cache's sequence** (flash-decode SP,
``launch/sharding.cache_specs_tree``: the cache's sequence dim over "model",
or over the DP axes and "model" where the batch cannot be sharded) is never
gathered by K7: each device runs K7's partials mode on its own rows, with
the lengths cut to them (clamp(length - offset, 0, rows)), the (O, M, L)
partials, B x H x (D + 2) float32, are all-gathered over the sequence's
mesh dims (``funcol``, the innermost dim first, so the pieces come in their
order along the sequence) and combined in that order
(``decode_attention.combine_partials``).  Only the query is gathered over
those dims; over the cache's batch dims it is sliced, never the cache
gathered.  The einsum decode path and cross attention (unsharded memory)
keep the route above.
"""
from __future__ import annotations

import torch

from ._util import narrow_from_kernel, widen_for_kernel
from .block_transpose import block_transpose as _transpose
from .decode_attention import combine_partials as _combine_partials
from .decode_attention import decode_attention as _decode
from .decode_attention import decode_attention_partials as _decode_partials
from .decode_attention import piece_lengths as _piece_lengths
from .flash_attention import flash_attention as _flash
from .linear_scan import linear_scan as _linscan
from .onehot_encode import onehot_encode as _onehot
from .segment_reduce import segment_reduce as _segred
from .window_scan import window_scan as _winscan

__all__ = ["transpose", "segment_reduce", "segment_reduce_multi",
           "window_scan", "linear_scan", "onehot_encode", "flash_attention",
           "decode_attention", "attention_on_shards"]

_FLT_MAX = torch.finfo(torch.float32).max


def transpose(x: torch.Tensor) -> torch.Tensor:
    w, orig = widen_for_kernel(x)
    return narrow_from_kernel(_transpose(w), orig)


def segment_reduce(values, codes, num_segments: int, op: str = "sum"):
    return _segred(values.to(torch.float32), codes.to(torch.int32),
                   num_segments, op)


def segment_reduce_multi(vals, valids, codes: torch.Tensor, *, bases,
                         num_segments: int, presence: bool = False) -> tuple:
    """A whole per-block partial-aggregation stage: null masking, squaring,
    presence counting, and one ``segment_reduce`` per reduce op, with
    same-op columns stacked into the kernel's (M, C) batch.  ``bases[i]`` ∈
    {sum,count,sumsq,min,max} names the statistic computed from ``(vals[i],
    valids[i])``; ``valids[i]`` may be None (all valid).  Returns one
    (G,)-vector per base, plus a trailing presence vector when ``presence``.
    Runs eagerly, one launch per reduce op."""
    codes = codes.to(torch.int32)
    m = codes.shape[0]
    by_op: dict[str, list] = {}

    def put(op: str, pos: int, vec) -> None:
        by_op.setdefault(op, []).append((pos, vec))

    for i, base in enumerate(bases):
        v = vals[i].to(torch.float32)
        valid = valids[i]
        if base == "count":
            put("sum", i, torch.ones(m, dtype=torch.float32, device=codes.device)
                if valid is None else valid.to(torch.float32))
        elif base == "sum":
            put("sum", i, v if valid is None else torch.where(valid, v, 0.0))
        elif base == "sumsq":
            put("sum", i, v * v if valid is None else torch.where(valid, v * v, 0.0))
        elif base == "min":
            put("min", i, v if valid is None else torch.where(valid, v, _FLT_MAX))
        else:   # max
            put("max", i, v if valid is None else torch.where(valid, v, -_FLT_MAX))
    if presence:
        # segment presence = #rows with a valid (non-negative) code,
        # independent of value nulls
        put("sum", len(bases), torch.ones(m, dtype=torch.float32,
                                          device=codes.device))

    out: list = [None] * (len(bases) + (1 if presence else 0))
    for op, items in by_op.items():
        if len(items) == 1:
            out[items[0][0]] = _segred(items[0][1], codes, num_segments, op)
        else:
            mat = torch.stack([vec for _, vec in items], dim=1)
            res = _segred(mat, codes, num_segments, op)
            for j, (pos, _) in enumerate(items):
                out[pos] = res[:, j]
    return tuple(out)


def window_scan(x, op: str = "cumsum") -> torch.Tensor:
    return _winscan(x.to(torch.float32), op)


def linear_scan(a, b) -> torch.Tensor:
    if _is_dtensor(a):
        return _sharded_scan(a.to(torch.float32), b.to(torch.float32))
    return _linscan(a.to(torch.float32), b.to(torch.float32))


def onehot_encode(codes, num_classes: int) -> torch.Tensor:
    return _onehot(codes.to(torch.int32), num_classes)


def flash_attention(q, k, v, *, causal: bool = True, scale=None, window=None):
    if _is_dtensor(q):
        return attention_on_shards(
            lambda q, k, v: _flash(q, k, v, causal=causal, scale=scale, window=window),
            q, (k, v), q_head=2, kv_head=2)
    return _flash(q, k, v, causal=causal, scale=scale, window=window)


def decode_attention(q, k_cache, v_cache, length, *, scale=None) -> torch.Tensor:
    if _is_dtensor(q):
        seq = _sequence_dims(q, k_cache, v_cache)
        if seq:
            return _decode_on_sequence_shards(q, k_cache, v_cache, length, seq, scale)
        return attention_on_shards(
            lambda q, k, v, n: _decode(q, k, v, n, scale=scale),
            q, (k_cache, v_cache), q_head=1, kv_head=2, length=length)
    return _decode(q, k_cache, v_cache, length, scale=scale)


# =============================================================================
# DTensor route: the kernels on each device's shards
# =============================================================================
def _is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _as_dtensor(x, mesh):
    """A plain tensor (e.g. decode's lengths, made on the fly) as a
    replicated DTensor on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    if _is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _run_local(fn, mesh, out_placements, args, placements):
    """``fn`` on the local shards of ``args`` redistributed to
    ``placements``, its output placed by ``out_placements``."""
    from torch.distributed.tensor.experimental import local_map
    args = [a.redistribute(mesh, pl) for a, pl in zip(args, placements)]
    return local_map(fn, out_placements=out_placements, in_placements=tuple(placements),
                     device_mesh=mesh)(*args)


def attention_on_shards(fn, q, kv, *, q_head: int, kv_head: int, length=None):
    """``fn(q, k, v[, length])`` — K6 (q (B, Sq, H, D), k / v (B, Sk, KVH,
    D)), K7 (q (B, H, D), caches (B, S, KVH, D), lengths (B,)) or the model's
    einsum attention — on the shards of DTensors; see the module's
    docstring.  The batch dim may stay sharded (K / V and the lengths follow
    the query's), and the heads; every other sharded dim is gathered."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    k, v = (_as_dtensor(t, mesh) for t in kv)
    h, kvh = q.shape[q_head], k.shape[kv_head]
    group = h // kvh
    q_pl, kv_pl, n_pl = [], [], []
    head_split, head_rank, kv_split = 1, 0, True
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        m = mesh.size(i)
        if m == 1:
            q_pl.append(pq)
            kv_pl.append(pk)
            n_pl.append(pq if pq == Shard(0) else Replicate())
            continue
        if pq == Shard(0):
            q_pl.append(pq)
            kv_pl.append(Shard(0))
            n_pl.append(Shard(0))
            continue
        n_pl.append(Replicate())
        if pq == Shard(q_head) and h % (head_split * m) == 0:
            q_pl.append(pq)
            head_rank = head_rank * m + coord[i]
            head_split *= m
            keep_kv = pk == Shard(kv_head) and kvh % head_split == 0 and kv_split
            kv_split = keep_kv
            kv_pl.append(Shard(kv_head) if keep_kv else Replicate())
            continue
        q_pl.append(Replicate())       # every device needs all of K / V
        kv_pl.append(Replicate())
    local_h = h // head_split
    if head_split > 1 and not kv_split:
        if local_h % group and group % local_h:    # the groups straddle devices
            return _attention_replicated(fn, q, k, v, length, mesh)
        first = head_rank * local_h // group
        count = max(1, local_h // group)
        kv_pl = [Replicate() if isinstance(p, Shard) and p.dim == kv_head else p
                 for p in kv_pl]

        def local(q, k, v, *rest):
            k = k.narrow(kv_head, first, count)
            v = v.narrow(kv_head, first, count)
            return fn(q, k, v, *rest)
    else:
        local = fn
    args, placements = [q, k, v], [q_pl, kv_pl, kv_pl]
    if length is not None:
        args.append(_as_dtensor(length, mesh))
        placements.append(n_pl)
    return _run_local(local, mesh, q_pl, args, placements)


def _sequence_dims(q, k, v) -> list:
    """The mesh dims (of size > 1) over which both caches shard their
    sequence dim evenly, in mesh order; [] where there are none (or the
    caches are placed apart, or a batch mesh dim would also shard the
    sequence)."""
    from torch.distributed.tensor import Shard
    if not (_is_dtensor(k) and _is_dtensor(v)) or k.placements != v.placements:
        return []
    mesh = q.device_mesh
    dims = [i for i, p in enumerate(k.placements) if p == Shard(1) and mesh.size(i) > 1]
    pieces = 1
    for i in dims:
        pieces *= mesh.size(i)
    if not dims or k.shape[1] % pieces or any(q.placements[i] == Shard(0) for i in dims):
        return []
    return dims


def _decode_on_sequence_shards(q, k, v, length, seq: list, scale):
    """K7 where the caches shard their sequence over the mesh dims ``seq``:
    partials on each device's rows, an all-gather of the partials over
    ``seq``, the combine in sequence order; see the module's docstring.
    Batch mesh dims stay sharded, the query's too where only the cache's
    batch is (a slice of the query, not a gather of the cache); on a dim
    of size 1 nothing moves."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    q_pl, kv_pl, n_pl = [], [], []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if i in seq:
            q_pl.append(Replicate())
            kv_pl.append(Shard(1))
            n_pl.append(Replicate())
        elif mesh.size(i) == 1:
            q_pl.append(pq)
            kv_pl.append(pk)
            n_pl.append(pq if pq == Shard(0) else Replicate())
        elif Shard(0) in (pq, pk):    # a batch dim: the query follows the cache's rows
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
            n_pl.append(Shard(0))
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            n_pl.append(Replicate())
    ql = q.redistribute(mesh, q_pl).to_local()
    kl = k.redistribute(mesh, kv_pl).to_local()
    vl = v.redistribute(mesh, kv_pl).to_local()
    nl = _as_dtensor(length, mesh).redistribute(mesh, n_pl).to_local()
    rows = kl.shape[1]
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    piece = 0
    for i in seq:
        piece = piece * mesh.size(i) + coord[i]
    o, m, l = _decode_partials(ql, kl, vl, _piece_lengths(nl, piece * rows, rows), scale=scale)
    d = o.shape[-1]
    packed = torch.cat([o, m[..., None], l[..., None]], dim=-1)[None]   # (1, B, H, D + 2)
    for i in reversed(seq):
        packed = funcol.all_gather_tensor(packed, 0, (mesh, i))
    parts = [(p[..., :d], p[..., d], p[..., d + 1]) for p in packed.unbind(0)]
    out = DTensor.from_local(_combine_partials(parts, ql.dtype), mesh, q_pl, run_check=False)
    if any(p.is_partial() for p in q.placements):
        return out
    return out.redistribute(mesh, q.placements)


def _attention_replicated(fn, q, k, v, length, mesh):
    from torch.distributed.tensor import Replicate, Shard
    q_pl = [p if p == Shard(0) else Replicate() for p in q.placements]
    args, placements = [q, k, v], [q_pl, q_pl, q_pl]
    if length is not None:
        args.append(_as_dtensor(length, mesh))
        placements.append(q_pl)
    return _run_local(fn, mesh, q_pl, args, placements)


def _sharded_scan(a, b):
    """K5 on DTensors (B, T, N): batch and channels stay sharded as ``a``'s
    are; time is gathered."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = a.device_mesh
    b = _as_dtensor(b, mesh)
    pl = [p if mesh.size(i) == 1 or p in (Shard(0), Shard(a.ndim - 1)) else Replicate()
          for i, p in enumerate(a.placements)]
    return _run_local(_linscan, mesh, pl, [a, b], [pl, pl])
