"""Abstract dry-run: run one step of every (architecture x input shape) on
the production mesh without a device, prove the sharding plan is coherent,
and account its per-device roofline terms, as the reference's
``repro/launch/dryrun.py``.

The reference lowers and compiles on 512 placeholder host devices (it sets
``XLA_FLAGS`` before jax starts) and parses the compiled HLO.  Here the
mesh is a ``DeviceMesh`` over torch's fake process-group backend
(``mesh.abstract_world``; this process is rank 0, collectives move
nothing), the parameters, optimizer state, batch and cache are DTensors of
**meta** shards placed by ``launch/sharding.py``, and the step runs once,
eagerly, under ``activation_sharding`` and ``hlo_analysis.analyze``, which
counts FLOPs, bytes, collectives and live memory per device.  Nothing is
allocated and no kernel launches: K5, K6 and K7 charge their analytic
counts on meta tensors.  Importing this module sets nothing and opens no
process group; ``run_cell`` opens the world it needs and closes it.

    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh single

writes ``experiments/torch_dryrun/<arch>__<shape>__<mesh>.json`` (status
"analyzed", the reference's keys).  The numbers are accounting against the
H100's data-sheet peaks, not measurements.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..models import build_model, input_specs
from ..models import model as model_lib
from ..models.sharding_ctx import activation_sharding
from ..train import optimizer as opt_lib
from ..train import schedule as sched_lib
from ..train.tree import get_path, leaves, leaves_with_paths, unflatten
from . import sharding as shlib
from .hlo_analysis import Roofline, analyze
from .mesh import abstract_world, axis_names, device_count, dp_axes, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "torch_dryrun")


# =============================================================================
# per-cell artifacts: (the step to run, its arguments, the argument groups)
# =============================================================================
def _train_artifacts(cfg, shape, mesh):
    model = build_model(cfg, device="meta")
    optimizer = opt_lib.get_optimizer(cfg.optimizer)
    lr_fn = sched_lib.warmup_cosine()
    period = len(cfg.pattern)

    params_sds = model_lib.params_specs(cfg)
    opt_sds = optimizer.init(params_sds, period=period)
    state_sds = {"params": params_sds, "opt": opt_sds,
                 "step": torch.zeros((), dtype=torch.int32)}
    pspecs = shlib.param_specs(cfg, params_sds, mesh)
    ospecs = shlib.opt_state_specs(pspecs, params_sds, opt_sds, period=period)
    state_specs = {"params": pspecs, "opt": ospecs, "step": shlib.P()}

    batch_sds = input_specs(cfg, shape)
    bspecs = shlib.batch_specs(cfg, shape, mesh, batch_sds)

    state = shlib.distribute(state_sds, state_specs, mesh)
    for p in leaves(state["params"]):
        p.requires_grad_(True)
    batch = shlib.distribute(batch_sds, bspecs, mesh)
    step_fn = _raw_train_step(model, optimizer, lr_fn, grad_shardings=pspecs)
    return (step_fn, (state, batch),
            {"state": (state_sds, state_specs), "batch": (batch_sds, bspecs)})


def _raw_train_step(model, optimizer, lr_fn, grad_shardings=None):
    """Full production step: microbatched gradient accumulation in float32
    (bounds live activation memory to one microbatch) + optimizer update.

    ``grad_shardings`` (the parameters' spec tree) pins each gradient, and
    so the accumulators, to its parameter's placement: per-microbatch weight
    gradients reduce-scatter at once instead of living replicated over the
    FSDP axis.  Microbatch i takes rows r with r % mb == i, so that each
    device's batch shard splits evenly: the same work per device as the
    reference's contiguous microbatches."""
    mb = max(1, model.cfg.train_microbatches)
    period = len(model.cfg.pattern)

    def pin(grads, params):
        if grad_shardings is None:
            return grads
        out = []
        for g, p in zip(grads, params):
            out.append(g.redistribute(p.device_mesh, p.placements)
                       if hasattr(g, "placements") and g.placements != p.placements else g)
        return out

    def grads_of(params, batch):
        loss, _ = model.loss_fn(params, batch)
        flat = leaves(params)
        return loss.detach(), pin(torch.autograd.grad(loss, flat), flat)

    def step(state, batch):
        params = state["params"]
        flat = leaves(params)
        if mb > 1:
            def micro(x, i):
                return x.reshape(x.shape[0] // mb, mb, *x.shape[1:]).select(1, i)

            loss = None
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
            for i in range(mb):
                li, g = grads_of(params, {k: micro(v, i) for k, v in batch.items()})
                for a, gi in zip(acc, g):
                    a.add_(gi)
                del g
                loss = li if loss is None else loss + li
            loss = loss / mb
            grads = [a / mb for a in acc]
        else:
            loss, grads = grads_of(params, batch)
        lr = lr_fn(state["step"])
        new_params, new_opt = optimizer.update(unflatten(params, grads), state["opt"],
                                               params, lr, period=period)
        return ({"params": new_params, "opt": new_opt, "step": state["step"] + 1},
                {"loss": loss})
    return step


def _prefill_artifacts(cfg, shape, mesh):
    model = build_model(cfg, device="meta")
    params_sds = model_lib.params_specs(cfg)
    pspecs = shlib.param_specs(cfg, params_sds, mesh)
    batch_sds = input_specs(cfg, shape)
    bspecs = shlib.batch_specs(cfg, shape, mesh, batch_sds)

    def serve_prefill(params, batch):
        return model.prefill(params, batch["tokens"], batch.get("memory"))

    args = (shlib.distribute(params_sds, pspecs, mesh), shlib.distribute(batch_sds, bspecs, mesh))
    return serve_prefill, args, {"params": (params_sds, pspecs), "batch": (batch_sds, bspecs)}


def _decode_artifacts(cfg, shape, mesh):
    model = build_model(cfg, device="meta")
    params_sds = model_lib.params_specs(cfg)
    pspecs = shlib.param_specs(cfg, params_sds, mesh)
    batch_sds = input_specs(cfg, shape)
    bspecs = shlib.batch_specs(cfg, shape, mesh, batch_sds)
    cache_sds = model_lib.cache_specs(cfg, shape.global_batch, shape.seq_len)
    cspecs = shlib.cache_specs_tree(cfg, shape, mesh, cache_sds)

    def serve_step(params, batch, cache):
        # the cache is written in place: the reference donates it
        return model.decode_step(params, batch["token"], cache, batch.get("memory"))

    args = (shlib.distribute(params_sds, pspecs, mesh), shlib.distribute(batch_sds, bspecs, mesh),
            shlib.distribute(cache_sds, cspecs, mesh))
    return serve_step, args, {"params": (params_sds, pspecs), "batch": (batch_sds, bspecs),
                              "cache": (cache_sds, cspecs)}


# =============================================================================
# analyses
# =============================================================================
def _sharded_arg_bytes(sds_specs: dict, mesh) -> dict:
    """Per-device bytes of each argument group under its spec."""
    sizes = {}
    for group, (sds, specs) in sds_specs.items():
        total = 0
        for path, leaf in leaves_with_paths(sds):
            nbytes = leaf.numel() * leaf.element_size()
            denom = 1
            for entry in tuple(get_path(specs, path)):
                if entry is None:
                    continue
                for ax in (entry if isinstance(entry, tuple) else (entry,)):
                    denom *= shlib.axis_size(mesh, ax)
            total += nbytes // max(1, denom)
        sizes[group] = total
    return sizes


def _model_flops(cfg, shape) -> float:
    _, active = cfg.param_count()
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch          # decode: one token a sequence


def _out_bytes(out) -> int:
    """Bytes of a step's outputs on this device (their local shards)."""
    from torch.utils._pytree import tree_flatten
    return sum(getattr(t, "_local_tensor", t).numel() * t.element_size()
               for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))


def _artifacts(cfg, shape, mesh):
    kind = {"train": _train_artifacts, "prefill": _prefill_artifacts}
    return kind.get(shape.kind, _decode_artifacts)(cfg, shape, mesh)


def analyze_cell(cfg, shape, mesh, skip_compile: bool = False) -> dict:
    """One step of ``cfg`` at ``shape`` on ``mesh`` (an open world), under
    the accounting; the reference's ``run_cell`` keys from "chips" on.
    ``skip_compile``: the arguments placed (status "placed"), the step not
    run."""
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.monotonic()
    step, args, groups = _artifacts(cfg, shape, mesh)
    result = {"chips": device_count(mesh), "status": "placed",
              "lower_s": time.monotonic() - t0,
              "arg_bytes_per_device": _sharded_arg_bytes(groups, mesh)}
    if skip_compile:
        return result

    def run(*a):
        with activation_sharding(mesh, shlib.effective_dp(cfg, mesh)) as rec, \
                implicit_replication():
            out = step(*a)
        return out, rec

    t1 = time.monotonic()
    stats = analyze(run, *args)
    out, rec = stats.output
    stats.replicated_by_op = dict(rec.replicated)
    stats.replicated_ops = sum(rec.replicated.values())
    result["compile_s"] = time.monotonic() - t1
    result["status"] = "analyzed"
    result["memory_analysis"] = {
        "argument_size_in_bytes": int(stats.arg_bytes),
        "output_size_in_bytes": _out_bytes(out),
        "peak_live_bytes": int(stats.peak_live_bytes),
        "method": "rank 0's local shards: the arguments, plus every operator's result "
                  "that is no view from its creation until its last reference goes",
    }
    result["cost_analysis_raw"] = {"flops": stats.flops, "bytes accessed": stats.hbm_bytes}
    result["hlo_analysis"] = stats.to_dict()
    rl = Roofline(hlo_flops=stats.flops, hlo_bytes=stats.hbm_bytes_fused,
                  wire_bytes=stats.wire_bytes, chips=result["chips"],
                  model_flops=_model_flops(cfg, shape))
    result["roofline"] = rl.to_dict()
    result["roofline"]["hlo_bytes_raw_per_dev"] = stats.hbm_bytes
    return result


def _world_size(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             skip_compile: bool = False) -> dict:
    """The reference's ``run_cell``: status "analyzed" (or "placed" with
    ``skip_compile``: the arguments placed, the step not run)."""
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    head = {"arch": arch_id, "shape": shape_name, "mesh": "multi" if multi_pod else "single"}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {**head, "status": "skipped", "reason": reason}
    with abstract_world(_world_size(multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        return {**head, **analyze_cell(cfg, shape, mesh, skip_compile)}


# =============================================================================
# the dataframe-pipeline dry-run (the paper's technique on the mesh)
# =============================================================================
def pipeline_step(vals, codes, mesh, groups: int = 8):
    """The Fig. 6 operator mix (map + groupby(n) + groupby(1) + window) per
    shard, as the reference's shard_map program: ``vals`` (rows, cols)
    DTensor sharded (DP, "model"), ``codes`` (rows,) sharded DP.  Returns
    DTensors (mapped, gb_n, gb_1, window): the groupby combine is the
    all-reduce the paper's shuffle became, the window's cross-shard carry an
    all-gather of shard totals with an exclusive prefix."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    names = axis_names(mesh)
    dp = [names.index(a) for a in dp_axes(mesh)]
    model = names.index("model")
    shard2 = [Shard(0) if i in dp else Shard(1) if i == model else Replicate()
              for i in range(mesh.ndim)]
    shard1 = [Shard(0) if i in dp else Replicate() for i in range(mesh.ndim)]
    cols_only = [Shard(1) if i == model else Replicate() for i in range(mesh.ndim)]
    shard_index = 0
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    for i in dp:
        shard_index = shard_index * mesh.size(i) + coord[i]

    def per_shard(v, c):
        # MAP: null scrub (the paper's map benchmark: isnull -> fill)
        mapped = torch.where(torch.isnan(v), 0.0, v)
        # GROUPBY(n): a local one-hot partial + an all-reduce over the DP dims
        onehot = torch.nn.functional.one_hot(torch.remainder(c, groups).long(),
                                             groups).to(torch.float32)
        gb_n = torch.einsum("rg,rc->gc", onehot, mapped)
        gb_1 = mapped.sum(dim=0, keepdim=True)
        for i in dp:
            gb_n = funcol.all_reduce(gb_n, "sum", (mesh, i))
            gb_1 = funcol.all_reduce(gb_1, "sum", (mesh, i))
        # WINDOW: local cumsum + the exclusive carry of earlier shards' totals
        local = torch.cumsum(mapped, dim=0)
        totals = local[-1:]
        for i in reversed(dp):              # minor DP dim first: shard order major-first
            totals = funcol.all_gather_tensor(totals, 0, (mesh, i))
        mask = (torch.arange(totals.shape[0], device=v.device) < shard_index).to(torch.float32)
        carry = torch.einsum("s,sc->c", mask, totals)
        return mapped, gb_n, gb_1, local + carry

    return local_map(per_shard, out_placements=(shard2, cols_only, cols_only, shard2),
                     in_placements=(shard2, shard1), device_mesh=mesh)(vals, codes)


def run_pipeline_cell(multi_pod: bool, rows: int = 1 << 22, cols: int = 256,
                      groups: int = 8) -> dict:
    """The Fig. 6 mix as one step over the production mesh, on meta shards:
    rows shard DP, columns shard "model"."""
    with abstract_world(_world_size(multi_pod)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = device_count(mesh)
        spec2 = shlib.P(dp_axes(mesh) if len(dp_axes(mesh)) > 1 else dp_axes(mesh)[0], "model")
        vals = shlib.distribute({"v": torch.empty((rows, cols), device="meta")},
                                {"v": spec2}, mesh)["v"]
        codes = shlib.distribute({"c": torch.empty((rows,), dtype=torch.int32, device="meta")},
                                 {"c": shlib.P(spec2[0])}, mesh)["c"]
        t0 = time.monotonic()
        stats = analyze(pipeline_step, vals, codes, mesh, groups)
        return {
            "arch": "dataframe-pipeline", "shape": f"rows{rows}_cols{cols}",
            "mesh": "multi" if multi_pod else "single", "chips": chips,
            "status": "analyzed", "compile_s": time.monotonic() - t0,
            "cost_analysis": {"flops": stats.flops, "bytes accessed": stats.hbm_bytes},
            "collectives": {"wire_bytes": stats.wire_bytes, "counts": stats.collective_counts},
            "memory_analysis": {"argument_size_in_bytes": int(stats.arg_bytes),
                                "peak_live_bytes": int(stats.peak_live_bytes)},
        }


# =============================================================================
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--pipeline", action="store_true",
                    help="also dry-run the dataframe pipeline step")
    args = ap.parse_args()

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if args.arch == "all" else tuple(args.arch.split(","))
    shapes = tuple(SHAPES) if args.shape == "all" else tuple(args.shape.split(","))
    meshes = {"single": (False,), "multi": (True,), "both": (False, True)}[args.mesh]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip] {tag}")
                    continue
                print(f"[run ] {tag}", flush=True)
                try:
                    res = run_cell(arch, shape, mp)
                except Exception as e:       # a cell's failure is recorded, the sweep goes on
                    res = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()}
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                print(f"[done] {tag}: {res['status']}", flush=True)

    if args.pipeline:
        for mp in meshes:
            tag = f"pipeline__{'multi' if mp else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                continue
            res = run_pipeline_cell(mp)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            print(f"[done] {tag}: {res['status']}", flush=True)


if __name__ == "__main__":
    main()
