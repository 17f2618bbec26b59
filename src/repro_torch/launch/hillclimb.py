"""Perf-iteration driver, as the reference's ``repro/launch/hillclimb.py``.

Runs one (arch x shape) cell of the abstract dry-run (``launch/dryrun.py``)
under a named *variant* — a set of config overrides implementing a
hypothesis — and records the per-device breakdown (top byte / FLOP
contributors, wire bytes by collective kind), so each hypothesis -> change
-> account cycle is one invocation:

  python -m repro_torch.launch.hillclimb --arch rwkv6-1.6b --shape train_4k \\
      --variant chunked --set rwkv_chunked=True

Results land in ``experiments/torch_perf/<arch>__<shape>__<variant>.json``.
The reference's ``--adjust`` corrections are accepted and remove nothing
here: "flash_attention" subtracts the (chunk, S) probability tensors a
compiled einsum attention writes, where the port already counts K6's own
bytes and no such tensor; "bf16_psum" halves collectives XLA:CPU widened to
float32, where nothing here widens a bf16 collective.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from ..configs import SHAPES, get_config, shape_applicable
from .dryrun import _world_size, analyze_cell
from .mesh import abstract_world, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "torch_perf")

_ADJUSTMENTS = {
    "flash_attention": "nothing to remove: K6 charges its own analytic bytes on meta "
                       "tensors, and no (chunk, S) probability tensor is counted",
    "bf16_psum": "nothing to remove: no bf16 collective is widened to float32 here",
}


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        k, v = p.split("=", 1)
        if v in ("True", "False"):
            out[k] = v == "True"
        elif v.isdigit():
            out[k] = int(v)
        else:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def run_variant(arch: str, shape_name: str, variant: str, overrides: dict,
                multi_pod: bool = False, adjust: str = "") -> dict:
    cfg = dataclasses.replace(get_config(arch), **overrides)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name}: {reason}")
    adjustment = {}
    for adj in adjust.split(",") if adjust else []:
        if adj not in _ADJUSTMENTS:
            raise ValueError(f"unknown adjustment {adj!r} (known: {sorted(_ADJUSTMENTS)})")
        adjustment[adj] = {"removed_bytes": 0.0, "reason": _ADJUSTMENTS[adj]}
    t0 = time.monotonic()
    with abstract_world(_world_size(multi_pod)):
        cell = analyze_cell(cfg, shape, make_production_mesh(multi_pod=multi_pod))
    return {
        "arch": arch, "shape": shape_name, "variant": variant,
        "overrides": {k: str(v) for k, v in overrides.items()},
        "adjustment": adjustment,
        "compile_s": time.monotonic() - t0,
        "memory_analysis": cell["memory_analysis"],
        "hlo_analysis": cell["hlo_analysis"],
        "roofline": cell["roofline"],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--adjust", default="")
    args = ap.parse_args()

    os.makedirs(OUT_DIR, exist_ok=True)
    res = run_variant(args.arch, args.shape, args.variant,
                      _parse_overrides(args.set), args.multi, adjust=args.adjust)
    path = os.path.join(OUT_DIR, f"{args.arch}__{args.shape}__{args.variant}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    rl = res["roofline"]
    print(f"{args.arch} {args.shape} [{args.variant}]  analyzed in {res['compile_s']:.0f}s")
    print(f"  compute={rl['compute_s']:.3g}s memory={rl['memory_s']:.3g}s "
          f"collective={rl['collective_s']:.3g}s -> {rl['bottleneck']}")
    print(f"  useful={rl['useful_flops_fraction']:.3f} "
          f"roofline_frac={rl['roofline_fraction']:.4f}")
    ha = res["hlo_analysis"]
    print("  wire by kind:", {k: f"{v:.3g}" for k, v in ha["wire_bytes_by_kind"].items()})
    print("  top bytes:")
    for k, v in ha["top_bytes"][:8]:
        print(f"    {v:12.3e}  {k}")
    print("  top flops:")
    for k, v in ha["top_flops"][:5]:
        print(f"    {v:12.3e}  {k}")


if __name__ == "__main__":
    main()
