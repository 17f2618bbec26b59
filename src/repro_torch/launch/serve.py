"""Serving entry point:

    python -m repro_torch.launch.serve --arch yi-6b             # full config, CUDA
    python -m repro_torch.launch.serve --arch yi-6b --smoke --device cpu

Batched greedy decoding of synthetic requests with the continuous-batching
engine, random weights from a seeded generator (as the reference's
``repro/launch/serve.py``).  Prints the engine's metrics as JSON, with the
device they ran on.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import get_config, get_smoke_config
from ..core.dtypes import resolve_device
from ..data.tokenizer import HashTokenizer
from ..models import build_model
from ..serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    if not args.smoke and dev.type != "cuda":
        raise SystemExit("full configs need a CUDA card; use --smoke on the CPU")

    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(model, params, max_batch=args.max_batch, max_seq=args.max_seq)
    tok = HashTokenizer(cfg.vocab)
    prompts = [f"request number {i} about dataframes" for i in range(args.requests)]
    reqs = [Request(rid=i, prompt_ids=tok.encode(p), max_new_tokens=args.max_new)
            for i, p in enumerate(prompts)]
    t0 = time.monotonic()
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    dt = time.monotonic() - t0
    out = dict(engine.metrics)
    out["wall_s"] = dt
    out["tokens_per_s"] = engine.metrics["tokens_out"] / dt if dt else 0
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
