"""Training entry point:

    python -m repro_torch.launch.train --arch granite-8b --smoke --device cpu
    python -m repro_torch.launch.train --arch recurrentgemma-9b --seq-len 4096 --batch 1

Wires together the dataframe data pipeline, the trainer, checkpointing and
failure recovery (``--checkpoint-dir``), as the reference's
``repro/launch/train.py``; random weights from a seeded generator.  Full
configs run on a CUDA card; on the CPU only ``--smoke`` (reduced config)
runs, and anything else raises, as the reference refuses full configs on
its CPU.  Prints the last five logged steps and the pipeline's stats as
JSON.
"""
from __future__ import annotations

import argparse
import json

from ..configs import get_config, get_smoke_config
from ..core.dtypes import resolve_device
from ..data import DataPipeline, PipelineConfig, synthetic_corpus
from ..models import build_model
from ..train.fault import run_with_recovery
from ..train.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--docs", type=int, default=4000)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    if not args.smoke and dev.type != "cuda":
        raise SystemExit("full configs need a CUDA card; use --smoke on the CPU")

    model = build_model(cfg, dev)
    pc = PipelineConfig(seq_len=args.seq_len, global_batch=args.batch,
                        memory_len=cfg.cross_memory_len, d_model=cfg.d_model)
    pipe = DataPipeline(synthetic_corpus(args.docs), cfg.vocab, pc, device=dev)
    tc = TrainConfig(lr=args.lr, total_steps=args.steps,
                     microbatches=args.microbatches,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=max(10, args.steps // 5))
    trainer = Trainer(model, tc)
    if args.checkpoint_dir:
        run_with_recovery(trainer, lambda: pipe.batches(), steps=args.steps)
    else:
        trainer.fit(pipe.batches(), steps=args.steps)

    out = {"history": trainer.history[-5:], "pipeline": pipe.stats()}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
