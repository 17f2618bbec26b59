#!/usr/bin/env python3
"""Probes the one-pass RoPE (``csrc/rope.cu``) on one CUDA card.

    python3 scripts/rope_probe.py [--prefill]

Prints the ptxas report of ``rope.cu`` (one nvcc, into ``build/rope_probe/``).
Then, at yi-6b's largest prefill (4 x 4096 tokens; q of 32 heads and k of 4,
D 128, bfloat16; trinity-mini's q and k have the same shapes), times the
kernel and the plain chain (``rope_plain``) with CUDA events over 100 calls
and on the device under the profiler, beside the bound (x read and written
once at 3.35 TB/s), and counts the elements where the two differ.  With
``--prefill``, builds yi-6b at full width from random weights on the card,
counts the kernel's launches in one 4 x 1024 prefill, and lists, from the
profiler's trace of another, the operators and the device kernels launched
inside ``repro:rope`` ranges; then, for yi-6b and trinity-mini at full width
(one at a time), whether a 4 x 4096 prefill's logits with the kernel equal
those with ``rope_plain`` in its place (``torch.equal``).  Prints one line,
``RESULT {json}``, then the card's name and power limit.
"""
import argparse
import json
import sys

from probe_util import HBM_BYTES_PER_S, ROOT, card_line, ptxas_report, timed, with_shares, yi_prefill

B, S, HEAD_DIM = 4, 4096, 128
HEADS = {"q": 32, "k": 4}


def rope_inputs(torch, b: int, s: int, heads: int, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (3 * torch.randn((b, s, heads, HEAD_DIM), generator=g, device="cuda")).bfloat16()
    pos = torch.arange(s, device="cuda").expand(b, s)
    return x, pos


def kernel_table(torch) -> dict:
    from repro_torch.kernels import rope as rp
    table = {}
    for name, heads in HEADS.items():
        x, pos = rope_inputs(torch, B, S, heads)
        out = rp.rope(x, pos)
        want = rp.rope_plain(x, pos)
        rows = {"kernel": timed(torch, lambda: rp.rope(x, pos)),
                "plain": timed(torch, lambda: rp.rope_plain(x, pos))}
        bound_ms = 4 * x.numel() / HBM_BYTES_PER_S * 1e3
        table[name] = {"shape": list(x.shape), "bound_ms": bound_ms,
                       "rows": with_shares(rows, bound_ms),
                       "launch_shape": rp.launch_shape(B * S, HEAD_DIM // 2 // 8),
                       "differs": int((out != want).sum()), "elements": x.numel()}
    return table


def prefill_equal(torch, name: str) -> dict:
    """A 4 x 4096 prefill of ``name`` at full width, random weights: its
    logits with the kernel against those with rope_plain in its place."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import rope as rp
    from repro_torch.models.model import build_model
    cfg = get_config(name)
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(3, cfg.vocab, (B, S), device="cuda", dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(1))
    rp.counter.reset()
    with torch.no_grad():
        got = model.prefill(params, tokens)
        launches = dict(rp.counter.routes)
        kernel = ops._rope
        ops._rope = rp.rope_plain
        try:
            want = model.prefill(params, tokens)
        finally:
            ops._rope = kernel
    out = {"launches": launches, "equal": bool(torch.equal(got, want)),
           "max_abs_diff": float((got.float() - want.float()).abs().max())}
    del model, params, got, want
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prefill", action="store_true")
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import rope as rp
    out_dir = ROOT / "build" / "rope_probe"
    print(ptxas_report("rope.cu", out_dir), flush=True)
    result = {"kernel_table": kernel_table(torch)}
    if args.prefill:
        result["prefill"] = yi_prefill(torch, rp.counter, "repro:rope",
                                       out_dir / "prefill_trace.json")
        result["prefill_equal"] = {n: prefill_equal(torch, n) for n in ("yi-6b", "trinity-mini")}
    print("RESULT " + json.dumps(result), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
