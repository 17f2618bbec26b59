#!/usr/bin/env python3
"""Probes the one-pass RMSNorm (``csrc/rms_norm.cu``) on one CUDA card.

    python3 scripts/rms_norm_probe.py [--prefill]

Prints the ptxas report of ``rms_norm.cu`` (one nvcc, into
``build/rms_norm_probe/``).  Then, at yi-6b's largest prefill (4 x 4096 rows
of d 4096, bfloat16, scale float32), times three calls with CUDA events over
100 calls and on the device under the profiler: the kernel, the plain chain
(``rmsnorm_plain``) and ``torch.nn.functional.rms_norm`` (a yardstick: the
port never calls it), beside the bound (each row read and written once at
3.35 TB/s).  With ``--prefill``, builds yi-6b at full width from random
weights on the card, counts the kernel's launches in one 4 x 1024 prefill,
and lists, from the profiler's trace of another, the operators and the
device kernels launched inside ``repro:norm`` ranges.  Prints one line,
``RESULT {json}``, then the card's name and power limit.
"""
import argparse
import json
import sys

from probe_util import HBM_BYTES_PER_S, ROOT, card_line, ptxas_report, timed, with_shares, yi_prefill

ROWS, D = 4 * 4096, 4096


def kernel_table(torch) -> dict:
    from repro_torch.kernels import rms_norm as rn
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (3 * torch.randn((ROWS, D), generator=g, device="cuda")).bfloat16()
    scale = 1 + 0.05 * torch.randn(D, generator=g, device="cuda")
    scale_bf16 = scale.bfloat16()
    out = rn.rmsnorm(x, scale)
    want = rn.rmsnorm_plain(x, scale, 1e-6)
    ulps = ((out.float() - want.float()).abs()
            / (want.float().abs() * 2.0 ** -7).clamp_min(1e-30)).max()
    rows = {"kernel": timed(torch, lambda: rn.rmsnorm(x, scale)),
            "plain": timed(torch, lambda: rn.rmsnorm_plain(x, scale, 1e-6)),
            "F.rms_norm": timed(torch, lambda: torch.nn.functional.rms_norm(
                x, (D,), scale_bf16, 1e-6))}
    bound_ms = 4 * ROWS * D / HBM_BYTES_PER_S * 1e3
    return {"shape": [ROWS, D], "bound_ms": bound_ms, "rows": with_shares(rows, bound_ms),
            "max_err_in_bf16_ulps": float(ulps),
            "differs": int((out != want).sum()), "elements": ROWS * D}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prefill", action="store_true")
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import rms_norm as rn
    out_dir = ROOT / "build" / "rms_norm_probe"
    print(ptxas_report("rms_norm.cu", out_dir), flush=True)
    result = {"kernel_table": kernel_table(torch)}
    if args.prefill:
        result["prefill"] = yi_prefill(torch, rn.counter, "repro:norm",
                                       out_dir / "prefill_trace.json")
    print("RESULT " + json.dumps(result), flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
