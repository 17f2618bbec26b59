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
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
ROWS, D = 4 * 4096, 4096


def ptxas_report(out: Path) -> str:
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                          str(_build.CSRC / "rms_norm.cu"), "-o", str(out / "rms_norm.o")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        raise RuntimeError(run.stdout)
    return run.stdout


def timed(torch, fn, calls: int = 100) -> dict:
    """ms a call: CUDA events over ``calls`` calls after 10 warm-ups, and
    the device time of the kernels one call launches (profiler, 20 calls)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    return {"events_ms": start.elapsed_time(end) / calls, "device_ms": device_us / 20 / 1e3,
            "kernels_a_call": len(kernels) / 20,
            "names": sorted({e.name[:60] for e in kernels})}


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
    for r in rows.values():
        r["share_of_bound"] = bound_ms / r["device_ms"]
    return {"shape": [ROWS, D], "bound_ms": bound_ms, "rows": rows,
            "max_err_in_bf16_ulps": float(ulps),
            "differs": int((out != want).sum()), "elements": ROWS * D}


def prefill(torch, trace_path: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import rms_norm as rn
    from repro_torch.models.model import build_model
    cfg = get_config("yi-6b")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(3, cfg.vocab, (4, 1024), device="cuda", dtype=torch.int32)
    model.prefill(params, tokens)
    torch.cuda.synchronize()
    rn.counter.reset()
    model.prefill(params, tokens)
    launches = rn.counter.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.prefill(params, tokens)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    norms = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") == "repro:norm":
            norms.setdefault(e["tid"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def inside(e) -> bool:
        t = float(e["ts"])
        return any(a <= t <= b for a, b in norms.get(e["tid"], ()))

    ops, launched = {}, set()
    for e in events:
        if e.get("ph") != "X" or not inside(e):
            continue
        if e.get("cat") == "cpu_op":
            ops[e["name"]] = ops.get(e["name"], 0) + 1
        elif e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launched.add(e["args"]["correlation"])
    kernels = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel" \
                and e.get("args", {}).get("correlation") in launched:
            name = e["name"][:60]
            kernels[name] = kernels.get(name, 0) + 1
    return {"n_layers": cfg.n_layers, "launches_a_prefill": launches,
            "norm_ranges": sum(len(v) for v in norms.values()),
            "ops_in_norm": ops, "kernels_in_norm": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prefill", action="store_true")
    args = ap.parse_args()
    import torch
    out_dir = ROOT / "build" / "rms_norm_probe"
    print(ptxas_report(out_dir), flush=True)
    result = {"kernel_table": kernel_table(torch)}
    if args.prefill:
        result["prefill"] = prefill(torch, out_dir / "prefill_trace.json")
    print("RESULT " + json.dumps(result), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
