"""What the one-kernel probes share (``scripts/rms_norm_probe.py``,
``scripts/rope_probe.py``): the ptxas report of one ``csrc`` source, a
kernel's time on the card by CUDA events and under the profiler, and the
launches, operators and device kernels inside one ``repro:`` range of a
traced yi-6b prefill.  Imported by those scripts, which put this directory
on ``sys.path`` by being run from it.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12


def ptxas_report(source: str, out: Path) -> str:
    """nvcc with the library's flags and ``-Xptxas -v`` on ``csrc/<source>``,
    into ``out``; its registers, spills and shared memory a kernel."""
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                          str(_build.CSRC / source), "-o", str(out / (Path(source).stem + ".o"))],
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


def with_shares(rows: dict, bound_ms: float) -> dict:
    """Each of ``timed``'s rows with its share of the bound by device time."""
    for r in rows.values():
        r["share_of_bound"] = bound_ms / r["device_ms"]
    return rows


def inside_range(events: list, name: str) -> dict:
    """The ``name`` ranges of a chrome trace's events, and the operators and
    (by correlation) the device kernels launched inside them."""
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") == name:
            ranges.setdefault(e["tid"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def inside(e) -> bool:
        t = float(e["ts"])
        return any(a <= t <= b for a, b in ranges.get(e["tid"], ()))

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
            kernels[e["name"][:60]] = kernels.get(e["name"][:60], 0) + 1
    return {"ranges": sum(len(v) for v in ranges.values()), "ops": ops, "kernels": kernels}


def yi_prefill(torch, counter, range_name: str, trace_path: Path) -> dict:
    """yi-6b at full width from random weights on the card: ``counter``'s
    launches in one 4 x 1024 prefill (after a warm one), and what runs
    inside ``range_name`` in the profiler's trace of another."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config("yi-6b")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(3, cfg.vocab, (4, 1024), device="cuda", dtype=torch.int32)
    model.prefill(params, tokens)
    torch.cuda.synchronize()
    counter.reset()
    model.prefill(params, tokens)
    launches, routes = counter.launches, dict(counter.routes)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.prefill(params, tokens)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    found = inside_range(json.loads(trace_path.read_text())["traceEvents"], range_name)
    del model, params
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "launches_a_prefill": launches, "routes": routes,
            "in_range": found}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    return smi.stdout.strip()
