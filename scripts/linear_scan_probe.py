#!/usr/bin/env python3
"""Probes K5 (``csrc/linear_scan.cu``) on one CUDA card: its ring depth and
slab width, what its walk costs without the loads, and what the card's
memory gives for the same bytes.

    python3 scripts/linear_scan_probe.py

Builds ``linear_scan.cu`` alone once per variant (``-DLINSCAN_STAGES``,
``-DLINSCAN_SLAB``; one nvcc each, all started together, into
``build/linscan_probe/``), prints each build's ptxas report and the
multiply / add / fused opcodes that cuobjdump finds in its ``lin_walk``
SASS, then at (2, 4096, 4096) float32 as the RG-LRU makes it
(``chip_smoke.rglru_like``) times each variant, in a process of its own,
with CUDA events over 50 calls and on the device under the profiler, and
holds each to ``linear_scan_plain`` bit for bit (all but the one built
without loads, which walks an unfilled ring: its time is the chain and the
stores of h alone).  Two readings beside them, on the shipped build: the
same call with every stride 0 (a and b one row each, served from L2), and
``torch.add(a, b, out=h)``, which moves the same 3 * B * T * N * 4 bytes.
Prints one line, ``RESULT {json}``, then the card's name, power limit and
SM clocks.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (stages, slab, loads): the shipped build first; "no loads" walks the ring
# without filling it (-DLINSCAN_PROBE_NO_LOADS), so it reads the chain and
# the stores of h alone
VARIANTS = [(4, 32, True), (2, 32, True), (6, 32, True), (4, 16, True), (4, 32, False)]


def build(nvcc: str, flags: tuple, out: Path) -> dict:
    """{(stages, slab, loads): (library path, ptxas report)}; raises if one
    fails."""
    src = ROOT / "src" / "repro_torch" / "csrc" / "linear_scan.cu"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stages, slab, loads in VARIANTS:
        so = out / f"lin_s{stages}_w{slab}{'' if loads else '_noloads'}.so"
        procs[(stages, slab, loads)] = (so, subprocess.Popen(
            [nvcc, *flags, "-Xptxas", "-v", f"-DLINSCAN_STAGES={stages}",
             f"-DLINSCAN_SLAB={slab}", *([] if loads else ["-DLINSCAN_PROBE_NO_LOADS"]),
             "-shared", str(src), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (so, p) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {key} failed:\n{text}")
        built[key] = (so, [ln.strip() for ln in text.splitlines() if "lin_walk" in ln
                           or "registers" in ln or "spill" in ln])
    return built


def sass_ops(cuobjdump: str, so: Path) -> dict:
    """Opcode counts of FMUL, FADD and FFMA in each lin_walk instance."""
    text = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if "lin_walk" in m.group(1) else None
            if name:
                counts[name] = {"FMUL": 0, "FADD": 0, "FFMA": 0}
        elif name:
            for op in counts[name]:
                if re.search(rf"\b{op}\b", ln):
                    counts[name][op] += 1
    return counts


def time_variant(so: Path, first: bool) -> dict:
    """One variant's readings, in a process of its own (each library
    carries its own CUDA runtime)."""
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import linear_scan as ls

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    a, b = cs.rglru_like(torch, (cs.PREFILL_BATCH, cs.PREFILL_SEQ, 4096),
                         torch.Generator(device=dev).manual_seed(7))
    batch, t, n = a.shape
    lib = ctypes.CDLL(str(so))
    fn = lib.repro_linear_scan
    fn.argtypes = list(_build._SIGNATURES["repro_linear_scan"])
    fn.restype = ctypes.c_int
    out = torch.empty_like(a)

    def call(strides=(t * n, n, t * n, n)):
        _build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, t, n, *strides, 16,
                        torch.cuda.current_stream().cuda_stream), "linear_scan probe")

    call()
    torch.cuda.synchronize()
    row = {"bit_equal": bool(torch.equal(out, ls.linear_scan_plain(a, b))),
           "events_ms": cs.cuda_ms(call, iters=50),
           "device_ms": cs.device_ms(call, ("lin_walk",), iters=50)}
    if first:
        zero = lambda: call((0, 0, 0, 0))
        row["strides_0_events_ms"] = cs.cuda_ms(zero, iters=50)
        row["strides_0_device_ms"] = cs.device_ms(zero, ("lin_walk",), iters=50)
        add = lambda: torch.add(a, b, out=out)
        row["add_events_ms"] = cs.cuda_ms(add, iters=50)
        row["add_device_ms"] = cs.device_ms(add, None, iters=50)
        row["bound_ms"] = cs.bound_ms(3 * a.numel() * 4, 2 * a.numel())[0]
        row["card"] = cs.card_line()
    return row


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    nvcc = _build._nvcc()
    built = build(nvcc, _build.NVCC_FLAGS, ROOT / "build" / "linscan_probe")
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    res, ok = {}, True
    for (stages, slab, loads), (so, ptxas) in built.items():
        first = (stages, slab, loads) == VARIANTS[0]
        run = subprocess.run([sys.executable, __file__, "--variant", str(so), str(int(first))],
                             cwd=ROOT, capture_output=True, text=True)
        found = [ln for ln in run.stdout.splitlines() if ln.startswith("VARIANT ")]
        row = json.loads(found[-1][len("VARIANT "):]) if run.returncode == 0 and found else {
            "failed": (run.stdout[-1500:] + run.stderr[-1500:])}
        ok = ok and (row.get("bit_equal", False) or (not loads and "failed" not in row))
        row.update(ptxas=ptxas, sass=sass_ops(cuobjdump, so))
        res[f"stages {stages} slab {slab}" + ("" if loads else " no loads")] = row
    print("RESULT " + json.dumps(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--variant"]:
        print("VARIANT " + json.dumps(time_variant(Path(sys.argv[2]), sys.argv[3] == "1")),
              flush=True)
    else:
        sys.exit(main())
