#!/usr/bin/env python3
"""Times the port's K3 (onehot_encode) and K4 (window_scan) of earlier trees
and of this one, in turns on one CUDA card, beside the PyTorch call that
computes the same function.

Each earlier tree's ``src/`` is unpacked first, for example from a commit:

    mkdir -p build/parent && git archive <commit> src/repro_torch | tar -x -C build/parent
    python3 scripts/torch_kernel_ab.py build/parent/src [build/other/src ...]

The runs go earlier trees, this tree, this tree, earlier trees in reverse,
each a process of its own that builds its tree's kernels (into that tree's
``build/``) and prints one line, ``RESULT {json}``: per shape, CUDA events
over 200 back-to-back calls, device time under the profiler over 100, and
the host's enqueue time a call over 200 (``chip_smoke.py``'s timers).  The
card's name, power limit and SM clocks come last.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# K4's kernels before and after the one-launch redesign
SCAN_KERNELS = ("scan_totals", "scan_carries", "scan_apply", "scan_one_pass")


def time_tree(name: str) -> None:
    """Times the repro_torch first on PYTHONPATH; prints its RESULT line."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import onehot_encode as oh
    from repro_torch.kernels import window_scan as ws

    def row(fn, names, lib) -> dict:
        return dict(events=cs.cuda_ms(fn, iters=200), device=cs.device_ms(fn, names, iters=100),
                    host=cs.host_ms(fn), lib_events=cs.cuda_ms(lib, iters=200),
                    lib_device=cs.device_ms(lib, None, iters=100), lib_host=cs.host_ms(lib))

    _build.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"tree": name, "card": cs.card_line()}
    for m in (2_000_000, 16_000_000):
        x = torch.randn(m, device=dev, generator=gen)
        res[f"K4 ({m},) cumsum"] = row(lambda: ws.window_scan(x), SCAN_KERNELS,
                                       lambda: torch.cumsum(x, 0))
    for m, g in ((4, 4), (2_000_000, 3)):
        c = torch.randint(0, g, (m,), dtype=torch.int32, device=dev, generator=gen)
        c64 = c.long()
        res[f"K3 ({m},) x {g}"] = row(lambda: oh.onehot_encode(c, g), ("onehot",),
                                      lambda: F.one_hot(c64, g))
    print("RESULT " + json.dumps(res), flush=True)


def main(earlier: list[str]) -> int:
    trees = [(src, src) for src in earlier]
    order = trees + [("this", str(ROOT / "src"))] * 2 + trees[::-1]
    for name, src in order:
        env = dict(os.environ, PYTHONPATH=src)
        run = subprocess.run([sys.executable, __file__, "--time", name], env=env, cwd=ROOT,
                             capture_output=True, text=True)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("RESULT ")]
        if run.returncode != 0 or not lines:
            sys.stderr.write(run.stdout[-4000:] + run.stderr[-4000:])
            return run.returncode or 1
        print(lines[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_tree(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
