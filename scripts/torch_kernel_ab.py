#!/usr/bin/env python3
"""Times the port's K1 (segment_reduce), K5 (linear_scan) and K7
(decode_attention) of earlier trees and of this one, in turns on one CUDA
card, beside the PyTorch call that computes the same function where there
is one.

Each earlier tree's ``src/`` is unpacked first, for example from a commit:

    mkdir -p build/parent && git archive <commit> src/repro_torch | tar -x -C build/parent
    python3 scripts/torch_kernel_ab.py build/parent/src [build/other/src ...]

The runs go earlier trees, this tree, this tree, earlier trees in reverse,
each a process of its own that builds its tree's kernels (into that tree's
``build/``) and prints one line, ``RESULT {json}``.  Per shape: CUDA events
over 200 back-to-back calls, device time under the profiler over 100 (the
sum over the kernel names of every tree, and each kernel name apart, so a
two-kernel route shows both), and the host's enqueue time a call over 200
(``chip_smoke.py``'s timers); the library call likewise.  Shapes: K1 at one
Fig. 6 GROUPBY block, (2,000,000 x 8) float32 over G 6, sum (count, min and
max: device time only); K7 at the serving shape, 8 slots x 32 heads over 4
KV heads x D 128 over a (1024, 4, 128) bf16 cache
(``chip_smoke.decode_main_inputs``), and (device time only) the same call
with every length 1, its cost with no keys to move; K5 at one RG-LRU layer
of recurrentgemma-9b's 2 x 4,096 prefill, (2, 4096, 4096) float32 as
``chip_smoke.rglru_like`` makes it, with its max |err| against
``linear_scan_plain`` and, in place of a library call (none computes the
recurrence), the device time of ``torch.add(a, b, out=h)``, which moves the
same bytes.  K1's sum, K5 and both K7 rows are also timed queued: 100
calls behind a spin kernel, so that the card runs them back to back
without waiting for the host (device time under the profiler and events,
a call).  The card's name, power limit and
SM clocks come last.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# K1's, K5's and K7's kernels before and after the redesign
KERNELS = {"K1": ("seg_pass", "seg_reg"),
           "K5": ("lin_summaries", "lin_carries", "lin_apply", "lin_walk"),
           "K7": ("decode_split", "decode_combine", "decode_tc")}


def per_kernel_ms(cs, fn, names, iters: int = 100) -> dict:
    """{kernel name: device ms a call} of the records whose names contain
    one of ``names``, under the CUDA profiler (``chip_smoke.device_window``,
    as its ``device_ms``), or None where the profiler lost the window."""
    import torch
    for _ in range(3):
        fn()
    events, _ = cs.device_window(torch, lambda: [fn() for _ in range(iters)])
    if events is None:
        return None
    return {e.key[:60]: e.self_device_time_total / iters / 1e3 for e in events
            if any(n in e.key for n in names)}


def queued_ms(cs, fn, names, calls: int = 100) -> dict:
    """Device time a call, under the CUDA profiler (None where it lost the
    window), and events a call, when ``calls`` calls are queued behind a
    ~5 ms spin kernel: the card runs them back to back and never waits for
    the host between them."""
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run():
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
    events, _ = cs.device_window(torch, run)
    device = None if events is None else sum(
        e.self_device_time_total for e in events if any(n in e.key for n in names)) / calls / 1e3
    return dict(queued_device=device, queued_events=start.elapsed_time(end) / calls)


def time_tree(name: str) -> None:
    """Times the repro_torch first on PYTHONPATH; prints its RESULT line."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import segment_reduce as sr

    def row(fn, names, lib=None) -> dict:
        res = dict(events=cs.cuda_ms(fn, iters=200), device=cs.device_ms(fn, names, iters=100),
                   by_kernel=per_kernel_ms(cs, fn, names), host=cs.host_ms(fn),
                   **queued_ms(cs, fn, names))
        if lib is not None:
            res.update(lib_events=cs.cuda_ms(lib, iters=200),
                       lib_device=cs.device_ms(lib, None, iters=100), lib_host=cs.host_ms(lib))
        return res

    _build.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"tree": name, "card": cs.card_line()}
    m, c, g = 2_000_000, 8, 6
    v = torch.rand((m, c), device=dev, generator=gen)
    codes = torch.randint(0, g, (m,), dtype=torch.int32, device=dev, generator=gen)
    codes64 = codes.long()
    res[f"K1 ({m} x {c}) G {g} sum"] = row(
        lambda: sr.segment_reduce(v, codes, g, "sum"), KERNELS["K1"],
        lambda: torch.zeros((g, c), device=dev).index_add_(0, codes64, v))
    for op in ("count", "min", "max"):
        fn = lambda: sr.segment_reduce(v, codes, g, op)
        res[f"K1 ({m} x {c}) G {g} {op}"] = dict(
            device=cs.device_ms(fn, KERNELS["K1"], iters=100),
            by_kernel=per_kernel_ms(cs, fn, KERNELS["K1"]))
    del v, codes, codes64
    a, b = cs.rglru_like(torch, (cs.PREFILL_BATCH, cs.PREFILL_SEQ, 4096), gen)
    h = torch.empty_like(a)
    res[f"K5 {list(a.shape)} f32"] = dict(
        row(lambda: ls.linear_scan(a, b), KERNELS["K5"]),
        max_abs_err=float((ls.linear_scan(a, b) - ls.linear_scan_plain(a, b)).abs().max()),
        add_device=cs.device_ms(lambda: torch.add(a, b, out=h), None, iters=100))
    del a, b, h
    q, k, v, lengths = cs.decode_main_inputs(torch, dev)
    mask = (torch.arange(k.shape[1], device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    res[f"K7 {list(q.shape)} x {list(k.shape)} bf16"] = row(
        lambda: da.decode_attention(q, k, v, lengths), KERNELS["K7"],
        lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True))
    # the same call with every length 1: what a call costs with no keys to move
    ones = torch.ones_like(lengths)
    fn = lambda: da.decode_attention(q, k, v, ones)
    res["K7 lengths 1"] = dict(device=cs.device_ms(fn, KERNELS["K7"], iters=100),
                               by_kernel=per_kernel_ms(cs, fn, KERNELS["K7"]),
                               **queued_ms(cs, fn, KERNELS["K7"]))
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
