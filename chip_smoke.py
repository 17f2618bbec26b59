#!/usr/bin/env python3
"""Chip check of the PyTorch port: builds the hand-written sm_90a kernels,
holds each against its plain PyTorch version on the card, and drives the
engine's main path on CUDA through its user entry points.

Phases (any failure raises and the script exits non-zero):
  1. card      — CUDA must be available; prints the card's name and power limit
  2. build     — nvcc builds the kernels from src/repro_torch/csrc into build/
  3. kernels   — each kernel vs its plain version at edge shapes and at the
                 main path's shapes (segment_reduce sums both against a
                 float64 sum), an all-column aggregate of a 3,000-column
                 frame on the card vs the CPU; times kernel, plain version
                 and one library call with CUDA events
  (4 and 5 time each step unprofiled, then run the steps once more under
  the CUDA profiler for the device's busy time within each)
  4. fig6      — the Fig. 6 mix at 16,000,000 rows of taxi_like_frame in an
                 EAGER session: fillna, groupby(n).count(), count(), a
                 groupby(n).agg(sum, mean, min, max), and .T.T of a
                 1,600,000 x 64 matrix frame, each checked against numpy
  5. figure1   — the paper's Figure-1 workflow in OPPORTUNISTIC mode on CUDA,
                 compared with the same workflow on the CPU

Run from the root of a checkout:  python3 chip_smoke.py
The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}; the card's name and power limit come before.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
TAXI_ROWS = 16_000_000             # about one month of NYC yellow-cab trips
MATRIX_ROWS, MATRIX_COLS = TAXI_ROWS // 10, 64   # bench_fig6.py:78


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -----------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# -----------------------------------------------------------------------------
SUM_RTOL = 1e-5     # |sum - exact| <= SUM_RTOL * sum|v|, per segment and column


def sum_error(torch, got, v, codes, g: int) -> tuple[float, float]:
    """(max |got - exact|, max of |got - exact| / (SUM_RTOL * sum|v|)) over
    segments and columns, the exact sum taken in float64 on the same inputs.
    Raises unless NaN stands exactly where the exact sum has it."""
    keep = codes >= 0
    idx, v64 = codes[keep].long(), v[keep].double()
    exact = torch.zeros((g, v.shape[1]), dtype=torch.float64, device=v.device)
    exact.index_add_(0, idx, v64)
    absv = torch.zeros_like(exact).index_add_(0, idx, torch.nan_to_num(v64).abs())
    got = got.reshape(exact.shape).double()
    if not torch.equal(torch.isnan(got), torch.isnan(exact)):
        raise AssertionError("segment_reduce sum: NaN where the exact sum has none, or not")
    err = (torch.nan_to_num(got) - torch.nan_to_num(exact)).abs()
    return float(err.max()) if err.numel() else 0.0, \
        float((err / (SUM_RTOL * absv + 1e-30)).max()) if err.numel() else 0.0


def check_segment_reduce(torch, sr, dev, pool: int) -> None:
    """Edge shapes (ragged M, code -1, NaN, G = 1 / 6 / 65536, C = 1 / 8 and
    column slabs past one launch's width) and the Fig. 6 GROUPBY's per-block
    shape, uniform values as its validity and presence columns are."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = [(1000, 6, 8, "normal"), (4097, 1, 1, "normal"), (12345, 6, 1, "normal"),
             (777, 65536, 1, "normal"), (300_001, 65536, 1, "normal"),
             (70_001, 6, 8, "normal"), (5, 3, 2, "normal"), (0, 4, 1, "normal"),
             (2001, 6, 2000, "normal"), (1000, 65536, 1600, "normal"),
             (-(-TAXI_ROWS // pool), 6, 8, "uniform"), (-(-TAXI_ROWS // pool), 6, 8, "normal")]
    worst = 0.0
    for m, g, c, dist in cases:
        if dist == "uniform":
            v = torch.rand((m, c), generator=gen).to(dev)
            codes = torch.randint(0, g, (m,), generator=gen, dtype=torch.int32).to(dev)
        else:
            v = torch.randn((m, c), generator=gen).to(dev)
            codes = torch.randint(-1, g, (m,), generator=gen, dtype=torch.int32).to(dev)
            if m > 10:
                v[::97, 0] = float("nan")
        for op in ("sum", "count", "min", "max"):
            got = sr.segment_reduce(v, codes, g, op)
            again = sr.segment_reduce(v, codes, g, op)
            if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                raise AssertionError(f"segment_reduce {op} {(m, g, c)}: runs differ")
            want = sr.segment_reduce_plain(v, codes, g, op)
            if op == "sum":
                for who, res in (("kernel", got), ("plain", want)):
                    _, ratio = sum_error(torch, res, v, codes, g)
                    if ratio > 1.0:
                        raise AssertionError(f"segment_reduce sum {(m, g, c)}: {who} is "
                                             f"{ratio:.3g}x the tolerance off the exact sum")
                    worst = max(worst, ratio)
            else:
                torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                                           msg=lambda s: f"segment_reduce {op} {(m, g, c)}: {s}")
        del v, codes, got, again, want
    log(f"  segment_reduce: {len(cases)} shapes x 4 ops match the plain version "
        f"(count/min/max exact; sum of kernel and plain within {SUM_RTOL}*sum|v| of a "
        f"float64 sum, worst {worst:.3g} of it; reruns bit-identical)")


def check_transpose(torch, bt, dev, pool: int) -> None:
    block = -(-MATRIX_ROWS // pool)     # the .T.T's blocks: (block, 64) then (64, block)
    shapes = [(1, 1), (1, 777), (777, 1), (257, 129), (33, 4097), (31, 33),
              (block, MATRIX_COLS), (MATRIX_COLS, block)]
    for shape in shapes:
        for dtype in (torch.float32, torch.int32):
            x = (torch.randn(shape, device=dev) * 1000).to(dtype)
            if dtype == torch.float32:
                x.view(-1)[::5] = -0.0
                x.view(-1)[::7] = float("nan")
            got = bt.block_transpose(x)
            want = bt.block_transpose_plain(x)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"block_transpose {shape} {dtype}: bits differ")
    log(f"  block_transpose: {len(shapes)} shapes x (f32, i32) bit-exact")


def check_onehot(torch, oh, dev) -> None:
    # the last shape has M * G = 2,160,000,000 > 2^31 elements
    shapes = [(1, 1), (4, 4), (1000, 3), (513, 1000), (100_003, 7), (2048, 70_000),
              (36_000, 60_000)]
    for m, g in shapes:
        codes = torch.randint(-1, g + 3, (m,), dtype=torch.int32, device=dev)
        if not torch.equal(oh.onehot_encode(codes, g), oh.onehot_encode_plain(codes, g)):
            raise AssertionError(f"onehot_encode {(m, g)} differs")
    log(f"  onehot_encode: {len(shapes)} shapes bit-exact (codes -1 and >= G give zero rows)")


def check_wide_aggregate(torch, dev) -> None:
    """An all-column aggregate of a frame wider than one segment_reduce
    launch takes (the wide output of .T): on the card and on the CPU."""
    from repro_torch.core import DataFrame, EvalMode, Session
    from repro_torch.data import numeric_matrix_frame
    got = {}
    for d in (dev, "cpu"):
        s = Session(mode=EvalMode.EAGER, device=d)
        wide = DataFrame(numeric_matrix_frame(3000, 5, seed=0, device=d), session=s).T
        got[str(d)] = (wide.count().collect(), wide.sum().collect(), wide.max().collect())
        s.close()
    (gc, gs, gm), (cc, cs, cm) = got[str(dev)], got["cpu"]
    assert gc.shape == (1, 3000) and gc.to_pydict() == cc.to_pydict()
    assert gm.to_pydict() == cm.to_pydict()
    torch.testing.assert_close(gs.as_matrix()[0].cpu(), cs.as_matrix()[0], rtol=1e-5, atol=1e-5)
    log("  wide aggregate: .T.count() / .sum() / .max() over 3,000 columns match the CPU")


def time_kernels(torch, sr, bt, oh, dev, pool: int) -> dict:
    """Kernel, plain and library times at the main path's shapes; each
    kernel's error against its plain version is asserted, not only shown."""
    import torch.nn.functional as F
    rows = -(-TAXI_ROWS // pool)
    out = {}
    # GROUPBY count over 7 columns + presence: one (M, 8) sum launch per block
    m, c, g = rows, 8, 6
    v = torch.rand((m, c), device=dev)
    codes = torch.randint(0, g, (m,), dtype=torch.int32, device=dev)
    codes64 = codes.long()
    k = sr.segment_reduce(v, codes, g, "sum")
    plain = sr.segment_reduce_plain(v, codes, g, "sum")
    lib = torch.zeros((g, c), device=dev).index_add_(0, codes64, v)
    err = float((k - plain).abs().max())
    (k_abs, k_ratio), (p_abs, p_ratio), (l_abs, l_ratio) = (
        sum_error(torch, r, v, codes, g) for r in (k, plain, lib))
    assert k_ratio <= 1.0 and p_ratio <= 1.0, (k_ratio, p_ratio)
    log(f"  segment_reduce {[m, c, g]} sum against a float64 sum: kernel {k_abs:.6g} "
        f"({k_ratio:.3g} of the tolerance), plain {p_abs:.6g} ({p_ratio:.3g}), "
        f"float32 index_add_ {l_abs:.6g} ({l_ratio:.3g})")
    b, by = bound_ms((m * c + m + g * c) * 4, m * c)
    out["segment_reduce"] = dict(
        name="segment_reduce", route="cuda", source="src/repro_torch/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce.py:75", shape=[m, c, g],
        max_abs_err=err,
        ms=cuda_ms(lambda: sr.segment_reduce(v, codes, g, "sum")),
        plain_ms=cuda_ms(lambda: sr.segment_reduce_plain(v, codes, g, "sum")),
        library_ms=cuda_ms(lambda: torch.zeros((g, c), device=dev).index_add_(0, codes64, v)),
        bound_ms=b, bound_by=by)
    # TRANSPOSE: one (rows/10, 64) float32 block of the matrix frame
    x = torch.randn((-(-MATRIX_ROWS // pool), MATRIX_COLS), device=dev)
    err = float((bt.block_transpose(x) - bt.block_transpose_plain(x)).abs().max())
    assert err == 0.0, err
    b, by = bound_ms(2 * x.numel() * 4, 0)
    out["block_transpose"] = dict(
        name="block_transpose", route="cuda", source="src/repro_torch/csrc/block_transpose.cu",
        replaces="src/repro/kernels/block_transpose.py:31", shape=list(x.shape),
        max_abs_err=err,
        ms=cuda_ms(lambda: bt.block_transpose(x)),
        plain_ms=cuda_ms(lambda: bt.block_transpose_plain(x)),
        library_ms=cuda_ms(lambda: x.t().contiguous()),
        bound_ms=b, bound_by=by)
    # get_dummies of Figure-1's Display column: 4 rows, 4 categories
    codes = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=dev)
    codes64 = codes.long()
    err = float((oh.onehot_encode(codes, 4) - oh.onehot_encode_plain(codes, 4)).abs().max())
    assert err == 0.0, err
    b, by = bound_ms((4 * 4 + 4) * 4, 0)
    out["onehot_encode"] = dict(
        name="onehot_encode", route="cuda", source="src/repro_torch/csrc/onehot_encode.cu",
        replaces="src/repro/kernels/onehot_encode.py:29", shape=[4, 4],
        max_abs_err=err,
        ms=cuda_ms(lambda: oh.onehot_encode(codes, 4)),
        plain_ms=cuda_ms(lambda: oh.onehot_encode_plain(codes, 4)),
        library_ms=cuda_ms(lambda: F.one_hot(codes64, 4)),
        bound_ms=b, bound_by=by)
    return out


# -----------------------------------------------------------------------------
# phase 4: the Fig. 6 mix at full size
# -----------------------------------------------------------------------------
def timed(label: str, fn):
    """Run one step and print its wall time (host clock, ending in a sync)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    log(f"  {label}: {time.perf_counter() - t0:.3f} s wall")
    return out


def profiled(label: str, fn):
    """Run one step under the CUDA profiler and print the device's busy time
    in it (the summed durations of the kernels and copies the profiler saw)
    beside the profiled run's wall time, which the profiler lengthens."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e6
    log(f"  {label}: device busy {busy * 1e3:.3f} ms of {wall:.3f} s profiled wall "
        f"({100 * busy / wall:.2f}%)")
    return out


def fig6_data(dev):
    from repro_torch.data import numeric_matrix_frame, taxi_like_frame
    frame = timed(f"taxi_like_frame({TAXI_ROWS}) on the card",
                  lambda: taxi_like_frame(TAXI_ROWS, seed=0, device=dev))
    mat = timed(f"numeric_matrix_frame({MATRIX_ROWS}, {MATRIX_COLS}) on the card",
                lambda: numeric_matrix_frame(MATRIX_ROWS, MATRIX_COLS, seed=0, device=dev))
    return frame, mat


def fig6_steps(run, dev, frame, mat) -> dict:
    """The Fig. 6 mix in fresh EAGER sessions; ``run(label, thunk)`` runs
    each step (timed, or under the profiler)."""
    from repro_torch.core import DataFrame, EvalMode, Session
    s = Session(mode=EvalMode.EAGER, device=dev)
    # .T.T with rewriting off: R1 would cancel the pair and run no transpose
    st = Session(mode=EvalMode.EAGER, optimize=False, device=dev)
    df, dm = DataFrame(frame, session=s), DataFrame(mat, session=st)
    out = {"filled": run("fillna(0.0)", lambda: df.fillna(0.0).collect()),
           "count_n": run("groupby(passenger_count).count()",
                          lambda: df.groupby("passenger_count").count().collect()),
           "count_1": run('df["f0"].count()', lambda: df["f0"].count()),
           "agg": run("groupby(passenger_count).agg(f0: sum, mean, min, max)",
                      lambda: df.groupby("passenger_count").agg(
                          {"f0": ["sum", "mean", "min", "max"]}).collect())}
    t = run(".T", lambda: dm.T)
    out["back"] = run(".T (second) + collect", lambda: t.T.collect())
    s.close()
    st.close()
    return out


def check_fig6(torch, np, dev, out: dict) -> None:
    """Every Fig. 6 result against numpy from the same seed."""
    from repro_torch.core import Domain
    from repro_torch.core.frame import host
    n = TAXI_ROWS
    rng = np.random.default_rng(0)        # taxi_like_frame's calls, in order
    pc = rng.integers(1, 7, n)
    rng.choice(3, n)
    cols, nulls = [], []
    for _ in range(6):
        cols.append(rng.standard_normal(n).astype(np.float32))
        nulls.append(rng.random(n) < 0.01)

    filled = out["filled"]
    assert filled.shape == (n, 8), filled.shape
    for j in range(6):
        want = torch.from_numpy(np.where(nulls[j], 0.0, cols[j]).astype(np.float32)).to(dev)
        assert filled.columns[2 + j].mask is None and torch.equal(filled.columns[2 + j].data, want)

    g = out["count_n"]
    assert g.col("passenger_count").to_pylist() == [1, 2, 3, 4, 5, 6]
    assert g.col("payment_type").to_pylist() == np.bincount(pc - 1, minlength=6).tolist()
    for j in range(6):
        want = np.bincount(pc[~nulls[j]] - 1, minlength=6).tolist()
        assert g.col(f"f{j}").to_pylist() == want, (j, g.col(f"f{j}").to_pylist(), want)

    assert out["count_1"] == int((~nulls[0]).sum()), out["count_1"]

    a = out["agg"]
    valid = ~nulls[0]
    v64, key = cols[0][valid].astype(np.float64), pc[valid] - 1
    sums = np.bincount(key, weights=v64, minlength=6)
    abss = np.bincount(key, weights=np.abs(v64), minlength=6)
    cnt = np.bincount(key, minlength=6)
    got_sum = np.asarray(a.col("f0_sum").to_pylist())
    got_mean = np.asarray(a.col("f0_mean").to_pylist())
    assert np.all(np.abs(got_sum - sums) <= SUM_RTOL * abss), (got_sum, sums)
    assert np.all(np.abs(got_mean - sums / cnt) <= SUM_RTOL * abss / cnt), (got_mean, sums / cnt)
    for gi in range(6):
        seg = cols[0][valid][key == gi]
        assert a.col("f0_min").to_pylist()[gi] == float(seg.min())
        assert a.col("f0_max").to_pylist()[gi] == float(seg.max())

    back = out["back"]
    want = np.random.default_rng(0).standard_normal((MATRIX_ROWS, MATRIX_COLS)).astype(np.float32)
    got, _ = back.as_matrix(Domain.FLOAT)
    assert back.shape == (MATRIX_ROWS, MATRIX_COLS) and all(d is Domain.FLOAT for d in back.schema)
    assert torch.equal(got, torch.from_numpy(want).to(dev)), ".T.T is not bit-equal to the input"
    assert host(back.columns[0].data).dtype == np.float32


# -----------------------------------------------------------------------------
# phase 5: the Figure-1 workflow
# -----------------------------------------------------------------------------
def figure1(device):
    from repro_torch.core import DataFrame, EvalMode, Session, get_dummies
    s = Session(mode=EvalMode.OPPORTUNISTIC, device=device)
    products = DataFrame({
        "iPhone 11 Pro": ["5.8-inch", "12MP", "120MP", "Yes"],
        "iPhone 11 Pro Max": ["6.5-inch", "12MP", "12MP", "Yes"],
        "iPhone XR": ["6.1-inch", "12MP", "7MP", "No"],
        "iPhone 8 Plus": ["5.5-inch", "12MP", "7MP", "No"],
    }, row_labels=["Display", "Camera", "Front Camera", "Wireless Charging"], session=s)
    products.iloc[2, 0] = "12MP"
    products = products.T
    products["Wireless Charging"] = products["Wireless Charging"].map(
        lambda v: 1 if v == "Yes" else 0)
    prices = DataFrame({
        "model": ["iPhone 11 Pro", "iPhone 11 Pro Max", "iPhone XR", "iPhone 8 Plus"],
        "price": [999, 1099, 599, 449],
        "rating": [4.5, 4.6, 4.4, 4.3],
    }, session=s)
    one_hot = get_dummies(products.reset_index("model"), ["Display"])
    joined = one_hot.merge(prices, on="model")
    numeric = joined[[c for c in joined.columns
                      if c not in ("model", "Camera", "Front Camera")]]
    out = {"products": products.collect().induce(), "one_hot": one_hot.collect(),
           "joined": joined.collect(), "cov": numeric.cov()}
    s.close()
    return out


def compare_figure1(np, gpu: dict, cpu: dict) -> None:
    from repro_torch.core.frame import host
    for k in ("products", "one_hot", "joined"):
        a, b = gpu[k], cpu[k]
        assert a.col_labels.to_list() == b.col_labels.to_list(), k
        assert a.row_labels.to_list() == b.row_labels.to_list(), k
        assert a.schema == b.schema, k
        assert a.to_pydict() == b.to_pydict(), k
    ga, ca = host(gpu["cov"].as_matrix()[0]), host(cpu["cov"].as_matrix()[0])
    assert gpu["cov"].col_labels.to_list() == cpu["cov"].col_labels.to_list()
    np.testing.assert_allclose(ga, ca, rtol=1e-4, atol=1e-4)
    assert gpu["cov"].columns[0].data.is_cuda


# -----------------------------------------------------------------------------
def main() -> int:
    t_start = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false — this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.schedule import pool_width
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_transpose as bt
    from repro_torch.kernels import onehot_encode as oh
    from repro_torch.kernels import segment_reduce as sr
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    card = card_line()
    log(f"[card] {torch.cuda.get_device_name(0)} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | pool width {pool_width()} "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] nvcc {', '.join(_build.SOURCES)} -> build/: {_build.build_seconds():.1f} s")

    t0 = time.perf_counter()
    pool = pool_width()
    log("[kernels] against their plain versions")
    check_segment_reduce(torch, sr, dev, pool)
    check_transpose(torch, bt, dev, pool)
    check_onehot(torch, oh, dev)
    check_wide_aggregate(torch, dev)
    timings = time_kernels(torch, sr, bt, oh, dev, pool)
    for rec in timings.values():
        log(f"  {rec['name']} {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), max |err| {rec['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    log(f"[kernels] {time.perf_counter() - t0:.1f} s")

    counters = {"segment_reduce": sr.counter, "block_transpose": bt.counter,
                "onehot_encode": oh.counter}
    launches = dict.fromkeys(counters, 0)

    t0 = time.perf_counter()
    log(f"[fig6] EAGER sessions on {dev}, {TAXI_ROWS} rows")
    frame, mat = fig6_data(dev)
    for c in counters.values():
        c.reset()
    out = fig6_steps(timed, dev, frame, mat)
    for k, c in counters.items():
        launches[k] += c.launches
    log(f"[fig6] launches {dict((k, c.launches) for k, c in counters.items())}")
    for k in ("segment_reduce", "block_transpose"):
        assert counters[k].launches > 0, f"the Fig. 6 mix never launched {k}"
    check_fig6(torch, np, dev, out)
    del out
    log("[fig6] results match numpy; the same steps again under the CUDA profiler:")
    fig6_steps(profiled, dev, frame, mat)
    del frame, mat
    log(f"[fig6] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[figure1] OPPORTUNISTIC session on cuda vs the same workflow on the CPU")
    for c in counters.values():
        c.reset()
    gpu = timed("Figure-1 workflow on cuda", lambda: figure1(dev))
    fig1 = {k: c.launches for k, c in counters.items()}
    for k in counters:
        launches[k] += fig1[k]
    assert fig1["onehot_encode"] > 0, "the Figure-1 workflow never launched onehot_encode"
    compare_figure1(np, gpu, figure1("cpu"))
    profiled("Figure-1 workflow on cuda", lambda: figure1(dev))
    log(f"[figure1] launches {fig1}; matches the CPU run; {time.perf_counter() - t0:.1f} s")

    record = []
    for k in ("segment_reduce", "block_transpose", "onehot_encode"):
        rec = dict(timings[k])
        rec["launches"] = launches[k]
        record.append(rec)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
