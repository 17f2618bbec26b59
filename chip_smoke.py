#!/usr/bin/env python3
"""Chip check of the PyTorch port: builds the hand-written sm_90a kernels,
holds each against its plain PyTorch version on the card, and drives the
engine's main path on CUDA through its user entry points.

Phases (any failure raises and the script exits non-zero):
  1. card      — CUDA must be available; prints the card's name and power limit
  2. build     — nvcc builds the kernels from src/repro_torch/csrc into build/
  3. kernels   — each kernel vs its plain version at edge shapes and at the
                 main path's shapes (segment_reduce sums both against a
                 float64 sum; both its routes, "reg" and "table"; route
                 reg's sum bit-equal to the float32 emulation of its stated
                 order at (1 x 8), (4,097 x 8), (2,000,000 x 8) and
                 (3,000,001 x 1), one launch a call under the
                 profiler), an all-column aggregate of a 3,000-column
                 frame on the card vs the CPU; times kernel, plain version
                 and one library call with CUDA events, and each kernel's
                 device time under the profiler (K3 and K4 also the host's
                 enqueue time a call, theirs and the library call's);
                 onehot_encode at G = 1, 3, 4, 5, 7, 1000, ragged M, codes
                 -1 and >= G, codes at an odd offset, bit-exact; window_scan
                 at edge shapes, strided columns and one of more than 2^31
                 elements, every case run twice and bit-identical, 50 reruns
                 bit-identical at (2,000,000,) and (16,000,000,) (past the
                 grid's shared memory), cumsum bit-equal to the float32
                 emulation of its stated association order at five
                 lengths up to 16,000,000, one launch a call under the
                 profiler; K3 timed at Figure-1's 4 x 4 and at one block of
                 get_dummies(payment_type), 2,000,000 x 3; K4 at one block,
                 (2,000,000,), and at the whole column; decode_attention
                 (K7) at the reference's four f32 shapes (route fma), at the
                 serving shape in bf16 (route tc, ten reruns bit-identical,
                 one launch a call under the profiler), at eight more
                 bf16 shapes (G 1 to 64, D 16 to 256, S 129 to 32,768) and
                 at G 1, 4, 8, 16 with lengths 0, 1, 127, 128, 129, S and
                 S + 7; bf16 at D 40 refused;
                 K1 and K7 timed with host enqueue times and the library
                 call's device and host times; linear_scan (K5)
                 equal to its plain version bit for bit (torch.equal) at
                 the reference's three shapes, T = 0, 1, 63, 64, 65 and
                 4,097, B = 1 and 3 at N = 4096, N = 33 and 70 (4-byte
                 copies), views with batch and time strides, and phase 8's
                 (2, 4096, 4096) as the RG-LRU makes it, ten reruns
                 bit-identical, one launch a call under the profiler, timed
                 with its host enqueue time; K5's backward (the reverse
                 walk) through the autograd Function equal (torch.equal)
                 to autograd through linear_scan_plain at the reference's
                 three shapes, T = 1, 63, 64, 65 and 4,097, N = 33 and 70,
                 two time-strided views and phase 11's (1, 4096, 4096),
                 one fwd and one bwd launch a call, ten reruns
                 bit-identical, one launch a backward under the profiler,
                 timed against its bound; flash_attention (K6: bf16 on
                 the tensor cores, f32 on the FMA kernel) at the
                 reference's four shapes x window (None, 32) in f32 and
                 bf16, at yi-6b's and recurrentgemma-9b's prefill shapes in
                 bf16 (ten reruns bit-identical), rows before every key 0
                 (f32 and bf16), and in bf16: windows 63, 64 and 65 at Sq =
                 Sk and Sq < Sk, D 33 through the wrapper's padded copy, q /
                 k / v as views of one fused projection; K6 non-causal
                 (bf16 and f32) at the whisper encoder's shape (4 x 1,500
                 frames, 8 heads, D 64), both cross shapes of phase 12 (Sq
                 32 over M 1,500, D 64; over M 1,600, 64 heads over 8, D
                 128), and Sk 1, 63, 65 and 1,500 at Sq != Sk; K7 with
                 every length M at the decode-cross shapes, against its
                 plain version and K6 at Sq = 1; K7's split route (the
                 partials mode on each piece of the serving cache, cut
                 into 2, 4 and 8 pieces, combined in order) against the
                 whole cache in bf16 and f32 within K7_BF16_TOL, the
                 partials mode timed at the serving shape; then the CUDA-only
                 pytest cases, ``python -m pytest --noconftest
                 tests/test_torch_cuda_kernels.py`` in a child process
                 (every case must pass; none may skip)
  (4, 5, 6 and 9 time each step unprofiled, then run the steps once more under
  the CUDA profiler for the device's busy time within each; phase 9 its fused
  and per-node operator steps only)
  4. fig6      — the Fig. 6 mix at 16,000,000 rows of taxi_like_frame in an
                 EAGER session: fillna, groupby(n).count(), count(), a
                 groupby(n).agg(sum, mean, min, max), get_dummies of
                 payment_type (onehot_encode, one launch a block), and .T.T
                 of a 1,600,000 x 64 matrix frame, each checked against numpy
  5. figure1   — the paper's Figure-1 workflow in OPPORTUNISTIC mode on CUDA,
                 compared with the same workflow on the CPU
  6. ordered   — the ordered path on phase 4's 16,000,000-row frame: EAGER
                 sort_values (shuffled, and bit-identical to the serial
                 REPRO_SHUFFLE=0 path), cumsum over every numeric column,
                 cummax / cummin, diff / shift, rolling_mean, the §6.1
                 filter -> cumsum -> head(5) workflow in OPPORTUNISTIC mode,
                 and a merge with a 6-row table (shuffled == serial), each
                 checked against numpy; the results of the profiled rerun
                 must equal the timed run's bit for bit
  7. serve     — LM serving at the full width of yi-6b (32 layers, d 4096,
                 6.06e9 random bf16 parameters from a seeded generator):
                 8 requests (cut from 16 to pay for phase 11; BOS + 63..511
                 random prompt tokens, 32 new
                 tokens each) through ServeEngine(max_batch=8, max_seq=1024),
                 every layer's decode attention on decode_attention (K7),
                 timed per step, then 5 steps under the CUDA profiler.
                 Checks: K7 launched steps x 32 times, all on route tc;
                 the same requests
                 served with attn_impl="xla" (plain attention, same weights)
                 give the same tokens up to a near-tie, with the logits of
                 every compared step within FULL_LOGIT_TOL; 64 teacher-forced
                 decode steps, K7 against "xla", within the logit limits,
                 which two deliberately wrong attentions must break; one request
                 served alone and alongside seven others gives identical
                 tokens; a run with max_seq=64 and a 100-token request (every
                 length passes max_seq) matches its "xla" run.  Then a
                 prefill of 4 x 1,024 tokens, every layer's attention on K6
                 (32 launches, all on the tensor-core route), against "xla"
                 at every 128th position
  8. prefill   — recurrentgemma-9b at full width (38 layers: 26 RG-LRU, 12
                 local with window 2048; d 4096, vocab 256,000; 7.5e9
                 random bf16 parameters, Λ as Griffin initialises it) through
                 Model.prefill, B 2 x 4,096 tokens: K5 26 and K6 12 launches
                 (tensor-core route) a forward, timed, then once under the
                 CUDA profiler.
                 Checks: the "chunked" forward at every 64th position within
                 RG_CHUNKED_LIMITS, which K6 ignoring the window and K5
                 dropping its chunk carry must each break; 2,112
                 teacher-forced decode steps (no K5 or K6; the ring buffers
                 wrap) against the forward at every position
  9. algebra   — DIFFERENCE / DROP-DUPLICATES and the fusion pass, each step
                 in a fresh LAZY session: bench_dedup.py's map -> filter ->
                 drop_duplicates and map -> difference over a duplicate-heavy
                 16,000,000-row frame (k, v, x, s from small pools) against a
                 4,000,000-row right side, in its three modes (serial
                 REPRO_BLOCK_DEDUP=0, block, fused), bit-identical and equal
                 to numpy's first occurrences / anti-join; on phase 4's taxi
                 frame drop_duplicates(passenger_count, payment_type) (18
                 rows) and a difference of rows [0, 1M) against f0 > 0;
                 map -> filter -> groupby().agg(4) fused into GROUPBY (K1,
                 3 launches a block, route reg), filter -> cumsum(6) -> map
                 fused into WINDOW (K4, 6 launches a block), sort -> filter
                 -> project and merge -> filter fused into SORT / JOIN; fused
                 equal to per node bit for bit (and SORT / JOIN to the
                 serial REPRO_SHUFFLE=0 path), with fewer rows gathered; the
                 fusion counters' invariant; the host seconds of the dedup
                 key work (_row_keys, _keys_to_ids) and K1's / K4's device
                 time under the profiler; three map -> filter chains (one
                 multiply inexact: f0 * 3 + 1) with compiled map and
                 predicate runs (REPRO_JIT_UDFS unset, the card's default)
                 and eager (=0), bit-identical, with their walls; an
                 adopted chain's statement alone and while another chain
                 probes (traces and compiles) in a second thread, with the
                 blocks that ran eagerly meanwhile; the compiled programs
                 adopted and rejected over the phase, by reason (the phase
                 fails if none is adopted)
 10. outofcore — the engine under a 256 MiB HBM budget (a deployment's
                 80 GB card cut to fit the time limit; the 0.6 GB taxi
                 frame is 2.3x it, and is held on the host): the store's
                 _save_frame / _load_frame on one block, stage by stage;
                 groupby(n).agg(4) (K1), cumsum of 6 columns (K4),
                 sort_values and merge in a session with the budget (the
                 frame ingested by register_frame, in blocks at the
                 engine's budget floor, spilled device -> host -> disk),
                 each equal block by block and bit for bit to an
                 unbudgeted session on the same blocks, spilling and
                 faulting, the card's peak memory and the store's peak
                 counter within budget + one block per pool worker, the
                 seconds in spill writes / fault reads and the device's
                 busy share (one pass, under the profiler);
                 progressive_aggregate of f0's mean per group (final = the
                 GROUPBY mean); the GROUPBY of a MAP's output under a
                 seeded plan (transient task errors, one spilled MAP
                 block's file corrupted on every read and recomputed from
                 the lineage the engine recorded), bit-identical with the
                 recovery counters equal to the injections; read_csv of
                 250,000 taxi rows (cut from 2,000,000 to pay for phase 11 and
                 for compiled map / predicate runs; equal to the
                 frame written) and its GROUPBY against numpy; a
                 QueryService of 3 tenants sharing one budgeted store, their
                 groupby(n) / agg(4) / groupby(1) statements concurrent, per-session stats summing to the
                 service's, a traced statement's span deltas summing to its
                 stats, a cancel once a block has started, rerun
                 bit-identical

 11. train     — training recurrentgemma-9b at full width and depth (38
                 layers, d 4096, vocab 256,000; 7.5e9 random bf16
                 parameters, Λ as Griffin initialises it), Adafactor, 1 x
                 4,096 tokens a step, remat on: the dataframe pipeline
                 (SELECTION -> DROP-DUPLICATES -> MAP -> SORT, OPPORTUNISTIC
                 prefetch) on the card over synthetic_corpus(2048) with a
                 short and a duplicate document, its first 8 batches equal
                 to the CPU pipeline's; a 5-layer full-width gradient oracle
                 (K5 against linear_scan_plain under autograd, within
                 ORACLE_LIMITS, which two wrong backwards must break); (a)
                 6 steps on one repeated batch (the loss must fall), 2
                 profiled; the first step again from the same seed (its
                 determinism printed); (b) Trainer.fit for 8 steps over the
                 pipeline; every step 76 K5 launches (50 fwd, 26 bwd) and
                 no K6 / K7; walls, tokens/s, peak memory; at the smoke
                 config, checkpoint round-trip on the card and recovery at
                 the exact cursor
 12. zoo       — the rest of the model zoo through Model.prefill and
                 ServeEngine: rwkv6-1.6b, granite-moe-3b-a800m and
                 whisper-base at full width and depth, qwen3-moe-235b-a22b
                 cut to 2 layers (all 128 experts) and llama-3.2-vision-90b
                 to 5 (4 attn + their cross layer) at full width (each cut
                 printed); random bf16 weights and memory from seeds.  Per
                 config: a prefill of 4 x 32 tokens (K6: every attention,
                 the encoder's and the cross layers' non-causal), 4
                 requests of the same prompts and 16 new tokens (K7: decode
                 self- and cross-attention, every length M), the prefill
                 wall, the step median, peak memory, K6 / K7 launches;
                 checked against attn_impl="xla" on the same weights
                 (logits at every prefill position and the served streams,
                 within the serving limits; MoE's xla run replays the
                 kernel run's expert choices, the free run's reading and
                 its route flips printed), rwkv's chunked form against its
                 sequential scan, and teacher-forced decode with the
                 (encoded) memory against the forward
 13. launch    — the launch layer: make_local_mesh() and elastic_remesh(1)
                 give (1, 1) ("data", "model") meshes on the card (NCCL on a
                 HashStore); yi-6b at full width plain, then its parameters,
                 cache and tokens as DTensors placed by param_specs /
                 cache_specs_tree / batch_specs on that mesh, one prefill of
                 1 x 512 tokens and 8 decode steps under
                 activation_sharding: K6 and K7 through the DTensor route
                 (local_map) as often as in the plain run, every logit
                 torch.equal to the plain run's; meanwhile, in four
                 processes of their own (no card), the abstract dry-run of
                 yi-6b x train_4k, qwen3-moe-235b-a22b x prefill_32k,
                 llama-3.2-vision-90b x decode_32k and recurrentgemma-9b x
                 long_500k at full size on the fake 16 x 16 mesh, each
                 "analyzed", with its per-device FLOPs, bytes raw and fused,
                 wire bytes by kind, argument bytes and roofline terms
                 against the H100's data-sheet peaks (accounting, not a
                 measurement); and the decode cell once more on K7's
                 route before the cross-device combine (the
                 sequence-sharded cache gathered), its all-gather a device
                 before and after, with the prediction printed first (no
                 all-gather of cache rows may remain)

Run from the root of a checkout:  python3 chip_smoke.py
The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}; the card's name and power limit come before.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
TAXI_ROWS = 16_000_000             # about one month of NYC yellow-cab trips
PAYMENT = ("card", "cash", "dispute")   # taxi_like_frame's payment_type values
SERVE_ARCH = "yi-6b"
SERVE_BATCH, SERVE_SEQ = 8, 1024   # engine slots, cache positions per slot
SERVE_REQUESTS, SERVE_NEW = 8, 32     # cut from 16 requests to pay for phase 11
# decode steps in phase 7's profiled window, cut from 20 to pay for phase
# 11: reading a window of 20 steps (~58,000 device activities and their
# CPU activity) back from the profiler took far longer than the steps
PROFILED_STEPS = 5
PROMPT_LENS = (64, 512)            # prompt lengths, BOS included, uniform
# K7 against its plain version at the serving shape, bf16: about one bf16
# ulp at |x| < 1.  Both round a float32 result to bf16 once, so they may part
# by one ulp; the kernel's max |err| there reads 1.2e-4 to 2.4e-4 on an H100
# (PERF.md, "LM serving").
K7_BF16_TOL = 4e-3
# Limits on two bf16 runs of the full-width model that differ only in how
# attention is computed (K7, or the einsum path of attn_impl="xla").  Both
# round attention's float32 result to bf16; a one-ulp difference there grows
# through 32 random layers.  Each is set from the sound runs' readings on an
# H100 (PERF.md, "LM serving"): max |logit diff| at most 0.149, its mean over
# 64 teacher-forced steps 0.020, top-1 agreement there 0.947.  Check 3 runs
# two deliberately wrong attentions and fails unless each breaks one of them
# (they read max 3.3-4.3, mean 0.39-0.44, agreement 0.29-0.33).
FULL_LOGIT_TOL = 0.3     # max |logit diff|: twice the largest sound reading
MEAN_LOGIT_TOL = 0.04    # mean |logit diff| over check 3's steps: twice its reading
TOP1_AGREE_MIN = 0.9     # top-1 agreement over check 3's steps
# Two runs whose logits part by at most d can pick different tokens only
# where the top-1 - top-2 margin is below 2 d: twice the largest sound
# max |logit diff|
NEAR_TIE = 0.3
MATRIX_ROWS, MATRIX_COLS = TAXI_ROWS // 10, 64   # bench_fig6.py:78
# Limits on the full-width prefills, (max |logit diff|, mean |logit diff|,
# top-1 agreement): twice the sound runs' max and mean readings on an H100,
# rounded to two digits (PERF.md, "Limits"), agreement at least 0.9.  Sound
# readings: yi-6b K6 vs xla 0.1455 / 0.02157 / 0.9688; recurrentgemma-9b K6
# vs chunked 0.1104 / 0.01536 / 1.0, decode vs forward 0.1248 / 0.01612 /
# 1.0.  recurrentgemma ties its embeddings, so with random weights each
# position's top-1 is its own input token and agreement says little there.
# Phase 8 runs two deliberately wrong kernels, which must break the chunked
# limits: K6 ignoring the window read 0.2774 / 0.0251 (caught by the max
# alone: random weights make attention near-uniform, so the window moves
# the logits little), K5 dropping its carry every 64 steps 0.8193 / 0.103.
YI_PREFILL_LIMITS = (0.29, 0.043, 0.9)     # K6 vs xla, yi-6b
RG_CHUNKED_LIMITS = (0.22, 0.031, 0.9)     # K6 vs chunked, recurrentgemma-9b
RG_DECODE_LIMITS = (0.25, 0.032, 0.9)      # decode vs the K5 / K6 forward
K5_WRONG_CUT = 64                          # the wrong K5 restarts h every 64 steps
DECODE_STEPS = 2112                        # past the local window of 2048



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


def lead_in(torch) -> None:
    """The first device records of a profiling window: four spin kernels,
    then a sync, so that a profiler which drops the first device records of
    a window drops these and not the records a check counts.
    ``device_window`` leaves the spin kernels out."""
    for _ in range(4):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def device_window(torch, run, cuda_only: bool = False,
                  tries: int = 2) -> tuple[list | None, float]:
    """Runs ``run()`` under the CUDA profiler behind the lead-in; returns the
    device's own records of the window, the lead-in's spin kernels left
    out, and the wall seconds of ``run`` (ending in a sync).  An aten op's
    row carries the durations of the kernels it launched too, so only
    device records count.  A window that kept none of the lead-in's records
    lost all its device records: it is taken again, up to ``tries`` times,
    and then the records are None.  On an H100 the profiler has, in some
    runs, lost every window of a process from some point on, so a lost
    window makes a measurement "not measured", and the one-launch checks
    go to a fresh process (``one_launch``).  CPU activity is traced too
    unless ``cuda_only``: with CUDA activity alone one kernel's records came
    back short of its bytes bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if cuda_only else [ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            lead_in(torch)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if any("spin_kernel" in e.key for e in events):
            return [e for e in events if "spin_kernel" not in e.key], wall
        log("  (the CUDA profiler kept no device record of a window, not even the "
            "lead-in's)")
    return None, wall


def device_ms(fn, names: tuple | None, iters: int = 20) -> float | None:
    """Device time of one call: the summed durations, under the CUDA
    profiler, of the kernels whose names contain one of ``names`` (every
    kernel and copy when ``names`` is None), per call.  ``cuda_ms`` also
    counts the gaps in which the card waits for the host to launch the next
    call."""
    import torch
    for _ in range(3):
        fn()
    events, _ = device_window(torch, lambda: [fn() for _ in range(iters)])
    if events is None:
        return None
    return sum(e.self_device_time_total for e in events
               if names is None or any(n in e.key for n in names)) / iters / 1e3


def ms_text(ms: float | None) -> str:
    """A device time for the log: "not measured" where the profiler lost
    its window."""
    return "not measured" if ms is None else f"{ms:.4f}"


def tflops_text(flops: float, ms: float | None, share: bool = True) -> str:
    """The rate of ``flops`` in ``ms`` of device time for the log, with its
    share of the bf16 tensor cores' 989 TFLOP/s."""
    if ms is None:
        return "a rate not measured on the device"
    rate = flops / ms / 1e9
    return f"{rate:.4g} TFLOP/s on the device" + (
        f" ({rate / 989:.1%} of the bf16 tensor cores' 989)" if share else "")


# K1's, K3's, K4's and K7's rows time events over as many calls as their
# host times: over 20 calls the host's clock moved their event times by up
# to 2x
EVENT_CALLS = 200
# Device records of each route: K1 "reg" (one) and "table" (its two
# passes); K7 "tc" (one) and "fma" (split, combine)
SEG_KERNELS = ("seg_reg", "seg_pass")
DECODE_KERNELS = ("decode_tc", "decode_split", "decode_combine")
# Every route of the kernels that have two (K5: its forward and its
# backward), with its source and kernels: the "kernels" line lists them
# beside each kernel's main-path launches (a kernel not listed: its source)
KERNEL_ROUTES = {
    "linear_scan": {"fwd": "src/repro_torch/csrc/linear_scan.cu: lin_walk<VEC, false>",
                    "bwd": "src/repro_torch/csrc/linear_scan.cu: lin_walk<VEC, true> "
                           "(the reverse walk)"},
    "segment_reduce": {"reg": "src/repro_torch/csrc/segment_reduce.cu: seg_reg",
                       "table": "src/repro_torch/csrc/segment_reduce.cu: seg_pass1, seg_pass2"},
    "decode_attention": {"tc": "src/repro_torch/csrc/decode_attention_tc.cu: decode_tc",
                         "fma": "src/repro_torch/csrc/decode_attention.cu: decode_split, "
                                "decode_combine",
                         "tc_partials": "src/repro_torch/csrc/decode_attention_tc.cu: decode_tc "
                                        "(partials mode: O, M, L in float32, for the combine "
                                        "across devices of a sequence-sharded cache)",
                         "fma_partials": "src/repro_torch/csrc/decode_attention.cu: "
                                         "decode_split, decode_combine (partials mode)"},
    "flash_attention": {"tc": "src/repro_torch/csrc/flash_attention_tc.cu: flash_tc",
                        "fma": "src/repro_torch/csrc/flash_attention.cu: flash_fwd"},
}


def host_ms(fn, iters: int = EVENT_CALLS) -> float:
    """Host time of one call: the host clock over ``iters`` back-to-back
    calls, read before the sync (the enqueue, not the device's work)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -----------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# -----------------------------------------------------------------------------
def one_launch_case(torch, case: str, dev):
    """(fn, kernel names) of phase 3's one-launch checks: K1's route reg at
    one Fig. 6 block, K4 at (2,000,000,), K5 at one RG-LRU layer of phase
    8's prefill and its backward at one of phase 11's training step, K7's
    route tc at the serving shape."""
    if case == "seg_reg":
        from repro_torch.kernels import segment_reduce as sr
        v = torch.rand((2_000_000, 8), device=dev)
        codes = torch.randint(0, 6, (v.shape[0],), dtype=torch.int32, device=dev)
        return (lambda: sr.segment_reduce(v, codes, 6, "sum")), ("seg_reg",)
    if case == "scan_one_pass":
        from repro_torch.kernels import window_scan as ws
        x = torch.randn(2_000_000, device=dev)
        return (lambda: ws.window_scan(x)), ("scan_one_pass",)
    if case == "lin_walk":
        from repro_torch.kernels import linear_scan as ls
        a, b = rglru_like(torch, (PREFILL_BATCH, PREFILL_SEQ, 4096),
                          torch.Generator(device=dev).manual_seed(6))
        return (lambda: ls.linear_scan(a, b)), ("lin_walk",)
    if case == "lin_walk_bwd":
        from repro_torch.kernels import linear_scan as ls
        gen = torch.Generator(device=dev).manual_seed(6)
        a, b = rglru_like(torch, (TRAIN_BATCH, TRAIN_SEQ, 4096), gen)
        g = torch.randn(a.shape, generator=gen, device=dev)
        h = ls.linear_scan(a, b)
        return (lambda: ls.linear_scan_backward(a, g, h)), ("lin_walk",)
    from repro_torch.kernels import decode_attention as da
    q, k, v, lengths = decode_main_inputs(torch, dev)
    return (lambda: da.decode_attention(q, k, v, lengths)), ("decode_tc",)


def launch_records(torch, case: str, dev, calls: int = 5) -> dict | None:
    """{kernel name: records} of the device's activities over ``calls`` calls
    of ``one_launch_case(case)`` under the CUDA profiler, after one call
    outside it, or None where the profiler lost the window; raises unless
    every record's name contains the case's kernel name and there is one a
    call."""
    fn, names = one_launch_case(torch, case, dev)
    fn()
    events, _ = device_window(torch, lambda: [fn() for _ in range(calls)])
    if events is None:
        return None
    records = {e.key: e.count for e in events}
    if sum(records.values()) != calls or not all(any(n in r for n in names) for r in records):
        raise AssertionError(f"{calls} calls gave the profiler {records}, not one "
                             f"{' / '.join(names)} record a call")
    return records


def one_launch(torch, case: str, dev) -> dict:
    """``launch_records`` of a case; where the profiler lost the window in
    this process, the same check in a fresh one, which prints its records
    on a line of their own; raises if that loses it too."""
    records = launch_records(torch, case, dev)
    if records is not None:
        return records
    log(f"  {case}: the one-launch check again, in a fresh process")
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one-launch", case],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    found = [ln for ln in run.stdout.splitlines() if ln.startswith("ONE_LAUNCH ")]
    if run.returncode != 0 or not found:
        raise AssertionError(f"{case}: the one-launch check in a fresh process failed:\n"
                             f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
    return json.loads(found[-1][len("ONE_LAUNCH "):])


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
             (9999, 7, 5, "normal"), (3001, 16, 3, "normal"), (100_003, 64, 1, "normal"),
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
    routes = dict(sr.counter.routes)
    assert set(routes) == {"reg", "table"}, routes
    log(f"  segment_reduce: {len(cases)} shapes x 4 ops match the plain version "
        f"(count/min/max exact; sum of kernel and plain within {SUM_RTOL}*sum|v| of a "
        f"float64 sum, worst {worst:.3g} of it; reruns bit-identical); launches by route "
        f"{routes}")
    # route reg's sum in the association order its header states: bit-equal
    # to its float32 emulation on the CPU (finite inputs: NaN payloads are
    # the card's own)
    reg_shapes = ((1, 8), (4097, 8), (-(-TAXI_ROWS // pool), 8), (3_000_001, 1))
    for m, c in reg_shapes:
        v = torch.randn((m, c), generator=gen)
        codes = torch.randint(-1, 6, (m,), generator=gen, dtype=torch.int32)
        assert sr.route(c, 6) == "reg"
        got = sr.segment_reduce(v.to(dev), codes.to(dev), 6, "sum").cpu()
        if not torch.equal(got.view(torch.int32), sr.emulated_sum(v, codes, 6).view(torch.int32)):
            raise AssertionError(f"segment_reduce reg sum ({m} x {c}): differs from the "
                                 f"emulated order")
    log("  segment_reduce route reg: sum bit-equal to the float32 emulation of its stated "
        f"order at {', '.join(f'({m} x {c})' for m, c in reg_shapes)}, G 6")
    records = one_launch(torch, "seg_reg", dev)
    log(f"  segment_reduce route reg: 5 calls gave the profiler {records}: one launch a call")


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
    """Bit-exact against the plain version: G = 1, 3, 4, 5, 7 and 1000 at
    ragged M (not a multiple of 4, past one 8192-element span), codes -1 and
    >= G (zero rows), codes read at an odd offset (the scalar path), the
    (2,000,000,) x 3 shape of get_dummies(payment_type), and one output of
    more than 2^31 elements."""
    # the last shape has M * G = 2,160,000,000 > 2^31 elements
    shapes = [(1, 1), (4, 4), (1000, 3), (513, 1000), (100_003, 7), (2048, 70_000),
              (4097, 1), (3, 3), (10_001, 4), (10_003, 5), (1001, 1000), (2_000_000, 3),
              (36_000, 60_000)]
    for m, g in shapes:
        codes = torch.randint(-1, g + 3, (m + 1,), dtype=torch.int32, device=dev)
        for what, c in (("aligned", codes[:m]), ("odd offset", codes[1:])):
            if not torch.equal(oh.onehot_encode(c, g), oh.onehot_encode_plain(c, g)):
                raise AssertionError(f"onehot_encode {(m, g)} {what} differs")
        del codes
    log(f"  onehot_encode: {len(shapes)} shapes x (aligned, odd offset) codes bit-exact "
        f"(codes -1 and >= G give zero rows)")


def scan_sum_ratio(torch, got, x) -> float:
    """Largest |got - exact| / (SUM_RTOL * sum_{j<=i} |x_j|) over the rows of
    a column-wise cumsum, the exact prefix sum taken in float64.  Raises
    unless NaN and +-inf stand exactly where the exact prefix has them."""
    x64 = x.double()
    exact = torch.cumsum(x64, 0)
    got = got.double()
    inf = torch.isinf(exact)
    if not (torch.equal(torch.isnan(got), torch.isnan(exact))
            and torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], exact[inf])):
        raise AssertionError("window_scan cumsum: NaN or inf where the exact sum has none, or not")
    fin = torch.isfinite(exact)
    absacc = torch.cumsum(torch.where(torch.isfinite(x64), x64.abs(), 0.0), 0)
    err = torch.where(fin, (got - exact).abs(), 0.0)
    return float((err / (SUM_RTOL * absacc + 1e-30)).max()) if err.numel() else 0.0


def scan_inputs(torch, m: int, n: int, gen, special: bool):
    x = torch.randn((m, n), generator=gen, device=gen.device)
    x.view(-1)[5::23] = -0.0
    if special:
        x.view(-1)[3::37] = float("nan")
        x.view(-1)[7::53] = float("inf")
        x.view(-1)[9::71] = -float("inf")
    return x


def pow2_factors(torch, v, gen):
    """cumprod inputs whose products are exact in float32 in any order:
    +-1 with a rare 2 or 1/2 (the exponent walks, never out of range), and
    v's NaN, +-inf and +-0.0 kept where they stand."""
    u = torch.rand(v.shape, generator=gen, device=v.device)
    mag = torch.where(u < 1e-4, 2.0, torch.where(u > 1 - 1e-4, 0.5, 1.0))
    special = ~torch.isfinite(v) | (v == 0)
    return torch.where(special, v, torch.sign(v) * mag)


def check_window_scan(torch, ws, dev) -> None:
    """Edge shapes (ragged chunks, one row, 130 columns), strided column
    views of a row-major (M, 8) matrix, NaN / +-inf / -0.0 in the data, and
    one shape of more than 2^31 elements.  max / min bit-equal the plain
    version; cumsum of kernel and plain within SUM_RTOL * sum|v| of a
    float64 prefix sum at every row; cumprod of power-of-two factors (exact
    in any order) equal; every case run twice and bit-identical; cumsum
    bit-equal to ws.emulated_cumsum (the kernel's stated order) at five
    lengths."""
    gen = torch.Generator(device=dev).manual_seed(1)
    ms = (1, 2, 31, 32, 33, 1023, 1024, 1025, 65_537, 2_000_000)
    worst, cases = 0.0, 0
    for m in ms:
        for n in (1, 3, 130):
            for special in (False, True):
                x = scan_inputs(torch, m, n, gen, special)
                views = [("contiguous", x)]
                if n == 3:
                    wide = scan_inputs(torch, m, 8, gen, special)
                    views += [("column of (M, 8)", wide[:, 5]), ("3 columns of (M, 8)", wide[:, 2:5])]
                for what, v in views:
                    for op in ("cumsum", "cummax", "cummin", "cumprod"):
                        inp = pow2_factors(torch, v, gen) if op == "cumprod" else v
                        got = ws.window_scan(inp, op)
                        again = ws.window_scan(inp, op)
                        tag = f"window_scan {op} {what} {tuple(v.shape)} special={special}"
                        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
                            raise AssertionError(f"{tag}: runs differ")
                        want = ws.window_scan_plain(inp, op)
                        if op == "cumsum":
                            for res in (got, want):
                                r = scan_sum_ratio(torch, res, inp)
                                if r > 1.0:
                                    raise AssertionError(f"{tag}: {r:.3g}x the tolerance off the exact sum")
                                worst = max(worst, r)
                        elif op == "cumprod":
                            # exact products; NaN bits may differ between the
                            # float32 kernel and the float64 plain version
                            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                                                       msg=lambda e: f"{tag}: {e}")
                        elif not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                            raise AssertionError(f"{tag}: bits differ from the plain version")
                        cases += 1
                del x, views
    # more than 2^31 elements: 64-bit offsets (cummax: the plain version's
    # int64 indices make it the cheapest to hold against)
    big = torch.randn((16_777_259, 130), device=dev)
    assert big.numel() > 2 ** 31
    if not torch.equal(ws.window_scan(big, "cummax"), ws.window_scan_plain(big, "cummax")):
        raise AssertionError("window_scan cummax (16777259, 130): differs from the plain version")
    del big
    torch.cuda.empty_cache()
    # 50 reruns bit-identical where the column stays in shared memory
    # (2,000,000 rows) and where it streams (16,000,000 rows)
    for m in (2_000_000, TAXI_ROWS):
        x = torch.randn(m, generator=gen, device=dev)
        for op in ("cumsum", "cummax", "cummin", "cumprod"):
            inp = 1.0 + 1e-3 * x if op == "cumprod" else x
            first = ws.window_scan(inp, op)
            for _ in range(50):
                if not torch.equal(first.view(torch.int32), ws.window_scan(inp, op).view(torch.int32)):
                    raise AssertionError(f"window_scan {op} ({m},): a rerun differs")
            if op == "cumsum":
                r = scan_sum_ratio(torch, first, x)
                assert r <= 1.0, f"window_scan cumsum ({m},): {r:.3g}x the tolerance"
                worst = max(worst, r)
            elif op != "cumprod":
                want = ws.window_scan_plain(inp, op)
                assert torch.equal(first.view(torch.int32), want.view(torch.int32)), (op, m)
        del x, inp, first
    # cumsum in the association order the kernel's header states: bit-equal
    # to its float32 emulation on the CPU, within shared memory and past it
    for m in (1, 4097, 2_000_000, 3_000_000, TAXI_ROWS):
        x = torch.randn(m, generator=gen, device=dev)
        got = ws.window_scan(x).cpu()
        if not torch.equal(got.view(torch.int32), ws.emulated_cumsum(x).view(torch.int32)):
            raise AssertionError(f"window_scan cumsum ({m},): differs from the emulated order")
    log("  window_scan cumsum bit-equal to the float32 emulation of its stated order at "
        f"(1,), (4097,), (2000000,), (3000000,), ({TAXI_ROWS},)")
    # one launch a call: the profiler's device records over 5 calls
    records = one_launch(torch, "scan_one_pass", dev)
    log(f"  window_scan: 50 reruns bit-identical at (2000000,) and ({TAXI_ROWS},) x 4 ops; "
        f"5 calls gave the profiler {records}: one launch a call")
    log(f"  window_scan: {cases} cases x reruns bit-identical; max/min bit-equal, exact "
        f"cumprod equal, cumsum of kernel and plain within {SUM_RTOL}*sum|v| of a float64 "
        f"prefix (worst {worst:.3g} of it); (16777259, 130) cummax bit-equal")
    # cumprod of general values: any float32 product order loses up to i
    # roundings by row i; hold the kernel to that bound and show torch's
    y = 1.0 + 1e-3 * torch.randn(2_000_000, generator=gen, device=dev)
    exact = torch.cumprod(y.double(), 0)
    bound = torch.arange(1, y.numel() + 1, device=dev, dtype=torch.float64) * 2.0 ** -24
    rel = [((r.double() - exact).abs() / exact.abs()) for r in
           (ws.window_scan(y, "cumprod"), torch.cumprod(y, 0))]
    assert bool((rel[0] <= bound).all()), "window_scan cumprod: off the float64 product"
    log(f"  cumprod of 1 + 1e-3*N(0,1) at (2000000,), largest relative error against a "
        f"float64 product: kernel {float(rel[0].max()):.3g}, float32 torch.cumprod "
        f"{float(rel[1].max()):.3g} (bound (i+1)*2^-24)")
    z = torch.rand(2_000_000, device=dev) * 0.02 + 0.99
    for name, fn in (("cumsum", torch.cumsum), ("cumprod", torch.cumprod)):
        first = fn(z, 0)
        same = all(torch.equal(first, fn(z, 0)) for _ in range(10))
        log(f"  torch.{name} on the card, 10 reruns at (2000000,): bit-identical {same}")


DECODE_SHAPES = [(8, 2, 256, 100, 64), (16, 4, 333, 217, 64), (4, 4, 128, 128, 128),
                 (8, 1, 700, 1, 64)]   # (H, KVH, S, length, D): tests/test_kernels.py
# (B, H, KVH, S, D) of K7's tensor-core route past the serving shape
DECODE_TC_SHAPES = [(3, 16, 4, 333, 64), (3, 8, 1, 700, 64), (2, 32, 1, 300, 128),
                    (2, 64, 1, 200, 64), (2, 16, 8, 4096, 256), (4, 8, 8, 129, 16),
                    (2, 20, 20, 999, 128), (1, 8, 1, 32768, 128)]
DECODE_TC_GROUPS = (1, 4, 8, 16)     # G of the edge-length checks, over 4 KV heads


def decode_main_inputs(torch, dev):
    """K7 at the serving shape: yi-6b's heads, 8 slots, a 1024-slot bf16
    cache, lengths spread over [1, S] and one past S."""
    gen = torch.Generator(device=dev).manual_seed(2)
    b, h, kvh, s, d = SERVE_BATCH, 32, 4, SERVE_SEQ, 128
    q = torch.randn((b, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
    lengths = torch.tensor([1, 147, 293, 440, 586, 733, s, s + 9], dtype=torch.int32, device=dev)
    return q, k, v, lengths


def check_decode_attention(torch, da, dev) -> None:
    """The reference's four f32 shapes (three slots each: the shape's length,
    S, and S + 5) at rtol = atol = 2e-3 on route fma; the serving shape in
    bf16 at K7_BF16_TOL, ten reruns bit-identical, and route tc past it (G 1
    to 64, D 16 to 256, clusters of 1 to 8, edge lengths at G 1, 4, 8, 16);
    a zero length gives 0 (ROADMAP, known divergences); one launch a call
    under the profiler."""
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    for h, kvh, s, length, d in DECODE_SHAPES:
        q = torch.randn((3, h, d), generator=gen, device=dev)
        k = torch.randn((3, s, kvh, d), generator=gen, device=dev)
        v = torch.randn((3, s, kvh, d), generator=gen, device=dev)
        lengths = torch.tensor([length, s, s + 5], dtype=torch.int32, device=dev)
        got = da.decode_attention(q, k, v, lengths)
        if not torch.equal(got, da.decode_attention(q, k, v, lengths)):
            raise AssertionError(f"decode_attention {(h, kvh, s, length, d)}: runs differ")
        torch.testing.assert_close(got, da.decode_attention_plain(q, k, v, lengths),
                                   rtol=2e-3, atol=2e-3,
                                   msg=lambda m: f"decode_attention {(h, kvh, s, length, d)}: {m}")
        single = da.decode_attention(q[0], k[0], v[0], length)
        assert torch.equal(single, got[0]), "decode_attention: the single-sequence call differs"
        worst = max(worst, float((got - da.decode_attention_plain(q, k, v, lengths)).abs().max()))
    q, k, v, lengths = decode_main_inputs(torch, dev)
    got = da.decode_attention(q, k, v, lengths)
    for _ in range(10):
        if not torch.equal(got, da.decode_attention(q, k, v, lengths)):
            raise AssertionError("decode_attention serving shape: reruns differ")
    want = da.decode_attention_plain(q, k, v, lengths)
    torch.testing.assert_close(got.float(), want.float(), rtol=K7_BF16_TOL, atol=K7_BF16_TOL,
                               msg=lambda m: f"decode_attention serving shape bf16: {m}")
    zero = da.decode_attention(q, k, v, torch.zeros_like(lengths))
    assert torch.equal(zero, torch.zeros_like(zero)), "decode_attention: length 0 is not 0"
    serving_err = float((got.float() - want.float()).abs().max())
    # route tc past the serving shape: G 1 to 64 (several m-tiles past 16),
    # D 16 to 256, clusters of 1 to 8 CTAs; bf16 at K7_BF16_TOL
    tc_worst = 0.0
    for b, h, kvh, s, d in DECODE_TC_SHAPES:
        q = torch.randn((b, h, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
        lengths = torch.tensor(([1, s, s + 9] + [1 + 137 * i % s for i in range(b)])[:b],
                               dtype=torch.int32, device=dev)
        got = da.decode_attention(q, k, v, lengths)
        if not torch.equal(got, da.decode_attention(q, k, v, lengths)):
            raise AssertionError(f"decode_attention tc {(b, h, kvh, s, d)}: runs differ")
        want = da.decode_attention_plain(q, k, v, lengths)
        torch.testing.assert_close(got.float(), want.float(), rtol=K7_BF16_TOL, atol=K7_BF16_TOL,
                                   msg=lambda m: f"decode_attention tc {(b, h, kvh, s, d)}: {m}")
        tc_worst = max(tc_worst, float((got.float() - want.float()).abs().max()))
    # route tc at G 1, 4, 8, 16 over 4 KV heads with the edge lengths 0, 1,
    # 127, 128, 129, S, S + 7: length 0 gives 0, the rest K7_BF16_TOL
    lens = [0, 1, 127, 128, 129, SERVE_SEQ, SERVE_SEQ + 7]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    for g in DECODE_TC_GROUPS:
        q = torch.randn((len(lens), 4 * g, 128), generator=gen, device=dev).bfloat16()
        k = torch.randn((len(lens), SERVE_SEQ, 4, 128), generator=gen, device=dev).bfloat16()
        v = torch.randn((len(lens), SERVE_SEQ, 4, 128), generator=gen, device=dev).bfloat16()
        got = da.decode_attention(q, k, v, lengths)
        if not torch.equal(got, da.decode_attention(q, k, v, lengths)):
            raise AssertionError(f"decode_attention tc G {g}: runs differ")
        assert not got[0].any(), f"decode_attention tc G {g}: length 0 is not 0"
        want = da.decode_attention_plain(q, k, v, lengths)
        torch.testing.assert_close(got[1:].float(), want[1:].float(), rtol=K7_BF16_TOL,
                                   atol=K7_BF16_TOL,
                                   msg=lambda m: f"decode_attention tc G {g}: {m}")
        tc_worst = max(tc_worst, float((got[1:].float() - want[1:].float()).abs().max()))
    try:
        da.decode_attention(q[..., :40], k[..., :40], v[..., :40], lengths)
    except ValueError:
        pass
    else:
        raise AssertionError("decode_attention: bf16 at D 40 was not refused")
    routes = dict(da.counter.routes)
    assert set(routes) == {"fma", "tc"}, routes
    q, k = decode_main_inputs(torch, dev)[:2]
    records = one_launch(torch, "decode_tc", dev)
    log(f"  decode_attention: {len(DECODE_SHAPES)} f32 shapes x lengths (n, S, S+5) within 2e-3 "
        f"of the plain version on route fma (worst {worst:.3g}); serving shape "
        f"{list(q.shape)} x {list(k.shape)} bf16 on route tc within {K7_BF16_TOL} (max |err| "
        f"{serving_err:.3g}), 10 reruns bit-identical; {len(DECODE_TC_SHAPES)} more bf16 shapes "
        f"and G {DECODE_TC_GROUPS} at lengths {lens} on route tc (worst {tc_worst:.3g}); "
        f"length 0 gives 0; bf16 at D 40 refused; launches by route {routes}; "
        f"5 calls at the serving shape gave the profiler {records}: one launch a call")


# K6 against its plain version.  f32 at the reference's 2e-3
# (tests/test_kernels.py); the kernel reads ~1e-6 there on an H100 (PERF.md,
# the kernel table).  bf16: both sides round one float32 result to bf16, so
# they may part by one bf16 ulp (at most 2^-7 |x|) plus the float32
# difference (under 1e-6 in the f32 cases): rtol 2^-7, atol 1e-5.  K5 has no
# tolerance: it computes its plain version's roundings, bit for bit.
K6_F32_TOL = 2e-3
K6_BF16_RTOL, K6_BF16_ATOL = 2.0 ** -7, 1e-5
FLASH_SHAPES = [(2, 128, 128, 64), (4, 200, 200, 64), (1, 64, 256, 128),
                (2, 333, 333, 80)]   # (H, Sq, Sk, D): tests/test_kernels.py
PREFILL_ARCH = "recurrentgemma-9b"
PREFILL_BATCH, PREFILL_SEQ = 2, 4096          # past the local window of 2048
YI_PREFILL_BATCH, YI_PREFILL_SEQ = 4, 1024


def griffin_lam(torch, n: int, gen):
    """Λ as Griffin initialises it (arXiv:2402.19427 §2.4): a = exp(-8 *
    softplus(Λ)) at r = 1 uniform in [0.9, 0.999], so the recurrence
    remembers tens to thousands of steps.  The reference's linspace(2, 5)
    makes a_t < e^-8: no memory, and a fault in K5's carry could not show
    in the logits."""
    a = 0.9 + 0.099 * torch.rand(n, generator=gen, device=gen.device, dtype=torch.float64)
    sp = -torch.log(a) / 8.0
    return torch.log(torch.expm1(sp)).float()


def rglru_like(torch, shape, gen):
    """(a, b) float32 as _rglru_coeffs makes them from N(0, 1) gate
    pre-activations and inputs, with Griffin's Λ."""
    lam = griffin_lam(torch, shape[-1], gen)
    r = torch.sigmoid(torch.randn(shape, generator=gen, device=gen.device))
    log_a = -8.0 * r * torch.nn.functional.softplus(lam)
    i = torch.sigmoid(torch.randn(shape, generator=gen, device=gen.device))
    u = torch.randn(shape, generator=gen, device=gen.device)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * i * u
    return torch.exp(log_a), b


def check_linear_scan(torch, ls, dev) -> None:
    """K5 equal to linear_scan_plain bit for bit (the same two roundings a
    step): the reference's three (T, N) shapes with a in [0, 0.95), T = 0,
    1, 63, 64, 65 and 4,097, B = 1 and 3 at N = 4096, N = 33 and 70 (the
    4-byte copies), a view with batch and time strides that keeps the
    16-byte copies and one whose base is 4 bytes off, and phase 8's (2,
    4096, 4096) as the RG-LRU makes it; every case twice, bit-identical,
    the main shape ten times; one launch a call under the profiler."""
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [(16, 8), (300, 17), (1025, 64), (0, 5), (1, 5), (3, 129, 70), (2, 4097, 33),
             (63, 128), (2, 64, 4096), (3, 65, 4096), (1, 4097, 4096)]
    inputs = [(shape, torch.rand(shape, generator=gen, device=dev) * 0.95,
               torch.randn(shape, generator=gen, device=dev)) for shape in cases]
    # views of larger tensors: every other batch row and time step (16-byte
    # copies), and that with a slice 5 channels in (4-byte copies)
    big_a = torch.rand((6, 260, 2, 128), generator=gen, device=dev) * 0.95
    big_b = torch.randn((6, 260, 2, 128), generator=gen, device=dev)
    inputs += [("view [::2, ::2, 0]", big_a[::2, ::2, 0], big_b[::2, ::2, 0]),
               ("view [::2, ::2, 1, 5:75]", big_a[::2, ::2, 1, 5:75], big_b[::2, ::2, 1, 5:75])]
    by_copy = {4: 0, 16: 0}
    for shape, a, b in inputs:
        a3, b3 = (a, b) if a.dim() == 3 else (a[None], b[None])
        if a.numel():
            strides = (a3.stride(0), a3.stride(1), b3.stride(0), b3.stride(1))
            by_copy[ls.copy_bytes(a3.shape[2], strides, (a3.data_ptr(), b3.data_ptr()))] += 1
        got = ls.linear_scan(a, b)
        if got.shape != a.shape or not torch.equal(got, ls.linear_scan(a, b)):
            raise AssertionError(f"linear_scan {shape}: shape or reruns differ")
        want = ls.linear_scan_plain(a, b)
        if not torch.equal(got, want):
            raise AssertionError(f"linear_scan {shape}: not bit-equal to the plain version "
                                 f"(max |err| {float((got - want).abs().max()):.3g})")
    assert by_copy[4] and by_copy[16], by_copy
    a, b = rglru_like(torch, (PREFILL_BATCH, PREFILL_SEQ, 4096), gen)
    got = ls.linear_scan(a, b)
    for _ in range(10):
        if not torch.equal(got, ls.linear_scan(a, b)):
            raise AssertionError("linear_scan main shape: reruns differ")
    want = ls.linear_scan_plain(a, b)
    if not torch.equal(got, want):
        raise AssertionError(f"linear_scan main shape: not bit-equal to the plain version "
                             f"(max |err| {float((got - want).abs().max()):.3g})")
    records = one_launch(torch, "lin_walk", dev)
    log(f"  linear_scan: {len(inputs)} shapes and views bit-equal to the plain version "
        f"(copies of 4 / 16 bytes: {by_copy[4]} / {by_copy[16]} cases), reruns bit-identical; "
        f"{list(a.shape)} with a in [{float(a.min()):.4g}, {float(a.max()):.4g}] bit-equal, "
        f"grid {ls.grid(a.shape[0], a.shape[2])}, 10 reruns bit-identical; 5 calls gave the "
        f"profiler {records}: one launch a call")


# K5's backward against autograd through linear_scan_plain: the reference's
# three shapes, T = 1, 63, 64, 65 and 4,097, N = 33 and 70 (4-byte copies),
# and views; the main shape, one RG-LRU layer of phase 11's step, comes after
K5_BWD_SHAPES = [(16, 8), (300, 17), (1025, 64), (1, 5), (63, 128), (64, 33), (65, 70),
                 (3, 129, 70), (1, 4097, 33)]


def scan_grads(torch, fn, a, b, g, view=None):
    """(h, grad_a, grad_b) of ``fn`` through autograd, with g the gradient of
    h; ``view`` (of copies of a and b made leaves) gives fn its inputs, so
    the gradients come back through the view."""
    la, lb = a.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    va, vb = (view(la), view(lb)) if view else (la, lb)
    h = fn(va, vb)
    return (h.detach(),) + torch.autograd.grad(h, (la, lb), g)


def check_linear_scan_backward(torch, ls, dev) -> None:
    """K5's reverse walk: h, grad_a and grad_b of ``linear_scan`` (the
    autograd Function, kernels forward and backward) equal (``torch.equal``)
    to autograd through ``linear_scan_plain`` on the card, one "fwd" and one
    "bwd" launch a call, at K5_BWD_SHAPES, two time-strided views (16- and
    4-byte copies) and (1, 4096, 4096) as the RG-LRU makes a; the main
    shape's backward ten times bit-identical; one launch a backward under
    the profiler."""
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = [(shape, torch.rand(shape, generator=gen, device=dev) * 0.95,
              torch.randn(shape, generator=gen, device=dev), None) for shape in K5_BWD_SHAPES]
    big = (6, 260, 2, 128)
    big_a = torch.rand(big, generator=gen, device=dev) * 0.95
    big_b = torch.randn(big, generator=gen, device=dev)
    cases += [("view [::2, ::2, 0]", big_a, big_b, lambda t: t[::2, ::2, 0]),
              ("view [::2, ::2, 1, 5:75]", big_a, big_b, lambda t: t[::2, ::2, 1, 5:75])]
    a, b = rglru_like(torch, (TRAIN_BATCH, TRAIN_SEQ, 4096), gen)
    cases.append((f"{[TRAIN_BATCH, TRAIN_SEQ, 4096]} as the RG-LRU makes a", a, b, None))
    by_copy = {4: 0, 16: 0}
    for shape, a, b, view in cases:
        va = view(a) if view else a
        g = torch.randn(va.shape, generator=gen, device=dev)
        a3 = va if va.dim() == 3 else va[None]
        strides = (a3.stride(0), a3.stride(1)) + (va.shape[-2] * va.shape[-1], va.shape[-1]) * 2
        by_copy[ls.copy_bytes(a3.shape[2], strides, (a3.data_ptr(),))] += 1
        ls.counter.reset()
        got = scan_grads(torch, ls.linear_scan, a, b, g, view)
        if ls.counter.routes != {"fwd": 1, "bwd": 1}:
            raise AssertionError(f"linear_scan backward {shape}: launches {ls.counter.routes}, "
                                 "not one forward and one backward")
        want = scan_grads(torch, ls.linear_scan_plain, a, b, g, view)
        for name, x, y in zip(("h", "grad_a", "grad_b"), got, want):
            if not torch.equal(x, y):
                raise AssertionError(f"linear_scan backward {shape}: {name} not equal to "
                                     f"autograd through the plain version (max |err| "
                                     f"{float((x - y).abs().max()):.3g})")
    assert by_copy[4] and by_copy[16], by_copy
    g = torch.randn(a.shape, generator=gen, device=dev)
    h = ls.linear_scan(a, b)
    ga, gb = ls.linear_scan_backward(a, g, h)
    for _ in range(10):
        ra, rb = ls.linear_scan_backward(a, g, h)
        if not (torch.equal(ga, ra) and torch.equal(gb, rb)):
            raise AssertionError("linear_scan backward main shape: reruns differ")
    records = one_launch(torch, "lin_walk_bwd", dev)
    log(f"  linear_scan backward: {len(cases)} shapes and views (copies of 4 / 16 bytes: "
        f"{by_copy[4]} / {by_copy[16]} cases) equal to autograd through the plain version, "
        f"one fwd and one bwd launch each; {list(a.shape)} 10 reruns bit-identical; 5 calls "
        f"gave the profiler {records}: one launch a backward")


def flash_main_inputs(torch, dev, which: str):
    """K6 at its main shapes, bf16: yi-6b's prefill (phase 7; causal, 32
    heads over 4 KV heads, D 128) or recurrentgemma-9b's local layers
    (phase 8; causal with a window of 2048, 16 heads over 1, D 256)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    if which == "yi":
        b, s, h, kvh, d, window = YI_PREFILL_BATCH, YI_PREFILL_SEQ, 32, 4, 128, None
    else:
        b, s, h, kvh, d, window = PREFILL_BATCH, PREFILL_SEQ, 16, 1, 256, 2048
    q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16()
    return q, k, v, window


def bf16_ratio(torch, got, want) -> float:
    """max |got - want| / (K6_BF16_ATOL + K6_BF16_RTOL * |want|): at most 1
    within the limit."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (K6_BF16_ATOL + K6_BF16_RTOL * want.abs())).max())


def check_flash_attention(torch, fa, dev) -> None:
    """The reference's four shapes x window (None, 32) in f32 (the FMA
    kernel) at K6_F32_TOL and in bf16 (the tensor-core kernel) at the bf16
    limit; both main shapes in bf16, ten reruns bit-identical; causal rows
    before every key (Sq > Sk) give 0 in f32 and bf16 (ROADMAP, known
    divergences); in bf16, windows one short of, at and past the 64-key
    tile at Sq = Sk and Sq < Sk, D 33 (the wrapper's zero-padded copy), and
    q, k, v as views of one fused projection (read in place by TMA).  The
    f32 calls must take the "fma" route, the bf16 ones "tc"."""
    gen = torch.Generator(device=dev).manual_seed(6)
    worst32 = worst16 = 0.0
    for h, sq, sk, d in FLASH_SHAPES:
        q = torch.randn((h, sq, d), generator=gen, device=dev)
        k = torch.randn((h, sk, d), generator=gen, device=dev)
        v = torch.randn((h, sk, d), generator=gen, device=dev)
        for window in (None, 32):
            tag = f"flash_attention {(h, sq, sk, d)} window={window}"
            got = fa.flash_attention(q, k, v, window=window)
            if not torch.equal(got, fa.flash_attention(q, k, v, window=window)):
                raise AssertionError(f"{tag}: runs differ")
            want = fa.flash_attention_plain(q, k, v, window=window)
            torch.testing.assert_close(got, want, rtol=K6_F32_TOL, atol=K6_F32_TOL,
                                       msg=lambda m: f"{tag} f32: {m}")
            worst32 = max(worst32, float((got - want).abs().max()))
            qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
            r = bf16_ratio(torch, fa.flash_attention(qb, kb, vb, window=window),
                           fa.flash_attention_plain(qb, kb, vb, window=window))
            assert r <= 1.0, f"{tag} bf16: {r:.3g} of the limit"
            worst16 = max(worst16, r)
    msgs = []
    for which in ("yi", "rg"):
        q, k, v, window = flash_main_inputs(torch, dev, which)
        got = fa.flash_attention(q, k, v, window=window)
        for _ in range(10):
            if not torch.equal(got, fa.flash_attention(q, k, v, window=window)):
                raise AssertionError(f"flash_attention {which} main shape: reruns differ")
        want = fa.flash_attention_plain(q, k, v, window=window)
        r = bf16_ratio(torch, got, want)
        assert r <= 1.0, f"flash_attention {which} main shape bf16: {r:.3g} of the limit"
        msgs.append(f"{list(q.shape)} x {list(k.shape)} window={window} max |err| "
                    f"{float((got.float() - want.float()).abs().max()):.3g} ({r:.3g} of the limit)")
        del q, k, v, got, want
    q = torch.randn((2, 300, 8, 64), generator=gen, device=dev)
    kv = torch.randn((2, 100, 2, 64), generator=gen, device=dev)
    for x, y in ((q, kv), (q.bfloat16(), kv.bfloat16())):
        got = fa.flash_attention(x, y, y)
        unseen = got[:, :200]
        assert torch.equal(unseen, torch.zeros_like(unseen)), \
            f"flash_attention {x.dtype}: unseen rows are not 0"
        if x.dtype == torch.bfloat16:
            r = bf16_ratio(torch, got[:, 200:], fa.flash_attention_plain(x, y, y)[:, 200:])
            assert r <= 1.0, f"flash_attention bf16 past the unseen rows: {r:.3g} of the limit"
    edges = []

    def bf16_case(tag, q, k, v, **kw):
        got = fa.flash_attention(q, k, v, **kw)
        if not torch.equal(got, fa.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash_attention {tag}: runs differ")
        r = bf16_ratio(torch, got, fa.flash_attention_plain(q, k, v, **kw))
        assert r <= 1.0, f"flash_attention {tag} bf16: {r:.3g} of the limit"
        edges.append(r)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()
    for sq in (256, 200):
        for window in (63, 64, 65):
            bf16_case(f"Sq {sq} Sk 256 window {window}", rnd(2, sq, 4, 64), rnd(2, 256, 2, 64),
                      rnd(2, 256, 2, 64), window=window)
    for window in (None, 40):
        bf16_case(f"D 33 window {window}", rnd(2, 150, 4, 33), rnd(2, 150, 4, 33),
                  rnd(2, 150, 4, 33), window=window)
    fused = rnd(2, 200, 12, 128)
    views = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    assert all(fa.tma_operand(t) is t for t in views), "fused views: TMA cannot read them in place"
    bf16_case("fused projection views", *views)
    fa.counter.reset()
    fa.flash_attention(q, kv, kv)
    fa.flash_attention(q.bfloat16(), kv.bfloat16(), kv.bfloat16())
    assert fa.counter.routes == {"fma": 1, "tc": 1}, fa.counter.routes
    log(f"  flash_attention: {len(FLASH_SHAPES)} shapes x window (None, 32) f32 within "
        f"{K6_F32_TOL} (worst {worst32:.3g}), bf16 within {K6_BF16_RTOL:.4g}|x| + "
        f"{K6_BF16_ATOL} (worst {worst16:.3g} of it), reruns bit-identical; main shapes bf16, "
        f"10 reruns bit-identical: {'; '.join(msgs)}; rows before every key give 0 (f32, "
        f"bf16); bf16 windows 63 / 64 / 65 at Sq 256 and 200 over Sk 256, D 33 (padded "
        f"copy), fused projection views: worst {max(edges):.3g} of the limit, reruns "
        f"bit-identical; f32 took route fma, bf16 route tc")


# K6 non-causal (the encoder's and the cross layers' call) and K7 at the
# decode-cross shape: (B, Sq, H, KVH, Sk, D).  The whisper encoder
# (1,500 frames, 8 heads, D 64), both cross shapes at phase 12's prompt
# length (whisper: M 1,500; llama-vision: M 1,600, 64 heads over 8, D 128),
# and Sk of 1, 63, 65 and 1,500 (none a multiple of the 64-key tile) at Sq
# != Sk
ZOO_BATCH, ZOO_PROMPT, ZOO_NEW = 4, 32, 16
NON_CAUSAL_SHAPES = [(ZOO_BATCH, 1500, 8, 8, 1500, 64), (ZOO_BATCH, ZOO_PROMPT, 8, 8, 1500, 64),
                     (ZOO_BATCH, ZOO_PROMPT, 64, 8, 1600, 128), (2, 100, 8, 2, 1, 64),
                     (2, 100, 8, 2, 63, 64), (2, 100, 8, 2, 65, 64), (2, 300, 8, 8, 1500, 64),
                     (2, 1500, 8, 2, 65, 64)]
# (B, H, KVH, M, D) of decode's cross-attention: every length M
DECODE_CROSS_SHAPES = [(ZOO_BATCH, 8, 8, 1500, 64), (ZOO_BATCH, 64, 8, 1600, 128)]


def check_flash_non_causal(torch, fa, dev) -> None:
    """K6 with causal=False at NON_CAUSAL_SHAPES: bf16 on the tensor cores
    within the bf16 limit, float32 on the FMA kernel within K6_F32_TOL,
    each against its plain version; the first three (the main path's
    shapes) ten reruns bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(7)
    worst16 = worst32 = 0.0
    fa.counter.reset()
    for i, (b, sq, h, kvh, sk, d) in enumerate(NON_CAUSAL_SHAPES):
        tag = f"flash_attention non-causal {(b, sq, h, kvh, sk, d)}"
        q = torch.randn((b, sq, h, d), generator=gen, device=dev)
        k = torch.randn((b, sk, kvh, d), generator=gen, device=dev)
        v = torch.randn((b, sk, kvh, d), generator=gen, device=dev)
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        got = fa.flash_attention(qb, kb, vb, causal=False)
        for _ in range(10 if i < 3 else 1):
            if not torch.equal(got, fa.flash_attention(qb, kb, vb, causal=False)):
                raise AssertionError(f"{tag} bf16: reruns differ")
        r = bf16_ratio(torch, got, fa.flash_attention_plain(qb, kb, vb, causal=False))
        assert r <= 1.0, f"{tag} bf16: {r:.3g} of the limit"
        worst16 = max(worst16, r)
        got = fa.flash_attention(q, k, v, causal=False)
        want = fa.flash_attention_plain(q, k, v, causal=False)
        torch.testing.assert_close(got, want, rtol=K6_F32_TOL, atol=K6_F32_TOL,
                                   msg=lambda m: f"{tag} f32: {m}")
        worst32 = max(worst32, float((got - want).abs().max()))
        del q, k, v, qb, kb, vb, got, want
    routes = dict(fa.counter.routes)
    assert routes.get("fma") == len(NON_CAUSAL_SHAPES), routes
    log(f"  flash_attention non-causal: {len(NON_CAUSAL_SHAPES)} shapes (B, Sq, H, KVH, Sk, D) "
        f"{NON_CAUSAL_SHAPES}: bf16 (route tc) within {K6_BF16_RTOL:.4g}|x| + {K6_BF16_ATOL} "
        f"(worst {worst16:.3g} of it), f32 (route fma) within {K6_F32_TOL} (worst "
        f"{worst32:.3g}); the main shapes' 10 reruns bit-identical; launches by route {routes}")


def check_decode_cross(torch, da, fa, dev) -> None:
    """K7 at DECODE_CROSS_SHAPES with every length M (decode's
    cross-attention) on route tc: within K7_BF16_TOL of its plain version
    and of K6 non-causal at Sq = 1, ten reruns bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(8)
    msgs = []
    for b, h, kvh, m, d in DECODE_CROSS_SHAPES:
        tag = f"decode_attention cross {(b, h, kvh, m, d)}"
        q = torch.randn((b, h, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, m, kvh, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, m, kvh, d), generator=gen, device=dev).bfloat16()
        full = torch.full((b,), m, dtype=torch.int32, device=dev)
        got = da.decode_attention(q, k, v, full)
        for _ in range(10):
            if not torch.equal(got, da.decode_attention(q, k, v, full)):
                raise AssertionError(f"{tag}: reruns differ")
        errs = []
        flash = fa.flash_attention(q[:, None], k, v, causal=False)[:, 0]
        for name, want in (("plain", da.decode_attention_plain(q, k, v, full)),
                           ("K6 at Sq 1", flash)):
            torch.testing.assert_close(got.float(), want.float(), rtol=K7_BF16_TOL,
                                       atol=K7_BF16_TOL, msg=lambda e: f"{tag} vs {name}: {e}")
            errs.append(f"{float((got.float() - want.float()).abs().max()):.3g} vs {name}")
        msgs.append(f"{(b, h, kvh, m, d)} max |err| {', '.join(errs)}")
    log(f"  decode_attention cross (every length M, route tc), within {K7_BF16_TOL}, 10 reruns "
        f"bit-identical: {'; '.join(msgs)}")


SPLIT_PIECES = (2, 4, 8)   # the serving cache cut as 2, 4 or 8 devices would hold it


def split_decode(torch, da, q, k, v, lengths, pieces: int):
    """K7's split route on one card: the partials of each of ``pieces``
    equal runs of the cache's rows, each with the lengths cut to its rows,
    combined in order (what ``kernels.ops`` does across devices)."""
    rows = k.shape[1] // pieces
    parts = [da.decode_attention_partials(q, k[:, i * rows:(i + 1) * rows],
                                          v[:, i * rows:(i + 1) * rows],
                                          da.piece_lengths(lengths, i * rows, rows))
             for i in range(pieces)]
    return da.combine_partials(parts, q.dtype)


def check_decode_split(torch, da, dev) -> None:
    """K7's partials mode and the combine against the whole-cache route at
    the serving shape, bf16 (route tc) and float32 (route fma), the cache
    cut into 2, 4 and 8 pieces: within K7_BF16_TOL, 0 at length 0, reruns
    bit-identical, one partials launch a piece."""
    q, k, v, lengths = decode_main_inputs(torch, dev)
    lengths = lengths.clone()
    lengths[0] = 0
    msgs = []
    for dt in (torch.bfloat16, torch.float32):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        whole = da.decode_attention(qd, kd, vd, lengths)
        for n in SPLIT_PIECES:
            before = dict(da.counter.routes)
            got = split_decode(torch, da, qd, kd, vd, lengths, n)
            route = da.route(dt) + "_partials"
            if da.counter.routes.get(route, 0) - before.get(route, 0) != n:
                raise AssertionError(f"decode_attention split {dt} {n}: routes {da.counter.routes}")
            if not torch.equal(got, split_decode(torch, da, qd, kd, vd, lengths, n)):
                raise AssertionError(f"decode_attention split {dt} {n}: reruns differ")
            assert not got[0].any() and not whole[0].any(), "split: length 0 is not 0"
            torch.testing.assert_close(got.float(), whole.float(), rtol=K7_BF16_TOL,
                                       atol=K7_BF16_TOL,
                                       msg=lambda e: f"decode_attention split {dt} {n}: {e}")
            msgs.append(f"{str(dt)[6:]} {n} pieces {float((got.float() - whole.float()).abs().max()):.3g}")
    log(f"  decode_attention split route (partials of each piece + combine) at the serving "
        f"shape against the whole cache, within {K7_BF16_TOL}, reruns bit-identical, max "
        f"|err|: {'; '.join(msgs)}")


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


def time_kernels(torch, sr, bt, oh, ws, da, ls, fa, dev, pool: int) -> dict:
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
    index_add = lambda: torch.zeros((g, c), device=dev).index_add_(0, codes64, v)
    lib = index_add()
    assert sr.route(c, g) == "reg"
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
        replaces="src/repro/kernels/segment_reduce.py:75", shape=[m, c, g], timed_route="reg",
        max_abs_err=err,
        ms=cuda_ms(lambda: sr.segment_reduce(v, codes, g, "sum"), iters=EVENT_CALLS),
        device_ms=device_ms(lambda: sr.segment_reduce(v, codes, g, "sum"), SEG_KERNELS),
        host_ms=host_ms(lambda: sr.segment_reduce(v, codes, g, "sum")),
        plain_ms=cuda_ms(lambda: sr.segment_reduce_plain(v, codes, g, "sum")),
        library_ms=cuda_ms(index_add, iters=EVENT_CALLS),
        library_device_ms=device_ms(index_add, None),
        library_host_ms=host_ms(index_add),
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
        device_ms=device_ms(lambda: bt.block_transpose(x), ("transpose32",)),
        plain_ms=cuda_ms(lambda: bt.block_transpose_plain(x)),
        library_ms=cuda_ms(lambda: x.t().contiguous()),
        bound_ms=b, bound_by=by)
    # get_dummies: Figure-1's Display column (4 rows, 4 categories) and one
    # block of the 16M-row frame's payment_type (2,000,000 rows, 3 categories;
    # the JSON row, phase 4's shape).  F.one_hot gives int64 and takes codes
    # in [0, G) only.
    for m, g in ((4, 4), (-(-TAXI_ROWS // pool), 3)):
        codes = (torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=dev) if m == 4 else
                 torch.randint(0, g, (m,), dtype=torch.int32, device=dev))
        codes64 = codes.long()
        err = float((oh.onehot_encode(codes, g) - oh.onehot_encode_plain(codes, g)).abs().max())
        assert err == 0.0, err
        b, by = bound_ms((m * g + m) * 4, m * g)
        rec = dict(
            name="onehot_encode", route="cuda", source="src/repro_torch/csrc/onehot_encode.cu",
            replaces="src/repro/kernels/onehot_encode.py:29", shape=[m, g],
            max_abs_err=err,
            ms=cuda_ms(lambda: oh.onehot_encode(codes, g), iters=EVENT_CALLS),
            device_ms=device_ms(lambda: oh.onehot_encode(codes, g), ("onehot_span",)),
            host_ms=host_ms(lambda: oh.onehot_encode(codes, g)),
            plain_ms=cuda_ms(lambda: oh.onehot_encode_plain(codes, g)),
            library_ms=cuda_ms(lambda: F.one_hot(codes64, g), iters=EVENT_CALLS),
            library_device_ms=device_ms(lambda: F.one_hot(codes64, g), None),
            library_host_ms=host_ms(lambda: F.one_hot(codes64, g)),
            bound_ms=b, bound_by=by)
        if m == 4:
            out["onehot_encode_figure1"] = rec
        else:
            out["onehot_encode"] = rec
    # WINDOW: one column of one block of the 16M-row frame (the JSON row),
    # and the whole column, past the grid's shared memory
    for m in (-(-TAXI_ROWS // pool), TAXI_ROWS):
        x = torch.randn(m, device=dev)
        k, plain, lib = ws.window_scan(x), ws.window_scan_plain(x), torch.cumsum(x, 0)
        ratios = [scan_sum_ratio(torch, r, x) for r in (k, plain, lib)]
        assert ratios[0] <= 1.0 and ratios[1] <= 1.0, ratios
        log(f"  window_scan [{m}] cumsum against a float64 prefix sum: kernel {ratios[0]:.3g} of "
            f"the tolerance, plain {ratios[1]:.3g}, float32 torch.cumsum {ratios[2]:.3g}")
        b, by = bound_ms(2 * m * 4, m)
        rec = dict(
            name="window_scan", route="cuda", source="src/repro_torch/csrc/window_scan.cu",
            replaces="src/repro/kernels/window_scan.py:58", shape=[m],
            max_abs_err=float((k - plain).abs().max()),
            ms=cuda_ms(lambda: ws.window_scan(x), iters=EVENT_CALLS),
            device_ms=device_ms(lambda: ws.window_scan(x), ("scan_one_pass",)),
            host_ms=host_ms(lambda: ws.window_scan(x)),
            plain_ms=cuda_ms(lambda: ws.window_scan_plain(x)),
            library_ms=cuda_ms(lambda: torch.cumsum(x, 0), iters=EVENT_CALLS),
            library_device_ms=device_ms(lambda: torch.cumsum(x, 0), None),
            library_host_ms=host_ms(lambda: torch.cumsum(x, 0)),
            bound_ms=b, bound_by=by)
        out["window_scan" if m < TAXI_ROWS else "window_scan_16m"] = rec
        del x, k, plain, lib
    # decode attention: one serving step's layer, 8 slots over a 1024-slot cache
    q, k, v, lengths = decode_main_inputs(torch, dev)
    b_, h, d = q.shape
    kvh = k.shape[2]
    k_out, plain = da.decode_attention(q, k, v, lengths), da.decode_attention_plain(q, k, v, lengths)
    valid = torch.arange(k.shape[1], device=dev)[None, :] < lengths[:, None]
    mask = valid[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)[:, :, 0]
    lib_err = float((lib.float() - plain.float()).abs().max())
    assert lib_err <= 5e-2, lib_err
    keys = int(valid.sum())       # sum over slots of min(length, S)
    b, by = bound_ms(2 * keys * kvh * d * 2 + 2 * b_ * h * d * 2 + b_ * 4, 4 * keys * h * d)
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    out["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention_tc.cu",
        replaces="src/repro/kernels/decode_attention.py:65", shape=[b_, h, kvh, d, k.shape[1]],
        timed_route="tc",
        max_abs_err=float((k_out.float() - plain.float()).abs().max()),
        ms=cuda_ms(lambda: da.decode_attention(q, k, v, lengths), iters=EVENT_CALLS),
        device_ms=device_ms(lambda: da.decode_attention(q, k, v, lengths), DECODE_KERNELS),
        host_ms=host_ms(lambda: da.decode_attention(q, k, v, lengths)),
        plain_ms=cuda_ms(lambda: da.decode_attention_plain(q, k, v, lengths)),
        library_ms=cuda_ms(sdpa, iters=EVENT_CALLS),
        library_device_ms=device_ms(sdpa, None),
        library_host_ms=host_ms(sdpa),
        bound_ms=b, bound_by=by)
    log(f"  decode_attention {out['decode_attention']['shape']}: {keys} valid cache rows; "
        f"scaled_dot_product_attention (enable_gqa, length mask) off the plain version by "
        f"{lib_err:.3g}")
    # the partials mode at the same shape: the whole cache in one launch
    # (float32 O, M, L out), and the split route over 8 pieces (8 partials
    # launches, then the combine's elementwise work)
    part = lambda: da.decode_attention_partials(q, k, v, lengths)
    o, m, l = part()
    po, pm, pl = da.decode_attention_partials_plain(q, k, v, lengths)
    p_err = float((o / l[..., None] - po / pl[..., None]).abs().max())
    p_bound, p_by = bound_ms(2 * keys * kvh * d * 2 + b_ * h * d * 2 + b_ * 4
                             + b_ * h * (d + 2) * 4, 4 * keys * h * d)
    parts = [da.decode_attention_partials(q, k[:, i * 128:(i + 1) * 128], v[:, i * 128:(i + 1) * 128],
                                          da.piece_lengths(lengths, i * 128, 128))
             for i in range(k.shape[1] // 128)]
    comb = lambda: da.combine_partials(parts, q.dtype)
    split = lambda: split_decode(torch, da, q, k, v, lengths, k.shape[1] // 128)
    out["decode_attention"]["partials"] = dict(
        route="tc_partials", shape=[b_, h, kvh, d, k.shape[1]], max_abs_err=p_err,
        ms=cuda_ms(part, iters=EVENT_CALLS), device_ms=device_ms(part, DECODE_KERNELS),
        host_ms=host_ms(part),
        plain_ms=cuda_ms(lambda: da.decode_attention_partials_plain(q, k, v, lengths)),
        bound_ms=p_bound, bound_by=p_by,
        split_pieces=len(parts), split_ms=cuda_ms(split), combine_ms=cuda_ms(comb),
        combine_device_ms=device_ms(comb, None))
    pr = out["decode_attention"]["partials"]
    log(f"  decode_attention partials (route tc_partials) {pr['shape']}: kernel {pr['ms']:.4f} "
        f"ms (on the device {ms_text(pr['device_ms'])} ms, host {pr['host_ms']:.4f} ms a "
        f"call), plain {pr['plain_ms']:.4f} ms, bound {pr['bound_ms']:.4f} ms "
        f"({pr['bound_by']}), O / L off the plain version by {p_err:.3g}; the split route "
        f"over {len(parts)} pieces of 128 rows {pr['split_ms']:.4f} ms, of it the combine "
        f"{pr['combine_ms']:.4f} ms (on the device {ms_text(pr['combine_device_ms'])} ms)")
    del o, m, l, po, pm, pl, parts
    # linear scan: one RG-LRU layer of phase 8's prefill; no single PyTorch
    # call computes the recurrence
    gen = torch.Generator(device=dev).manual_seed(7)
    a, b = rglru_like(torch, (PREFILL_BATCH, PREFILL_SEQ, 4096), gen)
    b_bound, by = bound_ms(3 * a.numel() * 4, 2 * a.numel())
    out["linear_scan"] = dict(
        name="linear_scan", route="cuda", source="src/repro_torch/csrc/linear_scan.cu",
        replaces="src/repro/kernels/linear_scan.py:49", shape=list(a.shape),
        max_abs_err=float((ls.linear_scan(a, b) - ls.linear_scan_plain(a, b)).abs().max()),
        ms=cuda_ms(lambda: ls.linear_scan(a, b), iters=EVENT_CALLS),
        device_ms=device_ms(lambda: ls.linear_scan(a, b), ("lin_walk",)),
        host_ms=host_ms(lambda: ls.linear_scan(a, b)),
        plain_ms=cuda_ms(lambda: ls.linear_scan_plain(a, b), iters=3, warmup=1),
        library_ms=None, bound_ms=b_bound, bound_by=by)
    del a, b
    # its backward at one RG-LRU layer of phase 11's training step: a, g and
    # h read once, grad_a and grad_b written once; a multiply, an add and a
    # multiply an element.  No single PyTorch call computes it either.
    a, b = rglru_like(torch, (TRAIN_BATCH, TRAIN_SEQ, 4096), gen)
    g = torch.randn(a.shape, generator=gen, device=dev)
    h = ls.linear_scan(a, b)
    bwd = lambda: ls.linear_scan_backward(a, g, h)
    ga, gb = bwd()
    pa, pb = ls.linear_scan_backward_plain(a, g, h)
    b_bound, by = bound_ms(5 * a.numel() * 4, 3 * a.numel())
    out["linear_scan"]["backward"] = dict(
        shape=list(a.shape),
        max_abs_err=max(float((ga - pa).abs().max()), float((gb - pb).abs().max())),
        ms=cuda_ms(bwd, iters=EVENT_CALLS), device_ms=device_ms(bwd, ("lin_walk",)),
        host_ms=host_ms(bwd),
        plain_ms=cuda_ms(lambda: ls.linear_scan_backward_plain(a, g, h), iters=1, warmup=1),
        library_ms=None, bound_ms=b_bound, bound_by=by)
    del a, b, g, h, ga, gb, pa, pb
    # flash attention: one local layer of phase 8's prefill (the JSON row)
    # and one layer of phase 7's yi-6b prefill, bf16 on the tensor cores;
    # the library call is scaled_dot_product_attention with enable_gqa and
    # a causal / band mask.  TFLOP/s count the function's 4 D operations a
    # visible pair (the kernel does 6 D: P . V twice, P split in two).
    for which in ("rg", "yi"):
        q, k, v, window = flash_main_inputs(torch, dev, which)
        bsz, s, h, d = q.shape
        kvh = k.shape[2]
        mask = fa._mask(s, s, True, window, dev)
        pairs = int(mask.sum()) * bsz * h       # visible (query, key) pairs
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
        got, want = fa.flash_attention(q, k, v, window=window), fa.flash_attention_plain(q, k, v, window=window)
        lib_err = float((lib().transpose(1, 2).float() - want.float()).abs().max())
        b_bound, by = bound_ms(2 * (q.numel() + k.numel() + v.numel() + q.numel()), 4 * d * pairs,
                               BF16_OPS_PER_S)
        rec = dict(
            name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention_tc.cu",
            replaces="src/repro/kernels/flash_attention.py:75", shape=[bsz, s, h, kvh, d, window],
            max_abs_err=float((got.float() - want.float()).abs().max()),
            ms=cuda_ms(lambda: fa.flash_attention(q, k, v, window=window), iters=10),
            device_ms=device_ms(lambda: fa.flash_attention(q, k, v, window=window), ("flash_tc",),
                                iters=10),
            plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, window=window), iters=3,
                             warmup=1),
            library_ms=cuda_ms(lib, iters=10), bound_ms=b_bound, bound_by=by)
        log(f"  flash_attention bf16 (route tc) {rec['shape']}: {pairs} visible pairs, "
            f"{4 * d * pairs / 1e9:.4g} GFLOP at {tflops_text(4 * d * pairs, rec['device_ms'])}"
            f"; scaled_dot_product_attention off the plain version by {lib_err:.3g}")
        out["flash_attention" if which == "rg" else "flash_attention_yi"] = rec
        del q, k, v, got, want, mask, qs, ks, vs
    # non-causal, phase 12's main shapes: one whisper encoder layer (4 x
    # 1,500 frames, 8 heads, D 64) on K6, and one decode cross-attention of
    # whisper (4 slots over all 1,500 frames) on K7; the library call is
    # scaled_dot_product_attention without a mask
    b_, sq, h, kvh, sk, d = NON_CAUSAL_SHAPES[0]
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((b_, sq, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b_, sk, kvh, d), generator=gen, device=dev).bfloat16() for _ in range(2))
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    pairs = b_ * h * sq * sk
    b_bound, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()), 4 * d * pairs,
                           BF16_OPS_PER_S)
    enc = lambda: fa.flash_attention(q, k, v, causal=False)
    out["flash_attention_non_causal"] = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention_tc.cu",
        replaces="src/repro/kernels/flash_attention.py:75", shape=[b_, sq, h, kvh, d, "non-causal"],
        max_abs_err=float((enc().float() - fa.flash_attention_plain(q, k, v, causal=False).float())
                          .abs().max()),
        ms=cuda_ms(enc, iters=EVENT_CALLS), device_ms=device_ms(enc, ("flash_tc",)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=False), iters=3,
                         warmup=1),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True),
                           iters=EVENT_CALLS),
        bound_ms=b_bound, bound_by=by)
    rec = out["flash_attention_non_causal"]
    log(f"  flash_attention non-causal (route tc) {rec['shape']}: {pairs} pairs at "
        f"{tflops_text(4 * d * pairs, rec['device_ms'])}")
    b_, h, kvh, m, d = DECODE_CROSS_SHAPES[0]
    q = torch.randn((b_, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b_, m, kvh, d), generator=gen, device=dev).bfloat16() for _ in range(2))
    full = torch.full((b_,), m, dtype=torch.int32, device=dev)
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    b_bound, by = bound_ms(2 * b_ * m * kvh * d * 2 + 2 * b_ * h * d * 2 + b_ * 4,
                           4 * b_ * m * h * d)
    cross = lambda: da.decode_attention(q, k, v, full)
    sdpa_cross = lambda: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)
    out["decode_attention_cross"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention_tc.cu",
        replaces="src/repro/kernels/decode_attention.py:65", shape=[b_, h, kvh, d, m, "all M"],
        max_abs_err=float((cross().float() - da.decode_attention_plain(q, k, v, full).float())
                          .abs().max()),
        ms=cuda_ms(cross, iters=EVENT_CALLS), device_ms=device_ms(cross, DECODE_KERNELS),
        host_ms=host_ms(cross),
        plain_ms=cuda_ms(lambda: da.decode_attention_plain(q, k, v, full)),
        library_ms=cuda_ms(sdpa_cross, iters=EVENT_CALLS),
        library_device_ms=device_ms(sdpa_cross, None), library_host_ms=host_ms(sdpa_cross),
        bound_ms=b_bound, bound_by=by)
    del q, k, v, qs, ks, vs
    # the FMA route: float32 at the reference's largest shape, causal; its
    # bound is the float32 CUDA cores' rate
    h, sq, sk, d = FLASH_SHAPES[-1]
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn((h, n, d), generator=gen, device=dev) for n in (sq, sk, sk))
    pairs = int(fa._mask(sq, sk, True, None, dev).sum()) * h
    b_bound, by = bound_ms(4 * (2 * q.numel() + k.numel() + v.numel()), 4 * d * pairs)
    rec = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:75", shape=[1, sq, h, h, d, None],
        max_abs_err=float((fa.flash_attention(q, k, v) - fa.flash_attention_plain(q, k, v)).abs().max()),
        ms=cuda_ms(lambda: fa.flash_attention(q, k, v)),
        device_ms=device_ms(lambda: fa.flash_attention(q, k, v), ("flash_fwd",)),
        plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        bound_ms=b_bound, bound_by=by)
    log(f"  flash_attention f32 (route fma) {rec['shape']}: {pairs} visible pairs at "
        f"{tflops_text(4 * d * pairs, rec['device_ms'], share=False)}")
    out["flash_attention_f32"] = rec
    return out


CUDA_TESTS_TIMEOUT = 600


def cuda_kernel_tests() -> None:
    """The CUDA-only pytest cases (tests/test_torch_cuda_kernels.py, which
    imports no JAX) on the card, in a child process without the test
    suite's conftest (it imports the JAX package); every case must pass."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-p",
                           "no:cacheprovider", "-q", "tests/test_torch_cuda_kernels.py"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=CUDA_TESTS_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    tail = lines[-1] if lines else ""
    log(f"  pytest: {tail}")
    if proc.returncode != 0 or "passed" not in tail or any(
            w in tail for w in ("failed", "error", "skipped")):
        print(proc.stdout[-8000:], file=sys.stderr)
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"tests/test_torch_cuda_kernels.py on the card: {tail!r} "
                             f"(exit {proc.returncode})")


# -----------------------------------------------------------------------------
# phase 4: the Fig. 6 mix at full size
# -----------------------------------------------------------------------------
def timed(label: str, fn, kernels: tuple = ()):
    """Run one step and print its wall time (host clock, ending in a sync).
    ``kernels`` is ``profiled``'s and unused here."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    log(f"  {label}: {time.perf_counter() - t0:.3f} s wall")
    return out


def profiled(label: str, fn, kernels: tuple = ()):
    """Run one step under the CUDA profiler and print the device's busy time
    in it (the summed durations of the kernels and copies the profiler saw)
    beside the profiled run's wall time, which the profiler lengthens, and
    the device time of the kernels whose names contain one of ``kernels``."""
    import torch
    out = []
    events, wall = device_window(torch, lambda: out.append(fn()), cuda_only=True)
    if events is None:
        log(f"  {label}: device busy not measured ({wall:.3f} s profiled wall)")
        return out[-1]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    mine = ""
    if kernels:
        ms = sum(e.self_device_time_total for e in events
                 if any(n in e.key for n in kernels)) / 1e3
        mine = f"; {' / '.join(kernels)} {ms:.3f} ms"
    log(f"  {label}: device busy {busy * 1e3:.3f} ms of {wall:.3f} s profiled wall "
        f"({100 * busy / wall:.2f}%){mine}")
    return out[-1]


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
    from repro_torch.core import DataFrame, EvalMode, Session, get_dummies
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
                          {"f0": ["sum", "mean", "min", "max"]}).collect()),
           "dummies": run("get_dummies(payment_type)",
                          lambda: get_dummies(df, ["payment_type"]).collect())}
    t = run(".T", lambda: dm.T)
    out["back"] = run(".T (second) + collect", lambda: t.T.collect())
    s.close()
    st.close()
    return out


def taxi_numpy(np):
    """taxi_like_frame(TAXI_ROWS, seed=0) in numpy: passenger_count, the six
    float columns and their null masks, and the payment_type index into
    PAYMENT (taxi_like_frame's calls, in order)."""
    n = TAXI_ROWS
    rng = np.random.default_rng(0)
    pc = rng.integers(1, 7, n)
    pay = rng.choice(3, n)
    cols, nulls = [], []
    for _ in range(6):
        cols.append(rng.standard_normal(n).astype(np.float32))
        nulls.append(rng.random(n) < 0.01)
    return pc, cols, nulls, pay


def check_fig6(torch, np, dev, out: dict) -> None:
    """Every Fig. 6 result against numpy from the same seed."""
    from repro_torch.core import Domain
    from repro_torch.core.frame import host
    n = TAXI_ROWS
    pc, cols, nulls, pay = taxi_numpy(np)

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

    d = out["dummies"]
    labels = d.col_labels.to_list()
    assert d.shape == (n, 10), d.shape
    for j, val in enumerate(PAYMENT):
        col = d.columns[labels.index(f"payment_type_{val}")]
        want = torch.from_numpy((pay == j).astype(np.int32)).to(dev)
        assert col.mask is None and torch.equal(col.data, want), val

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
# phase 6: the ordered path at full size
# -----------------------------------------------------------------------------
RATES = [2.5, 3.0, 3.5, 4.0, 4.5, 5.0]   # one per passenger_count 1..6
THINK_S = 0.35                           # bench_opportunistic.py's think time
ROLL = 10


def workflow(dev, frame) -> dict:
    """The §6.1 think-time workflow of bench_opportunistic.py: a filter, a
    cumsum, think time, then head(5), in an OPPORTUNISTIC session."""
    from repro_torch.core import DataFrame, EvalMode, Session
    s = Session(mode=EvalMode.OPPORTUNISTIC, device=dev)
    try:
        df = DataFrame(frame, session=s)
        t0 = time.perf_counter()
        q = df[df["passenger_count"] > 1]
        q2 = q.cumsum(cols=["f0"])
        stmt_s = time.perf_counter() - t0
        time.sleep(THINK_S)
        t1 = time.perf_counter()
        head = q2.head(5)
        inspect_s = time.perf_counter() - t1
        prefix = s.executor.stats.prefix_evals
        for d in (q, q2):            # let the background runs finish here
            d._node.handle.result()
        return {"head": head, "stmt_s": stmt_s, "inspect_s": inspect_s,
                "prefix_evals": prefix}
    finally:
        s.close()


ORDERED_CACHE = 16 << 30   # holds every result of the steps (~0.6 GB each)


def ordered_steps(run, dev, frame) -> dict:
    """The ordered path in a fresh EAGER session (statements evaluate as
    they are made), then the §6.1 workflow; ``run(label, thunk)`` runs each
    step (timed, or under the profiler).  The session's materialization
    cache is 16 GiB, not the default 1 GiB: the default holds one 0.6 GB
    result, so each step on the sorted frame would evict it and sort again
    (PERF.md, Findings)."""
    from repro_torch.core import DataFrame, EvalMode, Session
    s = Session(mode=EvalMode.EAGER, device=dev, cache_budget_bytes=ORDERED_CACHE)
    df = DataFrame(frame, session=s)
    rates = DataFrame({"passenger_count": [1, 2, 3, 4, 5, 6], "rate": RATES}, session=s)
    srt = run("sort_values(f0)", lambda: df.sort_values("f0"))
    out = {"sorted": srt.collect(),
           "cumsum": run("cumsum() of 7 numeric columns", lambda: srt.cumsum().collect()),
           "cummax": run("cummax(f1)", lambda: srt.cummax(cols=["f1"]).collect()),
           "cummin": run("cummin(f1)", lambda: srt.cummin(cols=["f1"]).collect()),
           "diff": run("diff(1, f2)", lambda: df.diff(1, cols=["f2"]).collect()),
           "shift": run("shift(3, f2)", lambda: df.shift(3, cols=["f2"]).collect()),
           "rolling": run(f"rolling_mean({ROLL}, f3)",
                          lambda: srt.rolling_mean(ROLL, cols=["f3"]).collect()),
           "merge": run("merge(rates, on=passenger_count)",
                        lambda: df.merge(rates, on="passenger_count").collect())}
    log(f"  EAGER session: {s.executor.stats.evaluated_nodes} plan nodes evaluated, "
        f"{s.executor.stats.cache_hits} cache hits")
    s.close()
    out["workflow"] = run("§6.1 workflow, OPPORTUNISTIC", lambda: workflow(dev, frame))
    return out


def serial_steps(dev, frame) -> dict:
    """SORT and JOIN on the serial whole-frame path (REPRO_SHUFFLE=0), the
    oracle the shuffled results must equal bit for bit."""
    from repro_torch.core import DataFrame, EvalMode, Session
    with knobs({"REPRO_SHUFFLE": "0"}):
        s = Session(mode=EvalMode.EAGER, device=dev)
        df = DataFrame(frame, session=s)
        rates = DataFrame({"passenger_count": [1, 2, 3, 4, 5, 6], "rate": RATES}, session=s)
        out = {"sorted": timed("serial sort_values(f0) + collect",
                               lambda: df.sort_values("f0").collect()),
               "merge": timed("serial merge + collect",
                              lambda: df.merge(rates, on="passenger_count").collect())}
        s.close()
        return out


def label_array(np, labels):
    from repro_torch.core.labels import RangeLabels
    if isinstance(labels, RangeLabels):
        return np.arange(labels.start, labels.start + labels.length)
    return np.asarray(labels.values)


def same_frame(torch, np, a, b) -> bool:
    """Labels, schema, masks and every stored bit equal."""
    if (a.col_labels.to_list() != b.col_labels.to_list() or a.schema != b.schema
            or not np.array_equal(label_array(np, a.row_labels), label_array(np, b.row_labels))):
        return False
    for x, y in zip(a.columns, b.columns):
        if x.data.dtype != y.data.dtype or (x.mask is None) != (y.mask is None):
            return False
        if x.data.element_size() == 4:
            same = torch.equal(x.data.view(torch.int32), y.data.view(torch.int32))
        else:
            same = torch.equal(x.data, y.data)
        if not same or (x.mask is not None and not torch.equal(x.mask, y.mask)):
            return False
    return True


def check_ordered(torch, np, dev, out: dict, serial: dict) -> None:
    """Every ordered result against numpy from the same seed, and SORT and
    JOIN bit-identical to the serial path."""
    from repro_torch.core import Domain
    from repro_torch.core.frame import host
    n = TAXI_ROWS
    pc, cols, nulls, _ = taxi_numpy(np)
    filled = [np.where(nl, 0.0, c).astype(np.float32) for c, nl in zip(cols, nulls)]
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # 1. sort: numpy's stable argsort of f0 with nulls last
    srt = out["sorted"]
    perm = np.argsort(np.where(nulls[0], np.inf, cols[0].astype(np.float64)), kind="stable")
    assert np.array_equal(label_array(np, srt.row_labels), perm), "sort: row order"
    assert torch.equal(srt.col("passenger_count").data, dt(pc[perm].astype(np.int32)))
    for j in range(6):
        c = srt.col(f"f{j}")
        assert torch.equal(c.data, dt(filled[j][perm])) and torch.equal(c.mask, dt(~nulls[j][perm]))
    assert same_frame(torch, np, srt, serial["sorted"]), "sort: shuffled != serial"

    # 2. cumsum of every numeric column, against float64 prefix sums
    cs = out["cumsum"]
    worst = 0.0
    for name, v, valid in [("passenger_count", pc[perm], None)] + [
            (f"f{j}", filled[j][perm], ~nulls[j][perm]) for j in range(6)]:
        c = cs.col(name)
        assert c.domain is Domain.FLOAT
        ratio = scan_sum_ratio(torch, c.data, dt(v))
        assert ratio <= 1.0, (name, ratio)
        worst = max(worst, ratio)
        assert (c.mask is None) if valid is None else torch.equal(c.mask, dt(valid)), name
    assert cs.col("payment_type").domain is Domain.STR
    log(f"  cumsum: 7 columns within {SUM_RTOL}*sum|v| of float64 prefix sums "
        f"(worst {worst:.3g} of it); masks unchanged")

    # 3. cummax / cummin: bit-equal to numpy's accumulate in float32
    v, valid = filled[1][perm], ~nulls[1][perm]
    for key, ufunc, ident in (("cummax", np.maximum, -np.inf), ("cummin", np.minimum, np.inf)):
        want = ufunc.accumulate(np.where(valid, v, np.float32(ident)).astype(np.float32))
        c = out[key].col("f1")
        assert np.array_equal(host(c.data).view(np.int32), want.view(np.int32)), key
        assert torch.equal(c.mask, dt(valid)), key

    # 4. diff / shift on the unsorted frame, across the block seams
    v, valid = filled[2], ~nulls[2]
    rows = np.arange(n)
    prev, pvalid = np.roll(v, 1), np.roll(valid, 1)
    want_mask = valid & pvalid & (rows >= 1)
    c = out["diff"].col("f2")
    assert np.array_equal(host(c.mask), want_mask), "diff mask"
    assert np.array_equal(host(c.data)[want_mask].view(np.int32),
                          (v - prev)[want_mask].view(np.int32)), "diff values"
    want_mask = np.roll(valid, 3) & (rows >= 3)
    c = out["shift"].col("f2")
    assert np.array_equal(host(c.mask), want_mask), "shift mask"
    assert np.array_equal(host(c.data)[want_mask].view(np.int32),
                          np.roll(v, 3)[want_mask].view(np.int32)), "shift values"

    # 5. rolling_mean: cumsum - shift(cumsum, w), a null row i-w taking
    #    nothing off (the engine's rule); the bound is twice the cumsum's / w
    v64 = dt(filled[3][perm]).double()
    valid = dt(~nulls[3][perm])
    csum, absacc = torch.cumsum(v64, 0), torch.cumsum(v64.abs(), 0)
    idx = torch.arange(n, device=dev)
    base = torch.zeros_like(csum)
    base[ROLL:] = torch.where(valid[:-ROLL], csum[:-ROLL], 0.0)
    want = (csum - base) / ROLL
    c = out["rolling"].col("f3")
    want_mask = valid & (idx >= ROLL - 1)
    assert torch.equal(c.mask, want_mask), "rolling mask"
    err = torch.where(want_mask, (c.data.double() - want).abs(), 0.0)
    ratio = float((err / (2 * SUM_RTOL / ROLL * absacc + 1e-30)).max())
    log(f"  rolling_mean({ROLL}): largest |error| {float(err.max()):.6g} against a float64 "
        f"rolling mean, {ratio:.3g} of the bound 2e-6*sum|v|")
    assert ratio <= 1.0, ratio

    # 6. the §6.1 workflow's head(5)
    wf = out["workflow"]
    keep = np.flatnonzero(pc > 1)
    head = wf["head"]
    assert np.array_equal(label_array(np, head.row_labels), keep[:5]), "workflow head labels"
    f0 = filled[0][keep].astype(np.float64)
    exact = np.cumsum(f0)[:5]
    got = np.asarray(head.col("f0").data.double().cpu())
    assert np.all(np.abs(got - exact) <= SUM_RTOL * np.cumsum(np.abs(f0))[:5] + 1e-30), (got, exact)
    log(f"  §6.1 workflow: statements {wf['stmt_s'] * 1e3:.3f} ms, head(5) after "
        f"{THINK_S} s think time {wf['inspect_s'] * 1e3:.3f} ms, prefix_evals {wf['prefix_evals']}")

    # 7. merge: each left row meets exactly one rate, in left order
    mg = out["merge"]
    assert mg.shape == (n, 9), mg.shape
    assert np.array_equal(label_array(np, mg.row_labels), np.arange(n))
    assert torch.equal(mg.col("passenger_count").data, dt(pc.astype(np.int32)))
    assert torch.equal(mg.col("rate").data, dt(np.asarray(RATES, np.float32)[pc - 1]))
    assert torch.equal(mg.col("f0").data, dt(filled[0])) and torch.equal(mg.col("f0").mask, dt(~nulls[0]))
    assert same_frame(torch, np, mg, serial["merge"]), "merge: shuffled != serial"


def same_results(torch, np, a: dict, b: dict) -> None:
    """The profiled rerun's results equal the timed run's, bit for bit."""
    for k in a:
        if k == "workflow":
            assert same_frame(torch, np, a[k]["head"], b[k]["head"]), k
        else:
            assert same_frame(torch, np, a[k], b[k]), f"{k}: rerun differs"


# -----------------------------------------------------------------------------
# phase 7: LM serving at full width
# -----------------------------------------------------------------------------
def serve_prompts(np, vocab: int, n: int = SERVE_REQUESTS, seed: int = 0) -> list:
    """BOS plus random token ids in [3, vocab), lengths uniform in PROMPT_LENS
    (64 at least, as check 3's teacher forcing needs)."""
    from repro_torch.data import BOS
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, n)
    return [[BOS] + rng.integers(3, vocab, int(m) - 1).tolist() for m in lens]


def serve(model, params, prompts, *, max_batch: int = SERVE_BATCH,
          max_seq: int = SERVE_SEQ, new: int = SERVE_NEW, record: bool = False,
          steps: int | None = None) -> dict:
    """Serve ``prompts`` through ServeEngine, timing every step (each ends in
    the engine's host sync).  ``record`` keeps the logits row behind every
    output token; ``steps`` stops after that many steps."""
    import time as _time
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(model, params, max_batch=max_batch, max_seq=max_seq)
    reqs = [Request(rid=i, prompt_ids=p, max_new_tokens=new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    rows = {r.rid: [] for r in reqs}
    seen = {}
    if record:
        real = model.decode_step

        def recording(*args):
            out = real(*args)
            seen["logits"], seen["slots"] = out[0], list(eng.slots)
            return out
        model.decode_step = recording
    times = []
    t0 = _time.perf_counter()
    try:
        while steps is None or len(times) < steps:
            before = [len(r.out_ids) for r in reqs]
            t = _time.perf_counter()
            if eng.step() == 0 and not eng._pending:
                break
            times.append(_time.perf_counter() - t)
            if record:
                for r, n in zip(reqs, before):
                    if len(r.out_ids) > n:
                        slot = next(i for i, x in enumerate(seen["slots"]) if x is r)
                        rows[r.rid].append(seen["logits"][slot].clone())
    finally:
        if record:
            del model.decode_step
    return {"reqs": reqs, "engine": eng, "times": times, "rows": rows,
            "wall": _time.perf_counter() - t0}


def same_streams(torch, run: dict, oracle: dict, what: str) -> tuple[int, int, float, float]:
    """Tokens of ``run`` against the ``oracle`` run (attn_impl="xla").  Up to
    a request's first differing token both runs fed the same tokens, so their
    logits there must agree within FULL_LOGIT_TOL; the first differing token
    must be a near-tie of the oracle (top-1 - top-2 < NEAR_TIE); nothing of
    that request is compared after it.  Returns (tokens equal, requests that
    parted at a near-tie, max |logit difference|, the widest oracle margin
    at which a request parted)."""
    equal = parted = 0
    worst = widest = 0.0
    for a, b in zip(run["reqs"], oracle["reqs"]):
        for j in range(min(len(a.out_ids), len(b.out_ids))):
            la, lb = run["rows"][a.rid][j], oracle["rows"][b.rid][j]
            diff = float((la - lb).abs().max())
            worst = max(worst, diff)
            if diff > FULL_LOGIT_TOL:
                raise AssertionError(f"{what}: request {a.rid} token {j}: logits differ by "
                                     f"{diff:.4g} > {FULL_LOGIT_TOL}")
            if a.out_ids[j] != b.out_ids[j]:
                top = lb.topk(2).values
                margin = float(top[0] - top[1])
                if margin >= NEAR_TIE:
                    raise AssertionError(f"{what}: request {a.rid} parts at token {j} with an "
                                         f"oracle margin of {margin:.4g} >= {NEAR_TIE}")
                widest = max(widest, margin)
                parted += 1
                break
            equal += 1
        else:
            if len(a.out_ids) != len(b.out_ids):
                raise AssertionError(f"{what}: request {a.rid} ends after "
                                     f"{len(a.out_ids)} tokens, the oracle after {len(b.out_ids)}")
    return equal, parted, worst, widest


def teacher_forced(torch, transformer, params, toks, cfg, dev):
    """Logits (B, T, V) of ``decode_step`` fed ``toks`` (B, T) from an empty
    cache."""
    with torch.inference_mode():
        cache = transformer.cache_init(cfg, toks.shape[0], SERVE_SEQ, dev)
        outs = []
        for i in range(toks.shape[1]):
            lg, cache = transformer.decode_step(params, toks[:, i], cache, cfg)
            outs.append(lg)
    return torch.stack(outs, 1)


def logit_readings(got, want) -> tuple[float, float, float]:
    """(max |logit diff|, mean |logit diff|, top-1 agreement)."""
    d = (got - want).abs()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean()
    return float(d.max()), float(d.mean()), float(agree)


SERVE_LIMITS = (FULL_LOGIT_TOL, MEAN_LOGIT_TOL, TOP1_AGREE_MIN)


def within_logit_limits(readings, limits=SERVE_LIMITS) -> bool:
    (diff, mean, agree), (max_tol, mean_tol, agree_min) = readings, limits
    return diff <= max_tol and mean <= mean_tol and agree >= agree_min


def show_readings(what: str, readings, limits) -> str:
    return (f"{what}: max |logit diff| {readings[0]:.4g} (limit {limits[0]}), mean "
            f"{readings[1]:.4g} (limit {limits[1]}), top-1 agreement {readings[2]:.4f} "
            f"(at least {limits[2]})")


def logits_at(torch, transformer, params, toks, cfg, positions):
    """Logits (B, len(positions), V) of the forward at ``positions``: the
    whole forward, then the final norm and unembedding of those rows only."""
    with torch.inference_mode():
        x = transformer.hidden(params, toks, cfg)
        return transformer.logits(params, x[:, positions], cfg)


def prefill_ms(torch, model, params, toks, runs: int = 3) -> list:
    """Wall ms of ``runs`` prefills after one warm-up, each ending in a sync."""
    times = []
    with torch.inference_mode():
        for _ in range(runs + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.prefill(params, toks)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    return times[1:]


def profile_window(torch, fn, per: int, label: str, mine: dict | None = None,
                   tries: int = 2, cuda_only: bool = False) -> None:
    """Run ``fn`` under the CUDA profiler; print the device's busy share of
    the window's wall and its largest device activities, per ``per``; and
    for each of ``mine`` (label: kernel names) the device time and share of
    the busy time of the kernels whose names contain one of the names.
    ``tries`` and ``cuda_only`` as ``device_window``'s."""
    events, wall = device_window(torch, fn, cuda_only=cuda_only, tries=tries)
    if events is None:
        log(f"  {label}: device busy not measured ({wall * 1e3:.3f} ms wall)")
        return
    events = [e for e in events if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    log(f"  {label}: device busy {busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall "
        f"({100 * busy / wall:.2f}%), {wall / per * 1e3:.3f} ms a {label.split()[0]} under the "
        f"profiler; {sum(e.count for e in events) / per:.0f} device activities each; the "
        f"largest, device ms each (calls each):")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / per / 1e3:.4f} ({e.count / per:.0f})  {e.key[:90]}")
    for what, names in (mine or {}).items():
        hit = [e for e in events if any(n in e.key for n in names)]
        ms = sum(e.self_device_time_total for e in hit) / per / 1e3
        log(f"    {what}: {ms:.4f} ms ({sum(e.count for e in hit) / per:.0f} calls), "
            f"{ms / (busy * 1e3 / per):.2%} of the busy time")


def serving_phase(torch, np, da, dev, card: str) -> tuple[dict, dict]:
    """Phase 7; returns K7's launches in the main serving run and K6's in
    the main prefill run, each by route."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer
    cfg = get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert n_params == cfg.param_count()[0], (n_params, cfg.param_count())
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv} KV heads, ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters "
        f"({weight_bytes / 1e9:.3f} GB bf16/f32), random from seed 0: "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = serve_prompts(np, cfg.vocab)
    xla = dataclasses.replace(cfg, attn_impl="xla")
    oracle_model = build_model(xla, dev)

    # the main path: SERVE_REQUESTS requests, K7 on every layer of every step
    da.counter.reset()
    run = serve(model, params, prompts, record=True)
    launches = da.counter.launches
    eng = run["engine"]
    steps = int(eng.metrics["steps"])
    times = np.asarray(run["times"]) * 1e3
    peak = torch.cuda.max_memory_allocated()
    k7_routes = dict(da.counter.routes)
    if launches == 0 or k7_routes != {"tc": steps * cfg.n_layers}:
        raise AssertionError(f"decode_attention launched {k7_routes} (by route) in {steps} "
                             f"steps of {cfg.n_layers} layers, not all on route tc")
    assert all(len(r.out_ids) == SERVE_NEW or r.out_ids[-1] == 2 for r in run["reqs"])
    lengths = eng.cache["length"].tolist()
    # the least a step can take: every weight read once (the embedding table
    # gives only B rows), and each slot's valid K/V prefix in every layer
    emb = params["embed"]
    step_bytes = weight_bytes - emb.numel() * emb.element_size()
    bound = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  served {len(prompts)} requests (prompts {min(map(len, prompts))}..."
        f"{max(map(len, prompts))} tokens, {SERVE_NEW} new each) with max_batch "
        f"{SERVE_BATCH}, max_seq {SERVE_SEQ}: wall {run['wall']:.3f} s, {steps} steps, "
        f"prefill_tokens {int(eng.metrics['prefill_tokens'])}, tokens_out "
        f"{int(eng.metrics['tokens_out'])}, {eng.metrics['tokens_out'] / run['wall']:.3f} "
        f"tokens/s out ({(eng.metrics['tokens_out'] + eng.metrics['prefill_tokens']) / run['wall']:.3f} "
        f"with prefill)")
    log(f"  step ms: median {np.median(times):.3f}, p90 {np.percentile(times, 90):.3f}, "
        f"min {times.min():.3f}, max {times.max():.3f}; bound {bound:.3f} ms "
        f"({step_bytes / 1e9:.3f} GB of weights read once at {HBM_BYTES_PER_S / 1e12} TB/s): "
        f"median {np.median(times) / bound:.2f}x the bound | {card}")
    log(f"  decode_attention launches {launches} = {steps} steps x {cfg.n_layers} layers, "
        f"by route {k7_routes}; "
        f"max_memory_allocated {peak / 1e9:.3f} GB; final lengths {lengths}")

    # device busy share over PROFILED_STEPS steps of the same traffic, under
    # the profiler
    warm = serve(model, params, prompts, steps=40)
    weng = warm["engine"]

    def profiled_steps():
        for _ in range(PROFILED_STEPS):
            weng.step()
    profile_window(torch, profiled_steps, PROFILED_STEPS,
                   f"step (profiled window, steps 41-{40 + PROFILED_STEPS})",
                   {"K7": DECODE_KERNELS})
    del warm, weng

    # check 2: the same requests, attention on the einsum path
    oracle = serve(oracle_model, params, prompts, record=True)
    equal, parted, worst, widest = same_streams(torch, run, oracle, "serving, K7 vs xla")
    log(f"  attn_impl='xla' oracle (same weights): wall {oracle['wall']:.3f} s, "
        f"{int(oracle['engine'].metrics['steps'])} steps; {equal} of "
        f"{sum(len(r.out_ids) for r in run['reqs'])} tokens equal before any parting, "
        f"{parted} requests parted at a near-tie (widest oracle margin {widest:.4g}, limit "
        f"{NEAR_TIE}); max |logit diff| over compared steps {worst:.4g} (tolerance "
        f"{FULL_LOGIT_TOL})")
    assert oracle["engine"].cache["length"].tolist() == lengths
    del run, oracle

    # check 3: 64 teacher-forced decode steps, K7 against "xla"; then the
    # same steps with two deliberately wrong attentions, which the limits
    # must catch
    from repro_torch.kernels import ops as kops
    t_check = time.perf_counter()
    toks = torch.tensor([p[:64] for p in prompts[:SERVE_BATCH]], dtype=torch.int32, device=dev)
    want = teacher_forced(torch, transformer, params, toks, xla, dev)
    readings = logit_readings(teacher_forced(torch, transformer, params, toks, cfg, dev), want)
    log(f"  64 teacher-forced steps x {SERVE_BATCH} slots, K7 vs xla: max |logit diff| "
        f"{readings[0]:.4g} (limit {FULL_LOGIT_TOL}), mean {readings[1]:.4g} (limit "
        f"{MEAN_LOGIT_TOL}), top-1 agreement {readings[2]:.4f} (at least {TOP1_AGREE_MIN})")
    assert within_logit_limits(readings), readings
    wrong = {
        "softmax scale 1/D, not 1/sqrt(D)": lambda q, k, v, n, scale=None: da.decode_attention(
            q, k, v, n, scale=1.0 / q.shape[-1]),
        "the newest key left out (length - 1, at least 1)": lambda q, k, v, n, scale=None:
            da.decode_attention(q, k, v, (n - 1).clamp_min(1), scale=scale),
    }
    right = kops.decode_attention
    for name, fn in wrong.items():
        kops.decode_attention = fn
        try:
            bad = logit_readings(teacher_forced(torch, transformer, params, toks, cfg, dev), want)
        finally:
            kops.decode_attention = right
        log(f"  the same steps, K7 with {name}, vs xla: max |logit diff| {bad[0]:.4g}, mean "
            f"{bad[1]:.4g}, top-1 agreement {bad[2]:.4f}: "
            f"{'within the limits' if within_logit_limits(bad) else 'caught'}")
        if within_logit_limits(bad):
            raise AssertionError(f"check 3's limits do not catch K7 with {name}: {bad}")
    del want
    log(f"  check 3 (four teacher-forced runs): {time.perf_counter() - t_check:.1f} s")

    # prefill: B 4 x 1,024 tokens, every layer's attention on K6 (the main
    # path: the counters are reset just before it), against attn_impl="xla"
    # at the last position and every 128th
    from repro_torch.kernels import flash_attention as fa
    t_check = time.perf_counter()
    rng = np.random.default_rng(2)
    ptoks = torch.tensor(rng.integers(3, cfg.vocab, (YI_PREFILL_BATCH, YI_PREFILL_SEQ)),
                         dtype=torch.int32, device=dev)
    fa.counter.reset()
    with torch.inference_mode():
        model.prefill(params, ptoks)
    torch.cuda.synchronize()
    k6, k6_routes = fa.counter.launches, dict(fa.counter.routes)
    if k6_routes != {"tc": cfg.n_layers}:
        raise AssertionError(f"yi-6b prefill launched flash_attention {k6} times by route "
                             f"{k6_routes}, not {cfg.n_layers} on the tensor cores (tc)")
    times = prefill_ms(torch, model, params, ptoks)
    positions = list(range(127, YI_PREFILL_SEQ, 128))
    readings = logit_readings(logits_at(torch, transformer, params, ptoks, cfg, positions),
                              logits_at(torch, transformer, params, ptoks, xla, positions))
    log(f"  prefill {YI_PREFILL_BATCH} x {YI_PREFILL_SEQ} tokens, attn_impl auto (K6): "
        f"flash_attention launches {k6} = {cfg.n_layers} layers, by route {k6_routes}; wall ms "
        f"{times} (median {np.median(times):.3f}) | {card}")

    def yi_prefill():
        with torch.inference_mode():
            model.prefill(params, ptoks)
    profile_window(torch, yi_prefill, 1, "prefill (profiled)", {"K6": ("flash_tc", "flash_fwd")})
    log("  " + show_readings(f"K6 vs xla at positions 127, 255, ..., {YI_PREFILL_SEQ - 1}",
                             readings, YI_PREFILL_LIMITS))
    assert within_logit_limits(readings, YI_PREFILL_LIMITS), readings
    log(f"  the prefill's checks: {time.perf_counter() - t_check:.1f} s")

    # check 4: one request alone, then beside seven others
    t_check = time.perf_counter()
    short = [p[:96] for p in prompts[:SERVE_BATCH]]
    alone = serve(model, params, short[:1])["reqs"][0].out_ids
    mixed = serve(model, params, short)["reqs"][0].out_ids
    assert alone == mixed, (alone, mixed)
    log(f"  slot isolation: request 0 ({len(short[0])}-token prompt) alone and beside 7 "
        f"others gives the same {len(alone)} tokens: {time.perf_counter() - t_check:.1f} s")
    t_check = time.perf_counter()

    # check 5: max_seq 64 and a request of 100 tokens in all
    long = serve_prompts(np, cfg.vocab, n=1, seed=1)
    long[0] = long[0][:100 - SERVE_NEW]
    runs = [serve(m, params, long, max_seq=64, record=True) for m in (model, oracle_model)]
    torch.cuda.synchronize()
    equal, parted, worst, _ = same_streams(torch, runs[0], runs[1], "max_seq 64")
    lengths = runs[0]["engine"].cache["length"].tolist()
    assert lengths == runs[1]["engine"].cache["length"].tolist() and min(lengths) > 64, lengths
    log(f"  max_seq 64, a {len(long[0])}-token prompt + {SERVE_NEW} new: no fault, final "
        f"lengths {lengths}; {equal} tokens equal to the xla run, {parted} parted at a "
        f"near-tie, max |logit diff| {worst:.4g}: {time.perf_counter() - t_check:.1f} s")
    del runs, model, oracle_model, params
    torch.cuda.empty_cache()
    return k7_routes, k6_routes


# -----------------------------------------------------------------------------
# phase 8: prefill of recurrentgemma-9b at full width
# -----------------------------------------------------------------------------
def prefill_phase(torch, np, fa, ls, dev, card: str) -> tuple[dict, dict]:
    """Phase 8; returns K5's and K6's launches in the main prefill run, and
    K6's by route."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model, transformer
    cfg = get_config(PREFILL_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    lam_gen = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for p in params["layers"]:
            if "rglru" in p:
                p["rglru"]["lam"].copy_(griffin_lam(torch, cfg.rnn_width_, lam_gen))
    torch.cuda.synchronize()
    kinds = transformer.layer_kinds(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers ({kinds.count('rglru')} rglru, "
        f"{kinds.count('local')} local, window {cfg.window}), d {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv} KV head, head dim {cfg.head_dim_}, "
        f"ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters ({cfg.param_count()[0]} by "
        f"the config's count, which leaves out each rglru layer's {cfg.rnn_width_} Λ), random "
        f"from seed 0, Λ as Griffin's init: {time.perf_counter() - t0:.1f} s")
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    rng = np.random.default_rng(3)
    toks = torch.tensor(rng.integers(3, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ)),
                        dtype=torch.int32, device=dev)
    counters = {"linear_scan": ls.counter, "flash_attention": fa.counter}

    # the main path: one prefill, every RG-LRU on K5 and every local
    # attention on K6
    for c in counters.values():
        c.reset()
    with torch.inference_mode():
        last = model.prefill(params, toks)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    k6_routes = dict(fa.counter.routes)
    want = {"linear_scan": kinds.count("rglru"), "flash_attention": kinds.count("local")}
    if launches != want or k6_routes != {"tc": want["flash_attention"]}:
        raise AssertionError(f"prefill launches {launches} (K6 by route {k6_routes}), want "
                             f"{want}, K6 all on the tensor cores (tc)")
    assert last.shape == (PREFILL_BATCH, cfg.vocab) and bool(torch.isfinite(last).all())
    times = prefill_ms(torch, model, params, toks)
    peak = torch.cuda.max_memory_allocated()
    log(f"  prefill {PREFILL_BATCH} x {PREFILL_SEQ} tokens, attn_impl auto: launches "
        f"{launches} = one a layer, K6 by route {k6_routes}; wall ms {times} (median "
        f"{np.median(times):.3f}, "
        f"{PREFILL_BATCH * PREFILL_SEQ / np.median(times) * 1e3:.1f} tokens/s); "
        f"max_memory_allocated {peak / 1e9:.3f} GB | {card}")

    def one_prefill():
        with torch.inference_mode():
            model.prefill(params, toks)
    profile_window(torch, one_prefill, 1, "prefill (profiled)",
                   {"K6": ("flash_tc", "flash_fwd"),
                    "K5": ("lin_walk",)})

    # check 1: the "chunked" forward (einsum attention; K5 as well) at the
    # last position and every 64th.  Every check below runs and prints
    # before the phase fails on any of them.
    failures = []
    positions = list(range(63, PREFILL_SEQ, 64))
    want = logits_at(torch, transformer, params, toks, chunked, positions)
    got = logits_at(torch, transformer, params, toks, cfg, positions)
    readings = logit_readings(got, want)
    log("  " + show_readings(f"K6 vs chunked at positions 63, 127, ..., {PREFILL_SEQ - 1}",
                             readings, RG_CHUNKED_LIMITS))
    if not within_logit_limits(readings, RG_CHUNKED_LIMITS):
        failures.append(f"K6 vs chunked outside the limits: {readings}")
    del got

    # check 2: two deliberately wrong kernels in kernels.ops, each of which
    # the limits must catch
    wrong = {
        "K6 ignoring the window": ("flash_attention",
                                   lambda q, k, v, *, causal=True, scale=None, window=None:
                                   fa.flash_attention(q, k, v, causal=causal, scale=scale)),
        f"K5 dropping the carry every {K5_WRONG_CUT} steps": (
            "linear_scan", lambda a, b: torch.cat(
                [ls.linear_scan(a[:, i:i + K5_WRONG_CUT], b[:, i:i + K5_WRONG_CUT])
                 for i in range(0, a.shape[1], K5_WRONG_CUT)], dim=1)),
    }
    for name, (attr, fn) in wrong.items():
        right = getattr(kops, attr)
        setattr(kops, attr, fn)
        try:
            bad = logit_readings(logits_at(torch, transformer, params, toks, cfg, positions), want)
        finally:
            setattr(kops, attr, right)
        caught = not within_logit_limits(bad, RG_CHUNKED_LIMITS)
        log("  " + show_readings(f"{name}, vs chunked", bad, RG_CHUNKED_LIMITS)
            + (": caught" if caught else ": within the limits"))
        if not caught:
            failures.append(f"the prefill limits do not catch {name}: {bad}")
    del want

    # check 3: teacher-forced decode over DECODE_STEPS tokens (past the
    # window: the local layers' ring buffers wrap) against the forward at
    # every position.  Decode runs no K5 and no K6: rglru_decode's one-step
    # recurrence and the ring buffer's einsum attention.
    steps = DECODE_STEPS
    dtoks = toks[:, :steps].contiguous()
    with torch.inference_mode():
        ref = transformer.logits(params, transformer.hidden(params, dtoks, cfg), cfg)
    for c in counters.values():
        c.reset()
    t = time.perf_counter()
    sums = torch.zeros(3, dtype=torch.float64, device=dev)   # max, sum of means, agreement
    with torch.inference_mode():
        cache = transformer.cache_init(cfg, PREFILL_BATCH, steps, dev)
        for i in range(steps):
            lg, cache = transformer.decode_step(params, dtoks[:, i], cache, cfg)
            d = (lg - ref[:, i]).abs()
            sums[0] = torch.maximum(sums[0], d.max())
            sums[1] += d.mean()
            sums[2] += (lg.argmax(-1) == ref[:, i].argmax(-1)).double().mean()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    assert all(c.launches == 0 for c in counters.values()), "decode launched K5 or K6"
    worst, total, agree = sums.tolist()
    readings = (worst, total / steps, agree / steps)
    log(f"  teacher-forced decode, {PREFILL_BATCH} x {steps} steps: {wall:.1f} s "
        f"({wall / steps * 1e3:.3f} ms a step), no K5 / K6 launch")
    log("  " + show_readings("decode vs the K5 / K6 forward at every position", readings,
                             RG_DECODE_LIMITS))
    if not within_logit_limits(readings, RG_DECODE_LIMITS):
        failures.append(f"decode vs forward outside the limits: {readings}")
    del ref, cache, model, params
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return launches, k6_routes


# -----------------------------------------------------------------------------
# -----------------------------------------------------------------------------
# phase 9: DIFFERENCE / DROP-DUPLICATES and the fusion pass at full size
# -----------------------------------------------------------------------------
# bench_dedup.py's duplicate-heavy frame and its right-hand side (seed 12),
# cut from 16,000,000 and 4,000,000 rows to keep phase 9 near 120 s: at
# 16M the two chains took 63 s of the phase's 173 s on an H100, host-bound
DUP_ROWS = 4_000_000
DUP_RIGHT_ROWS = 1_000_000
DUP_STRINGS = tuple(f"s{i:02d}" for i in range(12))
# the taxi difference's left side: rows [0, 1M), cut from 4M to pay for
# phase 11 and for compiled map / predicate runs (its host-bound key
# factorization took 21.6 s at 4M on an H100)
DIFF_LEFT_ROWS = 1_000_000
FLOATS = [f"f{j}" for j in range(6)]
# bench_dedup.py's three modes: (REPRO_* knobs, optimize)
DEDUP_MODES = {"serial": ({"REPRO_BLOCK_DEDUP": "0"}, False), "block": ({}, False),
               "fused": ({}, True)}
K1_NAMES, K4_NAMES = ("seg_reg", "seg_pass"), ("scan_one_pass",)


def dup_numpy(np, n: int, seed: int):
    """bench_dedup.py's ``_dup_frame`` columns in numpy: k, v, x and the
    codes of s (over DUP_STRINGS)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 8, n, dtype=np.int32)
    v = rng.integers(0, 20, n, dtype=np.int32)
    x = (rng.integers(0, 12, n) * np.float32(0.25)).astype(np.float32)
    s = rng.integers(0, 12, n, dtype=np.int32)
    return k, v, x, s


def dup_frame(torch, np, dev, n: int, seed: int):
    from repro_torch.core import Domain
    from repro_torch.core.frame import Column, Frame
    from repro_torch.core.labels import RangeLabels, labels_from_values
    k, v, x, s = (torch.from_numpy(a).to(dev) for a in dup_numpy(np, n, seed))
    cols = [Column(k, Domain.INT), Column(v, Domain.INT), Column(x, Domain.FLOAT),
            Column(s, Domain.STR, None, DUP_STRINGS)]
    return Frame(cols, RangeLabels(n), labels_from_values(["k", "v", "x", "s"]), device=dev)


def scale_udf(col: str):
    """``col -> col * 2 + 1`` (bench_dedup.py's map), on the device."""
    from repro_torch.core import Domain
    from repro_torch.core import algebra as alg
    from repro_torch.core.frame import Column

    def fn(cols, frame):
        out = dict(cols)
        c = cols[col]
        out[col] = Column(c.data * 2.0 + 1.0, Domain.FLOAT, c.mask, None)
        return out
    return alg.Udf(name=f"algebra_scale_{col}", fn=fn, deps=frozenset([col]), elementwise=True)


def scale3_udf(col: str):
    """``col -> col * 3 + 1``: the multiply is inexact, so a compiled
    program that fused it with the add into one FMA would round otherwise
    than eager's two kernels."""
    from repro_torch.core import Domain
    from repro_torch.core import algebra as alg
    from repro_torch.core.frame import Column

    def fn(cols, frame):
        out = dict(cols)
        c = cols[col]
        out[col] = Column(c.data * 3.0 + 1.0, Domain.FLOAT, c.mask, None)
        return out
    return alg.Udf(name=f"algebra_scale3_{col}", fn=fn, deps=frozenset([col]), elementwise=True)


@contextlib.contextmanager
def knobs(env: dict):
    """Set ``REPRO_*`` knobs for a block, restoring them after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, old in saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old


class call_clock:
    """Host seconds in the functions ``names`` of ``module`` (summed over the
    pool's threads, which run them) and their calls, while the block runs."""

    def __init__(self, module, names: tuple):
        import threading
        self.M, self.lock = module, threading.Lock()
        self.secs = dict.fromkeys(names, 0.0)
        self.calls = dict.fromkeys(names, 0)

    def _wrap(self, name: str, fn):
        def clocked(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                with self.lock:
                    self.secs[name] += time.perf_counter() - t0
                    self.calls[name] += 1
        return clocked

    def __enter__(self):
        self.orig = {n: getattr(self.M, n) for n in self.secs}
        for n, fn in self.orig.items():
            setattr(self.M, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.M, n, fn)
        return False


def lazy_session(dev, optimize: bool = True):
    """A LAZY session (statements chain unevaluated, so the fusion pass sees
    the whole chain at collect) with the ordered phase's 16 GiB cache."""
    from repro_torch.core import EvalMode, Session
    return Session(mode=EvalMode.LAZY, device=dev, optimize=optimize,
                   cache_budget_bytes=ORDERED_CACHE)


def run_keys(run, label: str, fn):
    """``run(label, fn)`` with the host key work clocked and logged."""
    from repro_torch.core import physical
    with call_clock(physical, ("_row_keys", "_keys_to_ids")) as clock:
        out = run(label, fn)
    log(f"    host keys: _row_keys {clock.secs['_row_keys']:.3f} s in "
        f"{clock.calls['_row_keys']} calls (summed over pool threads), _keys_to_ids "
        f"{clock.secs['_keys_to_ids']:.3f} s in {clock.calls['_keys_to_ids']}")
    return out


def counter_delta(counter, before: tuple) -> tuple[int, dict]:
    launches, routes = before
    return (counter.launches - launches,
            {r: n - routes.get(r, 0) for r, n in counter.routes.items() if n - routes.get(r, 0)})


def fused_info(s, df) -> dict:
    """The session's dedup and gather counters, and the fusion counters of
    the statement's plan alone, prepared by a fresh executor over the
    session's frames beside the stage ops of its fused pipelines
    (``bench_blocking_fusion.py``'s invariant; the session's own counters
    also hold the chain's intermediate statements)."""
    from repro_torch.core.executor import Executor
    ex = Executor(s.frames, optimize=s.executor.optimize)
    try:
        plan = ex._prepared(df._node)
        fs = ex.stats
        pipe = sum(len(n.params["stages"]) for n in plan.walk() if n.op == "fused_pipeline")
        out = {k: getattr(fs, k) for k in ("barrier_fused_groups", "fused_stage_ops",
                                            "producer_stage_ops", "consumer_stage_ops")}
    finally:
        ex.shutdown()
    st = s.executor.stats
    return dict(out, pipeline_ops=pipe, top=plan.op, gather_rows=st.gather_rows,
                dedup_blocks=st.dedup_blocks, dedup_key_rows=st.dedup_key_rows)


def sort_query(df):
    srt = df.sort_values("f0")
    return srt[srt["f1"] > 0][["f0", "f1"]]


def join_query(df, s):
    from repro_torch.core import DataFrame
    rates = {"passenger_count": [1, 2, 3, 4, 5, 6], "rate": RATES}
    j = df.merge(DataFrame(rates, session=s), on="passenger_count")
    return j[j["rate"] > 3.0]


def fresh(s, q):
    """``q.collect`` with the session's cache emptied first, so that a
    profiler window taken again evaluates the plan again."""
    def collect():
        s.executor.cache.clear()
        return q.collect()
    return collect


def algebra_steps(run, dev, taxi, dup, right, dedup: bool = True) -> dict:
    """Phase 9's steps, each in a fresh LAZY session; ``run(label, thunk,
    kernels=...)`` runs each (timed, or under the profiler).  Returns the
    results, the sessions' counters and the K1 / K4 launches of each fused
    / unfused step.  The fused operators go first: the card's profiler has
    lost the later windows of a process.  ``dedup=False`` leaves out the
    dedup chains and the taxi dedup / difference (host-bound: the profiled
    rerun keeps to the steps with kernel time to read)."""
    from repro_torch.core import DataFrame
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.kernels import window_scan as ws
    out: dict = {"info": {}}

    # the barrier-fused operators, fused (optimize=True) and per node
    for optimize in (True, False):
        tag = "fused" if optimize else "unfused"

        def session():
            s = lazy_session(dev, optimize)
            return s, DataFrame(taxi, session=s)

        s, df = session()
        m = df.map_udf(scale_udf("f0"))
        q = m[m["f1"] > 0].groupby("passenger_count").agg({"f0": ["sum", "mean", "min", "max"]})
        before = (sr.counter.launches, dict(sr.counter.routes))
        out[f"groupby_{tag}"] = run(f"map -> filter -> groupby().agg(4), {tag}", fresh(s, q),
                                    kernels=K1_NAMES)
        out["info"][f"groupby_{tag}"] = dict(fused_info(s, q), k1=counter_delta(sr.counter, before))
        s.close()

        s, df = session()
        q = df[df["f1"] > 0].cumsum(cols=FLOATS).map_udf(scale_udf("f0"))
        before = (ws.counter.launches, {})
        out[f"window_{tag}"] = run(f"filter -> cumsum(6 columns) -> map, {tag}", fresh(s, q),
                                   kernels=K4_NAMES)
        out["info"][f"window_{tag}"] = dict(fused_info(s, q), k4=counter_delta(ws.counter, before))
        s.close()

        s, df = session()
        q = sort_query(df)
        out[f"sort_{tag}"] = run(f"sort_values(f0) -> filter -> project, {tag}", fresh(s, q))
        out["info"][f"sort_{tag}"] = fused_info(s, q)
        s.close()

        s, df = session()
        q = join_query(df, s)
        out[f"join_{tag}"] = run(f"merge(rates) -> filter, {tag}", fresh(s, q))
        out["info"][f"join_{tag}"] = fused_info(s, q)
        s.close()

    if not dedup:
        return out
    # bench_dedup.py's two chains in its three modes
    for mode, (env, optimize) in DEDUP_MODES.items():
        with knobs(env):
            for chain in ("dropdup", "difference"):
                s = lazy_session(dev, optimize)
                d = DataFrame(dup, session=s).map_udf(scale_udf("x"))
                q = (d[d["v"] > 10].drop_duplicates() if chain == "dropdup"
                     else d.difference(DataFrame(right, session=s)))
                label = {"dropdup": "map_filter_dropdup", "difference": "map_difference"}[chain]
                out[f"{chain}_{mode}"] = run_keys(run, f"{label}, {mode}", fresh(s, q))
                out["info"][f"{chain}_{mode}"] = fused_info(s, q)
                s.close()

    # the taxi frame: dedup on two keys, and a difference
    s = lazy_session(dev)
    df = DataFrame(taxi, session=s)
    q = df.drop_duplicates(subset=["passenger_count", "payment_type"])
    out["taxi_dedup"] = run_keys(run, "drop_duplicates(passenger_count, payment_type)",
                                 fresh(s, q))
    left = DataFrame(taxi.head(DIFF_LEFT_ROWS), session=s)
    q = left.difference(df[df["f0"] > 0])
    out["taxi_difference"] = run_keys(run, f"rows [0, {DIFF_LEFT_ROWS}) .difference(f0 > 0)",
                                      fresh(s, q))
    s.close()
    return out


def algebra_serial(dev, taxi) -> dict:
    """Fused SORT and JOIN on the serial whole-frame path (REPRO_SHUFFLE=0),
    the oracle of the exchange."""
    from repro_torch.core import DataFrame
    with knobs({"REPRO_SHUFFLE": "0"}):
        s = lazy_session(dev)
        df = DataFrame(taxi, session=s)
        out = {"sort": timed("serial fused sort + collect", sort_query(df).collect),
               "join": timed("serial fused merge + collect", join_query(df, s).collect)}
        s.close()
    return out


def check_algebra(torch, np, dev, out: dict, serial: dict) -> None:
    """Phase 9's results: the three dedup modes bit-identical and equal to
    numpy's first occurrences / anti-join; fused equal to per node bit for
    bit, with the counters and launches the fused plans must show."""
    from repro_torch.core.frame import host
    from repro_torch.core.schedule import GRID_PREFS, preferred_row_parts
    info = out["info"]
    dt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # 1. the dedup chains: three modes bit-identical, then numpy
    k, v, x, s = dup_numpy(np, DUP_ROWS, 11)
    xm = x * np.float32(2.0) + np.float32(1.0)
    key = ((k.astype(np.int64) * 20 + v) * 32 + (xm * 4).astype(np.int64)) * 12 + s
    rk, rv, rx, rs = dup_numpy(np, DUP_RIGHT_ROWS, 12)
    rkey = ((rk.astype(np.int64) * 20 + rv) * 32 + (rx * 4).astype(np.int64)) * 12 + rs
    kept = np.flatnonzero(v > 10)
    _, first = np.unique(key[kept], return_index=True)
    want = {"dropdup": np.sort(kept[first]),
            "difference": np.flatnonzero(~np.isin(key, np.unique(rkey)))}
    for chain, rows in want.items():
        for mode in ("block", "fused"):
            assert same_frame(torch, np, out[f"{chain}_serial"], out[f"{chain}_{mode}"]), \
                f"{chain}: {mode} != serial"
        got = out[f"{chain}_fused"]
        assert np.array_equal(label_array(np, got.row_labels), rows), f"{chain}: rows"
        for name, col in (("k", k), ("v", v), ("x", xm), ("s", s)):
            assert torch.equal(got.col(name).data, dt(col[rows])), (chain, name)
            assert got.col(name).mask is None, (chain, name)
        assert got.col("s").dictionary == DUP_STRINGS
        fi, bi, si = (info[f"{chain}_{m}"] for m in ("fused", "block", "serial"))
        assert fi["top"] == f"fused_{'drop_duplicates' if chain == 'dropdup' else 'difference'}"
        assert fi["barrier_fused_groups"] >= 1 and fi["producer_stage_ops"] >= 1, (chain, fi)
        assert fi["fused_stage_ops"] == (fi["pipeline_ops"] + fi["producer_stage_ops"]
                                         + fi["consumer_stage_ops"]), (chain, fi)
        assert bi["dedup_blocks"] > si["dedup_blocks"] and fi["dedup_key_rows"] > 0, chain
        assert fi["gather_rows"] == bi["gather_rows"] == si["gather_rows"] == rows.size, chain
        log(f"  {chain}: {rows.size} rows, bit-identical in the three modes and equal to "
            f"numpy; dedup_blocks serial {si['dedup_blocks']}, block {bi['dedup_blocks']}, "
            f"fused {fi['dedup_blocks']}")

    # 2. the taxi frame
    pc, cols, nulls, pay = taxi_numpy(np)
    _, first = np.unique(pc * 3 + pay, return_index=True)
    rows = np.sort(first)
    got = out["taxi_dedup"]
    assert got.nrows == 18 and np.array_equal(label_array(np, got.row_labels), rows), \
        label_array(np, got.row_labels)
    assert torch.equal(got.col("passenger_count").data, dt(pc[rows].astype(np.int32)))
    assert got.col("payment_type").to_pylist() == [PAYMENT[i] for i in pay[rows]]
    n = DIFF_LEFT_ROWS
    # the left rows are distinct: rows that share (f0, f1) as stored differ
    # in another column or a mask
    stored = [np.where(nulls[j][:n], np.float32(0.0), cols[j][:n]).view(np.uint32)
              for j in range(6)]
    pair = (stored[0].astype(np.uint64) << np.uint64(32)) | stored[1].astype(np.uint64)
    order = np.argsort(pair, kind="stable")
    same = pair[order][1:] == pair[order][:-1]
    row = lambda i: (pc[i], pay[i], *(c[i] for c in stored), *(nl[i] for nl in nulls))
    for a, b in zip(order[:-1][same], order[1:][same]):
        assert row(a) != row(b), f"taxi rows {a} and {b} are equal"
    f0, valid = cols[0][:n], ~nulls[0][:n]
    rows = np.flatnonzero(~(valid & (f0 > 0)))
    got = out["taxi_difference"]
    assert np.array_equal(label_array(np, got.row_labels), rows), "taxi difference: rows"
    assert torch.equal(got.col("f0").mask, dt(valid[rows]))
    assert torch.equal(got.col("f0").data, dt(np.where(nulls[0], 0.0, cols[0])[:n][rows]
                                                .astype(np.float32)))
    log(f"  taxi: drop_duplicates gives the 18 first occurrences; difference keeps the "
        f"{rows.size} left rows with f0 <= 0 or null, in left order")

    # 3. fused GROUPBY on K1
    g, gi = out["groupby_fused"], info["groupby_fused"]
    assert same_frame(torch, np, g, out["groupby_unfused"]), "groupby: fused != per node"
    assert gi["top"] == "fused_groupby" and gi["barrier_fused_groups"] >= 1, gi
    assert gi["fused_stage_ops"] == (gi["pipeline_ops"] + gi["producer_stage_ops"]
                                     + gi["consumer_stage_ops"]), gi
    blocks = preferred_row_parts(taxi_blocks(), GRID_PREFS["fused_groupby"])
    launches, routes = gi["k1"]
    # one launch a block for each reduce op: sum (sum, count and presence
    # stacked), min, max
    assert launches == 3 * blocks and routes == {"reg": launches}, (launches, routes, blocks)
    sel = ~nulls[1] & (cols[1] > 0)
    fm = (np.where(nulls[0], 0.0, cols[0]).astype(np.float32) * np.float32(2.0)
          + np.float32(1.0))
    ok = sel & ~nulls[0]
    for gid in range(6):
        seg = fm[ok & (pc == gid + 1)]
        assert g.col("f0_min").to_pylist()[gid] == float(seg.min())
        assert g.col("f0_max").to_pylist()[gid] == float(seg.max())
    log(f"  groupby: fused == per node bit for bit; min / max equal numpy; K1 {launches} "
        f"launches (3 a block over {blocks} blocks), routes {routes}")

    # 4. fused WINDOW on K4
    w, wi = out["window_fused"], info["window_fused"]
    assert same_frame(torch, np, w, out["window_unfused"]), "window: fused != per node"
    assert wi["top"] == "fused_window" and wi["barrier_fused_groups"] >= 1, wi
    wblocks = preferred_row_parts(taxi_blocks(), GRID_PREFS["fused_window"])
    launches, _ = wi["k4"]
    assert launches == 6 * wblocks, (launches, wblocks)
    assert np.array_equal(label_array(np, w.row_labels), np.flatnonzero(sel))
    log(f"  window: fused == per node bit for bit; K4 {launches} launches (6 columns a "
        f"block over {wblocks} blocks)")

    # 5. fused SORT and JOIN consumers
    for op in ("sort", "join"):
        f, u = info[f"{op}_fused"], info[f"{op}_unfused"]
        assert f["top"] == f"fused_{op}", f
        assert same_frame(torch, np, out[f"{op}_fused"], out[f"{op}_unfused"]), f"{op}: fused != per node"
        assert same_frame(torch, np, out[f"{op}_fused"], serial[op]), f"{op}: exchange != serial"
        assert 0 < f["gather_rows"] < u["gather_rows"], (op, f["gather_rows"], u["gather_rows"])
        log(f"  {op}: fused == per node == serial bit for bit; gather_rows {f['gather_rows']} "
            f"fused, {u['gather_rows']} per node")
    perm = np.argsort(np.where(nulls[0], np.inf, cols[0].astype(np.float64)), kind="stable")
    assert np.array_equal(label_array(np, out["sort_fused"].row_labels), perm[sel[perm]])


# phase 9's map -> filter chains, compiled (REPRO_JIT_UDFS unset: the card's
# default) and eager (REPRO_JIT_UDFS=0): {label: (frame, columns, filter,
# udf)}.  Each projects its numeric columns first: a map run over a frame
# with a coded (string) column stays eager, as the reference's does
def jit_queries(taxi, dup) -> dict:
    floats = ["f0", "f1", "f2"]
    return {"taxi[f0, f1, f2]: f0 * 2 + 1 -> f1 > 0":
            (taxi, floats, lambda m: m[m["f1"] > 0], scale_udf("f0")),
            "taxi[f0, f1, f2]: f0 * 3 + 1 -> f0 > 2.5":
            (taxi, floats, lambda m: m[m["f0"] > 2.5], scale3_udf("f0")),
            "dup[k, v, x]: x * 2 + 1 -> v > 10":
            (dup, ["k", "v", "x"], lambda m: m[m["v"] > 10], scale_udf("x"))}


@contextlib.contextmanager
def jit_mode(value: str | None):
    """``REPRO_JIT_UDFS`` set to ``value`` (None: unset) for a block."""
    saved = os.environ.pop("REPRO_JIT_UDFS", None)
    if value is not None:
        os.environ["REPRO_JIT_UDFS"] = value
    try:
        yield
    finally:
        os.environ.pop("REPRO_JIT_UDFS", None)
        if saved is not None:
            os.environ["REPRO_JIT_UDFS"] = saved


def jit_chains(torch, np, dev, taxi, dup) -> None:
    """The map -> filter chains of ``jit_queries``, each in a fresh LAZY
    session with compiled map and predicate runs (the first run probes and
    compiles, the second reuses the programs) and eagerly: bit-identical;
    the statement walls both ways."""
    from repro_torch.core import DataFrame
    for label, (frame, cols, filt, udf) in jit_queries(taxi, dup).items():
        got, walls = {}, {}
        for mode, value in (("compiled", None), ("compiled again", None), ("eager", "0")):
            with jit_mode(value):
                s = lazy_session(dev)
                q = filt(DataFrame(frame, session=s)[cols].map_udf(udf))
                t0 = time.perf_counter()
                got[mode] = q.collect()
                torch.cuda.synchronize()
                walls[mode] = time.perf_counter() - t0
                s.close()
        for mode in ("compiled", "compiled again"):
            if not same_frame(torch, np, got[mode], got["eager"]):
                raise AssertionError(f"phase 9 {label}: {mode} != eager")
        log(f"  {label}: {got['eager'].nrows} rows, compiled == eager bit for bit; walls "
            f"compiled {walls['compiled']:.3f} s (the probe and compile included), again "
            f"{walls['compiled again']:.3f} s, eager {walls['eager']:.3f} s")


def probe_stall(torch, np, dev, taxi) -> None:
    """``jit_queries``' first chain (its programs adopted) alone, and again
    while a chain never run before (f1 * 2 + 1 -> f2 > 0) probes, traces
    and compiles, in a second thread: the adopted chain's blocks that meet
    the probe's gate run eagerly instead of waiting.  Both statements are
    held to eager bit for bit."""
    import threading
    from repro_torch.core import DataFrame, physical
    floats = ["f0", "f1", "f2"]
    chains = {"adopted": (lambda m: m[m["f1"] > 0], scale_udf("f0")),
              "new": (lambda m: m[m["f2"] > 0], scale_udf("f1"))}

    def run(name: str, value: str | None = None):
        filt, udf = chains[name]
        with jit_mode(value):
            s = lazy_session(dev)
            t0 = time.perf_counter()
            out = filt(DataFrame(taxi, session=s)[floats].map_udf(udf)).collect()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            s.close()
        return out, wall

    _, alone = run("adopted")
    before = physical.jit_stats()
    probing = {}
    second = threading.Thread(target=lambda: probing.update(zip(("out", "wall"), run("new"))))
    second.start()
    t0 = time.perf_counter()
    while not physical._GATE._alone and second.is_alive() and time.perf_counter() - t0 < 60:
        time.sleep(0.001)
    overlapped = physical._GATE._alone
    during, wall = run("adopted")
    second.join()
    after = physical.jit_stats()
    for name, got in (("adopted", during), ("new", probing["out"])):
        if not same_frame(torch, np, got, run(name, "0")[0]):
            raise AssertionError(f"phase 9 probe stall: the {name} chain != eager")
    log(f"  an adopted chain (f0 * 2 + 1 -> f1 > 0) alone {alone:.3f} s; while f1 * 2 + 1 -> "
        f"f2 > 0 probes in a second thread (its statement {probing['wall']:.3f} s, "
        f"{after['compile_s'] - before['compile_s']:.2f} s in its probes' compiled first "
        f"calls; the gate {'held' if overlapped else 'not yet held'} as the adopted chain "
        f"started) {wall:.3f} s; {after['eager_blocks'] - before['eager_blocks']} blocks of "
        f"adopted chains ran eagerly meanwhile instead of waiting; both bit-identical to eager")


def taxi_blocks() -> int:
    """The taxi frame's row blocks in a session (its default grid)."""
    from repro_torch.core.partition import default_grid
    return default_grid(TAXI_ROWS, 8)[0]


def same_algebra(torch, np, a: dict, b: dict) -> None:
    """The profiled rerun's phase-9 results equal the timed run's."""
    for k in b:
        if k != "info":
            assert same_frame(torch, np, a[k], b[k]), f"{k}: rerun differs"


def algebra_phase(torch, np, dev, taxi, counters: dict) -> dict:
    """Phase 9 over the taxi frame; returns the kernels' launches of its
    timed pass."""
    dup = timed(f"duplicate-heavy frame ({DUP_ROWS} rows) on the card",
                lambda: dup_frame(torch, np, dev, DUP_ROWS, 11))
    right = dup_frame(torch, np, dev, DUP_RIGHT_ROWS, 12)
    from repro_torch.core import physical
    for c in counters.values():
        c.reset()
    physical.reset_jit_stats()
    out = algebra_steps(timed, dev, taxi, dup, right)
    launches = {k: (c.launches, dict(c.routes)) for k, c in counters.items()}
    log(f"[algebra] launches {dict((k, n) for k, (n, _) in launches.items())}")
    check_algebra(torch, np, dev, out, algebra_serial(dev, taxi))
    log("[algebra] results match numpy, the serial paths and the per-node plans; the "
        "fused and per-node steps again under the CUDA profiler:")
    same_algebra(torch, np, out, algebra_steps(profiled, dev, taxi, dup, right, dedup=False))
    log("[algebra] the profiled rerun is bit-identical; map -> filter chains with compiled "
        "map and predicate runs (REPRO_JIT_UDFS unset, the card's default) and eager (=0):")
    jit_chains(torch, np, dev, taxi, dup)
    probe_stall(torch, np, dev, taxi)
    jit = physical.jit_stats()
    log(f"[algebra] compiled programs over phase 9: adopted {jit['adopted']}, rejected by reason "
        f"{jit['rejected']}, {jit['compile_s']:.2f} s in the probes' compiled first calls, "
        f"{jit['eager_blocks']} blocks of adopted chains run eagerly during a probe; "
        f"chains {jit['chains']}")
    if not sum(jit["adopted"].values()):
        raise AssertionError(f"phase 9: no chain adopted a compiled program: {jit}")
    return launches


# -----------------------------------------------------------------------------
# phase 10: the out-of-core engine under an HBM budget
# -----------------------------------------------------------------------------
OOC_BUDGET = 256 << 20     # the taxi frame is 2.3x this
CSV_ROWS = 250_000         # rows of the taxi frame written to CSV and read back (cut
#                            from 2,000,000 to pay for phase 11 and for compiled map /
#                            predicate runs)
OOC_CHAOS_SEED = 5
OOC_CHAOS_WORKER = 0.25    # the chaos plan's transient task-error rate
SVC_TENANTS = 3
CANCEL_ROWS, CANCEL_BLOCKS = 1_000_000, 64   # blocks >> pool width: the cancel
#                                              lands at a dispatch boundary
_DELTA_KEYS = ("spills", "faults", "spilled_bytes", "checksum_failures",
               "recomputed_blocks", "budget_overruns", "faults_injected")


def spill_dir(name: str) -> str:
    """A fresh spill directory under the checkout's build/ (not the host's
    temp space)."""
    import shutil
    d = ROOT / "build" / "spill" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return str(d)


def budget_blocks(cfg, nbytes: int) -> int:
    """Row blocks for ``nbytes`` under the store of ``cfg``: each at most
    ``schedule.budget_max_block_bytes()`` (budget // (2 x workers + 2)), the
    engine's own floor, so that every pool worker's pinned input block and
    its output block fit in the budget together.  Larger blocks (eight of
    ~76 MB) break the store's bound of budget + one block per worker: two
    blocks a worker are in flight."""
    from repro_torch.core import config
    from repro_torch.core.schedule import budget_max_block_bytes
    with config.scope(cfg):
        return -(-nbytes // budget_max_block_bytes())


def agg_query(df):
    """Fig. 6's groupby(n).agg(4) on f0."""
    return df.groupby("passenger_count").agg({"f0": ["sum", "mean", "min", "max"]})


def evaluate(s, node):
    """``node`` evaluated in session ``s``: the result's blocks behind the
    store's handles (``Session.collect`` without concatenating them into one
    frame on the card)."""
    from repro_torch.core import config
    with config.scope(s.config):
        return s.executor.evaluate(node)


def same_blocks(torch, np, pf, want) -> bool:
    """``pf``, one row block at a time (faulted in where spilled, copied to
    the host), equals the host frame ``want`` bit for bit."""
    lo = 0
    for row in pf.handles:
        b = row[0].frame()
        for h in row[1:]:
            b = b.concat_cols(h.frame())
        b = b.to("cpu")
        if not same_frame(torch, np, b, want.take_rows(np.arange(lo, lo + b.nrows))):
            return False
        lo += b.nrows
    return lo == want.nrows


def ooc_queries(df, s) -> dict:
    """Phase 10's five statements over ``df`` in session ``s``: the GROUPBY
    twice, on the frame (the unfused path) and behind a filter (fused into
    the GROUPBY's per-block programs, the engine's memory-governed path)."""
    from repro_torch.core import DataFrame
    rates = DataFrame({"passenger_count": [1, 2, 3, 4, 5, 6], "rate": RATES}, session=s)
    return {"agg": agg_query(df),
            "agg_fused": agg_query(df[df["f1"] > 0]),
            "cumsum": df.cumsum(cols=FLOATS),
            "sort": df.sort_values("f0"),
            "merge": df.merge(rates, on="passenger_count")}


# GROUPBY and WINDOW coarsen their grid to the pool (schedule.preferred_row_parts)
# unless the budget floor forbids it, so with the adaptive grid on, a budgeted and
# an unbudgeted run sum floats over different blocks; a fixed grid compares them
# bit for bit.  SORT and JOIN results are permutations, equal on any grid, and
# keep the adaptive output grid (a fixed one is a single output block).
FIXED_GRID = {"REPRO_ADAPT_GRID": "0"}
OOC_KNOBS = {"agg": FIXED_GRID, "agg_fused": FIXED_GRID, "cumsum": FIXED_GRID,
             "sort": {}, "merge": {}}

OOC_LABELS = {"agg": "groupby(passenger_count).agg(f0: sum, mean, min, max)",
              "agg_fused": "filter(f1 > 0) -> groupby(passenger_count).agg(f0: sum, mean, "
                           "min, max), fused",
              "cumsum": "cumsum() of f0..f5", "sort": "sort_values(f0)",
              "merge": "merge(rates, on=passenger_count)"}


def ooc_steps(torch, np, dev, taxi, counters) -> tuple:
    """The five statements unbudgeted, then in a session whose store holds
    OOC_BUDGET bytes of the card's memory, both over the same row blocks of
    the host frame ``taxi`` (``register_frame`` lands each block on the
    card).  The budgeted results, block by block, must equal the unbudgeted
    ones bit for bit; every statement must spill and fault; the store's peak
    counter must stay within budget + one block per pool worker, and so must
    the card's own peak (``torch.cuda.max_memory_allocated`` above what it
    held before the ingest) over the ingest and every statement but the
    unfused GROUPBY.  That one resolves every block of its input at once
    (its general path factorizes the keys over all blocks, as the JAX
    package's ``_groupby_blocks`` does), so the card holds its input frame
    beside the budget: its limit is the bound plus the frame.  Returns (the unbudgeted
    results on the host, the budgeted session, its frame's source node, the
    block count, K1 / K4 launches of the budgeted pass)."""
    import gc
    from repro_torch.core import DataFrame, EvalMode, Session
    from repro_torch.core import store as store_mod
    from repro_torch.core.schedule import pool_width
    s = Session(mode=EvalMode.LAZY, device=dev, mem_budget_bytes=OOC_BUDGET,
                spill_dir=spill_dir("ooc"))
    parts = budget_blocks(s.config, taxi.nbytes())
    plain = lazy_session(dev)
    try:
        qs = ooc_queries(DataFrame(session=plain,
                                   node=plain.register_frame(taxi, row_parts=parts)), plain)
        ref = {}
        for k, q in qs.items():
            with knobs(OOC_KNOBS[k]):
                out = timed(f"unbudgeted {OOC_LABELS[k]}", q.collect)
            ref[k] = out.to("cpu")
            del out
        del qs, q
    finally:
        plain.close()
    gc.collect()

    store = s.config.store
    st = store.stats
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    src = s.register_frame(taxi, row_parts=parts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    card = torch.cuda.max_memory_allocated() - base
    pf = s.frames[src.params["frame_id"]]
    biggest = block = max(h.nbytes for row in pf.handles for h in row)
    del pf
    bound = OOC_BUDGET + pool_width() * block
    log(f"  budgeted ingest (register_frame of the host frame, a block at a time onto the "
        f"card) of {taxi.nrows} rows in {parts} blocks of <= {block} bytes (the engine's "
        f"budget floor for {pool_width()} workers; frame {taxi.nbytes()} bytes, "
        f"{taxi.nbytes() / OOC_BUDGET:.2f}x the budget of {OOC_BUDGET} bytes, which stands "
        f"for a deployment's 80 GB card cut to fit the time limit): {wall:.3f} s, "
        f"{st.spills} spills, resident {st.resident_bytes} bytes; card peak +{card} bytes, "
        f"now +{torch.cuda.memory_allocated() - base}")
    assert card <= bound, f"ingest: card peak +{card} bytes > budget + workers x block {bound}"
    df = DataFrame(session=s, node=src)
    qs = ooc_queries(df, s)
    for c in counters.values():
        c.reset()
    # one pass, under the CUDA profiler (its walls are the profiled walls):
    # each statement evaluated once, a lost window not taken again
    for k, q in qs.items():
        s0 = (st.spills, st.faults, st.spilled_bytes, st.faulted_bytes)
        out = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the store's spill writes (_save_frame: the copy to the host,
        # np.savez, CRC32, the file write) and fault reads (_load_frame: the
        # file read, CRC32, np.load, the copy back to the card)
        with call_clock(store_mod, ("_save_frame", "_load_frame")) as clock, \
                knobs(OOC_KNOBS[k]):
            events, wall = device_window(torch, lambda: out.append(evaluate(s, q._node)),
                                         cuda_only=True, tries=1)
        card = torch.cuda.max_memory_allocated() - base
        got = out[-1]
        d = [b - a for a, b in zip(s0, (st.spills, st.faults, st.spilled_bytes,
                                        st.faulted_bytes))]
        biggest = max([biggest] + [h.nbytes for h in list(store._handles)])
        bound = OOC_BUDGET + pool_width() * biggest
        limit = bound + (taxi.nbytes() if k == "agg" else 0)
        if events is None:
            busy = "device busy not measured (the profiler lost the window)"
        else:
            dev_s = sum(e.self_device_time_total for e in events) / 1e6
            mine = sum(e.self_device_time_total for e in events
                       if any(n in e.key for n in ("seg_", "scan_one_pass"))) / 1e3
            busy = (f"device busy {dev_s * 1e3:.3f} ms ({100 * dev_s / wall:.2f}%), "
                    f"K1 / K4 {mine:.3f} ms")
        log(f"  budgeted {OOC_LABELS[k]}: {wall:.3f} s profiled wall, {busy}")
        log(f"    {d[0]} spills ({d[2]} bytes), {d[1]} faults ({d[3]} bytes); spill writes "
            f"{clock.secs['_save_frame']:.3f} s, fault reads {clock.secs['_load_frame']:.3f} s "
            f"(summed over pool threads); resident {st.resident_bytes} bytes; card peak "
            f"+{card} bytes (limit {limit}: budget + {pool_width()} workers x {biggest}"
            f"{' + the input frame, which the unfused GROUPBY holds' if k == 'agg' else ''})")
        assert d[0] > 0 and d[1] > 0, f"{k}: the budgeted statement did not spill and fault"
        assert card <= limit, f"{k}: card peak +{card} bytes over its limit {limit}"
        assert same_blocks(torch, np, got, ref[k]), f"{k}: budgeted != unbudgeted"
        del got, out
    launches = {n: (counters[n].launches, dict(counters[n].routes))
                for n in ("segment_reduce", "window_scan")}
    log(f"  budgeted == unbudgeted bit for bit for all five; store's peak resident "
        f"{st.peak_resident_bytes} bytes <= budget + {pool_width()} workers x {biggest} "
        f"= {bound}; launches {launches}")
    assert st.peak_resident_bytes <= bound, (st.peak_resident_bytes, bound)
    assert st.budget_overruns == 0 and st.checksum_failures == 0
    return ref, s, src, parts, launches


def ooc_chaos(torch, np, dev, taxi, parts: int) -> None:
    """The GROUPBY over a MAP's output (f0 + 1), whose blocks carry the
    lineage the engine recorded as it made them, in a budgeted session under
    a seeded plan: transient task errors at OOC_CHAOS_WORKER, and every read
    of one spilled MAP block's file corrupted (the store recomputes it from
    its source block).  Bit-identical to the same statements unbudgeted, and
    the recovery counters equal what the plan injected."""
    from repro_torch.core import DataFrame, EvalMode, Session, faults
    from repro_torch.core import algebra as alg
    udf = blocking_map(None, None)

    def mapped_agg(sess):
        pf = evaluate(sess, alg.Map(sess.register_frame(taxi, row_parts=parts), udf))
        return pf, agg_query(DataFrame(session=sess, node=sess.register_frame(pf)))

    plain = lazy_session(dev)
    try:
        with knobs(FIXED_GRID):
            want = mapped_agg(plain)[1].collect().to("cpu")
    finally:
        plain.close()
    s = Session(mode=EvalMode.LAZY, device=dev, mem_budget_bytes=OOC_BUDGET,
                spill_dir=spill_dir("chaos"))
    try:
        with knobs(FIXED_GRID):
            pf, q = mapped_agg(s)
        # picked once the plan is built (building it may fault a block)
        victim = next(h for row in pf.handles for h in row if not h.is_resident)
        assert victim._recompute is not None, "a MAP output block without lineage"
        del pf
        plan = f"worker:{OOC_CHAOS_WORKER},corrupt@blk{victim._id}/:1.0"
        faults.reset()
        faults.configure(plan=plan, seed=OOC_CHAOS_SEED)
        try:
            # the plan was built before the faults were configured, so every
            # injection lands inside the executor's attribution windows
            with knobs(FIXED_GRID):
                got = timed(f"chaos {OOC_LABELS['agg']} of f0 + 1 (a MAP's output) under "
                            f"{plan!r}, seed {OOC_CHAOS_SEED}", lambda: evaluate(s, q._node))
            fired = faults.injected_snapshot()
        finally:
            faults.reset()
        st = s.executor.stats
        store = s.config.store.stats
        log(f"    injected {fired}; retries {st.retries}, task failures {st.task_failures}, "
            f"checksum failures {st.checksum_failures}, recomputed blocks "
            f"{st.recomputed_blocks}, faults injected {st.faults_injected}")
        assert same_blocks(torch, np, got, want), "chaos GROUPBY != unbudgeted"
        assert fired.get("worker", 0) > 0 and fired.get("corrupt", 0) > 0, fired
        assert st.retries == st.task_failures == fired["worker"]
        assert st.checksum_failures == st.recomputed_blocks == fired["corrupt"]
        assert store.checksum_failures == store.recomputed_blocks == fired["corrupt"]
        assert st.faults_injected == sum(fired.values())
        log("  chaos: bit-identical; the corrupt MAP block recomputed from its lineage; "
            "the recovery counters equal the injections")
    finally:
        s.close()


def csv_text(np, taxi, n: int) -> tuple[str, dict]:
    """The first ``n`` rows of the taxi frame as CSV text (nulls empty), and
    the host columns it was written from.  Each float is written as its
    shortest float32 decimal where that parses back (through float64, as
    read_csv parses) to the same float32, else as its float64 repr."""
    from repro_torch.core.frame import host
    cols, names, text = {}, taxi.col_labels.to_list(), []
    for name, c in zip(names, taxi.columns):
        d = host(c.data[:n])
        valid = None if c.mask is None else host(c.mask[:n])
        if c.domain.is_coded:
            s = np.asarray(c.dictionary, dtype=object)[d].astype(str)
        elif d.dtype == np.float32:
            s = d.astype(str)
            bad = s.astype(np.float64).astype(np.float32).view(np.int32) != d.view(np.int32)
            if bad.any():
                s[bad] = d[bad].astype(np.float64).astype(str)
        else:
            s = d.astype(str)
        if valid is not None:
            s = np.where(valid, s, "")
        cols[name] = (d, valid, c.dictionary)
        text.append(s.tolist())            # joins of str lists, not numpy scalars
    body = "\n".join(map(",".join, zip(*text)))
    return ",".join(names) + "\n" + body + "\n", cols


def check_csv_frame(np, got, cols: dict) -> None:
    """read_csv's frame equals the columns it was written from: ints and
    float32 bit for bit, nulls where the masks say, strings by value."""
    from repro_torch.core.frame import host
    assert got.col_labels.to_list() == list(cols)
    for (name, (d, valid, table)), c in zip(cols.items(), got.columns):
        v = np.ones(d.shape[0], bool) if valid is None else valid
        gv = np.ones(d.shape[0], bool) if c.mask is None else host(c.mask)
        assert np.array_equal(gv, v), f"{name}: null mask differs"
        g = host(c.data)
        if table is not None:
            assert np.array_equal(np.asarray(c.dictionary, dtype=object)[g[v]],
                                  np.asarray(table, dtype=object)[d[v]]), name
        else:
            assert g.dtype == d.dtype, (name, g.dtype, d.dtype)
            assert np.array_equal(g[v].view(np.int32), d[v].view(np.int32)), name


def ooc_csv(torch, np, dev, taxi) -> None:
    """CSV ingest of CSV_ROWS taxi rows into a budgeted session, then the
    Fig. 6 GROUPBY on it, checked against numpy."""
    from repro_torch.core import EvalMode, Session, read_csv
    path = Path(spill_dir("csv")) / "taxi.csv"
    t0 = time.perf_counter()
    text, cols = csv_text(np, taxi, CSV_ROWS)
    path.write_text(text)
    size = path.stat().st_size
    log(f"  wrote {CSV_ROWS} taxi rows as {size} bytes of CSV: "
        f"{time.perf_counter() - t0:.3f} s")
    del text
    s = Session(mode=EvalMode.LAZY, device=dev, mem_budget_bytes=OOC_BUDGET,
                spill_dir=spill_dir("csv_store"))
    try:
        t0 = time.perf_counter()
        df = read_csv(str(path), session=s)
        got = df.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pf = s.frames[df._node.params["frame_id"]]
        st = s.config.store.stats
        log(f"  read_csv: {wall:.3f} s wall, {size / wall / 1e6:.1f} MB/s of text; "
            f"{pf.row_parts} chunks; store: {st.spills} spills, peak resident "
            f"{st.peak_resident_bytes} bytes")
        check_csv_frame(np, got, cols)
        del got
        a = timed(f"{OOC_LABELS['agg']} on the CSV frame",
                  lambda: df.groupby("passenger_count").agg(
                      {"f0": ["sum", "mean", "min", "max"]}).collect())
        pc, (v, valid, _) = cols["passenger_count"][0], cols["f0"]
        key, v64 = pc[valid] - 1, v[valid].astype(np.float64)
        sums = np.bincount(key, weights=v64, minlength=6)
        abss = np.bincount(key, weights=np.abs(v64), minlength=6)
        got_sum = np.asarray(a.col("f0_sum").to_pylist())
        assert a.col("passenger_count").to_pylist() == [1, 2, 3, 4, 5, 6]
        assert np.all(np.abs(got_sum - sums) <= SUM_RTOL * abss), (got_sum, sums)
        for g in range(6):
            seg = v[valid][key == g]
            assert a.col("f0_min").to_pylist()[g] == float(seg.min())
            assert a.col("f0_max").to_pylist()[g] == float(seg.max())
        log("  read_csv equals the frame it was written from; its GROUPBY matches numpy")
    finally:
        s.close()


def tenant_queries(df, i: int) -> dict:
    """Tenant i's share of the Fig. 6 mix, on float column f<i>: groupby(n)
    over a map (the filter), groupby(n).agg(4) and groupby(1)."""
    f = f"f{i}"
    return {"agg": df.groupby("passenger_count").agg({f: ["sum", "mean", "min", "max"]}),
            "count": df[df[f] > 0].groupby("passenger_count").count(),
            "count_1": df[[f]].count()}


def blocking_map(started, release):
    """f0 + 1 whose blocks signal ``started`` and wait for ``release``."""
    from repro_torch.core import Domain
    from repro_torch.core import algebra as alg
    from repro_torch.core.frame import Column

    def fn(cols, frame):
        if started is not None:
            started.set()
        if release is not None:
            assert release.wait(120.0), "release never came"
        out = dict(cols)
        c = cols["f0"]
        out["f0"] = Column(c.data + 1.0, Domain.FLOAT, c.mask, None)
        return out
    return alg.Udf(name="ooc_cancel_map" if started else "ooc_cancel_ref", fn=fn,
                   deps=frozenset(["f0"]), elementwise=True)


def ooc_service(torch, np, dev, taxi, parts: int) -> None:
    """A QueryService of SVC_TENANTS tenants sharing one OOC_BUDGET store:
    each tenant's share of the Fig. 6 mix, run concurrently, equals the same
    statements in an unbudgeted session; per-session stats sum to the
    service's; tenant 0 is traced and its first statement's span deltas sum
    to its stats' movement; a cancel lands once a block has started, closes
    its spans, and a rerun is bit-identical."""
    import dataclasses
    import threading
    from repro_torch.core import DataFrame, QueryService, StatementCancelled
    from repro_torch.core import algebra as alg
    plain = lazy_session(dev)
    try:
        pdf = DataFrame(session=plain, node=plain.register_frame(taxi, row_parts=parts))
        with knobs(FIXED_GRID):
            want = {i: {k: q.collect().to("cpu") for k, q in tenant_queries(pdf, i).items()}
                    for i in range(SVC_TENANTS)}
    finally:
        plain.close()
    with knobs(FIXED_GRID), QueryService(mem_budget_bytes=OOC_BUDGET,
                                         spill_dir=spill_dir("svc"), device=dev) as svc:
        src = svc.register_frame(taxi, row_parts=parts)
        tenants = [svc.session(mode="lazy", trace=(i == 0)) for i in range(SVC_TENANTS)]
        got, errors, traced = {}, [], {}

        def run(i, t):
            try:
                qs = tenant_queries(DataFrame(session=t, node=src), i)
                for k, q in qs.items():
                    before = dataclasses.replace(t.stats)
                    h = t.submit(q._node)
                    got[i, k] = h.result(timeout=600).to_frame()
                    if i == 0 and not traced:
                        traced["before"], traced["after"] = before, dataclasses.replace(t.stats)
                        traced["stmt"] = h.stmt_id
            except BaseException as e:    # noqa: BLE001 - re-raised below
                errors.append((i, e))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i, t)) for i, t in enumerate(tenants)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        assert not errors, errors
        for (i, k), f in got.items():
            assert same_frame(torch, np, f.to("cpu"), want[i][k]), f"tenant {i} {k} differs"
        st = svc.stats
        for fld in dataclasses.fields(type(st)):
            if fld.name != "peak_resident_bytes":
                per = sum(getattr(t.stats, fld.name) for t in tenants)
                assert per == getattr(st, fld.name), (fld.name, per, getattr(st, fld.name))
        tr = tenants[0].tracer
        totals = tr.counter_totals(traced["stmt"])
        for k in _DELTA_KEYS:
            moved = getattr(traced["after"], k) - getattr(traced["before"], k)
            assert totals.get(k, 0) == moved, (k, totals.get(k, 0), moved)
        store = svc.store.stats
        log(f"  {SVC_TENANTS} tenants x {len(got) // SVC_TENANTS} statements concurrently: "
            f"{wall:.3f} s wall; each equals its unbudgeted run; shared store {store.spills} "
            f"spills, {store.faults} faults, peak resident {store.peak_resident_bytes} bytes; "
            f"per-session stats sum to the service's; tenant 0's traced statement's span "
            f"deltas {dict((k, totals.get(k, 0)) for k in _DELTA_KEYS)} equal its stats' "
            f"movement")
        for row in svc.tenant_report():
            log(f"    {row}")

        t = tenants[0]
        small = t.register_frame(taxi.take_rows(np.arange(CANCEL_ROWS)),
                                 row_parts=CANCEL_BLOCKS)
        started, release = threading.Event(), threading.Event()
        node = alg.Map(small, blocking_map(started, release))
        h = t.submit(node)
        assert started.wait(120.0)
        h.cancel()
        release.set()
        try:
            h.result(timeout=300)
        except StatementCancelled:
            pass
        else:
            raise AssertionError("the cancelled statement completed")
        deadline = time.monotonic() + 60
        while tr.open_spans() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert tr.open_spans() == 0, "spans left open after the cancel"
        assert any(sp.args and "Cancel" in str(sp.args.get("error", ""))
                   for sp in tr.snapshot())
        rerun = t.collect(node)
        ref = t.collect(alg.Map(small, blocking_map(None, None)))
        assert same_frame(torch, np, rerun, ref), "the rerun after the cancel differs"
        log("  cancel: StatementCancelled once a block had started, every span closed, "
            "rerun bit-identical")


def ooc_progressive(torch, np, s, src, agg) -> None:
    """progressive_aggregate of f0's mean per passenger_count group over the
    budgeted frame's blocks: each block faults in once, and its rows of each
    group go back into the budgeted store as a block of their own (spilled
    and faulted like any other).  The interval shrinks, and the final
    estimate equals the GROUPBY mean ``agg`` (on the host)."""
    from repro_torch.core import config
    from repro_torch.core.approx import progressive_aggregate
    from repro_torch.core.frame import host
    from repro_torch.core.partition import PartitionedFrame
    from repro_torch.core.store import as_handle
    pf = s.frames[src.params["frame_id"]]
    means = agg.col("f0_mean").to_pylist()
    st = s.config.store.stats
    s0 = (st.spills, st.faults)
    t0 = time.perf_counter()
    groups = {g: [] for g in range(1, 7)}
    vals = {g: [] for g in groups}
    with config.scope(s.config):
        for row in pf.handles:             # each block faults in once
            f = row[0].frame()
            pc = host(f.col("passenger_count").data)
            for g, handles in groups.items():
                part = f.take_rows(np.flatnonzero(pc == g))
                c = part.col("f0")
                vals[g].append(host(c.data)[host(c.valid_mask())])
                handles.append(as_handle(part))
            del f, part, c
    for g, handles in groups.items():
        ests = list(progressive_aggregate(PartitionedFrame([[h] for h in handles]), "f0",
                                          "mean"))
        assert len(ests) == pf.row_parts and ests[-1].final
        widths = [e.ci_high - e.ci_low for e in ests[:-1]]
        assert widths[-1] < widths[0], (g, widths)
        v = np.concatenate(vals[g]).astype(np.float64)
        assert abs(ests[-1].value - v.sum() / v.size) <= 1e-12 * np.abs(v).sum() / v.size
        assert abs(ests[-1].value - means[g - 1]) <= SUM_RTOL * np.abs(v).sum() / v.size, \
            (g, ests[-1].value, means[g - 1])
    log(f"  progressive mean of f0 per group over {pf.row_parts} blocks (the groups' "
        f"blocks in the budgeted store: {st.spills - s0[0]} spills, {st.faults - s0[1]} "
        f"faults): intervals shrink, the final estimates equal the GROUPBY means; "
        f"{time.perf_counter() - t0:.3f} s")


def spill_stages(torch, np, dev, taxi) -> None:
    """The store's own spill write and fault read (``store._save_frame`` /
    ``store._load_frame``) of one block of TAXI_ROWS / 8 rows on the card,
    twice, with the stages inside each clocked: the copies to the host
    (``store.host``), ``np.savez`` and CRC32 (``zlib.crc32``).  The rest of
    a write is the file write (into the page cache: the store does not
    fsync); the rest of a read is the file read, ``np.load`` and the copies
    back to the card."""
    from repro_torch.core import store as store_mod
    blk = taxi.take_rows(np.arange(taxi.nrows // 8)).to(dev)
    nbytes = blk.nbytes()
    gb = nbytes / 1e9
    path = str(Path(spill_dir("stages")) / "blk.spill")
    for rep in (1, 2):
        torch.cuda.synchronize()
        with call_clock(store_mod, ("host",)) as d2h, \
                call_clock(store_mod.np, ("savez",)) as ser, \
                call_clock(store_mod.zlib, ("crc32",)) as crc:
            t0 = time.perf_counter()
            store_mod._save_frame(path, blk)
            save = time.perf_counter() - t0
        with call_clock(store_mod.zlib, ("crc32",)) as crc_r:
            t0 = time.perf_counter()
            back = store_mod._load_frame(path)
            torch.cuda.synchronize()
            load = time.perf_counter() - t0
        assert same_frame(torch, np, back, blk), "a spilled block read back differs"
        del back
        write = save - d2h.secs["host"] - ser.secs["savez"] - crc.secs["crc32"]
        rest = load - crc_r.secs["crc32"]
        log(f"  spill path, pass {rep}, one {nbytes}-byte block through the store's "
            f"_save_frame / _load_frame: write {gb / save:.2f} GB/s (device->host "
            f"{gb / d2h.secs['host']:.2f}, np.savez {gb / ser.secs['savez']:.2f}, CRC32 "
            f"{gb / crc.secs['crc32']:.2f}, file write {gb / write:.2f} GB/s); read "
            f"{gb / load:.2f} GB/s (CRC32 {gb / crc_r.secs['crc32']:.2f}, file read + "
            f"np.load + host->device {gb / rest:.2f} GB/s)")


def outofcore_phase(torch, np, dev, taxi, counters: dict) -> dict:
    """Phase 10 over the taxi frame ``taxi``, held on the host: every
    session and the service land its blocks on the card through their own
    ``register_frame``.  Returns the K1 / K4 launches of the budgeted pass."""
    import shutil
    try:
        spill_stages(torch, np, dev, taxi)
        ref, s, src, parts, launches = ooc_steps(torch, np, dev, taxi, counters)
        try:
            ooc_progressive(torch, np, s, src, ref["agg"])
        finally:
            s.close()
        del ref
        ooc_chaos(torch, np, dev, taxi, parts)
        ooc_csv(torch, np, dev, taxi)
        ooc_service(torch, np, dev, taxi, parts)
    finally:
        shutil.rmtree(ROOT / "build" / "spill", ignore_errors=True)
    return launches


# -----------------------------------------------------------------------------
# phase 11: training recurrentgemma-9b at full width
# -----------------------------------------------------------------------------
TRAIN_ARCH = "recurrentgemma-9b"
TRAIN_BATCH, TRAIN_SEQ = 1, 4096          # tokens a step: one 4,096-token sequence
TRAIN_DOCS, TRAIN_SHARD = 2048, 512       # synthetic_corpus(2048, seed=0), 4 shards
PIPE_BATCHES = 8                          # batches held card against CPU
STEPS_REPEATED, STEPS_FIT = 6, 8          # (a) one repeated batch; (b) Trainer.fit
ORACLE_LAYERS = 5                         # one superblock (remat'd) + the 2-layer tail
SMOKE_TRAIN = dict(seq_len=16, global_batch=4, shard_docs=100)
# Limits of the 5-layer gradient oracle, K5 (forward and reverse walk)
# against linear_scan_plain under autograd, on the same weights and batch:
# |loss difference|, |grad norm ratio - 1|, and the largest relative norm
# of a parameter's gradient difference.  The sound readings on an H100 are
# exactly 0, 0, 0 (PERF.md, "Findings"): K5's forward is bit-equal to the plain
# version and its backward equal to autograd through it, and the rest of
# the step is deterministic on the card.  The limits leave room for float
# noise only; the two deliberately wrong backwards read 7.0e-6 / 2.23
# (grad_a zeroed) and 6.7e-3 / 0.805 (the carry dropped every 64 steps).
ORACLE_LIMITS = (1e-6, 1e-6, 1e-5)


def train_corpus() -> list:
    """synthetic_corpus(TRAIN_DOCS, seed=0) with one short document (the
    SELECTION drops it) and one duplicate (DROP-DUPLICATES drops it), as
    tests/test_pipeline.py builds its corpus."""
    from repro_torch.data import synthetic_corpus
    corpus = synthetic_corpus(TRAIN_DOCS, seed=0)
    corpus[10] = "short"
    corpus[11] = corpus[12]
    return corpus


def train_pipeline(torch, dev, vocab: int):
    """The pipeline on the card, its first PIPE_BATCHES batches against the
    same pipeline's on the CPU (bit for bit), its shard-0 stages, and its
    background prefetch; returns the pipeline and its first batch."""
    from repro_torch.data import DataPipeline, PipelineConfig
    pc = PipelineConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, shard_docs=TRAIN_SHARD)
    corpus = train_corpus()
    t0 = time.perf_counter()
    pipe = DataPipeline(corpus, vocab, pc, device=dev)
    card = [b for _, b in zip(range(PIPE_BATCHES), pipe.batches())]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = [b for _, b in zip(range(PIPE_BATCHES), DataPipeline(corpus, vocab, pc,
                                                               device="cpu").batches())]
    cpu_wall = time.perf_counter() - t0
    assert len(card) == len(cpu) == PIPE_BATCHES
    for i, (x, y) in enumerate(zip(card, cpu)):
        for k in ("tokens", "labels", "mask"):
            if x[k].device != dev or not torch.equal(x[k].cpu(), y[k]):
                raise AssertionError(f"pipeline batch {i} {k}: the card's differs from the CPU's")
    frame = pipe.session.collect(pipe._shard_plan(0))
    texts = frame.col("text").to_pylist()
    counts = frame.col("token_count").to_pylist()
    assert "short" not in texts and len(texts) == len(set(texts)) == TRAIN_SHARD - 2, len(texts)
    assert counts == sorted(counts)
    stats = pipe.stats()
    assert stats["background_tasks"] >= 1, stats
    log(f"  pipeline: {TRAIN_DOCS} docs in shards of {TRAIN_SHARD}, SELECTION -> DROP-DUPLICATES "
        f"-> MAP -> SORT on {dev} (shard 0: {TRAIN_SHARD} docs -> {len(texts)}), {PIPE_BATCHES} "
        f"batches of {TRAIN_BATCH} x {TRAIN_SEQ} in {wall:.3f} s (CPU {cpu_wall:.3f} s), "
        f"bit-equal to the CPU pipeline's; stats {stats}")
    return pipe, card[0]


def set_griffin_lam(torch, params: dict, cfg, seed: int) -> None:
    gen = torch.Generator(device=params["embed"].device).manual_seed(seed)
    with torch.no_grad():
        for p in params["layers"]:
            if "rglru" in p:
                p["rglru"]["lam"].copy_(griffin_lam(torch, cfg.rnn_width_, gen))


def wrong_scan(torch, ls, kind: str):
    """K5 forward with a deliberately wrong backward: grad_a zeroed, or the
    reverse walk restarted (dh and h_{t-1} taken as 0) every K5_WRONG_CUT
    steps."""
    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            h = ls.linear_scan(a, b)
            ctx.save_for_backward(a, h)
            return h

        @staticmethod
        def backward(ctx, g):
            a, h = ctx.saved_tensors
            if kind == "zero":
                ga, gb = ls.linear_scan_backward(a, g, h)
                return torch.zeros_like(ga), gb
            parts = [ls.linear_scan_backward(a[:, i:i + K5_WRONG_CUT], g[:, i:i + K5_WRONG_CUT],
                                             h[:, i:i + K5_WRONG_CUT])
                     for i in range(0, a.shape[1], K5_WRONG_CUT)]
            return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)
    return lambda a, b: Wrong.apply(a.float(), b.float())


def oracle_readings(torch, want, got) -> tuple[float, float, float]:
    (wl, wg), (gl, gg) = want, got
    wn = torch.sqrt(sum((g.float() ** 2).sum() for g in wg))
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in gg))
    worst = max(float((x.float() - y.float()).norm() / y.float().norm().clamp(min=1e-30))
                for x, y in zip(gg, wg))
    return abs(float(gl) - float(wl)), abs(float(gn / wn) - 1), worst


def gradient_oracle(torch, ls, cfg, dev, batch) -> None:
    """One loss and gradient at full width and ORACLE_LAYERS layers (one
    remat'd superblock, the 2-layer tail), K5 against linear_scan_plain
    swapped into kernels.ops, within ORACLE_LIMITS; two wrong backwards
    must break them."""
    import dataclasses
    from repro_torch.kernels import ops as kops
    from repro_torch.models import build_model
    from repro_torch.train.tree import leaves
    small = dataclasses.replace(cfg, n_layers=ORACLE_LAYERS)
    model = build_model(small, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    set_griffin_lam(torch, params, small, 3)
    for p in leaves(params):
        p.requires_grad_(True)

    def run(scan=None):
        right = kops.linear_scan
        if scan is not None:
            kops.linear_scan = scan
        try:
            loss, _ = model.loss_fn(params, batch)
            return loss.detach(), torch.autograd.grad(loss, leaves(params))
        finally:
            kops.linear_scan = right

    t0 = time.perf_counter()
    ls.counter.reset()
    mine = run()
    torch.cuda.synchronize()
    k5 = dict(ls.counter.routes)
    wall = time.perf_counter() - t0
    rglru = sum(1 for p in params["layers"] if "rglru" in p)
    assert k5 == {"fwd": rglru + 2, "bwd": rglru}, k5     # the superblock's 2 recomputed
    t0 = time.perf_counter()
    plain = run(lambda a, b: ls.linear_scan_plain(a.float(), b.float()))
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    sound = oracle_readings(torch, plain, mine)
    within = all(r <= lim for r, lim in zip(sound, ORACLE_LIMITS))
    log(f"  gradient oracle, {ORACLE_LAYERS} layers at full width, {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"K5 {wall:.3f} s ({k5}), linear_scan_plain under autograd {plain_wall:.3f} s; "
        f"|loss diff| {sound[0]:.6g}, |grad norm ratio - 1| {sound[1]:.6g}, worst gradient "
        f"{sound[2]:.6g} relative norm; limits {ORACLE_LIMITS}"
        + (": within" if within else ": OUTSIDE"))
    failures = [] if within else [f"K5 vs plain outside the oracle limits: {sound}"]
    for kind, name in (("zero", "grad_a zeroed"),
                       ("cut", f"the reverse walk's carry dropped every {K5_WRONG_CUT} steps")):
        bad = oracle_readings(torch, plain, run(wrong_scan(torch, ls, kind)))
        caught = not all(r <= lim for r, lim in zip(bad, ORACLE_LIMITS))
        log(f"  {name}: |loss diff| {bad[0]:.6g}, |grad norm ratio - 1| {bad[1]:.6g}, worst "
            f"gradient {bad[2]:.6g}" + (": caught" if caught else ": within the limits"))
        if not caught:
            failures.append(f"the oracle limits do not catch {name}: {bad}")
    del model, params, mine, plain
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


def param_digest(torch, params: dict) -> list:
    """Per parameter, the sum of its bit patterns as integers: equal lists
    for bit-identical parameters (and, in practice, different ones
    otherwise)."""
    from repro_torch.train.tree import leaves
    sums = [p.detach().view(torch.int16 if p.element_size() == 2 else torch.int32)
            .sum(dtype=torch.int64) for p in leaves(params)]
    return torch.stack(sums).tolist()


def step_walls(np, walls: list) -> str:
    w = np.asarray(walls)
    return (f"wall s {[round(x, 4) for x in walls]} (median {np.median(w):.4f}, p90 "
            f"{np.percentile(w, 90):.4f}; {TRAIN_BATCH * TRAIN_SEQ / np.median(w):.1f} tokens/s)")


def checkpoint_on_card(torch, dev) -> None:
    """CheckpointManager round-trips a CUDA state (smoke config, after one
    step) bit for bit, and run_with_recovery resumes at the exact cursor
    after a failure before batch 8: the restart trains batches 7.. again
    from the step-6 checkpoint, and ends at step 10."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataPipeline, PipelineConfig, synthetic_corpus
    from repro_torch.models import build_model
    from repro_torch.train import CheckpointManager, adafactor
    from repro_torch.train.fault import FailurePlan, run_with_recovery
    from repro_torch.train.schedule import constant
    from repro_torch.train.trainer import TrainConfig, Trainer, init_state, make_train_step
    from repro_torch.train.tree import leaves
    cfg = get_smoke_config(TRAIN_ARCH)
    model = build_model(cfg, dev)
    corpus = synthetic_corpus(400, seed=5, mean_len=30)
    pc = PipelineConfig(**SMOKE_TRAIN)
    batch = next(DataPipeline(corpus, cfg.vocab, pc, device=dev).batches())
    state, _ = make_train_step(model, adafactor(), constant(1e-3))(
        init_state(model, 0, adafactor()), batch)
    mgr = CheckpointManager(spill_dir("ckpt_roundtrip"), keep=2)
    mgr.save(1, state, extra={"cursor": 1}, blocking=True)
    back, extra = mgr.restore(init_state(model, 1, adafactor()))
    for a, b in zip(leaves(state), leaves(back)):
        assert a.device == b.device and a.dtype == b.dtype and torch.equal(a.detach(), b), a.shape
    assert extra == {"cursor": 1}
    seen = []

    def run(plan):
        trainer = Trainer(model, TrainConfig(lr=1e-3, total_steps=10,
                                             checkpoint_dir=spill_dir("ckpt_recovery"),
                                             checkpoint_every=3, log_every=100))
        step_fn = trainer.train_step

        def recording(st, b):
            seen.append(int(b["tokens"][0, 0]))
            return step_fn(st, b)
        trainer.train_step = recording
        return run_with_recovery(trainer, lambda: DataPipeline(corpus, cfg.vocab, pc,
                                                               device=dev).batches(),
                                 steps=10, failure_plan=plan)

    failed = run(FailurePlan(fail_at_steps=(8,)))
    after_failure = list(seen)
    seen.clear()
    clean = run(None)
    assert int(failed["step"]) == int(clean["step"]) == 10
    assert after_failure == seen[:7] + seen[6:], (after_failure, seen)
    same = all(torch.equal(a.detach(), b.detach())
               for a, b in zip(leaves(failed["params"]), leaves(clean["params"])))
    log(f"  checkpoint on {dev} (smoke {TRAIN_ARCH}): {len(leaves(state))} tensors round-trip "
        f"bit for bit; recovery from a failure before batch 8 resumed at the step-6 cursor "
        f"(batches trained {len(after_failure)} = 7 + 4), ends at step 10; its parameters "
        f"{'equal' if same else 'differ from'} an uninterrupted run's")


def train_phase(torch, np, ls, fa, da, dev, card: str) -> dict:
    """Phase 11; returns K5's launches by route in the main path's steps
    ((a) and (b)); K6 and K7 must launch none."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer
    from repro_torch.train import adafactor
    from repro_torch.train.schedule import constant
    from repro_torch.train.trainer import TrainConfig, Trainer, init_state, make_train_step
    from repro_torch.train.tree import leaves, leaves_with_paths, path_name
    cfg = get_config(TRAIN_ARCH)
    kinds = transformer.layer_kinds(cfg)
    repeats, _ = cfg.repeats_and_tail()
    rglru = kinds.count("rglru")
    recomputed = repeats * cfg.pattern.count("rglru")
    per_step = {"fwd": rglru + recomputed, "bwd": rglru}
    pipe, batch = train_pipeline(torch, dev, cfg.vocab)
    t_part = time.perf_counter()
    gradient_oracle(torch, ls, cfg, dev, batch)
    log(f"  the gradient oracle: {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    opt = adafactor()
    state = init_state(model, torch.Generator(device=dev).manual_seed(0), opt)
    set_griffin_lam(torch, state["params"], cfg, 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(state["params"]))
    p_bytes = sum(p.numel() * p.element_size() for p in leaves(state["params"]))
    opt_bytes = sum(t.numel() * t.element_size() for t in leaves(state["opt"]))
    log(f"  {cfg.name}: {cfg.n_layers} layers ({rglru} rglru, {kinds.count('local')} local, "
        f"window {cfg.window}), d {cfg.d_model}, vocab {cfg.vocab}; "
        f"{n_params} parameters ({p_bytes / 1e9:.3f} GB, random from seed "
        f"0, Λ as Griffin's init), Adafactor state {opt_bytes / 1e9:.3f} GB: "
        f"{time.perf_counter() - t0:.1f} s")
    step = make_train_step(model, opt, constant(1e-3))
    counters = {"linear_scan": ls.counter, "flash_attention": fa.counter,
                "decode_attention": da.counter}
    for c in counters.values():
        c.reset()
    total = {"fwd": 0, "bwd": 0}

    def one(state, b, walls, losses, norms):
        before = dict(ls.counter.routes)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        got = {k: ls.counter.routes.get(k, 0) - before.get(k, 0) for k in per_step}
        if got != per_step:
            raise AssertionError(f"a step launched K5 {got}, want {per_step}")
        return state

    # (a) STEPS_REPEATED steps on one batch: the loss must fall
    walls, losses, norms = [], [], []
    digest = None
    for i in range(STEPS_REPEATED):
        state = one(state, batch, walls, losses, norms)
        if i == 0:
            digest = param_digest(torch, state["params"])
    peak = torch.cuda.max_memory_allocated()
    for k in total:
        total[k] += ls.counter.routes.get(k, 0)
    others = {k: c.launches for k, c in counters.items() if k != "linear_scan"}
    assert others == {"flash_attention": 0, "decode_attention": 0}, others
    log(f"  (a) {STEPS_REPEATED} steps of Adafactor at lr 1e-3 on one batch of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}: loss {[round(x, 5) for x in losses]}, grad norm "
        f"{[round(x, 5) for x in norms]}; {step_walls(np, walls)}; K5 {per_step} a step, K6 / K7 "
        f"none; max_memory_allocated {peak / 1e9:.3f} GB (parameters {p_bytes / 1e9:.3f} + "
        f"their gradients {p_bytes / 1e9:.3f} + Adafactor {opt_bytes / 1e9:.3f} GB) | {card}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over the repeated batch: {losses}")
    log(f"  (a) with the model's init: {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()
    # one window of CUDA activity alone, not retaken if lost: 2 steps are
    # ~43,000 device activities, and tracing their CPU activity too makes
    # the window slow to read
    profile_window(torch, lambda: [step(state, batch) for _ in range(2)], 2,
                   "step (profiled, 2 steps)", {"K5 (fwd and bwd)": ("lin_walk",)},
                   tries=1, cuda_only=True)
    log(f"  the profiled steps: {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # determinism, a reading: the first step again from the same seed and
    # batch (the model holds the parameters too: drop them before the new ones)
    del state
    model.params = None
    torch.cuda.empty_cache()
    state = init_state(model, torch.Generator(device=dev).manual_seed(0), opt)
    set_griffin_lam(torch, state["params"], cfg, 1)
    w2, l2, n2 = [], [], []
    state = one(state, batch, w2, l2, n2)
    again = param_digest(torch, state["params"])
    names = [path_name(p) for p, _ in leaves_with_paths(state["params"])]
    differ = [n for n, x, y in zip(names, digest, again) if x != y]
    log(f"  determinism (a reading): the first step again from seed 0: loss {l2[0]!r} vs "
        f"{losses[0]!r}, grad norm {n2[0]!r} vs {norms[0]!r}; updated parameters "
        + ("bit-identical" if not differ else f"differ in {len(differ)} tensors, first "
           f"{differ[:3]}") + f": {time.perf_counter() - t_part:.1f} s")
    del state
    model.params = None
    torch.cuda.empty_cache()

    # (b) Trainer.fit over the pipeline's batches, warmup-cosine schedule
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, TrainConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS_FIT,
                                         log_every=1))
    before = dict(ls.counter.routes)
    t0 = time.perf_counter()
    state = trainer.fit(pipe.batches(), steps=STEPS_FIT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit = {k: ls.counter.routes.get(k, 0) - before.get(k, 0) for k in per_step}
    for k in total:
        total[k] += fit[k]
    hist = trainer.history
    assert [r["step"] for r in hist] == list(range(1, STEPS_FIT + 1)), hist
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in hist), hist
    assert fit == {k: v * STEPS_FIT for k, v in per_step.items()}, fit
    others = {k: c.launches for k, c in counters.items() if k != "linear_scan"}
    assert others == {"flash_attention": 0, "decode_attention": 0}, others
    fit_walls = [float(x) for x in np.diff([0.0] + [r["wall_s"] for r in hist])]
    log(f"  (b) Trainer.fit, {STEPS_FIT} steps over the pipeline (warmup 2, cosine, Adafactor): "
        f"loss {[round(r['loss'], 5) for r in hist]}, lr {[round(r['lr'], 8) for r in hist]}, "
        f"grad norm {[round(r['grad_norm'], 5) for r in hist]}; {step_walls(np, fit_walls)}; "
        f"{wall:.1f} s with init; K5 {fit}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB | {card}")
    del state, trainer, model
    torch.cuda.empty_cache()
    t_part = time.perf_counter()
    checkpoint_on_card(torch, dev)
    log(f"  checkpoint and recovery: {time.perf_counter() - t_part:.1f} s")
    return total


# -----------------------------------------------------------------------------
# phase 12: the rest of the model zoo, served
# -----------------------------------------------------------------------------
# (arch, layers kept).  Three run at full width and depth; qwen3-moe
# (2.35e11 parameters) and llama-vision (8.77e10) do not fit in 80 GB of
# bf16 and keep their full width cut in depth: qwen3 to 2 layers (all 128
# experts, top-8), llama-vision to one pattern period, 4 attn layers and
# their cross layer
ZOO = (("rwkv6-1.6b", None), ("granite-moe-3b-a800m", None), ("whisper-base", None),
       ("qwen3-moe-235b-a22b", 2), ("llama-3.2-vision-90b", 5))


def attention_calls(cfg, memory: bool) -> tuple[int, int]:
    """(K6 launches a forward, K7 launches a decode step) of ``cfg`` with
    attn_impl auto: one a self- or cross-attention (two a dec layer, plus
    the encoder's layers when there is a memory); local decode and the
    recurrent kinds run neither."""
    from repro_torch.models import transformer
    kinds = transformer.layer_kinds(cfg)
    none = {"rglru": 0, "rwkv": 0, "dec": 2}
    fwd = sum(none.get(k, 1) for k in kinds) + (cfg.encoder_layers if memory else 0)
    return fwd, sum(0 if k == "local" else none.get(k, 1) for k in kinds)


@contextlib.contextmanager
def routes_taped(tape: list, replay: bool):
    """Record every MoE top-k choice (``models.moe._top_k``) in call order
    into ``tape``, or, with ``replay``, take each call's experts from the
    tape (their probabilities from this run).  Two runs that differ only in
    how attention rounds (K6 / K7 or the einsum path) can tip a router
    near-tie to another expert; the oracle replays the kernel run's choices,
    so that its comparison measures attention alone."""
    from repro_torch.models import moe
    real = moe._top_k
    calls = iter(list(tape))

    def recording(probs, k):
        vals, idx = real(probs, k)
        tape.append(idx)
        return vals, idx

    def replaying(probs, k):
        idx = next(calls, None)
        if idx is None or idx.shape != probs.shape[:-1] + (k,):
            raise AssertionError("the replayed run routes other calls than the recorded one")
        return probs.gather(-1, idx), idx

    moe._top_k = replaying if replay else recording
    try:
        yield
    finally:
        moe._top_k = real


def route_flips(torch, a: list, b: list) -> tuple[int, int]:
    """(tokens whose set of experts differs in some call, tokens x calls)
    between two tapes of the same calls."""
    flips = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum()) for x, y in zip(a, b))
    return flips, sum(x[..., 0].numel() for x in a)


def zoo_config(torch, np, fa, da, dev, card: str, arch: str, keep) -> tuple[dict, dict, list]:
    """One config of phase 12; returns K6's and K7's launches by route in
    its main runs (one prefill, then the engine) and its failed checks."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer
    full = get_config(arch)
    cfg = full if keep is None else dataclasses.replace(full, n_layers=keep)
    if keep is not None:
        log(f"  cut: {arch} to {keep} of {full.n_layers} layers at full width: "
            f"{full.param_count()[0]:.4g} parameters ({2 * full.param_count()[0] / 1e9:.1f} GB "
            f"in bf16) do not fit in 80 GB; {cfg.param_count()[0]:.4g} kept")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(3, cfg.vocab, (ZOO_BATCH, ZOO_PROMPT), generator=gen, device=dev,
                         dtype=torch.int32)
    mem = None
    if cfg.cross_memory_len:       # the modality stub: frame / patch embeddings
        mem = torch.randn((ZOO_BATCH, cfg.cross_memory_len, cfg.d_model), generator=gen,
                          device=dev).bfloat16()
    torch.cuda.synchronize()
    kinds = transformer.layer_kinds(cfg)
    log(f"  {arch}: {cfg.n_layers} layers {sorted(set(kinds))}"
        f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}, d "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv}, head dim {cfg.head_dim_}, mlp "
        f"{cfg.mlp}{f' ({cfg.n_experts} experts, top-{cfg.top_k})' if cfg.n_experts else ''}, "
        f"ff {cfg.d_ff}, vocab {cfg.vocab}, memory {cfg.cross_memory_len}; "
        f"{sum(p.numel() for p in model.parameters())} parameters, random from seed 0: "
        f"{time.perf_counter() - t0:.1f} s")
    xla = dataclasses.replace(cfg, attn_impl="xla")
    k6_fwd, k7_step = attention_calls(cfg, mem is not None)
    failures = []

    # the main path, part 1: one prefill of 4 x 32 tokens, every attention
    # on K6 (the encoder's and the cross layers' non-causal)
    fa.counter.reset()
    da.counter.reset()
    with torch.inference_mode():
        last = model.prefill(params, toks, mem)
    torch.cuda.synchronize()
    k6 = dict(fa.counter.routes)
    if k6 != ({"tc": k6_fwd} if k6_fwd else {}) or da.counter.launches:
        raise AssertionError(f"{arch} prefill launched K6 {k6}, K7 {da.counter.launches}, "
                             f"want K6 {k6_fwd} on route tc and no K7")
    assert last.shape == (ZOO_BATCH, cfg.vocab) and bool(torch.isfinite(last).all()), arch
    walls = []
    with torch.inference_mode():
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.prefill(params, toks, mem)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)

    # the main path, part 2: 4 requests of the same 32-token prompts, 16 new
    # tokens each, through ServeEngine (31 teacher-forced steps, then 16)
    prompts = toks.tolist()
    serve_tape = []
    fa.counter.reset()
    da.counter.reset()
    with routes_taped(serve_tape, replay=False):
        run = serve(model, params, prompts, max_batch=ZOO_BATCH, max_seq=ZOO_PROMPT + ZOO_NEW,
                    new=ZOO_NEW, record=True)
    steps = int(run["engine"].metrics["steps"])
    k7 = dict(da.counter.routes)
    if k7 != ({"tc": steps * k7_step} if k7_step else {}) or fa.counter.launches:
        raise AssertionError(f"{arch} serving launched K7 {k7}, K6 {fa.counter.launches} in "
                             f"{steps} steps, want {k7_step} K7 a step on route tc and no K6")
    step_ms = np.asarray(run["times"]) * 1e3
    # phase 7's step bound: every weight read once (the embedding table
    # gives B rows); MoE reads only the experts a step routes to, so there
    # it is above the least a step can take
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    bound = (weights - params["embed"].numel() * params["embed"].element_size()) / HBM_BYTES_PER_S
    log(f"  {arch}: prefill {ZOO_BATCH} x {ZOO_PROMPT} wall ms {[round(w, 3) for w in walls[1:]]} "
        f"(median {np.median(walls[1:]):.3f}; first {walls[0]:.3f}), K6 {k6_fwd} launches a "
        f"forward; serving {steps} steps ({int(run['engine'].metrics['tokens_out'])} tokens out), "
        f"step ms median {np.median(step_ms):.3f} (p90 {np.percentile(step_ms, 90):.3f}; weights "
        f"read once {bound * 1e3:.3f}), K7 "
        f"{k7_step} launches a step, K6 0; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB | {card}")

    # check 1: the forward at every position, K6 against the einsum path
    # (MoE: the einsum run replays the K6 run's expert choices; the free
    # run's reading and its route flips are printed beside it); for rwkv (no
    # attention) the chunked form against the sequential scan
    def all_logits(c, tape=None, replay=False):
        with torch.inference_mode(), (routes_taped(tape, replay) if tape is not None
                                      else contextlib.nullcontext()):
            return transformer.logits(params, transformer.hidden(params, toks, c, mem), cfg)

    moe_cfg = cfg.mlp == "moe"
    tape, free_tape = [], []
    got = all_logits(cfg, tape if moe_cfg else None)
    if "rwkv" in kinds:
        what, want = "chunked RWKV vs sequential", all_logits(
            dataclasses.replace(xla, rwkv_chunked=True))
    else:
        what, want = "K6 vs xla", all_logits(xla, tape if moe_cfg else None, replay=True)
    readings = logit_readings(got, want)
    log("    " + show_readings(f"prefill logits at every position, {what}"
                               + (" (the K6 run's expert choices replayed)" if moe_cfg else ""),
                               readings, SERVE_LIMITS))
    if not within_logit_limits(readings):
        failures.append(f"{arch} prefill {what}: {readings}")
    if moe_cfg:
        free = logit_readings(got, all_logits(xla, free_tape))
        flips, n = route_flips(torch, tape, free_tape)
        log(f"    without the replay: max |logit diff| {free[0]:.4g}, mean {free[1]:.4g}, top-1 "
            f"agreement {free[2]:.4f}; {flips} of {n} token routings chose other experts")
    del want

    # check 2: the same requests served with attn_impl="xla" (same weights;
    # MoE: the K7 run's expert choices replayed)
    with (routes_taped(serve_tape, replay=True) if moe_cfg else contextlib.nullcontext()):
        oracle = serve(build_model(xla, dev), params, prompts, max_batch=ZOO_BATCH,
                       max_seq=ZOO_PROMPT + ZOO_NEW, new=ZOO_NEW, record=True)
    try:
        equal, parted, worst, widest = same_streams(torch, run, oracle, f"{arch} serving")
        log(f"    serving K7 vs xla: {equal} of {sum(len(r.out_ids) for r in run['reqs'])} tokens "
            f"equal before any parting, {parted} requests parted at a near-tie (widest margin "
            f"{widest:.4g}), max |logit diff| {worst:.4g} (tolerance {FULL_LOGIT_TOL})")
    except AssertionError as e:
        failures.append(str(e))
        log(f"    serving K7 vs xla: {e}")
    del run, oracle

    # check 3: teacher-forced decode of the prompts against the forward at
    # every position, with the memory (encoded for whisper): K7 on the
    # decode cross-attention over all M.  MoE routes B tokens a decode step
    # and B x S a forward, so groups and capacities differ (in the reference
    # too): its decode is held to the xla oracle above instead.
    if cfg.mlp == "moe":
        log("    decode vs forward: not compared (MoE capacity groups differ by design)")
    else:
        with torch.inference_mode():
            enc = mem
            if cfg.encoder_layers:
                enc = transformer.encode(params["encoder"], mem, cfg)
            cache = transformer.cache_init(cfg, ZOO_BATCH, ZOO_PROMPT, dev)
            outs = []
            for i in range(ZOO_PROMPT):
                lg, cache = transformer.decode_step(params, toks[:, i], cache, cfg, enc)
                outs.append(lg)
            readings = logit_readings(torch.stack(outs, 1), got)
        log("    " + show_readings("teacher-forced decode vs the forward at every position",
                                   readings, SERVE_LIMITS))
        if not within_logit_limits(readings):
            failures.append(f"{arch} decode vs forward: {readings}")
    del got, params, model
    torch.cuda.empty_cache()
    return k6, k7, failures


def zoo_phase(torch, np, fa, da, dev, card: str) -> tuple[dict, dict]:
    """Phase 12; returns K6's and K7's launches by route in the main runs of
    the five configs.  Every config runs and prints before the phase fails
    on any check."""
    k6 = {"tc": 0, "fma": 0}
    k7 = {"tc": 0, "fma": 0}
    failures = []
    for arch, keep in ZOO:
        t0 = time.perf_counter()
        a, b, failed = zoo_config(torch, np, fa, da, dev, card, arch, keep)
        for total, routes in ((k6, a), (k7, b)):
            for route, n in routes.items():
                total[route] += n
        failures += failed
        log(f"  {arch}: {time.perf_counter() - t0:.1f} s")
    if failures:
        raise AssertionError("; ".join(failures))
    return k6, k7


# =============================================================================
# phase 13: the launch layer (meshes, sharding specs on DTensor, the dry-run)
# =============================================================================
LAUNCH_ARCH = "yi-6b"
LAUNCH_PROMPT, LAUNCH_STEPS = 512, 8
# the abstract dry-run's cells on the single-pod (16 x 16) mesh: dense
# training, MoE prefill (EP + FSDP), SP decode of a cross-attention model, and
# recurrent long-context decode
LAUNCH_CELLS = (("yi-6b", "train_4k"), ("qwen3-moe-235b-a22b", "prefill_32k"),
                ("llama-3.2-vision-90b", "decode_32k"), ("recurrentgemma-9b", "long_500k"))
# the decode cell again on K7's route before the cross-device combine (the
# sequence-sharded cache gathered for K7 in every layer), in a process of its
# own, for the all-gather bytes before and after
LAUNCH_GATHERED = ("llama-3.2-vision-90b", "decode_32k")
GATHERED_CELL = ("import sys; from repro_torch.kernels import ops; "
                 "ops._sequence_dims = lambda *a: []; from repro_torch.launch import dryrun; "
                 "sys.argv[0] = 'dryrun'; dryrun.main()")


def sharded_serving(torch, np, fa, da, dev, mesh) -> tuple[dict, dict]:
    """Phase 13 (b): yi-6b at full width, plain and then as DTensors placed by
    ``param_specs`` / ``cache_specs_tree`` / ``batch_specs`` on ``mesh``, one
    prefill of 1 x LAUNCH_PROMPT tokens and LAUNCH_STEPS decode steps each,
    the DTensor run under ``activation_sharding``; every logit must be
    ``torch.equal`` and K6 / K7 must launch as often, by route.  Returns the
    DTensor run's launches of K6 and K7 by route."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import sharding as shlib
    from repro_torch.models import build_model
    from repro_torch.models.sharding_ctx import activation_sharding
    cfg = get_config(LAUNCH_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        3, cfg.vocab, (1, LAUNCH_PROMPT)).astype(np.int32)).to(dev)
    s_max = LAUNCH_PROMPT + LAUNCH_STEPS

    def run(params, tokens, cache):
        out = [model.prefill(params, tokens)]
        for i in range(LAUNCH_STEPS):
            logits, cache = model.decode_step(params, tokens[:, i], cache)
            out.append(logits)
        return out

    fa.counter.reset()
    da.counter.reset()
    plain = [t.clone() for t in run(params, tokens, model.cache_init(1, s_max))]
    torch.cuda.synchronize()
    plain_routes = (dict(fa.counter.routes), dict(da.counter.routes))
    t_plain = time.perf_counter() - t0

    t1 = time.perf_counter()
    shape = ShapeConfig("phase13", s_max, 1, "decode")
    dparams = shlib.distribute(params, shlib.param_specs(cfg, params, mesh), mesh)
    cache = model.cache_init(1, s_max)
    dcache = shlib.distribute(cache, shlib.cache_specs_tree(cfg, shape, mesh, cache), mesh)
    batch = {"tokens": tokens}
    dtokens = shlib.distribute(batch, shlib.batch_specs(cfg, shape, mesh, batch), mesh)["tokens"]
    fa.counter.reset()
    da.counter.reset()
    with activation_sharding(mesh, shlib.effective_dp(cfg, mesh)) as rec, implicit_replication():
        got = run(dparams, dtokens, dcache)
    got = [t.full_tensor() for t in got]
    torch.cuda.synchronize()
    routes = (dict(fa.counter.routes), dict(da.counter.routes))
    kinds = sorted({type(t).__name__ for t in (dparams["embed"], dcache["layers"][0]["k"])})
    log(f"  {cfg.name} at full width ({cfg.param_count()[0]} parameters, seed 0) on mesh "
        f"{tuple(mesh.shape)} {mesh.mesh_dim_names}: plain run {t_plain:.1f} s (init included), "
        f"DTensor run {time.perf_counter() - t1:.1f} s; parameters and cache as {kinds}; "
        f"wq {dparams['layers'][0]['attn']['wq'].placements}, cache k "
        f"{dcache['layers'][0]['k'].placements}; operators run replicated {rec.replicated}")
    log(f"  launches by route (K6, K7): plain {plain_routes}, DTensor {routes}")
    equal = [bool(torch.equal(a, b)) for a, b in zip(plain, got)]
    log(f"  logits torch.equal to the plain run: prefill {equal[0]}, decode steps {equal[1:]}")
    if routes != plain_routes or not routes[0] or not routes[1]:
        raise AssertionError(f"phase 13: K6 / K7 launched {routes} through the DTensor route, "
                             f"{plain_routes} in the plain run")
    if not all(equal):
        raise AssertionError(f"phase 13: DTensor logits differ from the plain run's: {equal}")
    del params, dparams, cache, dcache, plain, got, model
    torch.cuda.empty_cache()
    return routes


LAUNCH_CELL_TIMEOUT = 300   # seconds a dry-run cell may take (its own process)


def start_cells(out_dir: Path) -> list:
    """Phase 13 (c), started: one process a cell of LAUNCH_CELLS, each
    ``python -m repro_torch.launch.dryrun`` on the single-pod mesh (its own
    fake world, meta tensors, no card: CUDA_VISIBLE_DEVICES is empty), all at
    once, while the card runs (a) and (b)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = []
    cells = [(arch, shape, out_dir, ["-m", "repro_torch.launch.dryrun"])
             for arch, shape in LAUNCH_CELLS]
    cells.append((*LAUNCH_GATHERED, out_dir / "gathered", ["-c", GATHERED_CELL]))
    for arch, shape, where, run in cells:
        where.mkdir(parents=True, exist_ok=True)
        out = open(where / f"{arch}__{shape}.log", "w")
        cmd = [sys.executable, *run, "--arch", arch, "--shape", shape, "--mesh", "single",
               "--out", str(where), "--force"]
        procs.append((arch, shape, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                                    stderr=subprocess.STDOUT), out, where))
    return procs


def stop_cells(procs: list) -> None:
    for _, _, proc, out, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        out.close()


def finish_cells(procs: list, out_dir: Path, card: str, t0: float) -> None:
    """Phase 13 (c), finished: each cell's process must exit 0 and its
    record reach "analyzed"; prints each cell's accounting."""
    failures, records = [], {}
    for arch, shape, proc, out, where in procs:
        try:
            rc = proc.wait(timeout=max(1.0, LAUNCH_CELL_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            failures.append(f"{arch} x {shape}: over {LAUNCH_CELL_TIMEOUT} s")
            continue
        out.flush()
        path = where / f"{arch}__{shape}__single.json"
        res = json.loads(path.read_text()) if path.exists() else {"status": f"no record, rc {rc}"}
        if rc != 0 or res["status"] != "analyzed":
            tail = (where / f"{arch}__{shape}.log").read_text()[-2000:]
            failures.append(f"{arch} x {shape}: rc {rc}, {res['status']} "
                            f"{res.get('error', '')}\n{tail}")
            continue
        gathered = where != out_dir
        records[arch, shape, gathered] = res
        ha, rl = res["hlo_analysis"], res["roofline"]
        log(f"  {arch} x {shape}{' (cache gathered for K7)' if gathered else ''} on {res['chips']} devices (placed in {res['lower_s']:.1f} s, "
            f"run in {res['compile_s']:.1f} s): per device {ha['flops']:.6g} FLOPs, "
            f"{ha['hbm_bytes']:.6g} bytes raw, {ha['hbm_bytes_fused']:.6g} fused, wire "
            f"{ha['wire_bytes_by_kind']} ({ha['collective_counts']}), arguments "
            f"{res['arg_bytes_per_device']}, peak live "
            f"{res['memory_analysis']['peak_live_bytes']}; kernels "
            f"{ {k: v['calls'] for k, v in ha['kernels'].items()} }, replicated "
            f"{ha['replicated_by_op']}")
        log(f"    roofline against the H100 data sheet (989 TFLOP/s bf16, 3.35 TB/s, 450 GB/s "
            f"NVLink a way; accounting, not a measurement) | {card}: compute "
            f"{rl['compute_s']:.6g} s, memory {rl['memory_s']:.6g} s, collective "
            f"{rl['collective_s']:.6g} s -> {rl['bottleneck']}; step bound {rl['step_s']:.6g} s, "
            f"useful {rl['useful_flops_fraction']:.4g}, roofline fraction "
            f"{rl['roofline_fraction']:.4g}")
    if failures:
        raise AssertionError("phase 13: " + "; ".join(failures))
    decode_gathers(records)


def cache_row_gathers(res: dict) -> float:
    """All-gather wire bytes a device whose result is cache rows: (B, rows,
    KVH, Dh) of the cell's config, rows neither 1 (a new token's K / V) nor
    the cross layers' memory length (their K / V, made from the memory)."""
    from repro_torch.configs import get_config
    cfg = get_config(res["arch"])
    return sum(c["bytes"] for c in res["hlo_analysis"]["collective_bytes_by_shape"]
               if c["kind"] == "all-gather" and any(
                   len(x) == 4 and x[1] not in (1, cfg.cross_memory_len)
                   and x[2:] == [cfg.n_kv, cfg.head_dim_] for x in c["shapes"]))


def decode_gathers(records: dict) -> None:
    """The decode cell's all-gather a device before (K7's route before the
    combine: the cache gathered) and after, the prediction first: the
    before run's cache-row gathers go; the partials' (B x H x (D + 2)
    float32 a piece of the sequence, a layer) come, and at most the
    output's (B x H x D bf16 a layer, where the query comes replicated
    over the batch's mesh dim); the bound follows the leading term."""
    from repro_torch.configs import SHAPES, get_config
    arch, shape = LAUNCH_GATHERED
    before, after = records[arch, shape, True], records[arch, shape, False]
    cfg, sh = get_config(arch), SHAPES[shape]
    layers = cfg.pattern.count("attn") * (cfg.n_layers // len(cfg.pattern))
    b_local, pieces = sh.global_batch // 16, 16          # batch over "data", sequence over "model"
    partials = layers * pieces * b_local * cfg.n_heads * (cfg.head_dim_ + 2) * 4
    output = layers * sh.global_batch * cfg.n_heads * cfg.head_dim_ * 2
    ag = lambda r: r["hlo_analysis"]["wire_bytes_by_kind"].get("all-gather", 0.0)
    rows = cache_row_gathers(before)
    log(f"  {arch} x {shape} all-gather a device, predicted: {ag(before):.6g} B less its "
        f"cache-row gathers {rows:.6g} B plus the partials' {partials:.6g} B ({layers} "
        f"attention layers x {pieces} pieces x {b_local} x {cfg.n_heads} x "
        f"({cfg.head_dim_} + 2) float32) = {ag(before) - rows + partials:.6g} B, plus at "
        f"most the output's {output:.6g} B")
    log(f"    measured (accounting): before {ag(before):.6g} B (cache-row all-gathers "
        f"{rows:.6g} B), after {ag(after):.6g} B (cache-row all-gathers "
        f"{cache_row_gathers(after):.6g} B); bound before {before['roofline']['step_s']:.6g} s "
        f"({before['roofline']['bottleneck']}), after {after['roofline']['step_s']:.6g} s "
        f"({after['roofline']['bottleneck']})")
    if cache_row_gathers(after) or not rows:
        raise AssertionError(f"phase 13: cache-row all-gathers before {rows}, after "
                             f"{cache_row_gathers(after)}")


def launch_phase(torch, np, fa, da, dev, card: str) -> tuple[dict, dict]:
    """Phase 13; returns K6's and K7's launches by route in the DTensor
    run."""
    from repro_torch.launch.mesh import close_local_group, make_local_mesh
    from repro_torch.train.fault import elastic_remesh
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "dryrun_phase13"
    procs = start_cells(out_dir)
    try:
        try:
            mesh = make_local_mesh(dev)
            remesh = elastic_remesh(1, device=dev)
            for m in (mesh, remesh):
                if tuple(m.shape) != (1, 1) or m.mesh_dim_names != ("data", "model"):
                    raise AssertionError(f"phase 13: a {tuple(m.shape)} {m.mesh_dim_names} mesh")
            log(f"  make_local_mesh() {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
                f"{mesh.device_type}, elastic_remesh(1) {tuple(remesh.shape)} "
                f"{remesh.mesh_dim_names} ({time.perf_counter() - t0:.1f} s)")
            k6, k7 = sharded_serving(torch, np, fa, da, dev, mesh)
        finally:
            close_local_group()
        finish_cells(procs, out_dir, card, t0)
    finally:
        stop_cells(procs)
    log(f"  dry-run cells done {time.perf_counter() - t0:.1f} s after the phase began")
    return k6, k7


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
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import onehot_encode as oh
    from repro_torch.kernels import segment_reduce as sr
    from repro_torch.kernels import window_scan as ws
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
    check_window_scan(torch, ws, dev)
    check_decode_attention(torch, da, dev)
    check_linear_scan(torch, ls, dev)
    check_linear_scan_backward(torch, ls, dev)
    check_flash_attention(torch, fa, dev)
    check_flash_non_causal(torch, fa, dev)
    check_decode_cross(torch, da, fa, dev)
    check_decode_split(torch, da, dev)
    check_wide_aggregate(torch, dev)
    timings = time_kernels(torch, sr, bt, oh, ws, da, ls, fa, dev, pool)
    for rec in timings.values():
        lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
        if "host_ms" in rec:
            host = f", host {rec['host_ms']:.4f} ms a call"
            if rec["library_ms"] is not None:
                lib += (f" (on the device {ms_text(rec['library_device_ms'])} ms, host "
                        f"{rec['library_host_ms']:.4f} ms a call)")
        else:
            host = ""
        log(f"  {rec['name']} {rec['shape']}: kernel {rec['ms']:.4f} ms (on the device "
            f"{ms_text(rec['device_ms'])} ms{host}), plain "
            f"{rec['plain_ms']:.4f} ms, library {lib}, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), max |err| {rec['max_abs_err']:.3g}")
        if "backward" in rec:
            bw = rec["backward"]
            log(f"  {rec['name']} backward {bw['shape']}: kernel {bw['ms']:.4f} ms (on the "
                f"device {ms_text(bw['device_ms'])} ms, host {bw['host_ms']:.4f} ms a call), "
                f"plain {bw['plain_ms']:.4f} ms, library none, bound {bw['bound_ms']:.4f} ms "
                f"({bw['bound_by']}), max |err| {bw['max_abs_err']:.3g}")
    torch.cuda.empty_cache()
    log(f"[kernels] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[cuda-tests] tests/test_torch_cuda_kernels.py on the card")
    cuda_kernel_tests()
    log(f"[cuda-tests] {time.perf_counter() - t0:.1f} s")

    counters = {"segment_reduce": sr.counter, "block_transpose": bt.counter,
                "onehot_encode": oh.counter, "window_scan": ws.counter,
                "decode_attention": da.counter, "linear_scan": ls.counter,
                "flash_attention": fa.counter}
    launches = dict.fromkeys(counters, 0)
    # main-path launches by route of the kernels that have two
    by_route = {"segment_reduce": {"reg": 0, "table": 0},
                "decode_attention": {"tc": 0, "fma": 0, "tc_partials": 0, "fma_partials": 0},
                "flash_attention": {"tc": 0, "fma": 0}, "linear_scan": {"fwd": 0, "bwd": 0}}

    def add_routes(kernel: str, routes: dict) -> None:
        for route, n in routes.items():
            by_route[kernel][route] += n

    t0 = time.perf_counter()
    log(f"[fig6] EAGER sessions on {dev}, {TAXI_ROWS} rows")
    frame, mat = fig6_data(dev)
    for c in counters.values():
        c.reset()
    out = fig6_steps(timed, dev, frame, mat)
    for k, c in counters.items():
        launches[k] += c.launches
    add_routes("segment_reduce", sr.counter.routes)
    log(f"[fig6] launches {dict((k, c.launches) for k, c in counters.items())}")
    for k in ("segment_reduce", "block_transpose", "onehot_encode"):
        assert counters[k].launches > 0, f"the Fig. 6 mix never launched {k}"
    check_fig6(torch, np, dev, out)
    del out
    log("[fig6] results match numpy; the same steps again under the CUDA profiler:")
    fig6_steps(profiled, dev, frame, mat)
    del mat
    log(f"[fig6] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[figure1] OPPORTUNISTIC session on cuda vs the same workflow on the CPU")
    for c in counters.values():
        c.reset()
    gpu = timed("Figure-1 workflow on cuda", lambda: figure1(dev))
    fig1 = {k: c.launches for k, c in counters.items()}
    for k in counters:
        launches[k] += fig1[k]
    add_routes("segment_reduce", sr.counter.routes)
    assert fig1["onehot_encode"] > 0, "the Figure-1 workflow never launched onehot_encode"
    compare_figure1(np, gpu, figure1("cpu"))
    profiled("Figure-1 workflow on cuda", lambda: figure1(dev))
    log(f"[figure1] launches {fig1}; matches the CPU run; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[ordered] the ordered path on {dev}, {TAXI_ROWS} rows")
    for c in counters.values():
        c.reset()
    out = ordered_steps(timed, dev, frame)
    ordered = {k: c.launches for k, c in counters.items()}
    for k in counters:
        launches[k] += ordered[k]
    add_routes("segment_reduce", sr.counter.routes)
    log(f"[ordered] launches {ordered}")
    assert ordered["window_scan"] > 0, "the ordered path never launched window_scan"
    check_ordered(torch, np, dev, out, serial_steps(dev, frame))
    log("[ordered] results match numpy and the serial path; the same steps again under "
        "the CUDA profiler:")
    same_results(torch, np, out, ordered_steps(profiled, dev, frame))
    del out, frame
    log(f"[ordered] the profiled rerun is bit-identical; {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[serve] {SERVE_ARCH} at full width through ServeEngine on {dev}")
    for c in counters.values():
        c.reset()
    k7_routes, k6_routes = serving_phase(torch, np, da, dev, card)
    launches["decode_attention"] += sum(k7_routes.values())
    launches["flash_attention"] += sum(k6_routes.values())
    add_routes("decode_attention", k7_routes)
    add_routes("flash_attention", k6_routes)
    log(f"[serve] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[prefill] {PREFILL_ARCH} at full width through Model.prefill on {dev}")
    for c in counters.values():
        c.reset()
    phase8, k6_routes = prefill_phase(torch, np, fa, ls, dev, card)
    for k, n in phase8.items():
        launches[k] += n
    by_route["linear_scan"]["fwd"] += phase8["linear_scan"]
    add_routes("flash_attention", k6_routes)
    log(f"[prefill] {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[algebra] DIFFERENCE / DROP-DUPLICATES and the fusion pass on {dev}: "
        f"{DUP_ROWS} duplicate-heavy rows, {TAXI_ROWS} taxi rows")
    from repro_torch.data import taxi_like_frame
    taxi = timed(f"taxi_like_frame({TAXI_ROWS}) on the card (phases 9 and 10)",
                 lambda: taxi_like_frame(TAXI_ROWS, seed=0, device=dev))
    phase9 = algebra_phase(torch, np, dev, taxi, counters)
    for k, (n, _) in phase9.items():
        launches[k] += n
    add_routes("segment_reduce", phase9["segment_reduce"][1])
    for k in ("segment_reduce", "window_scan"):
        assert phase9[k][0] > 0, f"phase 9 never launched {k}"
    log(f"[algebra] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    taxi = taxi.to("cpu")                  # phase 10 keeps no copy of it on the card
    torch.cuda.empty_cache()
    log(f"[outofcore] the engine under a {OOC_BUDGET}-byte HBM budget on {dev}, "
        f"{TAXI_ROWS} taxi rows (the frame held on the host); chaos, read_csv, the query "
        f"service, progressive aggregation")
    phase10 = outofcore_phase(torch, np, dev, taxi, counters)
    del taxi
    for k, (n, _) in phase10.items():
        launches[k] += n
        assert n > 0, f"phase 10 never launched {k}"
    add_routes("segment_reduce", phase10["segment_reduce"][1])
    log(f"[outofcore] {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[train] {TRAIN_ARCH} at full width: the data pipeline, Adafactor steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, K5 forward and backward, checkpoint and recovery "
        f"on {dev}")
    for c in counters.values():
        c.reset()
    k5_routes = train_phase(torch, np, ls, fa, da, dev, card)
    launches["linear_scan"] += sum(k5_routes.values())
    by_route["linear_scan"]["fwd"] += k5_routes["fwd"]
    by_route["linear_scan"]["bwd"] += k5_routes["bwd"]
    log(f"[train] {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[zoo] {', '.join(a for a, _ in ZOO)} through Model.prefill and ServeEngine on {dev}")
    k6_routes, k7_routes = zoo_phase(torch, np, fa, da, dev, card)
    launches["flash_attention"] += sum(k6_routes.values())
    launches["decode_attention"] += sum(k7_routes.values())
    add_routes("flash_attention", k6_routes)
    add_routes("decode_attention", k7_routes)
    log(f"[zoo] {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[launch] meshes on {dev}, {LAUNCH_ARCH} as DTensors through prefill and decode, the "
        f"abstract dry-run of {len(LAUNCH_CELLS)} cells")
    for c in counters.values():
        c.reset()
    k6_routes, k7_routes = launch_phase(torch, np, fa, da, dev, card)
    launches["flash_attention"] += sum(k6_routes.values())
    launches["decode_attention"] += sum(k7_routes.values())
    add_routes("flash_attention", k6_routes)
    add_routes("decode_attention", k7_routes)
    log(f"[launch] {time.perf_counter() - t0:.1f} s")

    record = []
    for k in ("segment_reduce", "block_transpose", "onehot_encode", "window_scan",
              "linear_scan", "flash_attention", "decode_attention"):
        rec = dict(timings[k])
        rec["launches"] = launches[k]
        if k == "onehot_encode":
            rec["at_figure1"] = timings["onehot_encode_figure1"]
        if k == "window_scan":
            rec["at_16m"] = timings["window_scan_16m"]
        if k == "flash_attention":
            rec["at_non_causal"] = timings["flash_attention_non_causal"]
        if k == "decode_attention":
            rec["at_cross"] = timings["decode_attention_cross"]
        rec["routes"] = KERNEL_ROUTES.get(k, {"cuda": rec["source"]})
        if k in by_route:
            rec["launches_by_route"] = by_route[k]
        record.append(rec)
    missing = [k for k in record if k["launches"] == 0]
    assert not missing, f"kernels no main path launched: {missing}"
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def one_launch_child(case: str) -> int:
    """``python3 chip_smoke.py --one-launch <case>``: phase 3's one-launch
    check of ``case`` alone, in a process of its own (the kernels built
    already); prints ``ONE_LAUNCH {records}``."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    records = launch_records(torch, case, dev)
    if records is None:
        print(f"{case}: the CUDA profiler lost the window here too", file=sys.stderr)
        return 1
    print("ONE_LAUNCH " + json.dumps(records), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one-launch"]:
        sys.exit(one_launch_child(sys.argv[2]))
    sys.exit(main())
