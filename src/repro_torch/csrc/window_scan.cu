// Inclusive scan along axis 0 of each column of an (M, N) float32 matrix:
// cumsum, cummax, cummin or cumprod.  The WINDOW operator's per-block scan.
//
// Replaces: src/repro/kernels/window_scan.py, _window_scan_padded (Pallas
// body _scan_kernel).  The TPU kernel walks the rows on a sequential grid and
// carries the running value across tiles in VMEM scratch.  CUDA runs CTAs in
// no order, so nothing can carry from one CTA to the next; the scan is split
// into three launches instead.  (cumprod is jnp.cumprod in the reference,
// not a Pallas kernel; it runs here too so that every WINDOW scan on the
// card is bit-identical from run to run.)
//
// Bound on the H100: device-memory bytes, M * N * 4 read and M * N * 4
// written; one add or compare per element.
//
// Design: a three-phase scan with a fixed association order.  Rows are cut
// into chunks of kChunk = kThreads * kRun rows; the chunk count is a
// function of M alone.
//   phase 1  grid (chunk, column).  A CTA stages its chunk in shared memory
//            (coalesced when the column is contiguous), each thread folds its
//            kRun consecutive rows in order, and the thread totals combine
//            through a fixed shuffle tree into the chunk total.
//   phase 2  one CTA per column scans the chunk totals in chunk order (each
//            thread a consecutive run, then the same shuffle tree) and
//            overwrites them with exclusive carries.
//   phase 3  grid (chunk, column) again.  Each thread starts from the carry
//            of its chunk folded with the exclusive prefix of the threads
//            before it, and folds its run in order, writing every row.
// Nothing depends on timing: no atomics, no decoupled look-back (how many
// predecessor aggregates a look-back folds depends on which CTAs finished
// first, so a float cumsum would not be bit-identical from run to run).
//
// Semantics: max and min propagate NaN, as jnp.maximum / jnp.minimum do
// (fmaxf/fminf would drop it); on ties the later value wins, as in
// torch.cummax / torch.cummin.  Both folds are associative on bits, so the
// results equal the sequential scan's bit for bit.  The running value starts
// at the identity 0, -inf, +inf or 1 (the Pallas kernel starts max / min at
// -FLT_MAX / +FLT_MAX; the engine's identity and the plain version use +-inf).
// Sums are exact to rounding in this fixed order, not sequential order.
// Input is read through a row stride and a column stride (in elements), so
// a column view of a wider matrix needs no copy; the output is contiguous
// (M, N).  Offsets are 64-bit: M * N may pass 2^31.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;
constexpr int kChunk = kThreads * kRun;
constexpr int kPitch = kRun + 1;  // pads each thread's run: conflict-free reads
constexpr unsigned kFull = 0xffffffffu;

enum Op { kSum = 0, kMax = 1, kMin = 2, kProd = 3 };

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == kMax) return -CUDART_INF_F;
  if (OP == kMin) return CUDART_INF_F;
  if (OP == kProd) return 1.0f;
  return 0.0f;
}

// acc folded with the next value v.  Written out so the operand order is
// fixed: a NaN v wins, then a NaN acc, then the strictly better acc.
template <int OP>
__device__ __forceinline__ float fold(float acc, float v) {
  if (OP == kSum) return acc + v;
  if (OP == kProd) return acc * v;
  if (v != v) return v;
  if (acc != acc) return acc;
  if (OP == kMax) return acc > v ? acc : v;
  return acc < v ? acc : v;
}

// Exclusive prefix of the threads' values in thread order, through a fixed
// tree: an inclusive shuffle scan per warp, then the warp totals scanned by
// warp 0.  Every thread of the CTA must call it.
template <int OP>
__device__ float cta_exclusive(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float other = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = fold<OP>(other, inc);
  }
  float lane_excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kWarps ? warp_tot[lane] : identity<OP>();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const float other = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = fold<OP>(other, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  float excl;
  if (warp == 0)
    excl = lane == 0 ? identity<OP>() : lane_excl;
  else
    excl = lane == 0 ? warp_tot[warp - 1] : fold<OP>(warp_tot[warp - 1], lane_excl);
  __syncthreads();  // warp_tot may be reused by the caller
  return excl;
}

// Stage rows [row0, row0 + kChunk) of one column into shared memory, each
// thread's run at a padded pitch; rows past m read as the identity.
template <int OP>
__device__ void load_chunk(float* tile, const float* __restrict__ x,
                           long long m, long long rs, long long row0) {
  // unrolled, so a thread's kRun loads are all in flight at once
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const long long row = row0 + i;
    tile[(i / kRun) * kPitch + i % kRun] = row < m ? x[row * rs] : identity<OP>();
  }
  __syncthreads();
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
scan_totals(const float* __restrict__ x, float* __restrict__ totals,
            long long m, long long rs, long long cs, long long chunks) {
  __shared__ float tile[kThreads * kPitch];
  __shared__ float warp_tot[kWarps];
  const long long chunk = blockIdx.x;
  const long long col = blockIdx.y;
  load_chunk<OP>(tile, x + col * cs, m, rs, chunk * kChunk);
  const float* run = tile + threadIdx.x * kPitch;
  float acc = run[0];
#pragma unroll
  for (int k = 1; k < kRun; ++k) acc = fold<OP>(acc, run[k]);
  // the chunk total is the exclusive prefix of the last thread folded with
  // its own run total, the same tree every thread of phase 3 uses
  const float excl = cta_exclusive<OP>(acc, warp_tot);
  if (threadIdx.x == kThreads - 1) totals[col * chunks + chunk] = fold<OP>(excl, acc);
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
scan_carries(float* __restrict__ totals, long long chunks) {
  __shared__ float warp_tot[kWarps];
  float* t = totals + (long long)blockIdx.x * chunks;
  const long long per = (chunks + kThreads - 1) / kThreads;
  const long long lo = min(chunks, per * threadIdx.x);
  const long long hi = min(chunks, lo + per);
  float acc = identity<OP>();
  for (long long i = lo; i < hi; ++i) acc = fold<OP>(acc, t[i]);
  float carry = cta_exclusive<OP>(acc, warp_tot);
  for (long long i = lo; i < hi; ++i) {
    const float v = t[i];
    t[i] = carry;
    carry = fold<OP>(carry, v);
  }
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
scan_apply(const float* __restrict__ x, const float* __restrict__ carries,
           float* __restrict__ out, long long m, int n, long long rs,
           long long cs, long long chunks) {
  __shared__ float tile[kThreads * kPitch];
  __shared__ float warp_tot[kWarps];
  const long long chunk = blockIdx.x;
  const long long col = blockIdx.y;
  const long long row0 = chunk * kChunk;
  load_chunk<OP>(tile, x + col * cs, m, rs, row0);
  float* run = tile + threadIdx.x * kPitch;
  float tot = run[0];
#pragma unroll
  for (int k = 1; k < kRun; ++k) tot = fold<OP>(tot, run[k]);
  const float excl = cta_exclusive<OP>(tot, warp_tot);
  float acc = fold<OP>(carries[col * chunks + chunk], excl);
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    acc = fold<OP>(acc, run[k]);
    run[k] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const long long row = row0 + i;
    if (row < m) out[row * n + col] = tile[(i / kRun) * kPitch + i % kRun];
  }
}

template <int OP>
cudaError_t launch(const float* x, float* out, float* totals, long long m,
                   int n, long long rs, long long cs, long long chunks,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)chunks, (unsigned)n);
  scan_totals<OP><<<grid, kThreads, 0, stream>>>(x, totals, m, rs, cs, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_carries<OP><<<(unsigned)n, kThreads, 0, stream>>>(totals, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_apply<OP><<<grid, kThreads, 0, stream>>>(x, totals, out, m, n, rs, cs, chunks);
  return cudaGetLastError();
}

}  // namespace

// x (m, n) float32 read at x[row * rs + col * cs]; out (m, n) float32
// contiguous; totals (n, chunks) float32 scratch with chunks =
// ceil(m / 4096), checked here.  m >= 1, 1 <= n <= 65535.
extern "C" int repro_window_scan(const float* x, float* out, float* totals,
                                 long long m, int n, long long rs,
                                 long long cs, int op, long long chunks,
                                 void* stream) {
  if (m < 1 || n < 1 || n > 65535 || rs < 0 || cs < 0 ||
      chunks != (m + kChunk - 1) / kChunk || chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kSum: return (int)launch<kSum>(x, out, totals, m, n, rs, cs, chunks, s);
    case kMax: return (int)launch<kMax>(x, out, totals, m, n, rs, cs, chunks, s);
    case kMin: return (int)launch<kMin>(x, out, totals, m, n, rs, cs, chunks, s);
    case kProd: return (int)launch<kProd>(x, out, totals, m, n, rs, cs, chunks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
