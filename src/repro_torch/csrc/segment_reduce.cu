// Per-segment sum / count / min / max of (M, C) float32 values over int32
// codes in [-1, G): the GROUPBY partial aggregation of the dataframe engine.
//
// Replaces: src/repro/kernels/segment_reduce.py, _segment_reduce_padded
// (Pallas body _seg_kernel).  The TPU kernel turns hash aggregation into a
// one-hot matrix product because the TPU has no scatter; Hopper has fast
// shared-memory scatter, so this kernel does not build the one-hot matrix.
//
// Bound on the H100: device-memory bytes.  The work is (M*C + M) * 4 bytes
// read once, a few flops per byte, and a (G, C) result that is tiny next to
// the input for the engine's small dense key ranges.
//
// Design, and why it is deterministic (no float atomics, no TF32, a fixed
// reduction order, so a result is bit-identical from run to run):
//   pass 1  grid (chunk, g-tile).  A CTA owns a fixed contiguous row range
//           (its chunk) and a range of TG segments (its g-tile).  Each of its
//           warps owns a fixed sub-range of the chunk's rows and its own
//           (TG, C) table in shared memory.  A warp takes 32 rows at a time;
//           lanes with equal codes are grouped by __match_any_sync, the group
//           leader folds the group's values in lane order through shuffles
//           and adds the result to the warp's table.  Warp tables are then
//           folded in warp order and written to a (chunks, G, C) scratch.
//   pass 2  one thread per (g, c) folds the chunks in chunk order.
// Large G: G*C that does not fit one shared-memory table is split into
// g-tiles (each CTA re-reads its chunk once per tile), and the wrapper caps
// the chunk count so the scratch stays bounded.  Wide C: the wrapper splits
// the columns into slabs whose one-segment warp tables fit, and launches
// once per slab; values and out are read and written through a row stride
// (ld, ldo), so a slab is a column range of the caller's tensors, not a
// copy.  Correct first; fast at large G is later work.
//
// Semantics: code < 0 or code >= G contributes nothing.  min and max
// propagate NaN, as XLA's min/max do (fminf/fmaxf would drop it).  A segment
// no row reaches gives the identity: 0 for sum and count, +inf for min, -inf
// for max (what the plain reference gives; the Pallas kernel gives +-FLT_MAX,
// and the engine masks both away on count > 0).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

enum Op { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == kMin) return CUDART_INF_F;
  if (OP == kMax) return -CUDART_INF_F;
  return 0.0f;
}

// NaN-propagating fold, written out so the order of operands is fixed.
template <int OP>
__device__ __forceinline__ float fold(float acc, float v) {
  if (OP == kMin) return (acc < v || acc != acc) ? acc : v;
  if (OP == kMax) return (acc > v || acc != acc) ? acc : v;
  return acc + v;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
seg_pass1(const float* __restrict__ values, const int* __restrict__ codes,
          float* __restrict__ scratch, long long m, int c, long long ld,
          int g, long long rows_per_chunk, int tile_g) {
  extern __shared__ float tables[];  // kWarps x tile_g x c
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long chunk = blockIdx.x;
  const int g0 = blockIdx.y * tile_g;
  const int tg = min(tile_g, g - g0);
  const int width = tg * c;
  float* mine = tables + (size_t)warp * tile_g * c;

  for (int i = threadIdx.x; i < kWarps * tile_g * c; i += kThreads)
    tables[i] = identity<OP>();
  __syncthreads();

  const long long lo = chunk * rows_per_chunk;
  const long long hi = min(m, lo + rows_per_chunk);
  const long long per_warp = (rows_per_chunk + kWarps - 1) / kWarps;
  const long long wlo = lo + warp * per_warp;
  const long long whi = min(hi, wlo + per_warp);

  for (long long base = wlo; base < whi; base += 32) {
    const long long row = base + lane;
    int local = -1;
    if (row < whi) {
      const int code = codes[row];
      if (code >= g0 && code < g0 + tg) local = code - g0;
    }
    const unsigned group = __match_any_sync(kFull, local);
    const int leader = __ffs(group) - 1;
    for (int col = 0; col < c; ++col) {
      float v = 0.0f;
      if (local >= 0) v = (OP == kCount) ? 1.0f : values[row * ld + col];
      float acc = identity<OP>();
      for (int src = 0; src < 32; ++src) {
        const float other = __shfl_sync(kFull, v, src);
        if ((group >> src) & 1u) acc = fold<OP>(acc, other);
      }
      if (local >= 0 && lane == leader) {
        float* slot = mine + local * c + col;
        *slot = fold<OP>(*slot, acc);
      }
    }
    __syncwarp();
  }
  __syncthreads();

  float* dst = scratch + (chunk * g + g0) * (long long)c;
  for (int i = threadIdx.x; i < width; i += kThreads) {
    float acc = identity<OP>();
    for (int w = 0; w < kWarps; ++w)
      acc = fold<OP>(acc, tables[(size_t)w * tile_g * c + i]);
    dst[i] = acc;
  }
}

template <int OP>
__global__ void seg_pass2(const float* __restrict__ scratch,
                          float* __restrict__ out, long long gc, int c,
                          long long ldo, int chunks) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= gc) return;
  float acc = identity<OP>();
  // unrolled so several chunk loads are in flight; the fold order is fixed
#pragma unroll 8
  for (int b = 0; b < chunks; ++b) acc = fold<OP>(acc, scratch[b * gc + i]);
  out[(i / c) * ldo + i % c] = acc;
}

template <int OP>
cudaError_t launch(const float* values, const int* codes, float* out,
                   float* scratch, long long m, int c, long long ld,
                   long long ldo, int g, int chunks, long long rows_per_chunk,
                   int tile_g, cudaStream_t stream) {
  const int tiles = (g + tile_g - 1) / tile_g;
  const size_t smem = (size_t)kWarps * tile_g * c * sizeof(float);
  dim3 grid1((unsigned)chunks, (unsigned)tiles);
  seg_pass1<OP><<<grid1, kThreads, smem, stream>>>(values, codes, scratch, m,
                                                   c, ld, g, rows_per_chunk,
                                                   tile_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long gc = (long long)g * c;
  const int threads = 256;
  const long long blocks = (gc + threads - 1) / threads;
  seg_pass2<OP><<<(unsigned)blocks, threads, 0, stream>>>(scratch, out, gc, c,
                                                          ldo, chunks);
  return cudaGetLastError();
}

}  // namespace

// values (m, c) float32 with row stride ld, codes (m,) int32, out (g, c)
// float32 with row stride ldo, scratch (chunks, g, c) float32 contiguous.
// Shared memory per CTA is 8 * tile_g * c * 4 bytes and must stay within
// the default 48 KB.
extern "C" int repro_segment_reduce(const float* values, const int* codes,
                                    float* out, float* scratch, long long m,
                                    int c, long long ld, long long ldo, int g,
                                    int op, int chunks,
                                    long long rows_per_chunk, int tile_g,
                                    void* stream) {
  if (c < 1 || ld < c || ldo < c || g < 1 || chunks < 1 || tile_g < 1 ||
      tile_g > g ||
      (size_t)kWarps * tile_g * c * sizeof(float) > 48 * 1024 ||
      (long long)chunks * rows_per_chunk < m || (g + tile_g - 1) / tile_g > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kSum: return (int)launch<kSum>(values, codes, out, scratch, m, c, ld, ldo, g, chunks, rows_per_chunk, tile_g, s);
    case kCount: return (int)launch<kCount>(values, codes, out, scratch, m, c, ld, ldo, g, chunks, rows_per_chunk, tile_g, s);
    case kMin: return (int)launch<kMin>(values, codes, out, scratch, m, c, ld, ldo, g, chunks, rows_per_chunk, tile_g, s);
    case kMax: return (int)launch<kMax>(values, codes, out, scratch, m, c, ld, ldo, g, chunks, rows_per_chunk, tile_g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
