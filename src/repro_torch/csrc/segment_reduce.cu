// Per-segment sum / count / min / max of (M, C) float32 values over int32
// codes in [-1, G): the GROUPBY partial aggregation of the dataframe engine.
//
// Replaces: src/repro/kernels/segment_reduce.py, _segment_reduce_padded
// (Pallas body _seg_kernel).  The TPU kernel turns hash aggregation into a
// one-hot matrix product because the TPU has no scatter; Hopper has
// registers and fast shared memory, so neither route here builds the
// one-hot matrix.
//
// Bound on the H100: device-memory bytes.  The work is (M*C + M) * 4 bytes
// read once, a few flops per byte, and a (G, C) result that is tiny next to
// the input for the engine's small dense key ranges.
//
// Two routes, picked by the wrapper from (C, G) alone (route()); neither
// uses float atomics or TF32, and each folds in a fixed order, so a result
// is bit-identical from run to run.
//
// Route "reg": G padded to a power of two >= 8 (GMAX) times C padded to 1,
// 2, 4 or 8 (CP) is at most 64 accumulators.  The engine's GROUPBY blocks
// (Fig. 6: G 6, C 8) and G <= 64 at C 1.  One launch, seg_reg<OP, CP, GMAX>:
//   rows      grid of `ctas` CTAs of 512 threads (the wrapper's reg_plan: at
//             most 132, one an SM; a function of M alone).  CTA b owns rows
//             [b * per, (b + 1) * per) cut to M.  It walks them in steps of
//             512 * U rows (U rows a lane: 16 for count, 8 at CP 1 and 2,
//             4 at CP 4 and 8); in step k warp w reads the 32 * U
//             consecutive rows lo + 512 U k + 32 U w + [0, 32 U), lane l
//             rows 32 u + l, u = 0 .. U - 1: one row a lane, by 16-byte
//             loads where C == CP and the base allows it (two float4 a row
//             at C 8, so a warp's 32 rows are 1 KB contiguous), else by
//             C scalar loads.
//   fold      each thread keeps acc[GMAX][CP] in registers (indices fixed
//             at compile time: nothing spills) and folds its rows in the
//             order (k, u) above, for every slot s: sum and count acc =
//             (code == s) ? acc + v : acc (a select, so the NaN or -0.0 of
//             a row that is not selected never enters), min acc =
//             min.NaN(acc, code == s ? v : +inf), max likewise.  A code
//             outside [0, G) matches no written slot.  count keeps one
//             accumulator a segment and reads no values.
//   combine   (1) per warp, a butterfly: x = fold(x, shfl_xor(x, o)) for o =
//             16, 8, 4, 2, 1, lane 0's value kept; (2) per CTA, from the
//             identity, the 16 warps' values in warp order, stored to
//             part[b][e] (e = slot * CP + column); (3) every CTA then takes a
//             ticket, atomicInc on an int that wraps to 0 when the last CTA
//             takes it (the wrapper keeps one zeroed int a device and
//             stream), after a __threadfence(); the CTA that draws the last
//             ticket folds part[0 .. ctas)[e], from the identity, in CTA
//             (chunk) order, and writes out.  The ticket decides which CTA
//             folds, never the order.  One launch a call.
//   For sum this order is repro_torch.kernels.segment_reduce.emulated_sum in
//   float32 on the CPU (adds only: no contraction can part them);
//   chip_smoke.py holds the kernel to it bit for bit.
//
// Route "table" (every other (C, G): G 65,536, slabs of 1,536+ columns):
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
// copy.
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


// ---- route "reg" -------------------------------------------------------------
constexpr int kRegThreads = 512;    // the wrapper's REG_THREADS
constexpr int kRegWarps = kRegThreads / 32;
constexpr int kRegMaxCtas = 132;    // the wrapper's REG_CTAS: one CTA an SM of an H100

// Rows a lane reads a step (the wrapper's reg_rows): 16 to 36 registers of
// loads in flight beside the accumulators, within 128 registers a thread
// (16 rows at CP 1 spilled at G 8).
template <int OP, int CP>
__host__ __device__ constexpr int reg_rows() {
  return OP == kCount ? 16 : (CP <= 2 ? 8 : 4);
}

// min / max of a row into an accumulator: one instruction that returns NaN
// if either operand is NaN (which NaN comes out is the card's canonical one).
template <int OP>
__device__ __forceinline__ float fold_nan(float acc, float v) {
  float r;
  if (OP == kMin)
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(acc), "f"(v));
  else
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(acc), "f"(v));
  return r;
}

// One row's CP values (columns past C read as 0): 16-byte vectors (8-byte
// at CP 2) where `vec` (C == CP and an aligned base), else C scalar loads.
template <int CP>
__device__ __forceinline__ void load_row(float* x, const float* __restrict__ values,
                                         long long row, int c, bool vec) {
  if constexpr (CP >= 4) {
    if (vec) {
      const float4* p = reinterpret_cast<const float4*>(values + row * CP);
#pragma unroll
      for (int j = 0; j < CP / 4; ++j) {
        const float4 t = __ldg(p + j);
        x[4 * j] = t.x; x[4 * j + 1] = t.y; x[4 * j + 2] = t.z; x[4 * j + 3] = t.w;
      }
      return;
    }
  } else if constexpr (CP == 2) {
    if (vec) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(values + row * 2));
      x[0] = t.x; x[1] = t.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < CP; ++j) x[j] = j < c ? __ldg(values + row * c + j) : 0.0f;
}

// Every index into acc, x and code is a compile-time constant after
// unrolling: no dynamic register indexing, no local memory.
template <int OP, int CP, int GMAX>
__global__ void __launch_bounds__(kRegThreads, 1)
seg_reg(const float* __restrict__ values, const int* __restrict__ codes,
        float* __restrict__ part, unsigned* __restrict__ ticket, float* __restrict__ out,
        long long m, int c, long long ldo, int g, long long per, int vec) {
  constexpr int W = (OP == kCount) ? 1 : CP;   // accumulator columns
  constexpr int U = reg_rows<OP, CP>();
  constexpr int E = GMAX * W;                  // accumulators a thread
  __shared__ float red[kRegWarps][E];
  __shared__ float stage[kRegMaxCtas * E];
  __shared__ bool last;
  float acc[GMAX][W];
#pragma unroll
  for (int s = 0; s < GMAX; ++s)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[s][j] = identity<OP>();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long lo = (long long)blockIdx.x * per;
  const long long hi = min(m, lo + per);
  for (long long base = lo + (long long)warp * 32 * U; base < hi;
       base += (long long)kRegThreads * U) {
    int code[U];
    float x[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = base + u * 32 + lane;
      const bool ok = row < hi;
      code[u] = ok ? __ldg(codes + row) : -1;
      if constexpr (OP != kCount) {
        if (ok) {
          load_row<CP>(x[u], values, row, c, vec);
        } else {
#pragma unroll
          for (int j = 0; j < W; ++j) x[u][j] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int s = 0; s < GMAX; ++s) {
        const bool hit = code[u] == s;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          if constexpr (OP == kMin || OP == kMax) {
            // an unselected row folds the identity, which changes nothing
            acc[s][j] = fold_nan<OP>(acc[s][j], hit ? x[u][j] : identity<OP>());
          } else if constexpr (OP == kCount) {
            const float f = acc[s][j] + 1.0f;
            acc[s][j] = hit ? f : acc[s][j];
          } else {
            const float f = acc[s][j] + x[u][j];
            acc[s][j] = hit ? f : acc[s][j];
          }
        }
      }
  }

  // (1) lanes by the butterfly, (2) warps in warp order
#pragma unroll
  for (int s = 0; s < GMAX; ++s)
#pragma unroll
    for (int j = 0; j < W; ++j) {
      float y = acc[s][j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) y = fold<OP>(y, __shfl_xor_sync(kFull, y, o));
      if (lane == 0) red[warp][s * W + j] = y;
    }
  __syncthreads();
  float* mine = part + (long long)blockIdx.x * E;
  for (int e = threadIdx.x; e < E; e += kRegThreads) {
    float y = identity<OP>();
    for (int w = 0; w < kRegWarps; ++w) y = fold<OP>(y, red[w][e]);
    mine[e] = y;
  }
  // (3) the CTA that draws the last ticket folds the CTAs' partials in
  // CTA order; the ticket wraps to 0 for the next call on this stream
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n = (int)gridDim.x * E;
  for (int i = threadIdx.x; i < n; i += kRegThreads) stage[i] = __ldcg(part + i);
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += kRegThreads) {
    const int s = e / W, j = e - s * W;
    if (s >= g) continue;
    float y = identity<OP>();
#pragma unroll 4
    for (int b = 0; b < (int)gridDim.x; ++b) y = fold<OP>(y, stage[b * E + e]);
    if (OP == kCount) {
      for (int col = 0; col < c; ++col) out[s * ldo + col] = y;   // every column
    } else if (j < c) {
      out[s * ldo + j] = y;
    }
  }
}

template <int OP, int CP, int GMAX>
cudaError_t reg_launch(const float* values, const int* codes, float* out, float* part,
                       unsigned* ticket, long long m, int c, long long ldo, int g, int ctas,
                       long long per, int vec, cudaStream_t stream) {
  seg_reg<OP, CP, GMAX><<<ctas, kRegThreads, 0, stream>>>(values, codes, part, ticket, out, m,
                                                          c, ldo, g, per, vec);
  return cudaGetLastError();
}

// GMAX: G padded to a power of two >= 8, with GMAX * CP <= 64.
template <int OP, int CP>
cudaError_t reg_by_g(const float* values, const int* codes, float* out, float* part,
                     unsigned* ticket, long long m, int c, long long ldo, int g, int ctas,
                     long long per, int vec, cudaStream_t s) {
  const int gmax = g <= 8 ? 8 : g <= 16 ? 16 : g <= 32 ? 32 : 64;
#define REPRO_REG(GM)                                                                   \
  if constexpr (GM * CP <= 64) {                                                        \
    if (gmax == GM)                                                                     \
      return reg_launch<OP, CP, GM>(values, codes, out, part, ticket, m, c, ldo, g, ctas, \
                                    per, vec, s);                                       \
  }
  REPRO_REG(8)
  REPRO_REG(16)
  REPRO_REG(32)
  REPRO_REG(64)
#undef REPRO_REG
  return cudaErrorInvalidValue;
}

template <int OP>
cudaError_t reg_by_c(const float* values, const int* codes, float* out, float* part,
                     unsigned* ticket, long long m, int c, long long ldo, int g, int ctas,
                     long long per, cudaStream_t s) {
  // count reads no values: one accumulator a segment whatever C is
  if constexpr (OP == kCount) {
    return reg_by_g<OP, 1>(values, codes, out, part, ticket, m, c, ldo, g, ctas, per, 0, s);
  } else {
    const int cp = c <= 1 ? 1 : c <= 2 ? 2 : c <= 4 ? 4 : 8;
    const uintptr_t align = cp >= 4 ? 16 : 4 * cp;
    const int vec = c == cp && reinterpret_cast<uintptr_t>(values) % align == 0;
    switch (cp) {
      case 1: return reg_by_g<OP, 1>(values, codes, out, part, ticket, m, c, ldo, g, ctas, per, vec, s);
      case 2: return reg_by_g<OP, 2>(values, codes, out, part, ticket, m, c, ldo, g, ctas, per, vec, s);
      case 4: return reg_by_g<OP, 4>(values, codes, out, part, ticket, m, c, ldo, g, ctas, per, vec, s);
      default: return reg_by_g<OP, 8>(values, codes, out, part, ticket, m, c, ldo, g, ctas, per, vec, s);
    }
  }
}

}  // namespace

// Route "table": values (m, c) float32 with row stride ld, codes (m,) int32,
// out (g, c) float32 with row stride ldo, scratch (chunks, g, c) float32
// contiguous.  Shared memory per CTA is 8 * tile_g * c * 4 bytes and must
// stay within the default 48 KB.
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

// Route "reg": values (m, c) float32 contiguous, codes (m,) int32, out (g,
// c) float32 with row stride ldo; part (ctas, GMAX * CP) float32 scratch
// (GMAX * 1 for count); ticket one int on the device, 0 between calls (the
// kernel leaves it 0), used by one stream at a time; c <= 8 and GMAX * CP
// (GMAX for count) at most 64; `ctas` CTAs (at most 132) of `per` rows
// each cover every row.  Returns the cudaError_t of the launch.
extern "C" int repro_segment_reduce_reg(const float* values, const int* codes, float* out,
                                        float* part, void* ticket, long long m, int c,
                                        long long ldo, int g, int op, int ctas, long long per,
                                        void* stream) {
  const int cp = (op == kCount) ? 1 : (c <= 1 ? 1 : c <= 2 ? 2 : c <= 4 ? 4 : 8);
  const int gmax = g <= 8 ? 8 : g <= 16 ? 16 : g <= 32 ? 32 : 64;
  if (c < 1 || c > 8 || ldo < c || g < 1 || g > 64 || gmax * cp > 64 || ctas < 1 ||
      ctas > kRegMaxCtas || per < 0 || (long long)ctas * per < m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* t = static_cast<unsigned*>(ticket);
  switch (op) {
    case kSum: return (int)reg_by_c<kSum>(values, codes, out, part, t, m, c, ldo, g, ctas, per, s);
    case kCount: return (int)reg_by_c<kCount>(values, codes, out, part, t, m, c, ldo, g, ctas, per, s);
    case kMin: return (int)reg_by_c<kMin>(values, codes, out, part, t, m, c, ldo, g, ctas, per, s);
    case kMax: return (int)reg_by_c<kMax>(values, codes, out, part, t, m, c, ldo, g, ctas, per, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
