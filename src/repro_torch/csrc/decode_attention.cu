// One decode token's grouped-query attention over a float32 KV cache, for
// every batch slot: out[b, h] = softmax(q[b, h] . K[b, :len]^T * scale) .
// V[b, :len], with len = min(lengths[b], S).  The float32 route ("fma") of
// K7; bf16, the serving step's type, runs on the tensor cores in
// decode_attention_tc.cu (route "tc").
//
// Replaces: src/repro/kernels/decode_attention.py, _decode_single (Pallas
// body _decode_kernel), for float32 operands.  The TPU kernel is called per
// slot and per KV head (vmapped), walks all S cache positions on a
// sequential grid with the running max, sum and accumulator of the G query
// rows in VMEM scratch, and masks positions past the length.  CUDA runs
// CTAs in no order, so nothing carries from one CTA to the next; the walk
// is split instead.
//
// Bound on the H100: device-memory bytes.  Each valid K and V row is read
// once: 2 * sum_b min(len_b, S) * KVH * D * 4; the arithmetic is 4 * G * D
// flops a key, far below the card's rate.
//
// Design, simple and right first:
//   pass 1  grid (split, KV head, slot).  A CTA holds the G query rows of
//           its KV head (pre-scaled) and walks its split's keys,
//           [split * kSplitKeys, (split + 1) * kSplitKeys) cut to the slot's
//           valid prefix: positions past the length are never read (the
//           Pallas kernel reads and masks them; the result is the same).
//           Keys come in tiles of 32 staged in shared memory with a padded
//           pitch, each thread issuing 8 loads of K and 8 of V before it
//           stores any.  A warp owns query rows g = warp, warp + 4, ...;
//           each lane scores one key (a sequential dot over D), the warp
//           folds the tile into the row's running max and sum (online
//           softmax), and the CTA then adds p . V into an accumulator in
//           shared memory, each element summing its keys in order.  A split
//           past the length writes an empty partial (max -inf, sum 0).
//   pass 2  grid (head, slot).  The splits' partials combine in split
//           order into the output; a row with no valid key is 0, the value
//           the Pallas kernel's l == 0 guard is written for.  In the
//           partials mode (part_o given) the combined O stays unnormalised
//           and is written as float32 with the row's (M, L), M in the log2
//           domain (the natural-log max times log2(e), rounded once; -inf
//           and L 0 where no key is valid), for a combine across devices.
// The split count is a function of S alone, so a slot's result does not
// depend on the other slots or on the lengths of its neighbours.  No
// atomics: the result is bit-identical from run to run.  The lengths stay
// on the device (no host sync).  The caches are read through their strides,
// (B, S, KVH, D) with the last dimension contiguous, so the serving cache
// needs no transpose copy.  The dot and p . V loops are unrolled so their
// shared-memory loads issue ahead of the dependent FMA chain (the sums keep
// their order).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;         // keys per tile: one per lane
constexpr int kSplitKeys = 128;   // keys per CTA of pass 1 (the wrapper's SPLIT_KEYS)
constexpr int kLoads = 8;         // loads in flight per thread per cache tensor
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Butterfly reductions: every lane ends with the same bits.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared memory of pass 1, in floats.
__host__ __device__ inline long long split_smem_floats(int g, int d) {
  return 2LL * g * d + 2LL * kTile * (d + 1) + (long long)g * kTile + 3LL * g;
}

__global__ void __launch_bounds__(kThreads)
decode_split(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ lengths,
             float* __restrict__ part_acc, float* __restrict__ part_ml,
             int kvheads, int g_size, int d, long long s,
             long long qb, long long qh, long long kb, long long ks, long long kh,
             long long vb, long long vs, long long vh, int nsplit, float scale) {
  extern __shared__ float smem[];
  const int pitch = d + 1;                      // conflict-free column reads
  float* qs = smem;                             // (G, D) scaled queries
  float* acc = qs + g_size * d;                 // (G, D) running p . V
  float* kt = acc + g_size * d;                 // (kTile, pitch)
  float* vt = kt + kTile * pitch;               // (kTile, pitch)
  float* ps = vt + kTile * pitch;               // (G, kTile) this tile's p
  float* ms = ps + g_size * kTile;              // (G,) running max
  float* ls = ms + g_size;                      // (G,) running sum
  float* al = ls + g_size;                      // (G,) this tile's rescale

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long len = lengths[b];
  len = len < 0 ? 0 : (len > s ? s : len);
  const long long s0 = (long long)split * kSplitKeys;
  const long long s1 = s0 + kSplitKeys < len ? s0 + kSplitKeys : len;

  const float* qrow = q + b * qb + (long long)kvh * g_size * qh;
  for (int i = tid; i < g_size * d; i += kThreads) {
    const int g = i / d, j = i - g * d;
    qs[i] = qrow[g * qh + j] * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < g_size; g += kThreads) {
    ms[g] = -CUDART_INF_F;
    ls[g] = 0.f;
  }
  __syncthreads();

  const float* kbase = k + b * kb + kvh * kh;
  const float* vbase = v + b * vb + kvh * vh;
  for (long long t0 = s0; t0 < s1; t0 += kTile) {
    const int nt = (int)(s1 - t0 < kTile ? s1 - t0 : kTile);
    // kLoads elements of K and of V a thread, all loads issued before the
    // first store, so that a tile costs d / (4 * kLoads) memory round trips
    // and not one per element
    for (int base = tid; base < kTile * d; base += kThreads * kLoads) {
      float kx[kLoads], vx[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kThreads;
        const int t = i / d, j = i - t * d;
        kx[u] = vx[u] = 0.f;
        if (i < kTile * d && t < nt) {
          kx[u] = kbase[(t0 + t) * ks + j];
          vx[u] = vbase[(t0 + t) * vs + j];
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kThreads;
        const int t = i / d, j = i - t * d;
        if (i < kTile * d) {
          kt[t * pitch + j] = kx[u];
          vt[t * pitch + j] = vx[u];
        }
      }
    }
    __syncthreads();
    // scores and the online-softmax fold, one warp per query row
    for (int g = warp; g < g_size; g += kWarps) {
      const float* qr = qs + g * d;
      const float* kr = kt + lane * pitch;
      float sc = 0.f;
#pragma unroll 8
      for (int j = 0; j < d; ++j) sc = fmaf(qr[j], kr[j], sc);
      const bool ok = lane < nt;
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(ok ? sc : -CUDART_INF_F));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float sum = warp_sum(p);          // every lane has read ms[g]
      ps[g * kTile + lane] = p;
      if (lane == 0) {
        const float a = expf(m_old - m_new);  // 0 on the first tile
        al[g] = a;
        ls[g] = ls[g] * a + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < g_size * d; i += kThreads) {
      const int g = i / d, j = i - g * d;
      const float* pr = ps + g * kTile;
      float o = acc[i] * al[g];
#pragma unroll 8
      for (int t = 0; t < nt; ++t) o = fmaf(pr[t], vt[t * pitch + j], o);
      acc[i] = o;
    }
    __syncthreads();
  }

  const long long row0 = (((long long)b * kvheads + kvh) * nsplit + split) * g_size;
  for (int i = tid; i < g_size * d; i += kThreads) part_acc[row0 * d + i] = acc[i];
  for (int g = tid; g < g_size; g += kThreads) {
    part_ml[(row0 + g) * 2] = ms[g];
    part_ml[(row0 + g) * 2 + 1] = ls[g];
  }
}

__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               float* __restrict__ out, float* __restrict__ dev_o, float* __restrict__ dev_ml,
               int heads, int kvheads, int g_size, int d, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / g_size, g = h - kvh * g_size;
  const long long first = ((long long)b * kvheads + kvh) * nsplit;
  float mx = -CUDART_INF_F;
  for (int sp = 0; sp < nsplit; ++sp) {
    const float* ml = part_ml + ((first + sp) * g_size + g) * 2;
    if (ml[1] > 0.f) mx = fmaxf(mx, ml[0]);
  }
  float denom = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const float* ml = part_ml + ((first + sp) * g_size + g) * 2;
    if (ml[1] > 0.f) denom += ml[1] * expf(ml[0] - mx);
  }
  const long long row = (long long)b * heads + h;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    float o = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float* ml = part_ml + ((first + sp) * g_size + g) * 2;
      if (ml[1] > 0.f)
        o = fmaf(part_acc[((first + sp) * g_size + g) * d + j], expf(ml[0] - mx), o);
    }
    if (dev_o != nullptr)
      dev_o[row * d + j] = o;
    else
      out[row * d + j] = denom > 0.f ? o / denom : 0.f;
  }
  if (dev_o != nullptr && threadIdx.x == 0) {
    dev_ml[row * 2] = denom > 0.f ? mx * kLog2e : -CUDART_INF_F;
    dev_ml[row * 2 + 1] = denom;
  }
}

}  // namespace

// q (B, H, D) float32 through strides (qb, qh); caches (B, S, KVH, D)
// float32 through strides (kb, ks, kh) and (vb, vs, vh), the last dimension
// contiguous; lengths (B,) int32 on the device; out (B, H, D) float32
// contiguous; part_acc (B, KVH, nsplit, G, D) and part_ml (B, KVH, nsplit, G,
// 2) float32 scratch.  With dev_o non-null (the partials mode) out is not
// written: dev_o (B, H, D) and dev_ml (B, H, 2) float32 contiguous take each
// row's unnormalised O and (M, L).  Returns the cudaError_t of the launches.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths, void* part_acc,
    void* part_ml, void* out, void* dev_o, void* dev_ml, int batch, int heads, int kvheads, int d, long long s,
    long long qb, long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, int nsplit, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g_size = heads / kvheads;
  const size_t smem = (size_t)split_smem_floats(g_size, d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_split<<<dim3(nsplit, kvheads, batch), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), kvheads, g_size, d, s,
      qb, qh, kb, ks, kh, vb, vs, vh, nsplit, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine<<<dim3(heads, batch), kThreads, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<float*>(out), static_cast<float*>(dev_o), static_cast<float*>(dev_ml), heads,
      kvheads, g_size, d, nsplit);
  return (int)cudaGetLastError();
}
