// Fused (flash) attention of the forward / prefill pass in float32, every
// batch row and head in one launch: out[b, i, h] = softmax(q[b, i, h] .
// K[b, :, h / G]^T * scale, masked) . V[b, :, h / G], with query positions
// aligned to the end of the key axis (query i sits at position i + Sk -
// Sq), a causal mask (key <= position) and a local window (key > position -
// window).  bf16 takes the tensor cores (flash_attention_tc.cu) through the
// same entry point, repro_flash_attention.
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_single (Pallas
// body _flash_kernel).  The TPU kernel is vmapped over batch x heads (the
// model repeats K/V to every query head and transposes to (B*H, S, D)
// first); per head it keeps a (TQ, D) query tile in VMEM and walks every key
// tile on a sequential grid, the running max, sum and accumulator in VMEM
// scratch, masking key tiles it still reads.
//
// Bound on the H100: operations.  4 * D flops for each visible (query, key)
// pair; bytes are q, k, v read once and out written once.
//
// Design (float32 FMA on the CUDA cores: TF32 tensor cores would round the
// operands; bf16 inputs take flash_attention_tc.cu):
//   grid (query tile, head, batch row); a CTA of 8 warps owns 64 query rows
//   of one head, each warp 8 rows.  The tile's queries, pre-scaled, sit in
//   shared memory.  The CTA walks only the key tiles that meet its causal /
//   window band (the Pallas kernel reads every tile and masks; the function
//   is the same), in key order, 32 keys a tile staged in shared memory.
//   Per tile:
//     scores  lane j of a warp scores key j against the warp's 8 rows, a
//             sequential dot over D (float4 reads of q and k);
//     softmax the warp folds the tile into each row's running max and sum
//             (online softmax, float32; butterfly reductions, so every lane
//             holds the same bits);
//     p . V   lane j owns output columns j, j + 32, ... of the warp's 8
//             rows in registers and adds p[row, key] (a shuffle from the
//             key's lane) times V[key, column], keys in order.
//   A row with no visible key gives 0, the value the Pallas kernel's l == 0
//   guard is written for (its finite -1e30 mask never lets the guard fire).
//   Heavy causal tiles (the last query tiles) are scheduled first.
// No atomics and a fixed order of every sum: bit-identical from run to run.
// q is read through strides (B, Sq, H, D) and k / v through (B, Sk, KVH, D),
// the last dimension contiguous, so the model's GQA layout needs neither a
// K/V repeat nor a transpose; head h reads KV head h / G.  out is
// contiguous (B, Sq, H, D).  D <= 256: the kernel is compiled for D up to
// 64, 128 and 256, the unused columns zero.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                   // query rows per warp
constexpr int kTileQ = kWarps * kRows;     // 64 query rows per CTA (the wrapper's TILE_Q)
constexpr int kTileK = 32;                 // keys per tile: one per lane
constexpr int kLoads = 8;                  // loads in flight per thread per tensor
constexpr unsigned kFull = 0xffffffffu;

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

// Shared memory, in floats: q (kTileQ, DMAX + 4), k (kTileK, DMAX + 4), v
// (kTileK, DMAX).  The +4 pitch keeps rows 16-byte aligned and makes a
// warp's float4 reads of 32 different k rows conflict-free.
template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kTileQ * (DMAX + 4) + (size_t)kTileK * (DMAX + 4) +
                          (size_t)kTileK * DMAX);
}

struct Args {
  const void* q; const void* k; const void* v; void* out;
  int heads, kvheads, d;
  long long sq, sk;
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
  int causal;
  long long window;   // 0: none
  float scale;
};

template <int DMAX>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(Args args) {
  constexpr int kPitch = DMAX + 4;
  constexpr int kCols = DMAX / 32;           // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // (kTileQ, kPitch)
  float* kt = qs + kTileQ * kPitch;             // (kTileK, kPitch)
  float* vt = kt + kTileK * kPitch;             // (kTileK, DMAX)

  const float* __restrict__ q = static_cast<const float*>(args.q);
  const float* __restrict__ k = static_cast<const float*>(args.k);
  const float* __restrict__ v = static_cast<const float*>(args.v);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long qtile = (long long)gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (args.heads / args.kvheads);
  const int d = args.d;
  const long long q0 = qtile * kTileQ;
  const long long off = args.sk - args.sq;       // query i sits at key position i + off

  // the tile's queries, scaled, columns past D zero
  const float* qbase = q + b * args.qb + h * args.qh;
  for (int i = tid; i < kTileQ * DMAX; i += kThreads) {
    const int r = i / DMAX, j = i - r * DMAX;
    float x = 0.f;
    if (j < d && q0 + r < args.sq) x = qbase[(q0 + r) * args.qs + j] * args.scale;
    qs[r * kPitch + j] = x;
  }

  // the key range this tile's rows can see
  const long long last = (q0 + kTileQ < args.sq ? q0 + kTileQ : args.sq) - 1;
  long long k_begin = 0, k_end = args.sk;
  if (args.causal) k_end = last + off + 1 < k_end ? last + off + 1 : k_end;
  if (args.window > 0) {
    const long long lo = q0 + off - args.window + 1;
    k_begin = lo > 0 ? lo : 0;
  }

  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const float* kbase = k + b * args.kb + kvh * args.kh;
  const float* vbase = v + b * args.vb + kvh * args.vh;
  const int row0 = warp * kRows;
  for (long long k0 = k_begin; k0 < k_end; k0 += kTileK) {
    const int nt = (int)(args.sk - k0 < kTileK ? args.sk - k0 : kTileK);
    __syncthreads();   // the previous tile's reads are done (and q is staged)
    for (int base = tid; base < kTileK * DMAX; base += kThreads * kLoads) {
      float kx[kLoads], vx[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kThreads;
        const int t = i / DMAX, j = i - t * DMAX;
        kx[u] = vx[u] = 0.f;
        if (i < kTileK * DMAX && t < nt && j < d) {
          kx[u] = kbase[(k0 + t) * args.ks + j];
          vx[u] = vbase[(k0 + t) * args.vs + j];
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = base + u * kThreads;
        const int t = i / DMAX, j = i - t * DMAX;
        if (i < kTileK * DMAX) {
          kt[t * kPitch + j] = kx[u];
          vt[t * DMAX + j] = vx[u];
        }
      }
    }
    __syncthreads();

    // scores: lane = key, the warp's 8 rows
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(kt + lane * kPitch);
    const int d4 = (d + 3) >> 2;
#pragma unroll 2
    for (int c = 0; c < d4; ++c) {
      const float4 kv = kr[c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = reinterpret_cast<const float4*>(qs + (row0 + i) * kPitch)[c];
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    // mask and the online-softmax fold
    const long long kpos = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long qi = q0 + row0 + i;
      const long long pos = qi + off;
      const bool ok = lane < nt && qi < args.sq && (!args.causal || kpos <= pos) &&
                      (args.window <= 0 || kpos > pos - args.window);
      const float sc = ok ? s[i] : -CUDART_INF_F;
      const float m_new = fmaxf(m[i], warp_max(sc));
      p[i] = ok ? expf(sc - m_new) : 0.f;
      // m[i] == -inf: nothing seen yet, acc and l are 0 whatever alpha is
      const float alpha = m[i] == -CUDART_INF_F ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }

    // p . V, keys in order
#pragma unroll 4
    for (int t = 0; t < kTileK; ++t) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vt[t * DMAX + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pt = __shfl_sync(kFull, p[i], t);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pt, vv[c], acc[i][c]);
      }
    }
  }

  float* out = static_cast<float*>(args.out);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long qi = q0 + row0 + i;
    if (qi >= args.sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow = out + ((b * args.sq + qi) * args.heads + h) * (long long)d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = lane + 32 * c;
      if (j < d) orow[j] = l[i] > 0.f ? acc[i][c] * inv : 0.f;
    }
  }
}

template <int DMAX>
int launch(const Args& args, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<DMAX>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned tiles = (unsigned)((args.sq + kTileQ - 1) / kTileQ);
  flash_fwd<DMAX><<<dim3(tiles, args.heads, batch), kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

// flash_attention_tc.cu: the bf16 kernel on the tensor cores
int flash_tc_launch(const void* q, const void* k, const void* v, void* out, int batch,
                    int heads, int kvheads, int d, long long sq, long long sk, long long qb,
                    long long qs, long long qh, long long kb, long long ks, long long kh,
                    long long vb, long long vs, long long vh, int causal, long long window,
                    float scale, cudaStream_t stream);

// q (B, Sq, H, D) through strides (qb, qs, qh); k, v (B, Sk, KVH, D)
// through (kb, ks, kh) and (vb, vs, vh); the last dimension contiguous in
// all three; out (B, Sq, H, D) contiguous; q, k, v and out of one type,
// bfloat16 (bf16 = 1: flash_tc on the tensor cores, which also needs the
// bases 16-byte aligned and the strides multiples of 8) or float32 (0:
// flash_fwd).  1 <= D <= 256, H a multiple of KVH, Sq >= 1, Sk >= 1, B and
// H <= 65535; window 0 for none, else >= 1.  Returns the cudaError_t of the
// launch (flash_tc_launch: or 10000 + a tensor-map encode's CUresult).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int bf16, int batch,
    int heads, int kvheads, int d, long long sq, long long sk, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, int causal, long long window, float scale,
    void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || kvheads < 1 ||
      heads % kvheads || d < 1 || d > 256 || sq < 1 || sk < 1 || window < 0 ||
      (sq + kTileQ - 1) / kTileQ > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return flash_tc_launch(q, k, v, out, batch, heads, kvheads, d, sq, sk, qb, qs, qh, kb, ks,
                           kh, vb, vs, vh, causal, window, scale, st);
  const Args args{q, k, v, out, heads, kvheads, d, sq, sk, qb, qs, qh,
                  kb, ks, kh, vb, vs, vh, causal, window, scale};
  if (d <= 64) return launch<64>(args, batch, st);
  if (d <= 128) return launch<128>(args, batch, st);
  return launch<256>(args, batch, st);
}
