// RMSNorm of rows: out[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps)) * scale, in x's
// dtype (bfloat16 or float32), scale float32: the norms of the model zoo's rmsnorm
// configurations, two a layer and the final one.
//
// Replaces no TPU kernel: the JAX package (src/repro/models/layers.py, rmsnorm) leaves the
// norm to XLA, whose fusion keeps the float32 chain out of device memory.  The port ran it
// as about eight ATen launches (the cast, the square, the mean, + eps, rsqrt, two
// multiplies, the cast back), each moving the whole row in float32: ~40 bytes an element
// against the 4 a bfloat16 norm must move.  On yi-6b's prefill (4 x S tokens, d 4096, 65
// norms a prefill) that chain ran at 7.3% of its byte roofline and took 15% of the traced
// device time (PERF.md).
//
// Bound on the H100: device-memory bytes, each row read once and written once, 4 * d bytes
// a row in bfloat16 (8 * d in float32); scale's 4 * d bytes are read by every row and stay
// in L2.  Three flops an element.
//
// Design: one CTA a row; the row is held in registers between its sum of squares and its
// scaling, so x is read once.  A thread holds K chunks of VEC elements, chunk
// c = threadIdx.x + k * blockDim.x of the row: 16-byte loads and stores (8 bfloat16 or 4
// float32 a chunk) where d, the row stride and the three base addresses allow them, else
// one element a chunk.  The wrapper (kernels/rms_norm.py, launch_shape) picks K and the
// threads from d and the row count.  The sum of squares is taken in float32: each thread
// its own chunks in order, then a butterfly of warp shuffles, then warp 0 sums the warps'
// totals through 32 floats of shared memory, again by a butterfly.  The order is fixed by
// the launch shape, so reruns are bit-identical; it is not torch.mean's (nor the same for
// 16-byte and element loads), so r can differ from the plain chain's by a float32 rounding
// or two, and the output by one rounding of its own type.
//
// Arithmetic, as rmsnorm_plain rounds it: each square rounded, then added; var = sum *
// (1 / d) (torch.mean's factor on the card); r = rsqrtf(var + eps); out = (x * r) * scale,
// each product rounded to float32 in that order (__fmul_rn / __fadd_rn, which nvcc never
// contracts into an FFMA), then rounded to the output type once.  The row stride is any
// (64-bit, in elements: x[:, -1] of a (B, S, d) tensor is read in place); the last axis is
// contiguous and out is (rows, d) contiguous.  No scratch, no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;   // threads a CTA (the wrapper's MAX_THREADS)
constexpr int kMaxHeld = 32;        // floats of its row a thread holds, K * VEC (MAX_HELD)

struct Bf16 {
  using Raw = unsigned short;
  __device__ static float widen(Raw b) { return __uint_as_float(static_cast<unsigned>(b) << 16); }
  __device__ static Raw narrow(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
};

struct F32 {
  using Raw = float;
  __device__ static float widen(Raw v) { return v; }
  __device__ static Raw narrow(float v) { return v; }
};

template <typename D, int VEC>
union Chunk {
  uint4 u;
  typename D::Raw e[VEC];
};

template <typename D, int VEC>
__device__ __forceinline__ void load(const typename D::Raw* p, float* f) {
  if constexpr (VEC == 1) {
    f[0] = D::widen(p[0]);
  } else {
    static_assert(VEC * sizeof(typename D::Raw) == 16, "16-byte chunks");
    Chunk<D, VEC> c;
    c.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = D::widen(c.e[j]);
  }
}

template <typename D, int VEC>
__device__ __forceinline__ void store(typename D::Raw* p, const float* f) {
  if constexpr (VEC == 1) {
    p[0] = D::narrow(f[0]);
  } else {
    Chunk<D, VEC> c;
#pragma unroll
    for (int j = 0; j < VEC; ++j) c.e[j] = D::narrow(f[j]);
    *reinterpret_cast<uint4*>(p) = c.u;
  }
}

template <int VEC>
__device__ __forceinline__ void load_scale(const float* p, float* f) {
  if constexpr (VEC == 1) {
    f[0] = __ldg(p);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + j));
      f[j] = q.x;
      f[j + 1] = q.y;
      f[j + 2] = q.z;
      f[j + 3] = q.w;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename D, int VEC, int K>
__global__ void __launch_bounds__(kMaxThreads)
rms_rows(const typename D::Raw* __restrict__ x, const float* __restrict__ scale,
         typename D::Raw* __restrict__ out, int d, long long stride, float inv_d, float eps) {
  __shared__ float warp_sums[kMaxThreads / 32];
  __shared__ float r_row;
  const int chunks = d / VEC;                   // VEC divides d (the wrapper's rule)
  const typename D::Raw* xr = x + static_cast<long long>(blockIdx.x) * stride;
  typename D::Raw* yr = out + static_cast<long long>(blockIdx.x) * d;

  float v[K][VEC];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < chunks) {
      load<D, VEC>(xr + static_cast<long long>(c) * VEC, v[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss = __fadd_rn(ss, __fmul_rn(v[k][j], v[k][j]));
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ss = warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) r_row = rsqrtf(__fadd_rn(__fmul_rn(t, inv_d), eps));
  }
  __syncthreads();
  const float r = r_row;

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < chunks) {
      float s[VEC], o[VEC];
      load_scale<VEC>(scale + c * VEC, s);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = __fmul_rn(__fmul_rn(v[k][j], r), s[j]);
      store<D, VEC>(yr + static_cast<long long>(c) * VEC, o);
    }
  }
}

struct Args {
  const void* x;
  const float* scale;
  void* out;
  long long rows;
  int d;
  long long stride;
  int threads;
  float eps;
  cudaStream_t stream;
};

template <typename D, int VEC, int K>
cudaError_t run(const Args& a) {
  if constexpr (K * VEC > kMaxHeld) {
    return cudaErrorInvalidValue;
  } else {
    using Raw = typename D::Raw;
    rms_rows<D, VEC, K><<<static_cast<unsigned>(a.rows), a.threads, 0, a.stream>>>(
        static_cast<const Raw*>(a.x), a.scale, static_cast<Raw*>(a.out), a.d, a.stride,
        1.0f / static_cast<float>(a.d), a.eps);
    return cudaGetLastError();
  }
}

template <typename D, int VEC>
cudaError_t by_k(int k, const Args& a) {
  switch (k) {
    case 1: return run<D, VEC, 1>(a);
    case 2: return run<D, VEC, 2>(a);
    case 4: return run<D, VEC, 4>(a);
    case 8: return run<D, VEC, 8>(a);
    case 16: return run<D, VEC, 16>(a);
    case 32: return run<D, VEC, 32>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (rows, d) with row stride `stride` (elements), bfloat16 (bf16 = 1) or float32; scale
// (d,) float32; out (rows, d) contiguous, x's dtype.  vec: elements a chunk (8 or 1 for
// bfloat16, 4 or 1 for float32); k: chunks a thread; threads: a multiple of 32, at most
// 1,024, with k * threads * vec >= d.  Returns cudaGetLastError() after the launch.
extern "C" int repro_rms_norm(const void* x, const void* scale, void* out, long long rows,
                              int d, long long stride, int bf16, int vec, int k, int threads,
                              float eps, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0 || threads <= 0 || threads > kMaxThreads ||
      threads % 32 != 0 || vec <= 0 || d % vec != 0 ||
      static_cast<long long>(k) * threads * vec < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, static_cast<const float*>(scale), out, rows, d, stride, threads, eps,
               static_cast<cudaStream_t>(stream)};
  cudaError_t rc = cudaErrorInvalidValue;
  if (bf16) {
    if (vec == 8) rc = by_k<Bf16, 8>(k, a);
    else if (vec == 1) rc = by_k<Bf16, 1>(k, a);
  } else {
    if (vec == 4) rc = by_k<F32, 4>(k, a);
    else if (vec == 1) rc = by_k<F32, 1>(k, a);
  }
  return static_cast<int>(rc);
}
