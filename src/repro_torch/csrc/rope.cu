// Rotary position embedding (rotate-half) of q or k: for each token t, head h and pair
// i < half = D / 2, with angle = float(pos[t]) * freq[i],
//   out[t, h, i]        = x[t, h, i] * cos(angle) - x[t, h, i + half] * sin(angle)
//   out[t, h, i + half] = x[t, h, i + half] * cos(angle) + x[t, h, i] * sin(angle)
// in x's dtype (bfloat16 or float32): the RoPE of the model zoo's attention, q then k in
// every RoPE layer.  With `inverse`, the rotation by -angle: the gradient of the rotation.
//
// Replaces no TPU kernel: the JAX package (src/repro/models/layers.py, rope) leaves RoPE to
// XLA, whose fusion keeps the float32 chain out of device memory.  The port ran it as about
// thirteen ATen launches (arange, pow and multiply for the angles, cos, sin, two float32
// copies of the halves, four multiplies, a subtract, an add, the cat, the cast back), each
// float32 intermediate the size of x: on yi-6b's prefill (q of 32 heads and k of 4, D 128,
// two calls a layer) that chain ran at 5.7% of its byte roofline and took 12% of the traced
// device time (PERF.md).
//
// Bound on the H100: device-memory bytes, x read once and written once, 4 * D bytes a (token,
// head) row in bfloat16 (8 * D in float32).  The positions (8 bytes a token) and the
// frequencies (4 * half bytes, in L2) are small beside it.  Three flops an element; one cos
// and one sin a (token, pair).
//
// Design: a thread owns one piece of VEC pairs of one token: it computes those pairs' cos
// and sin once, in registers, and then walks over all the token's heads, reading the piece
// of each head's first half and the matching piece of its second half and writing both
// rotated.  VEC is 8 (bfloat16) or 4 (float32) for 16-byte loads and stores where half,
// both strides and the base addresses allow them, else 1.  A token's threads are its
// pieces, so a warp reads whole half-rows; a CTA holds as many tokens as fit 256 threads.
// A thread loads kBatch heads before it rotates and stores them, so several 16-byte loads
// are in flight a thread.  (Spreading a token's heads over more threads, each computing
// the angles again, was slower on the H100 at a prefill's k of 4 heads and no faster at
// its q of 32; it sped up only a decode step's device time, which the host's launch hides:
// PERF.md, the kernel table's RP row.)
//
// Arithmetic, as rope_plain rounds it: angle = __fmul_rn(float(pos), freq[i]) (freq is the
// chain's own float32 tensor, computed by the same torch expression and passed in);
// c = cosf(angle), s = sinf(angle) (no fast math: NVCC_FLAGS has no --use_fast_math, so
// these are the accurate functions torch.cos / torch.sin call); each product rounded to
// float32 on its own and then subtracted or added (__fmul_rn / __fsub_rn / __fadd_rn, which
// nvcc never contracts into an FFMA); the result rounded once to the output type.  So the
// output equals rope_plain's bit for bit.  The inverse negates s, which is exact, and so
// equals autograd's gradient through rope_plain.
//
// Layout: x (tokens, heads, D) with token stride x_tok and head stride x_head (elements; the
// last axis contiguous); out (tokens, heads, D) contiguous; pos (lead, seq) integers with
// strides p_lead and p_seq, token t at (t / seq, t % seq).  No scratch, no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;   // threads a CTA (the wrapper's MAX_THREADS)
constexpr int kBatch = 4;          // heads a thread loads before it rotates them

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

// VEC elements as they lie in memory: one 16-byte word, or one element.
template <typename D, int VEC>
struct Piece {
  typename D::Raw e[VEC];
};

template <typename D, int VEC>
__device__ __forceinline__ Piece<D, VEC> load(const typename D::Raw* p) {
  Piece<D, VEC> out;
  if constexpr (VEC == 1) {
    out.e[0] = p[0];
  } else {
    static_assert(VEC * sizeof(typename D::Raw) == 16, "16-byte pieces");
    Chunk<D, VEC> c;
    c.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < VEC; ++j) out.e[j] = c.e[j];
  }
  return out;
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

template <typename D, typename P, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
rope_rows(const typename D::Raw* __restrict__ x, const P* __restrict__ pos,
          const float* __restrict__ freq, typename D::Raw* __restrict__ out,
          long long tokens, int heads, int half, int pieces, int per_cta,
          long long x_tok, long long x_head, long long seq, long long p_lead,
          long long p_seq, int inverse) {
  using Raw = typename D::Raw;
  const int local = threadIdx.x / pieces;
  const long long t = static_cast<long long>(blockIdx.x) * per_cta + local;
  if (local >= per_cta || t >= tokens) return;
  const int i0 = (threadIdx.x - local * pieces) * VEC;   // the piece's first pair

  const float p = static_cast<float>(pos[(t / seq) * p_lead + (t % seq) * p_seq]);
  float c[VEC], s[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float a = __fmul_rn(p, __ldg(freq + i0 + j));
    c[j] = cosf(a);
    s[j] = inverse ? -sinf(a) : sinf(a);
  }

  const Raw* xt = x + t * x_tok + i0;
  Raw* ot = out + t * heads * (2LL * half) + i0;
  for (int h0 = 0; h0 < heads; h0 += kBatch) {
    Piece<D, VEC> lo[kBatch], hi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int h = h0 + u;
      if (h < heads) {
        lo[u] = load<D, VEC>(xt + h * x_head);
        hi[u] = load<D, VEC>(xt + h * x_head + half);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int h = h0 + u;
      if (h < heads) {
        float o1[VEC], o2[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float x1 = D::widen(lo[u].e[j]), x2 = D::widen(hi[u].e[j]);
          o1[j] = __fsub_rn(__fmul_rn(x1, c[j]), __fmul_rn(x2, s[j]));
          o2[j] = __fadd_rn(__fmul_rn(x2, c[j]), __fmul_rn(x1, s[j]));
        }
        Raw* o = ot + static_cast<long long>(h) * (2 * half);
        store<D, VEC>(o, o1);
        store<D, VEC>(o + half, o2);
      }
    }
  }
}

struct Args {
  const void* x;
  const void* pos;
  const float* freq;
  void* out;
  long long tokens;
  int heads, half, per_cta, threads;
  long long x_tok, x_head, seq, p_lead, p_seq;
  int inverse;
  cudaStream_t stream;
};

template <typename D, typename P, int VEC>
cudaError_t run(const Args& a) {
  using Raw = typename D::Raw;
  const long long grid = (a.tokens + a.per_cta - 1) / a.per_cta;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  rope_rows<D, P, VEC><<<static_cast<unsigned>(grid), a.threads, 0, a.stream>>>(
      static_cast<const Raw*>(a.x), static_cast<const P*>(a.pos), a.freq,
      static_cast<Raw*>(a.out), a.tokens, a.heads, a.half, a.half / VEC, a.per_cta,
      a.x_tok, a.x_head, a.seq, a.p_lead, a.p_seq, a.inverse);
  return cudaGetLastError();
}

template <typename D, int VEC>
cudaError_t by_pos(int pos64, const Args& a) {
  return pos64 ? run<D, long long, VEC>(a) : run<D, int, VEC>(a);
}

}  // namespace

// x (tokens, heads, 2 * half) with token stride x_tok and head stride x_head (elements),
// bfloat16 (bf16 = 1) or float32; pos integers, int64 (pos64 = 1) or int32, token t at
// pos[(t / seq) * p_lead + (t % seq) * p_seq]; freq (half,) float32; out (tokens, heads,
// 2 * half) contiguous, x's dtype.  vec: elements a piece (8 or 1 for bfloat16, 4 or 1 for
// float32), dividing half; per_cta: tokens a CTA; threads: a multiple of 32, at most 256,
// at least per_cta * half / vec.  inverse = 1 rotates by -angle.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_rope(const void* x, const void* pos, const void* freq, void* out,
                          long long tokens, int heads, int half, long long x_tok,
                          long long x_head, long long seq, long long p_lead, long long p_seq,
                          int bf16, int pos64, int vec, int per_cta, int threads,
                          int inverse, void* stream) {
  if (tokens <= 0 || heads <= 0 || half <= 0 || seq <= 0 || vec <= 0 || half % vec != 0 ||
      per_cta <= 0 || threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(per_cta) * (half / vec) > threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, pos, static_cast<const float*>(freq), out, tokens, heads, half, per_cta,
               threads, x_tok, x_head, seq, p_lead, p_seq, inverse,
               static_cast<cudaStream_t>(stream)};
  cudaError_t rc = cudaErrorInvalidValue;
  if (bf16) {
    if (vec == 8) rc = by_pos<Bf16, 8>(pos64, a);
    else if (vec == 1) rc = by_pos<Bf16, 1>(pos64, a);
  } else {
    if (vec == 4) rc = by_pos<F32, 4>(pos64, a);
    else if (vec == 1) rc = by_pos<F32, 1>(pos64, a);
  }
  return static_cast<int>(rc);
}
