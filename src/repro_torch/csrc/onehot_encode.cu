// One-hot encoding: (M,) int32 codes -> (M, G) float32 indicator matrix.
//
// Replaces: src/repro/kernels/onehot_encode.py, _onehot_padded (Pallas body
// _onehot_kernel), which serves get_dummies.
//
// Bound on the H100: device-memory bytes, (M * G + M) * 4 -- the output
// write dominates and there is one compare per element.
//
// Design: the flat M * G output is cut into spans of kSpan = 8192 elements,
// one span to each CTA, so every lane stores whatever G is (a launch that
// gives each row a warp leaves 29 of 32 lanes idle at G = 3).  The CTA first
// copies the codes of the span's rows into shared memory, 16 bytes a load
// where the codes are aligned, so each code is read from device memory once.
// Then each thread writes whole 16-byte vectors (float4) of the span:
// vector j of thread t is at element 4 * (t + 256 j), its row and column
// found by one 64-bit division by G at the start and carried by fixed steps
// (1024 / G rows, 1024 % G columns) after it; inside a vector the column
// steps by one and wraps to the next row at G.  Neighbouring lanes store
// neighbouring vectors, so a warp writes 512 contiguous bytes.  Only the
// last span can be ragged; its last vector is stored element by element.
// Offsets are 64-bit, so M * G may pass 2^31.  Code -1, or any code outside
// [0, G), matches no column and gives a zero row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 8;                       // float4 stores per thread
constexpr int kStep = kThreads * 4;            // elements between a thread's vectors
constexpr int kSpan = kStep * kVecs;           // 8192 output elements per CTA

__global__ void __launch_bounds__(kThreads)
onehot_span(const int* __restrict__ codes, float* __restrict__ out, long long m, long long g,
            long long total, bool vec_codes) {
  // the span's rows, from a multiple of 4 below its first: at most
  // kSpan + 4 of them (G = 1), plus room for a whole last int4
  __shared__ int code[kSpan + 8];
  const long long e0 = (long long)blockIdx.x * kSpan;
  const long long e1 = min(e0 + (long long)kSpan, total);
  const long long r_lo = (e0 / g) & ~3LL;
  const int nrows = (int)((e1 - 1) / g - r_lo + 1);
  for (int i = threadIdx.x * 4; i < nrows; i += kThreads * 4) {
    const long long r = r_lo + i;
    if (vec_codes && r + 3 < m) {
      const int4 c = *reinterpret_cast<const int4*>(codes + r);
      code[i] = c.x;
      code[i + 1] = c.y;
      code[i + 2] = c.z;
      code[i + 3] = c.w;
    } else {
      for (int j = 0; j < 4 && r + j < m; ++j) code[i + j] = codes[r + j];
    }
  }
  __syncthreads();

  // row (relative to r_lo) and column of the thread's first element; both
  // fit 32 bits inside a span (col + step_cols < 2 G < 2^32)
  long long e = e0 + threadIdx.x * 4;
  const long long row0 = e / g;
  int row = (int)(row0 - r_lo);
  unsigned col = (unsigned)(e - row0 * g);
  const unsigned gu = (unsigned)g;
  const int step_rows = (int)(kStep / g);
  const unsigned step_cols = (unsigned)(kStep % g);
#pragma unroll 2
  for (int k = 0; k < kVecs && e < e1; ++k, e += kStep) {
    float v[4];
    int r = row;
    unsigned c = col;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // past the span's last row only in a ragged vector, whose tail is not
      // stored; code[] has room for it
      v[j] = code[r] == (int)c ? 1.0f : 0.0f;
      if (++c == gu) {
        c = 0;
        ++r;
      }
    }
    if (e + 4 <= e1) {
      *reinterpret_cast<float4*>(out + e) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; e + j < e1; ++j) out[e + j] = v[j];
    }
    row += step_rows;
    col += step_cols;
    if (col >= gu) {
      col -= gu;
      ++row;
    }
  }
}

}  // namespace

// codes (m,) int32; out (m, g) float32 contiguous, 16-byte aligned.
extern "C" int repro_onehot_encode(const int* codes, float* out, long long m,
                                   long long g, void* stream) {
  if (m < 1 || g < 1 || g > 0x7fffffffLL || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long total = m * g;
  const long long spans = (total + kSpan - 1) / kSpan;
  if (spans > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  onehot_span<<<(unsigned)spans, kThreads, 0, (cudaStream_t)stream>>>(
      codes, out, m, g, total, ((uintptr_t)codes & 15) == 0);
  return (int)cudaGetLastError();
}
