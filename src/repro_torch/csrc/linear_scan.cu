// First-order linear recurrence along the time axis of a (B, T, N) float32
// batch: h[t] = a[t] * h[t-1] + b[t], h[-1] = 0 (an initial state is folded
// into b[0]).  The RG-LRU layer's recurrence, one launch a layer.
//
// Replaces: src/repro/kernels/linear_scan.py, _linear_scan_padded (Pallas
// body _linscan_kernel).  The TPU kernel walks time tiles of 512 rows on a
// sequential grid: inside a tile an associative scan of the (a, b) pairs,
// across tiles a (1, N) carry in VMEM.  CUDA runs CTAs in no order, so
// nothing can carry from one CTA to the next; the scan is split into three
// launches instead, as csrc/window_scan.cu does for WINDOW.
//
// Bound on the H100: device-memory bytes, a and b read once and h written
// once, 3 * B * T * N * 4 bytes; two flops an element.  This version reads
// a and b twice (phases 1 and 3), 5 * B * T * N * 4 bytes.
//
// Design: a pair (A, Bv) is the affine map h -> A * h + Bv; the map of
// steps t0..t1 is their composition in time order, (a2, b2) o (a1, b1) =
// (a1 * a2, a2 * b1 + b2).  Time is cut into chunks of kChunk steps; the
// chunk count is a function of T alone.  Each thread owns one channel of one
// batch row, so a warp reads 32 neighbouring channels of one time step: the
// loads are coalesced on the contiguous N axis.
//   phase 1  grid (channel block, chunk, batch row).  A thread composes its
//            chunk's maps in time order: A = the product of a, Bv = the
//            recurrence run from 0 over the chunk.
//   phase 2  grid (channel block, batch row).  A thread walks the chunk
//            summaries in chunk order and overwrites each Bv with the
//            state entering that chunk.
//   phase 3  grid as phase 1.  A thread starts from its chunk's entering
//            state and runs the recurrence over the chunk, writing h.
// Every step is one fmaf in a fixed order, chunk 0 exactly the sequential
// recurrence: no atomics, bit-identical from run to run.  The entering
// states of later chunks differ from the sequential recurrence's by
// rounding (A is a rounded product), which |a| < 1 damps.
// a and b are read through their batch and time strides (in elements), the
// channel axis contiguous; h is written contiguous (B, T, N).  Offsets are
// 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // channels per CTA
constexpr int kChunk = 64;      // time steps per chunk (the wrapper's CHUNK_STEPS)

struct Strides {
  long long ab, at, bb, bt;     // a's and b's batch and time strides
};

__global__ void __launch_bounds__(kThreads)
lin_summaries(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ sa, float* __restrict__ sb, long long t, int n,
              Strides st, int chunks) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= n) return;
  const long long c = blockIdx.y, row = blockIdx.z;
  const long long t0 = c * kChunk;
  const int len = (int)(t - t0 < kChunk ? t - t0 : kChunk);
  const float* ap = a + row * st.ab + t0 * st.at + col;
  const float* bp = b + row * st.bb + t0 * st.bt + col;
  float prod = 1.f, h = 0.f;
#pragma unroll 8
  for (int s = 0; s < len; ++s) {
    const float as = ap[s * st.at];
    prod *= as;
    h = fmaf(as, h, bp[s * st.bt]);
  }
  const long long o = (row * chunks + c) * n + col;
  sa[o] = prod;
  sb[o] = h;
}

__global__ void __launch_bounds__(kThreads)
lin_carries(const float* __restrict__ sa, float* __restrict__ sb, int n, int chunks) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= n) return;
  const long long base = (long long)blockIdx.y * chunks * n + col;
  float h = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const long long o = base + (long long)c * n;
    const float entering = h;
    h = fmaf(sa[o], h, sb[o]);
    sb[o] = entering;
  }
}

__global__ void __launch_bounds__(kThreads)
lin_apply(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ carries, float* __restrict__ out, long long t,
          int n, Strides st, int chunks) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= n) return;
  const long long c = blockIdx.y, row = blockIdx.z;
  const long long t0 = c * kChunk;
  const int len = (int)(t - t0 < kChunk ? t - t0 : kChunk);
  const float* ap = a + row * st.ab + t0 * st.at + col;
  const float* bp = b + row * st.bb + t0 * st.bt + col;
  float* op = out + (row * t + t0) * n + col;
  float h = carries[(row * chunks + c) * n + col];
#pragma unroll 8
  for (int s = 0; s < len; ++s) {
    h = fmaf(ap[s * st.at], h, bp[s * st.bt]);
    op[(long long)s * n] = h;
  }
}

}  // namespace

// a, b (batch, t, n) float32 read at [row * ab + step * at + col] and
// [row * bb + step * bt + col]; out (batch, t, n) float32 contiguous;
// sa, sb (batch, chunks, n) float32 scratch with chunks = ceil(t / 64),
// checked here.  t >= 1, n >= 1, 1 <= batch <= 65535, chunks <= 65535.
// Returns the cudaError_t of the launches.
extern "C" int repro_linear_scan(const float* a, const float* b, float* out, float* sa,
                                 float* sb, int batch, long long t, int n,
                                 long long ab, long long at, long long bb, long long bt,
                                 int chunks, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || n < 1 ||
      chunks != (t + kChunk - 1) / kChunk || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Strides st{ab, at, bb, bt};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const dim3 grid(blocks, (unsigned)chunks, (unsigned)batch);
  lin_summaries<<<grid, kThreads, 0, s>>>(a, b, sa, sb, t, n, st, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lin_carries<<<dim3(blocks, (unsigned)batch), kThreads, 0, s>>>(sa, sb, n, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lin_apply<<<grid, kThreads, 0, s>>>(a, b, sb, out, t, n, st, chunks);
  return (int)cudaGetLastError();
}
