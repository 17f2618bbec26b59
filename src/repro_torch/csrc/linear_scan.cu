// First-order linear recurrence along the time axis of a (B, T, N) float32
// batch: h[t] = a[t] * h[t-1] + b[t], h[-1] = 0 (an initial state is folded
// into b[0]).  The RG-LRU layer's recurrence, one launch a layer.
//
// Replaces: src/repro/kernels/linear_scan.py, _linear_scan_padded (Pallas
// body _linscan_kernel).  The TPU kernel walks time tiles on a sequential
// grid and carries a (1, N) state across tiles in VMEM.  Here a loop inside
// the CTA takes the place of that grid axis: each CTA walks one slab of
// kSlab channels of one batch row through all T steps in order, so nothing
// has to carry from one CTA to another.
//
// Bound on the H100: device-memory bytes, a and b read once and h written
// once, 3 * B * T * N * 4 bytes; two flops an element.  This kernel moves
// exactly those bytes (a ragged last slab and a last time tile copy only
// what lies inside the tensors).
//
// Order, exactly: for t = 0 .. T-1, h = (a[t] * h) rounded, then (+ b[t])
// rounded, the two roundings of the sequential recurrence written as a
// PyTorch multiply and add (linear_scan_plain).  The multiply and the add
// are __fmul_rn / __fadd_rn, which nvcc never contracts into an FFMA, so the
// kernel equals linear_scan_plain bit for bit at every shape, on the card
// and against the CPU, and is bit-identical from run to run.
//
// Design: grid (ceil(N / kSlab), B), ONE warp a CTA, lane c owning channel c
// of the slab (a ragged last slab masks its lanes).  Time is cut into tiles
// of kSteps steps; the tiles of a and of b go through a ring of kStages
// shared-memory stages, kStages - 1 tiles ahead of the walk, by cp.async:
// 16-byte copies (a row of 32 channels is eight of them, a warp copies four
// rows an instruction) where N, the strides and the bases are multiples of
// 4 floats / 16 bytes, else 4-byte copies, one channel a lane.  Each lane
// waits for its own copies of a tile, then one __syncwarp makes the tile
// visible to the warp: one warp barrier a tile and none a step.  The walk
// reads a[t] and b[t] from shared memory (a row of 128 bytes, one bank a
// lane: no conflicts), and each step's h leaves as one coalesced 128-byte
// row a warp.  The dependency chain is a multiply and an add a step; a
// tile's 16 KB of loads take longer than its 64 steps, so the walk hides
// under the copies in flight: kStages - 1 tiles a CTA, two CTAs an SM at the
// RG-LRU's N = 4096.  On an H100 at (2, 4096, 4096), built without its
// loads, the kernel takes about the time of h's stores alone, and 2 to 6
// stages read alike (scripts/linear_scan_probe.py; PERF.md).  No
// scratch and no atomics; offsets are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LINSCAN_STAGES
#define LINSCAN_STAGES 4
#endif
#ifndef LINSCAN_SLAB
#define LINSCAN_SLAB 32
#endif

namespace {

constexpr int kSlab = LINSCAN_SLAB;       // channels a CTA (the wrapper's SLAB_CHANNELS)
constexpr int kSteps = 64;                // time steps a tile (the wrapper's CHUNK_STEPS)
constexpr int kStages = LINSCAN_STAGES;   // tiles in the ring
constexpr int kTile = kSteps * kSlab;     // floats of one tile of a (or of b)
constexpr int kSmem = kStages * 2 * kTile * 4;
static_assert(kSlab % 4 == 0 && kSlab <= 32 && kStages >= 2, "one warp, 16-byte pieces");

struct Strides {
  long long ab, at, bb, bt;     // a's and b's batch and time strides, in floats
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Puts the copies of `steps` rows of a and b (from time step t0 of this
// CTA's slab, `width` channels) in flight into one ring stage.
template <int VEC>
__device__ __forceinline__ void load_tile(float* sa, float* sb, const float* a, const float* b,
                                          long long t0, int steps, int width, Strides st,
                                          int lane) {
#ifdef LINSCAN_PROBE_NO_LOADS   // scripts/linear_scan_probe.py: the walk and stores alone
  return;
#endif
  if (VEC == 16) {
    constexpr int kPieces = kSlab / 4;          // 16-byte pieces a row
    constexpr int kRows = 32 / kPieces;         // rows a warp copies an instruction
    const int piece = lane % kPieces;
    if (lane >= kPieces * kRows || piece * 4 >= width) return;
    for (int r = lane / kPieces; r < steps; r += kRows) {
      cp_async16(sa + r * kSlab + piece * 4, a + (t0 + r) * st.at + piece * 4);
      cp_async16(sb + r * kSlab + piece * 4, b + (t0 + r) * st.bt + piece * 4);
    }
  } else {
    if (lane >= width) return;
    for (int r = 0; r < steps; ++r) {
      cp_async4(sa + r * kSlab + lane, a + (t0 + r) * st.at + lane);
      cp_async4(sb + r * kSlab + lane, b + (t0 + r) * st.bt + lane);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(32)
lin_walk(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
         long long t, int n, Strides st) {
  extern __shared__ float4 smem[];
  float* ring = reinterpret_cast<float*>(smem);   // stage s: a at 2 s kTile, b after it
  const int lane = threadIdx.x;
  const long long col0 = (long long)blockIdx.x * kSlab, row = blockIdx.y;
  const int width = (int)(n - col0 < kSlab ? n - col0 : kSlab);
  a += row * st.ab + col0;
  b += row * st.bb + col0;
  float* o = out + row * t * n + col0 + lane;
  const bool mine = lane < width;
  const long long tiles = (t + kSteps - 1) / kSteps;

  // the copies of time tile `tile` into ring stage `slot`, as one group
  auto issue = [&](long long tile, int slot) {
    if (tile < tiles) {
      const long long t0 = tile * kSteps;
      load_tile<VEC>(ring + 2 * slot * kTile, ring + (2 * slot + 1) * kTile, a, b, t0,
                     (int)(t - t0 < kSteps ? t - t0 : kSteps), width, st, lane);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s, s);
  float h = 0.f;
  int stage = 0, fill = kStages - 1;
  for (long long k = 0; k < tiles; ++k) {
    issue(k + kStages - 1, fill);
    cp_async_wait();      // this lane's copies of tile k have landed
    __syncwarp();         // ... and every lane's
    const float* ta = ring + 2 * stage * kTile + (lane < kSlab ? lane : 0);
    const float* tb = ta + kTile;
    const long long t0 = k * kSteps;
    if (t - t0 >= kSteps) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        h = __fadd_rn(__fmul_rn(ta[s * kSlab], h), tb[s * kSlab]);
        if (mine) *o = h;
        o += n;
      }
    } else {
      for (int s = 0; s < (int)(t - t0); ++s) {
        h = __fadd_rn(__fmul_rn(ta[s * kSlab], h), tb[s * kSlab]);
        if (mine) *o = h;
        o += n;
      }
    }
    __syncwarp();         // the stage is read before the next copies refill it
    stage = stage + 1 == kStages ? 0 : stage + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;
  }
}

template <int VEC>
int launch(const float* a, const float* b, float* out, int batch, long long t, int n,
           Strides st, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(lin_walk<VEC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + kSlab - 1) / kSlab), (unsigned)batch);
  lin_walk<VEC><<<grid, 32, kSmem, s>>>(a, b, out, t, n, st);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// a, b (batch, t, n) float32 read at [row * ab + step * at + col] and
// [row * bb + step * bt + col]; out (batch, t, n) float32 contiguous.
// copy_bytes 16 needs n and the four strides multiples of 4 and a, b 16-byte
// aligned; 4 takes any.  t >= 1, n >= 1, 1 <= batch <= 65535, checked here.
// Returns the cudaError_t of the launch.
extern "C" int repro_linear_scan(const float* a, const float* b, float* out, int batch,
                                 long long t, int n, long long ab, long long at,
                                 long long bb, long long bt, int copy_bytes, void* stream) {
  if (batch < 1 || batch > 65535 || t < 1 || n < 1 || (copy_bytes != 4 && copy_bytes != 16))
    return (int)cudaErrorInvalidValue;
  if (copy_bytes == 16 && ((n | ab | at | bb | bt) % 4 != 0 || !aligned16(a) || !aligned16(b)))
    return (int)cudaErrorInvalidValue;
  const Strides st{ab, at, bb, bt};
  cudaStream_t s = (cudaStream_t)stream;
  return copy_bytes == 16 ? launch<16>(a, b, out, batch, t, n, st, s)
                          : launch<4>(a, b, out, batch, t, n, st, s);
}
