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
//
// The backward (repro_linear_scan_bwd; the JAX package writes none, its
// training differentiates the sequential lax.scan of ref.linear_scan) is the
// same walk reversed in time, lin_walk<VEC, true>: with g the gradient of h,
// dh[t] = g[t] + a[t+1] * dh[t+1], grad_b = dh, grad_a[t] = dh[t] * h[t-1].
// A ring stage holds three operands (a one step ahead, g, h one step
// behind), so a, g and h are each read once and grad_a and grad_b written
// once: bound 5 * B * T * N * 4 bytes.  The multiply and the add are again
// rounded once each, the two terms of dh[t] added as autograd adds the two
// gradients of h[t] (in either order: an IEEE sum of two terms commutes), so
// it equals autograd through linear_scan_plain bit for bit, but for the
// sign of grad_a's zeros at t = 0 (autograd's sum of per-step slices makes
// them +0).
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
static_assert(kSlab % 4 == 0 && kSlab <= 32 && kStages >= 2, "one warp, 16-byte pieces");

struct Strides {
  long long ab, at, bb, bt;     // a's and b's (the backward: g's) batch and time strides,
  long long hb, ht;             // and the backward's h's, in floats
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

// Puts the copies of rows r0 .. r0 + steps - 1 of one operand (this CTA's
// slab, `width` channels, time stride ts) in flight into `dst`.  With EDGES,
// a row outside [0, t) is not read: its stage row is written as zeros (the
// backward walk's a[T] and h[-1]).
template <int VEC, bool EDGES>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long r0, int steps,
                                          long long t, int width, long long ts, int lane) {
#ifdef LINSCAN_PROBE_NO_LOADS   // scripts/linear_scan_probe.py: the walk and stores alone
  return;
#endif
  if (VEC == 16) {
    constexpr int kPieces = kSlab / 4;          // 16-byte pieces a row
    constexpr int kRows = 32 / kPieces;         // rows a warp copies an instruction
    const int piece = lane % kPieces;
    if (lane >= kPieces * kRows || piece * 4 >= width) return;
    for (int r = lane / kPieces; r < steps; r += kRows) {
      float* d = dst + r * kSlab + piece * 4;
      const long long row = r0 + r;
      if (EDGES && (row < 0 || row >= t))
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        cp_async16(d, src + row * ts + piece * 4);
    }
  } else {
    if (lane >= width) return;
    for (int r = 0; r < steps; ++r) {
      const long long row = r0 + r;
      if (EDGES && (row < 0 || row >= t))
        dst[r * kSlab + lane] = 0.f;
      else
        cp_async4(dst + r * kSlab + lane, src + row * ts + lane);
    }
  }
}

// BWD = false, the forward: a, b -> out = h.
// BWD = true, the backward: a, b = g (the gradient of h), hin = h -> out =
// grad_b = dh, out_a = grad_a.  The walk runs t = T-1 .. 0:
//   dh[t] = g[t] + a[t+1] * dh[t+1]   (a[T] = 0, dh[T] = 0)
//   grad_b[t] = dh[t],  grad_a[t] = dh[t] * h[t-1]   (h[-1] = 0)
// A stage of the ring holds the tile's rows of a one step ahead (t0 + 1 ..),
// of g, and of h one step behind (t0 - 1 ..), so each of a, g and h is read
// once, and a[T] and h[-1] are zeros written into the stage, never read.
template <int VEC, bool BWD>
__global__ void __launch_bounds__(32)
lin_walk(const float* __restrict__ a, const float* __restrict__ b,
         const float* __restrict__ hin, float* __restrict__ out, float* __restrict__ out_a,
         long long t, int n, Strides st) {
  constexpr int kOps = BWD ? 3 : 2;               // operands a ring stage holds
  extern __shared__ float4 smem[];
  float* ring = reinterpret_cast<float*>(smem);   // stage s: operand j at (kOps s + j) kTile
  const int lane = threadIdx.x;
  const long long col0 = (long long)blockIdx.x * kSlab, row = blockIdx.y;
  const int width = (int)(n - col0 < kSlab ? n - col0 : kSlab);
  a += row * st.ab + col0;
  b += row * st.bb + col0;
  if constexpr (BWD) hin += row * st.hb + col0;
  const long long base = row * t * n + col0 + lane;
  float* o = out + base;
  const bool mine = lane < width;
  const long long tiles = (t + kSteps - 1) / kSteps;

  // the copies of the walk's k-th time tile into ring stage `slot`, as one
  // group; the backward walks the tiles from the last
  auto issue = [&](long long k, int slot) {
    if (k < tiles) {
      const long long t0 = (BWD ? tiles - 1 - k : k) * kSteps;
      const int steps = (int)(t - t0 < kSteps ? t - t0 : kSteps);
      float* s = ring + kOps * slot * kTile;
      if constexpr (BWD) {
        load_rows<VEC, true>(s, a, t0 + 1, steps, t, width, st.at, lane);
        load_rows<VEC, false>(s + kTile, b, t0, steps, t, width, st.bt, lane);
        load_rows<VEC, true>(s + 2 * kTile, hin, t0 - 1, steps, t, width, st.ht, lane);
      } else {
        load_rows<VEC, false>(s, a, t0, steps, t, width, st.at, lane);
        load_rows<VEC, false>(s + kTile, b, t0, steps, t, width, st.bt, lane);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s, s);
  float h = 0.f;   // the forward's h; the backward's dh
  int stage = 0, fill = kStages - 1;
  for (long long k = 0; k < tiles; ++k) {
    issue(k + kStages - 1, fill);
    cp_async_wait();      // this lane's copies of tile k have landed
    __syncwarp();         // ... and every lane's
    const float* ta = ring + kOps * stage * kTile + (lane < kSlab ? lane : 0);
    const float* tb = ta + kTile;
    if constexpr (BWD) {
      const float* th = ta + 2 * kTile;
      const long long t0 = (tiles - 1 - k) * kSteps;
      const int steps = (int)(t - t0 < kSteps ? t - t0 : kSteps);
      float* ob = o + (t0 + steps - 1) * n;
      float* oa = out_a + base + (t0 + steps - 1) * n;
      if (steps == kSteps) {
#pragma unroll
        for (int s = kSteps - 1; s >= 0; --s) {
          h = __fadd_rn(tb[s * kSlab], __fmul_rn(ta[s * kSlab], h));
          if (mine) {
            *ob = h;
            *oa = __fmul_rn(h, th[s * kSlab]);
          }
          ob -= n;
          oa -= n;
        }
      } else {
        for (int s = steps - 1; s >= 0; --s) {
          h = __fadd_rn(tb[s * kSlab], __fmul_rn(ta[s * kSlab], h));
          if (mine) {
            *ob = h;
            *oa = __fmul_rn(h, th[s * kSlab]);
          }
          ob -= n;
          oa -= n;
        }
      }
    } else {
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
    }
    __syncwarp();         // the stage is read before the next copies refill it
    stage = stage + 1 == kStages ? 0 : stage + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;
  }
}

template <int VEC, bool BWD>
int launch(const float* a, const float* b, const float* hin, float* out, float* out_a,
           int batch, long long t, int n, Strides st, cudaStream_t s) {
  constexpr int kSmem = kStages * (BWD ? 3 : 2) * kTile * 4;
  const cudaError_t e = cudaFuncSetAttribute(lin_walk<VEC, BWD>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + kSlab - 1) / kSlab), (unsigned)batch);
  lin_walk<VEC, BWD><<<grid, 32, kSmem, s>>>(a, b, hin, out, out_a, t, n, st);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool valid(int batch, long long t, int n, int copy_bytes) {
  return batch >= 1 && batch <= 65535 && t >= 1 && n >= 1 &&
         (copy_bytes == 4 || copy_bytes == 16);
}

}  // namespace

// a, b (batch, t, n) float32 read at [row * ab + step * at + col] and
// [row * bb + step * bt + col]; out (batch, t, n) float32 contiguous.
// copy_bytes 16 needs n and the four strides multiples of 4 and a, b 16-byte
// aligned; 4 takes any.  t >= 1, n >= 1, 1 <= batch <= 65535, checked here.
// Returns the cudaError_t of the launch.
extern "C" int repro_linear_scan(const float* a, const float* b, float* out, int batch,
                                 long long t, int n, long long ab, long long at,
                                 long long bb, long long bt, int copy_bytes, void* stream) {
  if (!valid(batch, t, n, copy_bytes)) return (int)cudaErrorInvalidValue;
  if (copy_bytes == 16 && ((n | ab | at | bb | bt) % 4 != 0 || !aligned16(a) || !aligned16(b)))
    return (int)cudaErrorInvalidValue;
  const Strides st{ab, at, bb, bt, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  return copy_bytes == 16 ? launch<16, false>(a, b, nullptr, out, nullptr, batch, t, n, st, s)
                          : launch<4, false>(a, b, nullptr, out, nullptr, batch, t, n, st, s);
}

// The backward of repro_linear_scan, one launch: a, g (the gradient of h)
// and h (the forward's output), each (batch, t, n) float32 read through its
// batch and time strides, -> grad_a, grad_b (batch, t, n) float32
// contiguous.  copy_bytes 16 needs n and the six strides multiples of 4 and
// a, g, h 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int repro_linear_scan_bwd(const float* a, const float* g, const float* h,
                                     float* grad_a, float* grad_b, int batch, long long t,
                                     int n, long long ab, long long at, long long gb,
                                     long long gt, long long hb, long long ht, int copy_bytes,
                                     void* stream) {
  if (!valid(batch, t, n, copy_bytes)) return (int)cudaErrorInvalidValue;
  if (copy_bytes == 16 && ((n | ab | at | gb | gt | hb | ht) % 4 != 0 || !aligned16(a) ||
                           !aligned16(g) || !aligned16(h)))
    return (int)cudaErrorInvalidValue;
  const Strides st{ab, at, gb, gt, hb, ht};
  cudaStream_t s = (cudaStream_t)stream;
  return copy_bytes == 16 ? launch<16, true>(a, g, h, grad_b, grad_a, batch, t, n, st, s)
                          : launch<4, true>(a, g, h, grad_b, grad_a, batch, t, n, st, s);
}
