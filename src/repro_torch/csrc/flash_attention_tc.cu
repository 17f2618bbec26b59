// Fused (flash) attention of the forward / prefill pass in bf16 on Hopper's
// tensor cores: the function of flash_attention.cu's flash_fwd (which keeps
// float32 inputs on the CUDA cores) for q, k, v and out in bfloat16.
// out[b, i, h] = softmax(q[b, i, h] . K[b, :, h / G]^T * scale, masked) .
// V[b, :, h / G]; query i sits at key position i + Sk - Sq; a causal mask
// (key <= position) and a local window (key > position - window).
//
// Replaces: src/repro/kernels/flash_attention.py, _flash_single (Pallas
// body _flash_kernel), for bf16 operands.
//
// Bound on the H100: operations, 4 * D flops for each visible (query, key)
// pair at the bf16 tensor cores' 989 TFLOP/s.  The kernel does 6 * D: P . V
// runs twice (see "P . V" below).
//
// Design (sm_90a: TMA, mbarriers, wgmma):
//   grid (query tile, head, batch row), heavy causal tiles first; a CTA of
//   five warps owns 64 query rows of one head.  Warps 0-3 are the consumer
//   warpgroup; one lane of warp 4 is the producer.  The CTA walks the 64-key
//   tiles of its causal / window band in key order.
//   Loads   TMA, 128-byte swizzled, through 4-D tensor maps (D, S, heads, B)
//           built on the host from the strides, so the model's GQA views and
//           slices of a fused projection load without a copy.  The Q tile
//           comes in once; K and V tiles through a ring of two stages, each
//           guarded by a "full" mbarrier (TMA bytes) and an "empty" one (the
//           consumer's four warps), so the next tile loads while this one
//           computes.  Columns past D and keys past Sk arrive as zeros.
//   Scores  S = Q . K^T by wgmma m64n64k16, both operands K-major in shared
//           memory, float32 accumulation; then S * scale in float32, as the
//           plain version scales after the product.
//   Softmax online, in float32 on the accumulator fragments: a thread holds
//           16 scores of each of two rows; the row max folds across the four
//           lanes of a row by two xor shuffles; the running sum stays per
//           thread and folds once at the end, in a fixed order.  The mask is
//           applied only on tiles that cross the band's edges or Sk.
//   P . V   P split as P_hi = bf16(p), P_lo = bf16(p - P_hi) (the difference
//           is exact in float32); two wgmma m64n64k16 per 16 keys and 64
//           columns, A = P_hi then P_lo from registers (the accumulator
//           fragment of S is, pair for pair, the A fragment of P), B = the V
//           tile MN-major from shared memory, into one float32 accumulator.
//           Rounding P once would put a 2^-9 relative error on every term:
//           ~3.5e-5 on outputs of ~1e-2 at 1,024 near-uniform keys, outside
//           the bf16 check of one ulp + 1e-5; the split leaves ~2^-17.
//   Epilogue O / l in float32, rounded once to bf16, staged in shared memory
//           and stored in 16-byte coalesced rows.  A row with no visible key
//           gives 0, as flash_fwd does.
// One CTA per (query tile, head, batch row), no split over keys, no atomics,
// every sum in a fixed order: bit-identical from run to run.  D <= 256,
// compiled for D up to 64, 128 and 256 (64-column chunks).  The launcher
// needs 16-byte aligned bases and strides (the wrapper copies what is not);
// it encodes the tensor maps through the runtime's driver entry point.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 128;            // one warpgroup: warps 0-3
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kTileQ = 64;                 // query rows per CTA (the wrapper's TILE_Q)
constexpr int kTileK = 64;                 // keys per tile
constexpr int kChunk = 64;                 // bf16 columns per 128-byte swizzle row
constexpr int kChunkBytes = 64 * kChunk * 2;   // one 64 x 64 bf16 box: 8 KB
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int DMAX>
struct Smem {
  static constexpr int kChunks = DMAX / kChunk;
  static constexpr int kTile = kChunks * kChunkBytes;   // one Q, K or V tile
  static constexpr int kBars = 8 * (1 + 2 * kStages);
  // 1024 bytes of slack to align the swizzled tiles to 1 KB
  static constexpr int kBytes = 1024 + (1 + 2 * kStages) * kTile + kBars;
  static_assert(kTileQ * (DMAX + 8) * 2 <= (1 + 2 * kStages) * kTile, "epilogue staging");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.  A wait
// past 2^35 clocks (~20 s) traps: a fault in the pipeline then ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 35)) __trap();
  }
}

// One 64 x 64 bf16 box of a 4-D tensor map (D, S, heads, B) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, int col, int row,
                                         int head, int batch, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(col), "r"(row), "r"(head), "r"(batch),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout 1 = SWIZZLE_128B.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma window.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B on the tensor cores: m64n64k16, bf16 operands, float32
// accumulator; A and B from shared memory, both K-major.  scale_d 0 ignores
// d's input (d = A . B).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A . B: m64n64k16, A (64 x 16 bf16) from registers in the mma
// fragment layout, B from shared memory MN-major (transposed: N contiguous).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

struct TcArgs {
  void* out;
  int heads, kvheads, d;
  long long sq, sk;
  int causal;
  long long window;   // 0: none
  float scale;
};

template <int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX <= 128 ? 2 : 1)
flash_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
         const __grid_constant__ CUtensorMap tv, TcArgs args) {
  using L = Smem<DMAX>;
  constexpr int kChunks = L::kChunks;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const qs = base;                    // Q: kChunks boxes of 64 rows x 64 columns
  uint8_t* const kv = base + L::kTile;         // stage s: K at kv + 2 s kTile, V after it
  uint64_t* const bars = reinterpret_cast<uint64_t*>(kv + kStages * 2 * L::kTile);
  uint64_t* const q_full = bars;
  uint64_t* const full = bars + 1;
  uint64_t* const empty = bars + 1 + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long qtile = (long long)gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (args.heads / args.kvheads);
  const long long q0 = qtile * kTileQ;
  const long long off = args.sk - args.sq;       // query i sits at key position i + off

  // the key tiles that meet this query tile's band
  const long long last = (q0 + kTileQ < args.sq ? q0 + kTileQ : args.sq) - 1;
  long long k_begin = 0, k_end = args.sk;
  if (args.causal) k_end = last + off + 1 < k_end ? last + off + 1 : k_end;
  if (args.window > 0) {
    const long long lo = q0 + off - args.window + 1;
    k_begin = lo > 0 ? lo : 0;
  }
  const int tile0 = (int)(k_begin / kTileK);
  const int n_tiles = k_end > k_begin ? (int)((k_end + kTileK - 1) / kTileK) - tile0 : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: one lane keeps the ring full
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int c = 0; c < kChunks; ++c)
        tma_load(qs + c * kChunkBytes, tq, c * kChunk, (int)q0, h, b, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        uint8_t* const kt = kv + s * 2 * L::kTile;
        uint8_t* const vt = kt + L::kTile;
        const int k0 = (tile0 + t) * kTileK;
        mbar_expect_tx(&full[s], 2 * L::kTile);
        for (int c = 0; c < kChunks; ++c)
          tma_load(kt + c * kChunkBytes, tk, c * kChunk, k0, kvh, b, &full[s]);
        for (int c = 0; c < kChunks; ++c)
          tma_load(vt + c * kChunkBytes, tv, c * kChunk, k0, kvh, b, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup: this thread holds rows rq and rq + 8 of the tile,
  // columns cq, cq + 1 of every 8-column block of each accumulator
  const int rq = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const long long pos0 = q0 + rq + off, pos1 = pos0 + 8;
  float o[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint8_t* const kt = kv + s * 2 * L::kTile;
    const uint8_t* const vt = kt + L::kTile;
    mbar_wait(&full[s], (t / kStages) & 1);

    // S = Q . K^T: per 64-column chunk of D, four k16 steps 32 bytes apart
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        wgmma_ss(sc, sw128_desc(qs + c * kChunkBytes + kk * 32, 16, 1024),
                 sw128_desc(kt + c * kChunkBytes + kk * 32, 16, 1024), c + kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(sc);

    // scale; mask only a tile that crosses the band's edges or Sk
    const long long k0 = (long long)(tile0 + t) * kTileK;
    const bool edge = k0 + kTileK > args.sk || (args.causal && k0 + kTileK - 1 > q0 + off) ||
                      (args.window > 0 && k0 <= q0 + kTileQ - 1 + off - args.window);
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * args.scale;
      if (edge) {
        const long long kp = k0 + 8 * (i >> 2) + cq + (i & 1);
        const long long pos = (i & 2) ? pos1 : pos0;
        const bool ok = kp < args.sk && (!args.causal || kp <= pos) &&
                        (args.window <= 0 || kp > pos - args.window);
        if (!ok) x = -CUDART_INF_F;
      }
      sc[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));

    // online softmax; a row that has seen no key keeps p = 0 (its max
    // stands in as 0, so -inf - max stays -inf and never NaN)
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float ms1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float a0 = exp2f((m0 - ms0) * kLog2e), a1 = exp2f((m1 - ms1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f((sc[i] - ((i & 2) ? ms1 : ms0)) * kLog2e);
      sc[i] = p;
      if (i & 2) sum1 += p;
      else sum0 += p;
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= (i & 2) ? a1 : a0;

    // P = P_hi + P_lo as the A fragments of four k16 steps: register j of
    // step kk packs accumulator elements 8 kk + 2 j and 8 kk + 2 j + 1
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x0 = sc[8 * kk + 2 * j], x1 = sc[8 * kk + 2 * j + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
        phi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
        plo[kk][j] = *reinterpret_cast<const uint32_t*>(&lo);
      }

    // O += P_hi . V + P_lo . V; the V tile MN-major: 16 keys = 2048 bytes
#pragma unroll
    for (int c = 0; c < kChunks; ++c) pin(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint64_t dv = sw128_desc(vt + c * kChunkBytes + kk * 16 * 128, kChunkBytes, 1024);
        wgmma_rs(o[c], phi[kk], dv);
        wgmma_rs(o[c], plo[kk], dv);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) pin(o[c]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: O / l, rounded once, staged row-major over the tiles, which
  // every warp of the group is done reading
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  constexpr int kPitch = DMAX + 8;   // bf16; conflict-free 4-byte stores
  __nv_bfloat16* const stage = reinterpret_cast<__nv_bfloat16*>(base);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = c * kChunk + 8 * i + cq;
      *reinterpret_cast<__nv_bfloat162*>(stage + rq * kPitch + col) =
          __floats2bfloat162_rn(o[c][4 * i] * inv0, o[c][4 * i + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(stage + (rq + 8) * kPitch + col) =
          __floats2bfloat162_rn(o[c][4 * i + 2] * inv1, o[c][4 * i + 3] * inv1);
    }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  __nv_bfloat16* const out = static_cast<__nv_bfloat16*>(args.out);
  const int d = args.d;
  const int rows = (int)(args.sq - q0 < kTileQ ? args.sq - q0 : kTileQ);
  const long long row0 = ((long long)b * args.sq + q0) * args.heads + h;   // out row of q0
  if ((d & 7) == 0) {
    const int per = d >> 3;   // 16-byte pieces a row
    for (int i = tid; i < rows * per; i += kConsumers) {
      const int r = i / per, c = i - r * per;
      *reinterpret_cast<uint4*>(out + (row0 + (long long)r * args.heads) * d + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * kPitch + 8 * c);
    }
  } else {
    for (int i = tid; i < rows * d; i += kConsumers) {
      const int r = i / d, j = i - r * d;
      out[(row0 + (long long)r * args.heads) * d + j] = stage[r * kPitch + j];
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's driver entry point, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

constexpr int kEncodeError = 10000;   // + the CUresult of a failed encode

// The 4-D map (D, S, heads, B) of a bf16 tensor with element strides (s_,
// h_, b_), read in boxes of 64 rows x 64 columns, 128-byte swizzled;
// reads past D or S give zeros.
int make_map(CUtensorMap* map, const void* ptr, int d, long long s, int heads, int batch,
             long long s_, long long h_, long long b_) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_ * 2, (cuuint64_t)h_ * 2, (cuuint64_t)b_ * 2};
  const cuuint32_t box[4] = {kChunk, kTileK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int DMAX>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           const TcArgs& args, int batch, cudaStream_t stream) {
  constexpr int smem = Smem<DMAX>::kBytes;
  const cudaError_t e =
      cudaFuncSetAttribute(flash_tc<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)((args.sq + kTileQ - 1) / kTileQ);
  flash_tc<DMAX><<<dim3(tiles, args.heads, batch), kThreads, smem, stream>>>(mq, mk, mv, args);
  return (int)cudaGetLastError();
}

}  // namespace

// flash_attention.cu's repro_flash_attention for bf16: the same arguments.
// Needs q, k, v 16-byte aligned with strides (in elements) multiples of 8,
// Sq, Sk < 2^31.  Returns a cudaError_t, or 10000 + the CUresult of a
// failed tensor-map encode.
int flash_tc_launch(const void* q, const void* k, const void* v, void* out, int batch,
                    int heads, int kvheads, int d, long long sq, long long sk, long long qb,
                    long long qs, long long qh, long long kb, long long ks, long long kh,
                    long long vb, long long vs, long long vh, int causal, long long window,
                    float scale, cudaStream_t stream) {
  if (sq > 0x7fffffffLL || sk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, d, sq, heads, batch, qs, qh, qb);
  if (rc == 0) rc = make_map(&mk, k, d, sk, kvheads, batch, ks, kh, kb);
  if (rc == 0) rc = make_map(&mv, v, d, sk, kvheads, batch, vs, vh, vb);
  if (rc != 0) return rc;
  const TcArgs args{out, heads, kvheads, d, sq, sk, causal, window, scale};
  if (d <= 64) return launch<64>(mq, mk, mv, args, batch, stream);
  if (d <= 128) return launch<128>(mq, mk, mv, args, batch, stream);
  return launch<256>(mq, mk, mv, args, batch, stream);
}
