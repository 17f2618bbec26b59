// One decode token's grouped-query attention over a bf16 KV cache on
// Hopper's tensor cores, for every batch slot in one launch: out[b, h] =
// softmax(q[b, h] . K[b, :len]^T * scale) . V[b, :len], len = min(lengths[b],
// S).  The serving step's attention: every bf16 call (route "tc"; D a
// multiple of 16, which the wrapper checks); float32 stays on
// decode_attention.cu (route "fma").
//
// Replaces: src/repro/kernels/decode_attention.py, _decode_single (Pallas
// body _decode_kernel), for bf16 operands.  The TPU kernel walks all S cache
// positions of one (slot, KV head) on a sequential grid with the running
// max, sum and accumulator in VMEM scratch.
//
// Bound on the H100: device-memory bytes.  Each valid K and V row is read
// once: 2 * sum_b min(len_b, S) * KVH * D * 2 bytes; the arithmetic, 4 * G
// * D flops a key, is far below the tensor cores' rate.  So the design is
// about loads in flight and one launch, not about the products.
//
// Design (sm_90a: thread-block clusters, distributed shared memory,
// cp.async, mma.sync):
//   grid     (nsplit, KV head x m-tile, slot), one cluster of nsplit CTAs a
//            (slot, KV head, m-tile); nsplit = min(8, ceil(S / 128)) and the
//            keys a CTA (keys_per_cta, a multiple of 64) are functions of S
//            alone (the wrapper's splits and split_keys), so no slot's
//            result depends on another's length.  An m-tile is 16 of the G
//            query rows, zero-padded (G > 16 takes several, each re-reading
//            the same K / V, mostly from L2).
//   CTA      4 warps.  Rank r owns keys [r * keys_per_cta, (r + 1) *
//            keys_per_cta) cut to the length; warp w owns its 16-key
//            sub-tiles s0 + 16 (w + 4 j), j = 0, 1, ..., in order, with its
//            own running (m, l, O).
//   loads    each warp moves its own sub-tiles, K and V rows of D bf16, by
//            cp.async 16-byte vectors into a two-stage ring of padded rows
//            (D + 8 elements: ldmatrix without bank conflicts), so the next
//            sub-tile loads while this one computes; no CTA-wide barrier in
//            the loop.  Keys at or past the length are never read: their
//            rows are zero-filled (cp.async with source size 0), and their
//            scores masked.
//   S = Q K^T  mma.sync.m16n8k16 bf16, float32 accumulation: A = the 16 query
//            rows (rows past G zero) by ldmatrix, B = K by ldmatrix; two
//            n-tiles of 8 keys.  The float32 scores are multiplied by scale *
//            log2(e) (q keeps its bf16 bits); softmax online in float32 with
//            exp2, the row max over a quad of lanes by two xor shuffles, the
//            running sum per thread, folded across the quad at the end.
//   O += P V  P split as P_hi = bf16(p), P_lo = bf16(p - P_hi); two mma.sync
//            per 16 keys and 8 columns, A = P_hi then P_lo straight from the
//            score accumulators (the C fragment of S is, pair for pair, the A
//            fragment of P), B = V by ldmatrix.trans, into one float32
//            accumulator.  Rounding P once would put a 2^-9 relative error on
//            every term; the split leaves ~2^-17.
//   combine  Order, exactly: (1) per CTA, per row, M = the largest m of the
//            warps with l > 0 (the warps' (m, l) go through shared memory);
//            each warp scales its own O in registers by s_w = 2^(m_w - M)
//            (0 where l_w = 0) and stores it, with a pitch of D + 8 floats
//            so that the float2 stores meet no bank conflict, into shared
//            memory aliasing the ring; the CTA's O = ((0 + O_0 s_0) + O_1
//            s_1) + ... in warp order, into a buffer apart from the one it
//            reads, and L = sum over warps in warp order of l_w * 2^(m_w -
//            M) (fmaf from 0).  (2) cluster.sync(); per output element, over
//            the ranks in rank order by distributed shared memory
//            (cluster.map_shared_rank), M* = the largest M of the ranks with
//            L > 0, then O and L folded as fmaf(x_r, 2^(M_r - M*), acc)
//            from 0; out = O / L rounded once to bf16, 0 where L is 0 (no
//            valid key: the value the Pallas kernel's l == 0 guard is
//            written for).  The output elements are dealt to the cluster's
//            CTAs in turn, so every rank writes a share.  In the partials
//            mode (part_o given) the fold's O and, once a row, (M*, L) are
//            written as float32 instead, O unnormalised and M* in the log2
//            domain of the scores (-inf, L 0 and O 0 where no key is valid),
//            for a combine across devices that folds them as (2) does.
//            (3) a second
//            cluster.sync(), so that no CTA's shared memory goes while
//            another rank still reads it.
// Every CTA reaches both cluster.sync() calls, a split past the length
// included.  No atomics, no scratch in device memory, one launch a call;
// every sum in a fixed order, so results are bit-identical from run to run.
// The lengths stay on the device (no host sync).  The caches are read
// through their strides, (B, S, KVH, D) with the last dimension contiguous;
// the launcher needs their bases and q's 16-byte aligned and their strides
// multiples of 8 elements (the wrapper copies what is not).  D is compiled
// up to 64, 128 and 256.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSub = 16;          // keys per warp sub-tile
constexpr int kStages = 2;        // cp.async ring stages a warp
constexpr int kRows = 16;         // query rows per CTA: one m16 tile
constexpr int kMaxCluster = 8;    // portable cluster size (the wrapper's MAX_SPLITS)
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory, in bytes from a 16-byte aligned base.
struct Layout {
  int pitch;   // one K, V or Q row: (d + 8) bf16
  int ring;    // kWarps x kStages x (K, V) x kSub rows; after the loop the
               // warps' scaled O (kWarps x kRows x (d + 8) floats), then the
               // CTA's O (kRows x d floats)
  int q;       // kRows Q rows
  int ml;      // kWarps x kRows x (m, l) float
  int cta;     // kRows x (M, L) float of this CTA
  int total;
};

__host__ __device__ inline Layout layout(int d) {
  Layout s;
  s.pitch = (d + 8) * 2;
  s.ring = kWarps * kStages * 2 * kSub * s.pitch;
  s.q = s.ring;
  s.ml = s.q + kRows * s.pitch;
  s.cta = s.ml + kWarps * kRows * 2 * 4;
  s.total = s.cta + kRows * 2 * 4;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 fills the 16 bytes with zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a . b, m16n8k16, bf16 in, float32 accumulator
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as a bf16 pair hi and the bf16 pair of what hi leaves, lo; x in
// the low half (the smaller column).  x - float(hi) is exact in float32.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
decode_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
          __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
          float* __restrict__ part_ml, int heads, int g_size, int mtiles, int d,
          long long s, long long qb, long long qh, long long kb, long long ks,
          long long kh, long long vb, long long vs, long long vh, int keys_per_cta,
          float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nsplit = (int)cluster.num_blocks();
  const int kvh = blockIdx.y / mtiles, mt = blockIdx.y - kvh * mtiles, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout L = layout(d);
  const int g0 = mt * kRows;
  const int gm = min(kRows, g_size - g0);            // this CTA's query rows
  // the m-tile's query rows first (they do not wait for the length), rows
  // past G zero-filled: one cp.async group
  unsigned char* qs = smem + L.q;
  const __nv_bfloat16* qrow = q + b * qb + (long long)(kvh * g_size + g0) * qh;
  constexpr int kChunks = DMAX / 8;                  // 16-byte chunks a row, compiled
  const int cpr = d >> 3;                            // of which the row has
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    if (c < cpr)
      cp_async16(qs + r * L.pitch + c * 16, r < gm ? qrow + r * qh + c * 8 : qrow,
                 r < gm ? 16 : 0);
  }
  cp_async_commit();

  long long len = lengths[b];
  len = len < 0 ? 0 : (len > s ? s : len);
  const long long s0 = (long long)rank * keys_per_cta;
  const long long s1 = min(s0 + keys_per_cta, len);
  // this warp's sub-tiles: s0 + kSub * (warp + kWarps * j) < s1
  const long long first = s0 + (long long)kSub * warp;
  const int nsub = first < s1 ? (int)((s1 - first + kSub * kWarps - 1) / (kSub * kWarps)) : 0;

  const __nv_bfloat16* kbase = k + b * kb + kvh * kh;
  const __nv_bfloat16* vbase = v + b * vb + kvh * vh;
  unsigned char* ring = smem + (size_t)warp * kStages * 2 * kSub * L.pitch;
  // a sub-tile's K and V rows in 16-byte chunks, (tensor, row, chunk) with
  // kChunks a row: lane l moves chunks l, l + 32, ...; all of them issued
  // before any is waited for
  auto issue = [&](int j, int stage) {
    const long long key0 = first + (long long)kSub * kWarps * j;
    unsigned char* dst = ring + (size_t)stage * 2 * kSub * L.pitch;
#pragma unroll
    for (int it = 0; it < 2 * kSub * kChunks / 32; ++it) {
      const int i = lane + it * 32;
      const int c = i % kChunks, r = (i / kChunks) % kSub, t = i / (kChunks * kSub);
      if (c < cpr) {
        const long long key = key0 + r;
        const bool ok = key < s1;
        const __nv_bfloat16* src = t == 0 ? kbase + key * ks + c * 8 : vbase + key * vs + c * 8;
        cp_async16(dst + (t * kSub + r) * L.pitch + c * 16, ok ? src : kbase, ok ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < nsub) issue(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages>();   // this thread's Q chunks have landed
  __syncthreads();            // and every thread's

  // fragment coordinates: rows r and r + 8, columns 2 * (lane & 3) + {0, 1}
  const int fr = lane >> 2, fc = 2 * (lane & 3);
  // ldmatrix row addresses: lanes 8i..8i+7 address matrix i
  const int lm = lane >> 3, lr = lane & 7;
  float o[DMAX / 8][4];
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < nsub; ++j) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int stage = j % kStages;
    const unsigned char* kt = ring + (size_t)stage * 2 * kSub * L.pitch;
    const unsigned char* vt = kt + kSub * L.pitch;
    // S = Q K^T over two n-tiles of 8 keys
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < d) {
        uint32_t a[4], bk[4];
        ldmatrix_x4(a, qs + ((lm & 1) * 8 + lr) * L.pitch + (kk * 16 + (lm >> 1) * 8) * 2);
        ldmatrix_x4(bk, kt + ((lm >> 1) * 8 + lr) * L.pitch + (kk * 16 + (lm & 1) * 8) * 2);
        mma_bf16(sc[0], a, bk[0], bk[1]);
        mma_bf16(sc[1], a, bk[2], bk[3]);
      }
    }
    const long long key0 = first + (long long)kSub * kWarps * j;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[n][e] = key0 + n * 8 + fc + (e & 1) < s1 ? sc[n][e] * scale_log2 : -CUDART_INF_F;
    float x0 = fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1]));
    float x1 = fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3]));
    x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 2));
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    const float u0 = n0 == -CUDART_INF_F ? 0.f : n0, u1 = n1 == -CUDART_INF_F ? 0.f : n1;
    const float a0 = exp2f(m0 - u0), a1 = exp2f(m1 - u1);   // 0 on the first sub-tile
    m0 = n0;
    m1 = n1;
    float p[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      p[n][0] = exp2f(sc[n][0] - u0);
      p[n][1] = exp2f(sc[n][1] - u0);
      p[n][2] = exp2f(sc[n][2] - u1);
      p[n][3] = exp2f(sc[n][3] - u1);
    }
    l0 = l0 * a0 + (((p[0][0] + p[0][1]) + p[1][0]) + p[1][1]);
    l1 = l1 * a1 + (((p[0][2] + p[0][3]) + p[1][2]) + p[1][3]);
#pragma unroll
    for (int n = 0; n < DMAX / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    uint32_t ph[4], pl[4];
    split_pair(p[0][0], p[0][1], ph[0], pl[0]);   // row r,     keys fc, fc + 1
    split_pair(p[0][2], p[0][3], ph[1], pl[1]);   // row r + 8, keys fc, fc + 1
    split_pair(p[1][0], p[1][1], ph[2], pl[2]);   // row r,     keys 8 + fc, 9 + fc
    split_pair(p[1][2], p[1][3], ph[3], pl[3]);   // row r + 8, keys 8 + fc, 9 + fc
#pragma unroll
    for (int np = 0; np < DMAX / 16; ++np) {
      if (np * 16 < d) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + ((lm & 1) * 8 + lr) * L.pitch + (np * 16 + (lm >> 1) * 8) * 2);
        mma_bf16(o[2 * np], ph, bv[0], bv[1]);
        mma_bf16(o[2 * np], pl, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], ph, bv[2], bv[3]);
        mma_bf16(o[2 * np + 1], pl, bv[2], bv[3]);
      }
    }
    __syncwarp();   // every lane has read this stage before it is refilled
    if (j + kStages < nsub) issue(j + kStages, stage);
    cp_async_commit();
  }
  cp_async_wait<0>();
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);

  // (1) the CTA's warps: (m, l) through shared memory; every warp finds
  // each row's M (the largest m of the warps with l > 0), scales its own O
  // in registers by 2^(m_w - M) (0 where l_w = 0) and stores it with a
  // pitch of d + 8 floats (float2 stores without bank conflicts); then
  // each element's warps are summed in warp order into the CTA's O, a
  // buffer apart, so the loads of that pass run ahead of its stores
  float* wml = reinterpret_cast<float*>(smem + L.ml);       // (kWarps, kRows, 2)
  if ((lane & 3) == 0) {
    float* w = wml + warp * kRows * 2;
    w[fr * 2] = m0;
    w[fr * 2 + 1] = l0;
    w[(fr + 8) * 2] = m1;
    w[(fr + 8) * 2 + 1] = l1;
  }
  __syncthreads();   // every warp's (m, l) is in, and every warp is done with the ring
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float* ml = wml + w * kRows * 2;
    if (ml[fr * 2 + 1] > 0.f) mx0 = fmaxf(mx0, ml[fr * 2]);
    if (ml[(fr + 8) * 2 + 1] > 0.f) mx1 = fmaxf(mx1, ml[(fr + 8) * 2]);
  }
  const float sw0 = l0 > 0.f ? exp2f(m0 - mx0) : 0.f;
  const float sw1 = l1 > 0.f ? exp2f(m1 - mx1) : 0.f;
  const int opitch = d + 8;
  float* stage_o = reinterpret_cast<float*>(smem);          // (kWarps, kRows, opitch)
  float* mine = stage_o + (size_t)warp * kRows * opitch;
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    if (n * 8 < d) {
      *reinterpret_cast<float2*>(mine + fr * opitch + n * 8 + fc) =
          make_float2(o[n][0] * sw0, o[n][1] * sw0);
      *reinterpret_cast<float2*>(mine + (fr + 8) * opitch + n * 8 + fc) =
          make_float2(o[n][2] * sw1, o[n][3] * sw1);
    }
  }
  float* cml = reinterpret_cast<float*>(smem + L.cta);      // (kRows, 2): the CTA's (M, L)
  for (int r = tid; r < gm; r += kThreads) {
    float mx = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w)
      if (wml[(w * kRows + r) * 2 + 1] > 0.f) mx = fmaxf(mx, wml[(w * kRows + r) * 2]);
    float den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* ml = wml + (w * kRows + r) * 2;
      if (ml[1] > 0.f) den = fmaf(ml[1], exp2f(ml[0] - mx), den);
    }
    cml[r * 2] = mx;
    cml[r * 2 + 1] = den;
  }
  __syncthreads();
  float* cta_o = stage_o + (size_t)kWarps * kRows * opitch;  // (kRows, d)
  for (int i = tid; i < gm * d; i += kThreads) {
    const int r = i / d, j = i - r * d;
    const float* e = stage_o + r * opitch + j;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += e[(size_t)w * kRows * opitch];
    cta_o[i] = acc;
  }

  // (2) the cluster's CTAs in rank order, through distributed shared memory
  cluster.sync();
  const long long row0 = (long long)b * heads + kvh * g_size + g0;   // first output row
  for (int i = rank * kThreads + tid; i < gm * d; i += nsplit * kThreads) {
    const int r = i / d;
    // every rank's (M, L) and O element requested before any is used
    float rm[kMaxCluster], rl[kMaxCluster], ro[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < nsplit) {
        const float2 ml = *reinterpret_cast<const float2*>(cluster.map_shared_rank(cml, c) + r * 2);
        rm[c] = ml.x;
        rl[c] = ml.y;
        ro[c] = cluster.map_shared_rank(cta_o, c)[i];
      } else {
        rm[c] = -CUDART_INF_F;
        rl[c] = 0.f;
        ro[c] = 0.f;
      }
    }
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (rl[c] > 0.f) mx = fmaxf(mx, rm[c]);
    float acc = 0.f, den = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (rl[c] > 0.f) {
        const float a = exp2f(rm[c] - mx);
        acc = fmaf(ro[c], a, acc);
        den = fmaf(rl[c], a, den);
      }
    }
    if (part_o != nullptr) {
      part_o[row0 * d + i] = acc;
      if (i == r * d) {
        part_ml[(row0 + r) * 2] = mx;
        part_ml[(row0 + r) * 2 + 1] = den;
      }
    } else {
      out[row0 * d + i] = __float2bfloat16_rn(den > 0.f ? acc / den : 0.f);
    }
  }
  // (3) every rank's shared memory stays until the last remote read
  cluster.sync();
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           void* part_o, void* part_ml, int batch, int heads, int kvheads, int d, long long s, long long qb,
           long long qh, long long kb, long long ks, long long kh, long long vb,
           long long vs, long long vh, int nsplit, int keys_per_cta, float scale_log2,
           cudaStream_t stream) {
  const int g_size = heads / kvheads;
  const int mtiles = (g_size + kRows - 1) / kRows;
  const Layout L = layout(d);
  cudaError_t e = cudaFuncSetAttribute(decode_tc<DMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, kvheads * mtiles, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_tc<DMAX>, static_cast<const __nv_bfloat16*>(q),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
                         static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_o),
                         static_cast<float*>(part_ml), heads, g_size, mtiles, d, s, qb, qh,
                         kb, ks, kh, vb, vs, vh, keys_per_cta, scale_log2);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, D) bf16 through strides (qb, qh); caches (B, S, KVH, D) bf16
// through strides (kb, ks, kh) and (vb, vs, vh); the last dimensions
// contiguous, bases 16-byte aligned and strides multiples of 8; lengths (B,)
// int32 on the device; out (B, H, D) bf16 contiguous; D a multiple of 16 up
// to 256; nsplit in [1, 8] CTAs of keys_per_cta keys (a multiple of 64) a
// cluster, nsplit * keys_per_cta >= S; scale_log2 = scale * log2(e).  With
// part_o non-null (the partials mode) out is not written: part_o (B, H, D)
// and part_ml (B, H, 2) float32 contiguous take each row's unnormalised O and
// (M, L).  Returns the cudaError_t of the launch.
extern "C" int repro_decode_attention_tc(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    void* part_o, void* part_ml, int batch,
    int heads, int kvheads, int d, long long s, long long qb, long long qh, long long kb,
    long long ks, long long kh, long long vb, long long vs, long long vh, int nsplit,
    int keys_per_cta, float scale_log2, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (d < 16 || d > 256 || d % 16 || heads % kvheads || nsplit < 1 || nsplit > kMaxCluster ||
      keys_per_cta % (kSub * kWarps) || (long long)nsplit * keys_per_cta < s || align % 16 ||
      ((qb | qh | kb | ks | kh | vb | vs | vh) & 7) || batch > 65535 ||
      (long long)kvheads * ((heads / kvheads + kRows - 1) / kRows) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE_TC_ARGS                                                              \
  q, k, v, lengths, out, part_o, part_ml, batch, heads, kvheads, d, s, qb, qh, kb, ks, kh, vb, \
      vs, vh, nsplit,                                                                         \
      keys_per_cta, scale_log2, st
  if (d <= 64) return launch<64>(REPRO_DECODE_TC_ARGS);
  if (d <= 128) return launch<128>(REPRO_DECODE_TC_ARGS);
  return launch<256>(REPRO_DECODE_TC_ARGS);
#undef REPRO_DECODE_TC_ARGS
}
