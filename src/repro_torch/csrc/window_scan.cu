// Inclusive scan along axis 0 of each column of an (M, N) float32 matrix:
// cumsum, cummax, cummin or cumprod.  The WINDOW operator's per-block scan.
//
// Replaces: src/repro/kernels/window_scan.py, _window_scan_padded (Pallas
// body _scan_kernel).  The TPU kernel walks the rows on a sequential grid and
// carries the running value across tiles in VMEM scratch.  CUDA runs CTAs in
// no order, so nothing carries from one CTA to the next by itself.  (cumprod
// is jnp.cumprod in the reference, not a Pallas kernel; it runs here too so
// that every WINDOW scan on the card is bit-identical from run to run.)
//
// Bound on the H100: device-memory bytes, M * N * 4 read and M * N * 4
// written; one add or compare per element.
//
// Design: ONE cooperative, persistent launch (cudaLaunchCooperativeKernel),
// as many 512-thread CTAs as fit on the card at once, in three phases.  Work
// items are tiles of 4096 elements: 4096 rows of the column when N = 1,
// else 512 rows of a group of kGroup = 8 neighbouring columns (eight lanes
// then cover 32 contiguous bytes of a row).  A thread owns a run of kRun = 8
// consecutive rows of one column in every item.  A CTA takes a contiguous
// range of items.
//   phase A  the copies of every item the CTA keeps (up to kMaxSlots tiles
//            of shared memory, 16 KB each) are put in flight at once
//            (cp.async, 16 bytes a copy where the column is contiguous and
//            aligned), then each item's chunk totals are written to scratch.
//            While the grid's shared memory holds the column (13 x 132
//            tiles, ~7M rows) x is read from device memory once.  Past that,
//            the last kRing slots stream the remaining items (kRing - 1
//            items' copies ahead), and phase C reads those again.
//   grid barrier  cooperative_groups' grid sync (it builds without -rdc,
//            so the build flags are unchanged); the cooperative launch
//            guarantees every CTA is resident.  Its state comes with the
//            launch, so a call leaves nothing behind and needs no memset.
//   phase B  each CTA computes the carries of its own chunks from all the
//            chunk totals of their columns (point 3 below), every CTA by the
//            same arithmetic, so they agree bit for bit; the resident items'
//            carries stay in shared memory.
//   phase C  each item is folded from its carry and written, 16 bytes a
//            store when N = 1.
// Why cp.async and not a TMA bulk copy: a thread copies its own 32-byte run
// and alone reads it back, so a tile needs no mbarrier and no CTA-wide wait.
// Why not fewer passes: a decoupled look-back folds a number of predecessor
// aggregates that depends on which CTAs finished first, so a float cumsum
// would change from run to run; a chained scan (each chunk waiting for the
// previous one) is deterministic but serialises on one latency per chunk.
//
// Association order, a function of M and N alone (never of the grid size,
// the SM count or timing; no atomics touch data):
//   1. a thread folds its kRun consecutive rows of one column in order;
//   2. in a tile, the run totals of a column are scanned in thread order: an
//      inclusive shuffle scan per warp (steps W, 2W, .. 16 for a group of W
//      columns), then one thread per column folds the 16 warp totals in warp
//      order; the chunk total is that fold;
//   3. the chunk totals of a column: runs of ceil(chunks / (512 / W))
//      consecutive chunks, one a thread, each folded in order from its
//      first; the run totals through the tree of point 2; each run walked
//      in order from its exclusive prefix, giving each chunk's carry;
//   4. a thread of a chunk starts from fold(carry, the exclusive prefix of
//      its column's threads before it, point 2) and folds its run in order.
// chip_smoke.py's k4_emulated_cumsum is this order in float32 on the CPU;
// its phase 3 holds the kernel's cumsum to it bit for bit at (1,), (4097,),
// (2,000,000,), (3,000,000,) and (16,000,000,).
//
// Semantics: max and min propagate NaN, as jnp.maximum / jnp.minimum do
// (fmaxf/fminf would drop it); on ties the later value wins, as in
// torch.cummax / torch.cummin.  Both folds are associative on bits, so the
// results equal the sequential scan's bit for bit.  The running value starts
// at the identity 0, -inf, +inf or 1 (the Pallas kernel starts max / min at
// -FLT_MAX / +FLT_MAX; the engine's identity and the plain version use +-inf).
// Sums are exact to rounding in this fixed order, not sequential order.
// Input is read through a row stride and a column stride (in elements), so
// a column view of a wider matrix needs no copy; the output is contiguous
// (M, N).  Offsets are 64-bit: M * N may pass 2^31.  The occupancy table is
// computed once, for the device current at the first call.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;                          // rows a thread folds in order
constexpr int kTile = kThreads * kRun;           // elements of a work item
constexpr int kSlotBytes = kTile * 4;            // 16,384
constexpr int kMaxSlots = 13;                    // 212,992 bytes of shared memory
constexpr int kRing = 3;                         // slots that stream items past the rest
constexpr int kGroup = 8;                        // columns of an item when N > 1
constexpr unsigned kFull = 0xffffffffu;

enum Op { kSum = 0, kMax = 1, kMin = 2, kProd = 3 };

struct Scan {
  const float* x;
  float* out;
  float* totals;      // (n, chunks): chunk totals
  float* carries;     // (n, chunks): exclusive carries of the chunks
  long long m, rs, cs, chunks, items;
  int n, rows, resident;
  bool vec;           // x contiguous and 16-byte aligned, n == 1
};

template <int OP>
__device__ __forceinline__ float identity() {
  if (OP == kMax) return -CUDART_INF_F;
  if (OP == kMin) return CUDART_INF_F;
  if (OP == kProd) return 1.0f;
  return 0.0f;
}

// acc folded with the next value v.  Written out so the operand order is
// fixed: a NaN v wins, then a NaN acc, then the strictly better acc.
template <int OP>
__device__ __forceinline__ float fold(float acc, float v) {
  if (OP == kSum) return acc + v;
  if (OP == kProd) return acc * v;
  if (v != v) return v;
  if (acc != acc) return acc;
  if (OP == kMax) return acc > v ? acc : v;
  return acc < v ? acc : v;
}

// Exclusive prefix of the threads' values in thread order, separately for
// each column c = threadIdx.x % W (thread t holds run t / W of column c): an
// inclusive shuffle scan per warp, then one thread per column folds the 16
// warp totals in warp order.  Threads c < W also get their column's total.
// Every thread must call it.
template <int OP, int W>
__device__ float cta_exclusive(float v, float* warp_tot, float& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float inc = v;
#pragma unroll
  for (int d = W; d < 32; d <<= 1) {
    const float other = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = fold<OP>(other, inc);
  }
  const float lane_excl = __shfl_up_sync(kFull, inc, W);
  if (lane >= 32 - W) warp_tot[warp * W + lane - (32 - W)] = inc;
  __syncthreads();
  if (threadIdx.x < W) {
    float t[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t[w] = warp_tot[w * W + threadIdx.x];
    float acc = t[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      warp_tot[w * W + threadIdx.x] = acc;     // prefix of the warps before w
      acc = fold<OP>(acc, t[w]);
    }
    total = acc;
  }
  __syncthreads();
  float excl;
  if (lane < W)
    excl = warp == 0 ? identity<OP>() : warp_tot[warp * W + lane];
  else
    excl = warp == 0 ? lane_excl : fold<OP>(warp_tot[warp * W + (lane & (W - 1))], lane_excl);
  __syncthreads();  // warp_tot is reused by the next call
  return excl;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread owns one run of an item: kRun consecutive rows of one column,
// rows row0 + (t / W) * kRun + k of column col0 + t % W.  In a shared-memory
// slot the run sits at slot[t * kRun + k], so a thread reads back only what
// it copied itself.
struct Run {
  long long row;   // first row
  int col;
};

template <int W>
__device__ __forceinline__ Run my_run(long long row0, int col0) {
  return {row0 + (long long)(threadIdx.x / W) * kRun, col0 + (int)(threadIdx.x % W)};
}

// Copy the thread's run into its slot (cp.async, complete after the next
// cp_async_wait that covers its group); cells past M or N get the identity.
template <int OP, int W>
__device__ void stage_run(float* slot, const Scan& p, Run r) {
  float* dst = slot + threadIdx.x * kRun;
  if (W == 1 && p.vec && r.row + kRun <= p.m) {
    cp_async16(dst, p.x + r.row);
    cp_async16(dst + 4, p.x + r.row + 4);
    return;
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if (r.row + k < p.m && r.col < p.n)
      cp_async4(dst + k, p.x + (r.row + k) * p.rs + (long long)r.col * p.cs);
    else
      dst[k] = identity<OP>();
  }
}

// The thread's run, from its slot.
__device__ __forceinline__ void read_slot(float (&v)[kRun], const float* slot) {
  const float4* s = reinterpret_cast<const float4*>(slot + threadIdx.x * kRun);
  const float4 a = s[0], b = s[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Write the thread's scanned run: 16-byte stores where the output is one
// column (out is contiguous and 16-byte aligned), else row by row (eight
// neighbouring lanes cover 32 contiguous bytes of a row).
template <int W>
__device__ void store_run(const float (&v)[kRun], const Scan& p, Run r) {
  if (W == 1 && r.row + kRun <= p.m) {
    float4* o = reinterpret_cast<float4*>(p.out + r.row);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k)
    if (r.row + k < p.m && r.col < p.n) p.out[(r.row + k) * p.n + r.col] = v[k];
}

template <int OP>
__device__ __forceinline__ float run_total(const float (&v)[kRun]) {
  float acc = v[0];
#pragma unroll
  for (int k = 1; k < kRun; ++k) acc = fold<OP>(acc, v[k]);
  return acc;
}

// A work item's chunk and first column.
struct Item {
  long long chunk;
  int col0;
};

__device__ __forceinline__ Item item_at(const Scan& p, long long it, int w) {
  const long long grp = it / p.chunks;
  return {it - grp * p.chunks, (int)grp * w};
}

// Phase A's work on an item's run: the chunk total of each column.
template <int OP, int W>
__device__ void chunk_totals(const float (&v)[kRun], const Scan& p, Item item, float* warp_tot) {
  float total;
  cta_exclusive<OP, W>(run_total<OP>(v), warp_tot, total);
  if (threadIdx.x < W && item.col0 + (int)threadIdx.x < p.n)
    p.totals[(long long)(item.col0 + threadIdx.x) * p.chunks + item.chunk] = total;
}

// Phase C's work on an item's run: fold it from its carry and write it.
template <int OP, int W>
__device__ void apply_run(float (&v)[kRun], const Scan& p, Item item, float carry,
                          float* warp_tot) {
  float total;
  float acc = fold<OP>(carry, cta_exclusive<OP, W>(run_total<OP>(v), warp_tot, total));
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    acc = fold<OP>(acc, v[k]);
    v[k] = acc;
  }
  store_run<W>(v, p, my_run<W>(item.chunk * p.rows, item.col0));
}

// Phase B: the exclusive carries of chunks [c0, c1) of column group grp,
// each column's chunk totals scanned in the fixed order: runs of
// ceil(chunks / (kThreads / W)) consecutive chunks, one a thread, each
// folded in order; the run totals through cta_exclusive; then each run
// walked in order from its prefix.  Every CTA that needs a column repeats
// the same arithmetic, so they agree bit for bit.
template <int OP, int W>
__device__ void column_carries(const Scan& p, long long grp, long long c0, long long c1,
                               long long lo_item, long long kept, float* carry_s,
                               float* warp_tot) {
  const int col = (int)grp * W + (int)(threadIdx.x % W);
  const long long per = (p.chunks + kThreads / W - 1) / (kThreads / W);
  const long long lo = min(p.chunks, (long long)(threadIdx.x / W) * per);
  const long long hi = min(p.chunks, lo + per);
  const float* t = p.totals + (long long)col * p.chunks;
  float acc = identity<OP>();
  if (col < p.n && lo < hi) {
    acc = __ldcg(t + lo);
#pragma unroll 8
    for (long long i = lo + 1; i < hi; ++i) acc = fold<OP>(acc, __ldcg(t + i));
  }
  float total;
  float carry = cta_exclusive<OP, W>(acc, warp_tot, total);
  if (col >= p.n || hi <= c0 || lo >= c1) return;
  // a resident item's carry goes to shared memory, a streamed one's to
  // the scratch
  float* out = p.carries + (long long)col * p.chunks;
  const long long k0 = grp * p.chunks - lo_item;   // item k = k0 + chunk
  const int c = (int)(threadIdx.x % W);
  for (long long chunk = lo; chunk < hi && chunk < c1; ++chunk) {
    if (chunk >= c0) {
      if (k0 + chunk < kept) carry_s[(k0 + chunk) * W + c] = carry;
      else out[chunk] = carry;
    }
    carry = fold<OP>(carry, __ldcg(t + chunk));
  }
}

template <int OP, int W>
__device__ __forceinline__ void stage_item(float* slot, const Scan& p, long long it) {
  const Item item = item_at(p, it, W);
  stage_run<OP, W>(slot, p, my_run<W>(item.chunk * p.rows, item.col0));
}

// Streamed items go through a ring of kRing slots, kRing - 1 items' copies
// in flight ahead of the one being folded.  Each thread copies and reads
// only its own run, so the ring needs no __syncthreads.
template <int OP, int W>
__device__ __forceinline__ void ring_prologue(float* ring, const Scan& p, long long first,
                                              long long hi) {
#pragma unroll
  for (int j = 0; j < kRing - 1; ++j) {
    if (first + j < hi) stage_item<OP, W>(ring + j * kTile, p, first + j);
    cp_async_commit();
  }
}

template <int OP, int W>
__device__ __forceinline__ const float* ring_next(float* ring, const Scan& p, long long first,
                                                  long long it, long long hi) {
  const long long ahead = it + kRing - 1;
  if (ahead < hi) stage_item<OP, W>(ring + ((ahead - first) % kRing) * kTile, p, ahead);
  cp_async_commit();
  cp_async_wait<kRing - 1>();
  return ring + ((it - first) % kRing) * kTile;
}

template <int OP, int W>
__global__ void __launch_bounds__(kThreads, 2) scan_one_pass(Scan p) {
  extern __shared__ __align__(16) float slots[];
  __shared__ float warp_tot[kWarps * W];
  __shared__ float carry_s[kMaxSlots * W];   // the resident items' carries
  // this CTA's items: a contiguous range, item = group * chunks + chunk;
  // the first p.resident stay in their slots, the rest stream
  const long long lo = p.items * blockIdx.x / gridDim.x;
  const long long hi = p.items * (blockIdx.x + 1) / gridDim.x;
  const long long kept = min(hi - lo, (long long)p.resident);
  float* ring = slots + (long long)p.resident * kTile;
  float v[kRun];

  // phase A: every resident item's copies in flight at once, and the
  // ring's first; then the chunk totals
  for (long long k = 0; k < kept; ++k) stage_item<OP, W>(slots + k * kTile, p, lo + k);
  cp_async_commit();
  ring_prologue<OP, W>(ring, p, lo + kept, hi);
  cp_async_wait<kRing - 1>();
  for (long long k = 0; k < kept; ++k) {
    read_slot(v, slots + k * kTile);
    chunk_totals<OP, W>(v, p, item_at(p, lo + k, W), warp_tot);
  }
  for (long long it = lo + kept; it < hi; ++it) {
    read_slot(v, ring_next<OP, W>(ring, p, lo + kept, it, hi));
    chunk_totals<OP, W>(v, p, item_at(p, it, W), warp_tot);
  }
  cp_async_wait<0>();
  cooperative_groups::this_grid().sync();

  // phase B: the carries of this CTA's chunks, group by group
  if (lo + kept < hi) ring_prologue<OP, W>(ring, p, lo + kept, hi);
  const long long last_grp = (hi - 1) / p.chunks;
  for (long long grp = lo / p.chunks; lo < hi && grp <= last_grp; ++grp) {
    const long long c0 = max(lo - grp * p.chunks, 0LL);
    const long long c1 = min(hi - grp * p.chunks, p.chunks);
    column_carries<OP, W>(p, grp, c0, c1, lo, kept, carry_s, warp_tot);
  }
  __syncthreads();

  // phase C: fold each item from its carry and write it
  const int c = (int)(threadIdx.x % W);
  for (long long k = 0; k < kept; ++k) {
    const Item item = item_at(p, lo + k, W);
    const float carry = item.col0 + c < p.n ? carry_s[k * W + c] : identity<OP>();
    read_slot(v, slots + k * kTile);
    apply_run<OP, W>(v, p, item, carry, warp_tot);
  }
  for (long long it = lo + kept; it < hi; ++it) {
    const Item item = item_at(p, it, W);
    const float carry = item.col0 + c < p.n
                            ? __ldcg(p.carries + (long long)(item.col0 + c) * p.chunks + item.chunk)
                            : identity<OP>();
    read_slot(v, ring_next<OP, W>(ring, p, lo + kept, it, hi));
    apply_run<OP, W>(v, p, item, carry, warp_tot);
  }
  cp_async_wait<0>();
}

// Co-resident CTAs for each slot count, from the occupancy calculator: the
// cooperative launch's grid.  Computed once per kernel (C++ makes the
// static's initialisation thread-safe).
struct Plan {
  cudaError_t err;
  long long grid[kMaxSlots + 1];
};

template <int OP, int W>
const Plan& plan() {
  static const Plan p = [] {
    Plan q{};
    int dev = 0, sms = 0;
    q.err = cudaGetDevice(&dev);
    if (q.err == cudaSuccess) q.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (q.err == cudaSuccess)
      q.err = cudaFuncSetAttribute(scan_one_pass<OP, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMaxSlots * kSlotBytes);
    for (int r = 1; r <= kMaxSlots && q.err == cudaSuccess; ++r) {
      int per = 0;
      q.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, scan_one_pass<OP, W>, kThreads,
                                                            (size_t)r * kSlotBytes);
      q.grid[r] = (long long)per * sms;
    }
    return q;
  }();
  return p;
}

template <int OP, int W>
cudaError_t launch(Scan p, cudaStream_t stream) {
  const Plan& pl = plan<OP, W>();
  if (pl.err != cudaSuccess) return pl.err;
  // the fewest slots that hold every item; else all of them, and the rest
  // of the items stream through registers
  int slots = kMaxSlots;
  for (int r = 1; r <= kMaxSlots; ++r)
    if (pl.grid[r] > 0 && r * pl.grid[r] >= p.items) {
      slots = r;
      break;
    }
  long long grid = pl.grid[slots];
  if (grid < 1) return cudaErrorInvalidConfiguration;
  p.resident = slots * grid >= p.items ? slots : slots - kRing;
  if (grid > p.items) grid = p.items;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)scan_one_pass<OP, W>, dim3((unsigned)grid),
                                     dim3(kThreads), args, (size_t)slots * kSlotBytes, stream);
}

template <int OP>
cudaError_t launch_op(const Scan& p, cudaStream_t s) {
  return p.rows == kTile ? launch<OP, 1>(p, s) : launch<OP, kGroup>(p, s);
}

}  // namespace

// x (m, n) float32 read at x[row * rs + col * cs]; out (m, n) float32
// contiguous and 16-byte aligned; scratch 2 * n * chunks float32, where a
// chunk is 4096 rows when n == 1 and 512 rows (of 8 columns) otherwise,
// checked here.  m >= 1, n >= 1.
extern "C" int repro_window_scan(const float* x, float* out, float* scratch,
                                 long long m, long long n, long long rs, long long cs, int op,
                                 long long chunks, void* stream) {
  const int rows = n == 1 ? kTile : kTile / kGroup;
  if (m < 1 || n < 1 || n > 0x7fffffffLL || rs < 0 || cs < 0 ||
      chunks != (m + rows - 1) / rows || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Scan p{};
  p.x = x;
  p.out = out;
  p.totals = scratch;
  p.carries = scratch + n * chunks;
  p.m = m;
  p.rs = rs;
  p.cs = cs;
  p.chunks = chunks;
  p.n = (int)n;
  p.rows = rows;
  p.items = (n == 1 ? 1 : (n + kGroup - 1) / kGroup) * chunks;
  p.vec = n == 1 && rs == 1 && ((uintptr_t)x & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kSum: return (int)launch_op<kSum>(p, s);
    case kMax: return (int)launch_op<kMax>(p, s);
    case kMin: return (int)launch_op<kMin>(p, s);
    case kProd: return (int)launch_op<kProd>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
