// 2-D transpose of 4-byte words: (M, N) -> (N, M), both row-major.
//
// Replaces: src/repro/kernels/block_transpose.py, _transpose_padded (Pallas
// body _transpose_kernel), the per-block step of the engine's TRANSPOSE.
//
// Bound on the H100: device-memory bytes, 2 * M * N * 4 (each word read once
// and written once, no arithmetic).
//
// Design: one CTA per 32x32 tile, 32x8 threads, each thread moving four
// words.  The tile is staged through shared memory padded to 32x33 so the
// column-wise read of the transposed store hits 32 distinct banks; loads and
// stores are both coalesced along rows.  Ragged edges are masked, not padded
// (the TPU wrapper pads the arrays to tile multiples).  Words move as raw
// uint32_t bits, so the result is bit-exact for float32 (NaN payloads and
// -0.0 included), int32, and bools widened to int32.  Tiles are numbered on
// a 1-D grid so neither M nor N is limited by the 65535 cap of grid.y.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;

__global__ void __launch_bounds__(kTile * kRows)
transpose32(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            long long m, long long n, long long tiles_n) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const long long t = blockIdx.x;
  const long long r0 = (t / tiles_n) * kTile;
  const long long c0 = (t % tiles_n) * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  const long long col = c0 + tx;
  for (int k = ty; k < kTile; k += kRows) {
    const long long row = r0 + k;
    if (row < m && col < n) tile[k][tx] = in[row * n + col];
  }
  __syncthreads();
  // output row = input column c0 + k, output column = input row r0 + tx
  const long long orow_col = r0 + tx;
  for (int k = ty; k < kTile; k += kRows) {
    const long long orow = c0 + k;
    if (orow < n && orow_col < m) out[orow * m + orow_col] = tile[tx][k];
  }
}

}  // namespace

extern "C" int repro_block_transpose(const void* in, void* out, long long m,
                                     long long n, void* stream) {
  if (m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const long long tiles_m = (m + kTile - 1) / kTile;
  const long long tiles_n = (n + kTile - 1) / kTile;
  const long long tiles = tiles_m * tiles_n;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 block(kTile, kRows);
  transpose32<<<(unsigned)tiles, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, m, n, tiles_n);
  return (int)cudaGetLastError();
}
