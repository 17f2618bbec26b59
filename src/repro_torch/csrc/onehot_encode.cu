// One-hot encoding: (M,) int32 codes -> (M, G) float32 indicator matrix.
//
// Replaces: src/repro/kernels/onehot_encode.py, _onehot_padded (Pallas body
// _onehot_kernel), which serves get_dummies.
//
// Bound on the H100: device-memory bytes, (M * G + M) * 4 -- the output
// write dominates and there is one compare per element.
//
// Design: a 2-D launch with no index division.  threadIdx.x walks the
// columns of a row and threadIdx.y the rows of a tile (a block is 256
// threads: x is G rounded up to a warp, at most 256); grid.x covers the
// columns and grid.y strides over the rows.  A warp stores to neighbouring
// addresses of one row, so stores are coalesced; the code is read once per
// element from L1.  Offsets are 64-bit, so M * G may pass 2^31.  Code -1,
// or any code outside [0, G), matches no column and gives a zero row.
#include <cuda_runtime.h>

namespace {

__global__ void onehot(const int* __restrict__ codes, float* __restrict__ out,
                       long long m, int g) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= g) return;
  const long long step = (long long)gridDim.y * blockDim.y;
  for (long long row = (long long)blockIdx.y * blockDim.y + threadIdx.y;
       row < m; row += step)
    out[row * g + col] = (codes[row] == col) ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int repro_onehot_encode(const int* codes, float* out, long long m,
                                   long long g, void* stream) {
  if (m < 1 || g < 1 || g > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tx = g >= 256 ? 256 : (int)((g + 31) / 32 * 32);
  const int ty = 256 / tx;
  const long long col_blocks = (g + tx - 1) / tx;
  long long row_blocks = (m + ty - 1) / ty;
  if (row_blocks > 65535) row_blocks = 65535;
  onehot<<<dim3((unsigned)col_blocks, (unsigned)row_blocks), dim3(tx, ty), 0,
           (cudaStream_t)stream>>>(codes, out, m, (int)g);
  return (int)cudaGetLastError();
}
