// Kernel K26: the staging-transpose experiment at the 32M-bit shape and its
// consumer.  Replaces the TPU kernels of scripts/transpose_bench.py:
// _tr_kernel (:33, launched by pallas_transpose at :68), which moved a (B,
// Lw) int32 array to (Lw, B) in tiles of 256 x 256, 512 x 512 and 128 x
// 1056 through VMEM, and _sum_kernel (:37, launched by pallas_consume at
// :51), which summed the first 128 columns of every row of its input to
// force it to exist.
//
// Variants (the JAX tiles, mapped to tiles that fit 227 KB of shared
// memory; a JAX tile of 512 x 512 int32 is 1 MB):
//   0 32x32   a 32 x 33 padded tile, a CUDA block of 32 x 8 threads (K6's)
//   1 64x64   a 64 x 65 padded tile, 64 x 8 threads
//   2 slab    32 whole rows (the JAX 128 x 1056's full width) in a 32 x
//             (cols | 1) padded slab of dynamic shared memory, 1024 threads:
//             a warp writes 32 neighbouring words of each output row
//   3 consume out[j] += sum over rows of t[r][j], j < 128, int32 wrapping
//             (the caller zeroes out): 128 threads a block, 16 rows a block,
//             one atomicAdd a column a block (integer addition mod 2^32
//             does not depend on the order)
// The plain PyTorch versions are transpose_torch and consume_torch in
// tpu_viterbi_torch/scripts/transpose_bench.py; each variant agrees with
// them bit for bit.
//
// What bounds it: device memory, 2 x 66.5 MB at the JAX shape (15,744 x
// 1,056 int32): 0.040 ms at 3.35 TB/s.  What the design does about it: a
// tile through shared memory, so that both the reads (along an input row)
// and the writes (along an output row) are whole 128-byte lines a warp; the
// padding column keeps the column-wise shared accesses free of bank
// conflicts (odd pitch).  The consumer reads 128 columns a row, 512 bytes,
// coalesced.

#include <cuda_runtime.h>

#include <cstdint>

namespace viterbi_transpose {

constexpr int kRowsAPass = 8;
constexpr int kSlabRows = 32;
constexpr int kSlabThreads = 1024;
constexpr int kSumCols = 128;
constexpr int kSumRows = 16;

template <int TILE>
__global__ void __launch_bounds__(TILE * kRowsAPass)
tile_transpose_kernel(const int* __restrict__ in, int* __restrict__ out,
                      int rows, int cols) {
  __shared__ int tile[TILE][TILE + 1];
  const int c0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
#pragma unroll
  for (int j = threadIdx.y; j < TILE; j += kRowsAPass) {
    const int r = r0 + j, c = c0 + threadIdx.x;
    if (r < rows && c < cols)
      tile[j][threadIdx.x] = in[static_cast<size_t>(r) * cols + c];
  }
  __syncthreads();
#pragma unroll
  for (int j = threadIdx.y; j < TILE; j += kRowsAPass) {
    const int c = c0 + j, r = r0 + threadIdx.x;  // output row c, column r
    if (c < cols && r < rows)
      out[static_cast<size_t>(c) * rows + r] = tile[threadIdx.x][j];
  }
}

__global__ void __launch_bounds__(kSlabThreads)
slab_transpose_kernel(const int* __restrict__ in, int* __restrict__ out,
                      int rows, int cols) {
  extern __shared__ int slab[];
  const int pitch = cols | 1;
  const int r0 = blockIdx.x * kSlabRows;
  for (int j = 0; j < kSlabRows && r0 + j < rows; ++j) {
    const int* src = in + static_cast<size_t>(r0 + j) * cols;
    for (int c = threadIdx.x; c < cols; c += kSlabThreads)
      slab[j * pitch + c] = src[c];
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = r0 + lane;
  if (r >= rows) return;
  for (int c = warp; c < cols; c += kSlabThreads / 32)
    out[static_cast<size_t>(c) * rows + r] = slab[lane * pitch + c];
}

__global__ void __launch_bounds__(kSumCols)
consume_kernel(const int* __restrict__ t, int* __restrict__ out, int rows,
               int cols) {
  const int r0 = blockIdx.x * kSumRows;
  const int r1 = min(rows, r0 + kSumRows);
  uint32_t acc = 0u;
  for (int r = r0; r < r1; ++r)
    acc += static_cast<uint32_t>(t[static_cast<size_t>(r) * cols +
                                   threadIdx.x]);
  atomicAdd(reinterpret_cast<unsigned int*>(out) + threadIdx.x, acc);
}

size_t slab_bytes(int cols) {
  return static_cast<size_t>(kSlabRows) * (cols | 1) * sizeof(int);
}

}  // namespace viterbi_transpose

using namespace viterbi_transpose;

// Launch variant `variant` (0 32x32, 1 64x64, 2 slab: out (cols, rows) =
// in (rows, cols) transposed; 3 consume: out (128,) += the column sums of
// in's first 128 columns, cols >= 128) on int32 arrays.  The slab needs
// cols | 1 <= 1816 (32 rows of it in 227 KB).  Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int viterbi_k26_launch(int variant, const void* in, void* out,
                                  int rows, int cols, void* stream) {
  const int* x = static_cast<const int*>(in);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0 || in == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: {
      const dim3 grid((cols + 31) / 32, (rows + 31) / 32);
      if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
      tile_transpose_kernel<32><<<grid, dim3(32, kRowsAPass), 0, s>>>(
          x, o, rows, cols);
      break;
    }
    case 1: {
      const dim3 grid((cols + 63) / 64, (rows + 63) / 64);
      if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
      tile_transpose_kernel<64><<<grid, dim3(64, kRowsAPass), 0, s>>>(
          x, o, rows, cols);
      break;
    }
    case 2: {
      const size_t smem = slab_bytes(cols);
      const cudaError_t err = cudaFuncSetAttribute(
          slab_transpose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      slab_transpose_kernel<<<(rows + kSlabRows - 1) / kSlabRows,
                              kSlabThreads, smem, s>>>(x, o, rows, cols);
      break;
    }
    case 3:
      if (cols < kSumCols) return static_cast<int>(cudaErrorInvalidValue);
      consume_kernel<<<(rows + kSumRows - 1) / kSumRows, kSumCols, 0, s>>>(
          x, o, rows, cols);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
