// Kernel K26: the staging-transpose experiment at the 32M-bit shape and its
// consumer.  Replaces the TPU kernels of scripts/transpose_bench.py:
// _tr_kernel (:33, launched by pallas_transpose at :68), which moved a (B,
// Lw) int32 array to (Lw, B) in tiles of 256 x 256, 512 x 512 and 128 x
// 1056 through VMEM, and _sum_kernel (:37, launched by pallas_consume at
// :51), which summed the first 128 columns of every row of its input to
// force it to exist.
//
// Tilings (the JAX tiles, mapped to tiles that fit 227 KB of shared
// memory; a JAX tile of 512 x 512 int32 is 1 MB), each on two routes:
//   0 32x32   32 x 32 tiles
//   1 64x64   64 x 64 tiles
//   2 slab    32 whole rows (the JAX 128 x 1056's full width)
// and variant 3, the consumer: out[j] = sum over rows of t[r][j], j < 128,
// int32 wrapping (integer addition mod 2^32 does not depend on the order):
// one launch of one thread-block cluster of 8 CTAs of 1,024 threads that
// writes out, so the caller allocates it with torch.empty and no zeroing
// launch runs before it.  CTA k sums the k-th eighth of the rows, 8 row
// groups of 128 columns, reduces its groups in shared memory, and CTA 0
// adds the 8 CTAs' sums through distributed shared memory
// (map_shared_rank) and writes the 128 results: no atomics.  A cluster
// rather than one CTA of 1,024 threads, so that the loads of eight SMs, not
// one, share the 540 KB of the JAX shape.
// The plain PyTorch versions are transpose_torch and consume_torch in
// tpu_viterbi_torch/scripts/transpose_bench.py; every tiling on either route
// agrees with them bit for bit.
//
// What bounds the transpose: device memory, 2 x 66.5 MB at the JAX shape
// (15,744 x 1,056 int32): 0.040 ms at 3.35 TB/s; a copy_ of the same bytes
// takes 0.0456 ms on the H100 (PERF.md).  The first design (the element
// route below) moves every word with a 4-byte load and a 4-byte store, and
// a CTA moves one tile, so its loads never overlap its own stores; its 32 x
// 32 and 64 x 64 tiles still reach 79-80 % of the bound, many CTAs an SM
// overlapping each other, but its slab CTA loads 135 KB, syncs, then
// stores, and one slab fills an SM, so each SM alternates between reading
// only and writing only: 29 %.
//
// Route 1, bulk (rows and cols multiples of 4, both arrays 16-byte
// aligned; the JAX shape): the copy engine moves the bytes in.
//   - Loads are 1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx),
//     one a tile row (128 bytes a 32-word row, 256 a 64-word one), issued
//     by the 32 lanes of a warp, completing on the tile slot's mbarrier; no
//     thread loads a word itself.
//   - A tile slot holds row i at i * 4T + 16 (i >> 2) bytes: the 16-byte
//     chunk j of row i falls in bank group ((i >> 2) + j) % 8, so the eight
//     lanes of a quarter-warp, which read chunk j of rows 4g + p for g = 0
//     .. 7, hit eight distinct groups (no bank conflict on LDS.128).
//   - A lane reads a 4 x 4 block (four 16-byte shared loads), transposes it
//     in registers and writes four 16-byte stores (st.global.v4), one an
//     output row; the eight lanes of a quarter-warp write 128 contiguous
//     bytes of one output row.
//   - 32x32 and 64x64: a persistent grid (the CTAs an SM holds, times the
//     SMs) of CTAs of kTileWarps warps; each warp walks tiles t = its global
//     index + n x (warps in the grid) with a ring of kTileSlots slots, each
//     with its own mbarrier, so that the loads of the next kTileSlots - 1
//     tiles are in flight while it stores one.  The walk takes the tile's
//     row block fastest, so the warps in flight write whole output rows.
//   - slab: a persistent grid of one CTA an SM, each walking slabs of 32
//     rows; the slab is a row of 32-word chunks, each in its own slot with
//     its own mbarrier, and a warp owns a few chunks: it stores a chunk's
//     output rows as soon as that chunk lands and then loads the same chunk
//     of its CTA's next slab into the slot, so an SM reads and writes at
//     once.
// Route 0, element (any shape): the first design, kept for the shapes the
// bulk copies cannot take (a row pitch or a base that is not a multiple of
// 16 bytes): a tile through a padded shared tile (odd pitch: the
// column-wise accesses are free of bank conflicts), 4-byte loads along an
// input row and 4-byte stores along an output row, whole 128-byte lines a
// warp.
//   0 32x32   a 32 x 33 padded tile, a CUDA block of 32 x 8 threads (K6's)
//   1 64x64   a 64 x 65 padded tile, 64 x 8 threads
//   2 slab    32 whole rows in a 32 x (cols | 1) padded slab of dynamic
//             shared memory, 1024 threads: a warp writes 32 neighbouring
//             words of each output row
// The wrapper picks the route (TransposeBenchKernel.route) and counts the
// launches of each; a bulk launch on a shape it cannot take is refused.
// The consumer reads 128 columns a row, 512 bytes, coalesced: 540 KB at the
// JAX shape, 0.0002 ms of bytes, so the launch is its floor.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace viterbi_transpose {

namespace cg = cooperative_groups;

constexpr int kRowsAPass = 8;
constexpr int kSlabRows = 32;
constexpr int kSlabThreads = 1024;
constexpr int kSumCols = 128;
constexpr int kSumCluster = 8;                     // CTAs of the consumer
constexpr int kSumThreads = 1024;
constexpr int kSumGroups = kSumThreads / kSumCols;  // row groups a CTA

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

__global__ void __cluster_dims__(kSumCluster, 1, 1)
    __launch_bounds__(kSumThreads)
consume_kernel(const int* __restrict__ t, int* __restrict__ out, int rows,
               int cols) {
  __shared__ uint32_t part[kSumGroups][kSumCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int col = threadIdx.x % kSumCols, g = threadIdx.x / kSumCols;
  const int share = (rows + kSumCluster - 1) / kSumCluster;
  const int r1 = min(rows, (rank + 1) * share);
  uint32_t acc = 0u;
#pragma unroll 4
  for (int r = rank * share + g; r < r1; r += kSumGroups)
    acc += static_cast<uint32_t>(__ldg(t + static_cast<size_t>(r) * cols +
                                       col));
  part[g][col] = acc;
  __syncthreads();
  if (g == 0) {
    for (int k = 1; k < kSumGroups; ++k) acc += part[k][col];
    part[0][col] = acc;
  }
  cluster.sync();  // every CTA's part[0] is written and visible to CTA 0
  if (rank == 0 && g == 0) {
    uint32_t sum = 0u;
    for (int k = 0; k < kSumCluster; ++k)
      sum += cluster.map_shared_rank(&part[0][0], k)[col];
    out[col] = static_cast<int>(sum);
  }
  cluster.sync();  // no CTA exits while CTA 0 still reads its shared memory
}

// --- route 1: bulk copies into mbarrier-completed tile slots ---

// Warps a CTA (32x32, 64x64) and ring slots a warp: 1-8 warps with 2-4
// slots read within 6 % of each other on the H100 (PERF.md).
constexpr int kTileWarps = 4;
constexpr int kTileSlots = 3;
constexpr int kChunkWords = 32;     // slab: words a chunk of a slab row
constexpr int kBarBytes = 128;      // the barriers' space before the slots
static_assert(8 * kTileWarps * kTileSlots <= kBarBytes, "tile barriers");

// Bytes of a T x T slot: row i at i * 4T + 16 (i >> 2).
template <int T>
__host__ __device__ constexpr int slot_bytes() {
  return T * T * 4 + 16 * (T / 4);
}

template <int T>
__device__ __forceinline__ int slot_row(int i) {
  return i * T * 4 + 16 * (i >> 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The one arrival of a fill, which also expects its bytes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void st_v4(int* p, int x, int y, int z, int w) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(x),
               "r"(y), "r"(z), "r"(w)
               : "memory");
}

// Where a tile or chunk lies: rows r0 .. r0 + rv - 1, cols c0 .. c0 + cv - 1
// of the input (rv, cv multiples of 4 on this route).
struct Tile {
  int r0, c0, rv, cv;
};

// One warp fills a slot with a tile: lane 0 arrives expecting its bytes,
// then lane i copies rows i, i + 32, ... (4 cv bytes each).
template <int T>
__device__ __forceinline__ void fill(unsigned char* slot, uint64_t* bar,
                                     const int* __restrict__ in, int cols,
                                     Tile t, int lane) {
  if (lane == 0) mbar_expect_tx(bar, static_cast<uint32_t>(t.rv * t.cv * 4));
  __syncwarp();
  const int* src = in + static_cast<size_t>(t.r0) * cols + t.c0;
  for (int i = lane; i < t.rv; i += 32)
    bulk_load(slot + slot_row<T>(i), src + static_cast<size_t>(i) * cols,
              static_cast<uint32_t>(t.cv * 4), bar);
}

// One warp stores a landed slot transposed: lane (g, j) blocks, g = (lane &
// 7) + 8 a and j = (lane >> 3) + 4 b: rows 4g .. 4g + 3 of 16-byte chunk j,
// written as output rows c0 + 4j .. + 3 at columns r0 + 4g .. + 3.
template <int T>
__device__ __forceinline__ void drain(const unsigned char* slot,
                                      int* __restrict__ out, int rows, Tile t,
                                      int lane) {
  constexpr int kGroups = T / 4;
#pragma unroll
  for (int a = 0; a < kGroups / 8; ++a) {
#pragma unroll
    for (int b = 0; b < kGroups / 4; ++b) {
      const int g = (lane & 7) + 8 * a, j = (lane >> 3) + 4 * b;
      if (4 * g >= t.rv || 4 * j >= t.cv) continue;
      int4 v[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        v[p] = *reinterpret_cast<const int4*>(slot + slot_row<T>(4 * g + p) +
                                              16 * j);
      int* dst = out + static_cast<size_t>(t.c0 + 4 * j) * rows + t.r0 + 4 * g;
      st_v4(dst, v[0].x, v[1].x, v[2].x, v[3].x);
      st_v4(dst + rows, v[0].y, v[1].y, v[2].y, v[3].y);
      st_v4(dst + 2 * static_cast<size_t>(rows), v[0].z, v[1].z, v[2].z,
            v[3].z);
      st_v4(dst + 3 * static_cast<size_t>(rows), v[0].w, v[1].w, v[2].w,
            v[3].w);
    }
  }
}

// Before a slot the warp has read is filled again: the warp's reads are
// done (__syncwarp) and ordered before the copy engine's writes.
__device__ __forceinline__ void release_slot() {
  __syncwarp();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Every barrier of the CTA set up by its first `count` threads.
__device__ __forceinline__ void init_barriers(uint64_t* bars, int count) {
  if (static_cast<int>(threadIdx.x) < count) mbar_init(bars + threadIdx.x);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
}

template <int T>
__device__ __forceinline__ Tile tile_at(long long t, int row_blocks, int rows,
                                        int cols) {
  const int r0 = static_cast<int>(t % row_blocks) * T;
  const int c0 = static_cast<int>(t / row_blocks) * T;
  return Tile{r0, c0, min(T, rows - r0), min(T, cols - c0)};
}

template <int T>
__global__ void __launch_bounds__(kTileWarps * 32)
bulk_tile_kernel(const int* __restrict__ in, int* __restrict__ out, int rows,
                 int cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  init_barriers(bars, kTileWarps * kTileSlots);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_blocks = (rows + T - 1) / T;
  const long long tiles =
      static_cast<long long>(row_blocks) * ((cols + T - 1) / T);
  const long long first = static_cast<long long>(blockIdx.x) * kTileWarps +
                          warp;
  const long long step = static_cast<long long>(gridDim.x) * kTileWarps;
  uint64_t* bar = bars + warp * kTileSlots;
  unsigned char* ring = smem + kBarBytes +
                        static_cast<size_t>(warp) * kTileSlots *
                            slot_bytes<T>();
#pragma unroll
  for (int s = 0; s < kTileSlots; ++s) {
    const long long t = first + s * step;
    if (t < tiles)
      fill<T>(ring + s * slot_bytes<T>(), bar + s, in, cols,
              tile_at<T>(t, row_blocks, rows, cols), lane);
  }
  int s = 0;
  uint32_t parity = 0;
  for (long long t = first; t < tiles; t += step) {
    unsigned char* slot = ring + s * slot_bytes<T>();
    mbar_wait(bar + s, parity);
    drain<T>(slot, out, rows, tile_at<T>(t, row_blocks, rows, cols), lane);
    const long long next = t + kTileSlots * step;
    if (next < tiles) {
      release_slot();
      fill<T>(slot, bar + s, in, cols,
              tile_at<T>(next, row_blocks, rows, cols), lane);
    }
    if (++s == kTileSlots) {
      s = 0;
      parity ^= 1u;
    }
  }
}

// Barrier bytes of a slab of `chunks` chunks, rounded to kBarBytes.
__host__ __device__ __forceinline__ int slab_bar_bytes(int chunks) {
  return (8 * chunks + kBarBytes - 1) / kBarBytes * kBarBytes;
}

__global__ void __launch_bounds__(1024)
bulk_slab_kernel(const int* __restrict__ in, int* __restrict__ out, int rows,
                 int cols) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunks = (cols + kChunkWords - 1) / kChunkWords;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* slots = smem + slab_bar_bytes(chunks);
  init_barriers(bars, chunks);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int slabs = (rows + kSlabRows - 1) / kSlabRows;
  auto chunk_at = [&](int slab, int k) {
    const int r0 = slab * kSlabRows, c0 = k * kChunkWords;
    return Tile{r0, c0, min(kSlabRows, rows - r0),
                min(kChunkWords, cols - c0)};
  };
  if (static_cast<int>(blockIdx.x) < slabs)
    for (int k = warp; k < chunks; k += warps)
      fill<kChunkWords>(slots + k * slot_bytes<kChunkWords>(), bars + k, in,
                        cols, chunk_at(blockIdx.x, k), lane);
  uint32_t parity = 0;
  for (int slab = blockIdx.x; slab < slabs; slab += gridDim.x) {
    const int next = slab + static_cast<int>(gridDim.x);
    for (int k = warp; k < chunks; k += warps) {
      unsigned char* slot = slots + k * slot_bytes<kChunkWords>();
      mbar_wait(bars + k, parity);
      drain<kChunkWords>(slot, out, rows, chunk_at(slab, k), lane);
      if (next < slabs) {
        release_slot();
        fill<kChunkWords>(slot, bars + k, in, cols, chunk_at(next, k), lane);
      }
    }
    parity ^= 1u;
  }
}

size_t slab_bytes(int cols) {
  return static_cast<size_t>(kSlabRows) * (cols | 1) * sizeof(int);
}

// The grid of a persistent kernel: as many CTAs as the SMs hold at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), at most `work`.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            long long work, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = static_cast<int>(std::min(work, static_cast<long long>(sms) *
                                               per_sm));
  return cudaSuccess;
}

template <int T>
cudaError_t launch_bulk_tiles(const int* x, int* o, int rows, int cols,
                              cudaStream_t s) {
  const size_t smem = kBarBytes + static_cast<size_t>(kTileWarps) *
                                      kTileSlots * slot_bytes<T>();
  const long long tiles = static_cast<long long>((rows + T - 1) / T) *
                          ((cols + T - 1) / T);
  int grid = 0;
  const cudaError_t err =
      persistent_grid(bulk_tile_kernel<T>, kTileWarps * 32, smem,
                      (tiles + kTileWarps - 1) / kTileWarps, &grid);
  if (err != cudaSuccess) return err;
  bulk_tile_kernel<T><<<grid, kTileWarps * 32, smem, s>>>(x, o, rows, cols);
  return cudaGetLastError();
}

// The slab's warps: the fewest that give every warp the same number of
// chunks, give or take one, at most 32 (ceil(chunks / 32) chunks a warp).
cudaError_t launch_bulk_slab(const int* x, int* o, int rows, int cols,
                             cudaStream_t s) {
  const int chunks = (cols + kChunkWords - 1) / kChunkWords;
  const int per_warp = (chunks + 31) / 32;
  const int threads = 32 * ((chunks + per_warp - 1) / per_warp);
  const size_t smem = slab_bar_bytes(chunks) +
                      static_cast<size_t>(chunks) * slot_bytes<kChunkWords>();
  int grid = 0;
  const cudaError_t err = persistent_grid(
      bulk_slab_kernel, threads, smem, (rows + kSlabRows - 1) / kSlabRows,
      &grid);
  if (err != cudaSuccess) return err;
  bulk_slab_kernel<<<grid, threads, smem, s>>>(x, o, rows, cols);
  return cudaGetLastError();
}

}  // namespace viterbi_transpose

using namespace viterbi_transpose;

// Launch variant `variant` (0 32x32, 1 64x64, 2 slab: out (cols, rows) =
// in (rows, cols) transposed, on route `route`, 0 element or 1 bulk; 3
// consume: out (128,) = the column sums of in's first 128 columns, cols >=
// 128, route ignored) on int32 arrays.  The bulk route takes rows and cols
// that are multiples of 4 and 16-byte aligned arrays, and its slab needs
// ceil(cols / 32) chunks of 4,224 bytes (and their barriers) in 227 KB; the
// element slab needs cols | 1 <= 1816 (32 rows of it in 227 KB).  Returns
// the cudaError_t of the launch (0 = launched; a shape or array the route
// cannot take is cudaErrorInvalidValue).
extern "C" int viterbi_k26_launch(int variant, int route, const void* in,
                                  void* out, int rows, int cols,
                                  void* stream) {
  const int* x = static_cast<const int*>(in);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0 || in == nullptr || out == nullptr ||
      (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1 && variant < 3) {
    if (rows % 4 != 0 || cols % 4 != 0 ||
        reinterpret_cast<uintptr_t>(in) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        variant == 0   ? launch_bulk_tiles<32>(x, o, rows, cols, s)
        : variant == 1 ? launch_bulk_tiles<64>(x, o, rows, cols, s)
                       : launch_bulk_slab(x, o, rows, cols, s);
    return static_cast<int>(err);
  }
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
      consume_kernel<<<kSumCluster, kSumThreads, 0, s>>>(x, o, rows, cols);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
