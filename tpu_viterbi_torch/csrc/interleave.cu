// Kernel K28: the ACS' perfect shuffle on its own.  Replaces the TPU probe
// kernel scripts/interleave_bench.py:make_kernel (:51, launched by
// run_variant at :76 and by check_correct at :113), which timed lowerings of
// the sublane interleave I[2q] = E[q], I[2q+1] = O[q] of two (32, 128)
// arrays into (64, 128).
//
// Every column of x (64 rows, cols columns, int32) is one problem: E = rows
// 0-31, O = rows 32-63.  A rep merges them and adds `one` to every value:
// E' = I[0:32] + one, O' = I[32:64] + one; after `reps` reps the column is
// written back in place of x's (out has x's shape).  one = 0 and reps = 1
// give the bare merge, the JAX script's correctness check (:99-127).
// Variants, the GPU forms of the JAX ones:
//   0 regs    (bcast) a thread holds its column's 64 values in registers and
//             the shuffle is register renaming: it has order 6 on 64 rows,
//             so the rep loop is unrolled by 6 and the renaming is static;
//             a rep is 64 adds, the last reps % 6 moves and adds
//   1 shfl    (new) a warp holds a column, lane q rows q and 32 + q; a rep
//             fetches rows q >> 1 and 16 + (q >> 1) of E and of O with four
//             __shfl_sync and selects by the lane's parity
//   2 smem    (scratch) a thread stores its column's E and O to the even and
//             odd rows of a shared-memory column and reads all 64 back
//             (merge_scratch :44-48), volatile so that the round trip is
//             not forwarded in registers
//   3 concat  the wrong-result floor: I = [E; O], so a rep only adds; its
//             loop is regs' (unrolled by 6), so the two differ only where
//             regs renames
// Every add is inline PTX.  In regs' and concat's passes of 6 reps, rep j
// adds its own register o[j], read from shared memory where each holds
// `one`, so that ptxas cannot fold a value's 6 adds into one multiply (it
// may still fuse two adds into one IADD3, as the hardware allows).  The
// plain PyTorch version is interleave_torch in
// tpu_viterbi_torch/scripts/interleave_bench.py; each variant agrees with
// it bit for bit.
//
// What bounds it: issue, 64 adds a column-rep (regs, concat: 32 IADD3 at
// best, each adding two); shfl adds 4 shuffles and 2 selects a lane-rep,
// 256 lane-operations a column-rep, on the shuffle unit; smem 128 shared
// accesses a column-rep on the load/store unit.  At the JAX shape (1,024
// columns) only 8 CUDA blocks run: the probe also runs a grid that fills
// every SM.

#include <cuda_runtime.h>

#include <cstdint>

namespace viterbi_interleave {

constexpr int kRows = 64;
constexpr int kHalf = 32;
constexpr int kThreads = 128;   // a tile of 128 columns a CUDA block
constexpr int kOrder = 6;       // the perfect shuffle of 64 rows: order 6

__device__ __forceinline__ int add(int a, int one) {
  asm volatile("add.s32 %0, %0, %1;" : "+r"(a) : "r"(one));
  return a;
}

// Row r of I comes from row src(r) of [E; O]: E[r / 2] or O[r / 2].
__host__ __device__ constexpr int src_row(int r) {
  return (r % 2) * kHalf + r / 2;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
interleave_kernel(const int* __restrict__ x, int* __restrict__ out,
                  int cols, int reps, int one) {
  if constexpr (V == 1) {
    const int w = (blockIdx.x * kThreads + threadIdx.x) / 32;
    const int q = threadIdx.x % 32;
    if (w >= cols) return;
    int e = x[static_cast<size_t>(q) * cols + w];
    int o = x[static_cast<size_t>(kHalf + q) * cols + w];
    const int lo = q >> 1, hi = 16 + (q >> 1);
    const bool odd = q & 1;
#pragma unroll 1
    for (int k = 0; k < reps; ++k) {
      const int e_lo = __shfl_sync(0xffffffffu, e, lo);
      const int o_lo = __shfl_sync(0xffffffffu, o, lo);
      const int e_hi = __shfl_sync(0xffffffffu, e, hi);
      const int o_hi = __shfl_sync(0xffffffffu, o, hi);
      e = add(odd ? o_lo : e_lo, one);
      o = add(odd ? o_hi : e_hi, one);
    }
    out[static_cast<size_t>(q) * cols + w] = e;
    out[static_cast<size_t>(kHalf + q) * cols + w] = o;
    return;
  }
  __shared__ int ones[kOrder];
  if constexpr (V != 2) {
    if (threadIdx.x < kOrder) ones[threadIdx.x] = one;
    __syncthreads();
  }
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  int v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = x[static_cast<size_t>(r) * cols + c];
  if constexpr (V == 0 || V == 3) {
    // regs: every value gets one add a rep wherever it moves, and 6
    // shuffles bring every row back, so a pass of 6 reps is 6 x 64 adds on
    // the registers in place, the shuffles being static renaming; concat
    // moves nothing at all
    const volatile int* vo = ones;
    int o[kOrder];
#pragma unroll
    for (int j = 0; j < kOrder; ++j) o[j] = vo[j];
    int k = 0;
#pragma unroll 1
    for (; k + kOrder <= reps; k += kOrder) {
#pragma unroll
      for (int j = 0; j < kOrder; ++j) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = add(v[r], o[j]);
      }
    }
    for (; k < reps; ++k) {       // the last reps % 6 (regs: renamed by moves)
      int t[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        t[r] = add(v[V == 0 ? src_row(r) : r], one);
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = t[r];
    }
  } else {
    __shared__ int s[kRows][kThreads];
    volatile int* col = &s[0][threadIdx.x];
#pragma unroll 1
    for (int k = 0; k < reps; ++k) {
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        col[(2 * q) * kThreads] = v[q];
        col[(2 * q + 1) * kThreads] = v[kHalf + q];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = add(col[r * kThreads], one);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    out[static_cast<size_t>(r) * cols + c] = v[r];
}

template <int V>
cudaError_t launch(const int* x, int* out, int cols, int reps, int one,
                   cudaStream_t stream) {
  const long long threads = V == 1 ? 32LL * cols : cols;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  interleave_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(x, out, cols, reps, one);
  return cudaGetLastError();
}

}  // namespace viterbi_interleave

using namespace viterbi_interleave;

// Launch variant `variant` (0 regs, 1 shfl, 2 smem, 3 concat) for `reps`
// reps adding `one` on x, (64, cols) int32; out has x's shape.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k28_launch(int variant, const void* x, void* out,
                                  int cols, int reps, int one, void* stream) {
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols <= 0 || reps < 0 || x == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(xi, o, cols, reps, one, s));
    case 1: return static_cast<int>(launch<1>(xi, o, cols, reps, one, s));
    case 2: return static_cast<int>(launch<2>(xi, o, cols, reps, one, s));
    case 3: return static_cast<int>(launch<3>(xi, o, cols, reps, one, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
