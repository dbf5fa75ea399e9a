// Kernel K15: the ILP probe, int32 add/max chains at 1, 2 or 4 independent
// chains a thread.  Replaces the TPU probe kernel of scripts/ilp_probe.py:
// make_kernel (:23), launched at :48.
//
// Each thread owns element e = i mod 4096 of a (32, 128) int32 tile x, with
// c = x[1][e mod 128] (the JAX kernel's row 1, broadcast); chain k starts
// at x[e] + k, and each of `steps` steps applies 8 times, to every chain,
// a = a + c, then a = max(a, c - a).  out[i] is the sum of the chains, all
// arithmetic wrapping, so every element equals the plain version's value at
// its tile position (tpu_viterbi_torch/scripts/ilp_probe.py:ilp_torch).
//
// What bounds it: instruction issue when the card holds enough warps, and
// the chain's dependency latency when it does not; the only memory traffic
// is two loads and one store a thread.  What the design does about it: the
// caller picks the occupancy (one warp a scheduler, K1's at the headline,
// or the SM's 2048 threads), each construct is written as inline PTX, and
// the step loop is not unrolled, so its body holds 8 x chains pairs and the
// loop's own instructions, which the probe reads from the SASS.  ptxas
// still folds c - (a + c) into -a, an operand of the max: a pair is two
// instructions, the JAX probe's two operations.

#include <cuda_runtime.h>

namespace viterbi_ilp {

constexpr int kCols = 128;
constexpr int kTile = 32 * kCols;
constexpr int kUnroll = 8;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ int add_max(int a, int c) {
  asm volatile(
      "{\n\t.reg .s32 t;\n\t"
      "add.s32 %0, %0, %1;\n\t"
      "sub.s32 t, %1, %0;\n\t"
      "max.s32 %0, %0, t;\n\t}"
      : "+r"(a)
      : "r"(c));
  return a;
}

template <int CHAINS>
__global__ void __launch_bounds__(kMaxThreads)
ilp_kernel(const int* __restrict__ x, int* __restrict__ out, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int e = i % kTile;
  const int c = x[kCols + e % kCols];
  int a[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) a[k] = x[e] + k;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < CHAINS; ++k) a[k] = add_max(a[k], c);
    }
  }
  unsigned sum = 0u;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) sum += static_cast<unsigned>(a[k]);
  out[i] = static_cast<int>(sum);
}

}  // namespace viterbi_ilp

using namespace viterbi_ilp;

// Launch `chains` (1, 2 or 4) chains for `steps` steps on blocks x threads
// threads (threads a multiple of 32, at most 256): x holds one (32, 128)
// int32 tile, out blocks x threads int32.  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int viterbi_k15_launch(int chains, const void* x, void* out,
                                  int steps, int blocks, int threads,
                                  void* stream) {
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps < 0 || blocks <= 0 || threads <= 0 || threads % 32 != 0 ||
      threads > kMaxThreads || x == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (chains) {
    case 1: ilp_kernel<1><<<blocks, threads, 0, s>>>(xi, o, steps); break;
    case 2: ilp_kernel<2><<<blocks, threads, 0, s>>>(xi, o, steps); break;
    case 4: ilp_kernel<4><<<blocks, threads, 0, s>>>(xi, o, steps); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
