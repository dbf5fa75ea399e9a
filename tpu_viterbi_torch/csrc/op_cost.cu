// Kernel K11 (its op-cost part): the per-construct ALU cost probe behind
// the hardware model's ALU rate.  Replaces the TPU probe kernels of
// scripts/op_cost_probe.py:make_kernel (:45-105, launched at :129), which
// time one (32, 128) int32 vector construct of the ACS at a time.
//
// Each thread owns one element (r, l) of a (32, 128) int32 tile x: c =
// x[r][l], u = x[1][l] (the broadcast row), mask = (r % 3 == 0).  It starts
// from a = x[r][l] and applies its variant's construct `steps` x 8 times,
// then writes a; add4 carries four independent chains from x + k, k = 0..3,
// and writes their sum (scripts/op_cost_probe.py:87-97):
//   0 add       a = a + c
//   1 add4      four independent a_k = a_k + c
//   2 mul       a = a * c
//   3 cmpsel    a = a > c ? c - a : a
//   4 selconst  a = mask ? a + c : a - c
//   5 bcast     a = a + u
//   6 shiftor   a = (a << 1) | (c & 1)
// All arithmetic wraps in two's complement, as the plain version's int32
// does (tpu_viterbi_torch/scripts/op_cost_probe.py:op_cost_torch).  The
// grid is whole tiles: element e of thread i is i mod 4096, and every tile
// of the output equals the plain version's one tile.
//
// What bounds it: instruction issue, by design; the only memory traffic is
// one load and one store a thread.  What the design does about it: the grid
// fills every SM (the wrapper launches a multiple of the SM count), each
// construct is written as inline PTX so that the front end cannot fold a
// chain of a + c into a + 8c, and the step loop is not unrolled, so its
// body holds the 8 constructs and the loop's own 3 instructions.  ptxas
// still sees the PTX: the probe reads the loop's SASS (cuobjdump) and
// reports its instruction count beside each rate.

#include <cuda_runtime.h>

namespace viterbi_op_cost {

constexpr int kCols = 128;
constexpr int kTile = 32 * kCols;
constexpr int kUnroll = 8;
constexpr int kThreads = 256;

template <int V>
__device__ __forceinline__ int one(int a, int c, int u, int keep) {
  if constexpr (V == 0 || V == 1) {
    asm volatile("add.s32 %0, %0, %1;" : "+r"(a) : "r"(c));
  } else if constexpr (V == 2) {
    asm volatile("mul.lo.s32 %0, %0, %1;" : "+r"(a) : "r"(c));
  } else if constexpr (V == 3) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t.reg .s32 t;\n\t"
        "setp.gt.s32 p, %0, %1;\n\t"
        "sub.s32 t, %1, %0;\n\t"
        "selp.b32 %0, t, %0, p;\n\t}"
        : "+r"(a)
        : "r"(c));
  } else if constexpr (V == 4) {
    // keep >= 0 where the row's mask holds: slct picks a + c there
    asm volatile(
        "{\n\t.reg .s32 t0, t1;\n\t"
        "add.s32 t0, %0, %1;\n\t"
        "sub.s32 t1, %0, %1;\n\t"
        "slct.s32.s32 %0, t0, t1, %2;\n\t}"
        : "+r"(a)
        : "r"(c), "r"(keep));
  } else if constexpr (V == 5) {
    asm volatile("add.s32 %0, %0, %1;" : "+r"(a) : "r"(u));
  } else if constexpr (V == 6) {
    asm volatile(
        "{\n\t.reg .b32 t0, t1;\n\t"
        "shl.b32 t0, %0, 1;\n\t"
        "and.b32 t1, %1, 1;\n\t"
        "or.b32 %0, t0, t1;\n\t}"
        : "+r"(a)
        : "r"(c));
  }
  return a;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
op_cost_kernel(const int* __restrict__ x, int* __restrict__ out, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int e = i % kTile;
  const int r = e / kCols;
  const int c = x[e];
  const int u = x[kCols + e % kCols];
  const int keep = r % 3 == 0 ? 0 : -1;
  if constexpr (V == 1) {
    int a0 = c, a1 = c + 1, a2 = c + 2, a3 = c + 3;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        a0 = one<V>(a0, c, u, keep);
        a1 = one<V>(a1, c, u, keep);
        a2 = one<V>(a2, c, u, keep);
        a3 = one<V>(a3, c, u, keep);
      }
    }
    out[i] = a0 + a1 + a2 + a3;
  } else {
    int a = c;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) a = one<V>(a, c, u, keep);
    }
    out[i] = a;
  }
}

template <int V>
cudaError_t launch(const int* x, int* out, int steps, int tiles,
                   cudaStream_t stream) {
  op_cost_kernel<V><<<tiles * (kTile / kThreads), kThreads, 0, stream>>>(
      x, out, steps);
  return cudaGetLastError();
}

}  // namespace viterbi_op_cost

using namespace viterbi_op_cost;

// Launch variant `variant` (0..6, the list above) for `steps` steps over
// `tiles` tiles: x holds one (32, 128) int32 tile, out tiles of them.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k11_launch(int variant, const void* x, void* out,
                                  int steps, int tiles, void* stream) {
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps < 0 || tiles <= 0 || x == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(xi, o, steps, tiles, s));
    case 1: return static_cast<int>(launch<1>(xi, o, steps, tiles, s));
    case 2: return static_cast<int>(launch<2>(xi, o, steps, tiles, s));
    case 3: return static_cast<int>(launch<3>(xi, o, steps, tiles, s));
    case 4: return static_cast<int>(launch<4>(xi, o, steps, tiles, s));
    case 5: return static_cast<int>(launch<5>(xi, o, steps, tiles, s));
    case 6: return static_cast<int>(launch<6>(xi, o, steps, tiles, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
