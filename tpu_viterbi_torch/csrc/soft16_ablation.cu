// Kernel K25: SOFT16's input traffic apart from its unpack, on K13's
// harness.  Replaces the TPU probe kernel scripts/soft16_ablation.py:_kernel
// (:61, launched by time_variant at :87), which decomposed SOFT16's time a
// stage over SOFT8's at the construct level.
//
// A program is n_packs (wpp, 128) int32 word blocks of `words`, wpp 16
// (SOFT8's words of a 32-stage pack) or 32 (SOFT16's); each of its 128
// columns is one array of 64 states, pm and pp starting at zero, n_packs x
// 32 stages.  Variants:
//   0 s8/noup     wpp 16: u = row 0, d = row 1 of the pack's block, raw, for
//                 all 32 stages (JAX :73-77); every other word of the block
//                 is read and not used: SOFT8's traffic, no unpack
//   1 s16/noup    the same on wpp 32: SOFT16's traffic, no unpack
//   2 s8/unpack   SOFT8's unpack: stage s reads word s / 2, its fields MSB
//                 first (_make_ud_soft8, K13's +unpack, K1's IntReader<8>)
//   3 s16/unpack  SOFT16's: stage s reads word s, a0 = w >> 16, a1 = (w <<
//                 16) >> 16, u = a0 + a1, d = a0 - a1 (_make_ud_soft16 :48)
// Output: (programs, 128) = (pm + pp)[0] of every program, wrapping.  The
// stage is K1's acs_stage (acs.cuh); the plain PyTorch version is
// soft16_ablation_torch in tpu_viterbi_torch/scripts/soft16_ablation.py,
// with which every variant agrees bit for bit.
//
// What bounds it: the ACS' issue, 256 operations an array-stage; the words
// are 4 (SOFT8) or 8 (SOFT16) bytes an array-stage, 67 MB for SOFT16 at the
// JAX shape, 0.02 ms at the memory rate against 0.13 ms of issue.  What the
// design does about it: it is K13's: one thread an array, 64 CUDA threads a
// block, a loop of two stages whose next words load while it runs.  The
// words noup does not use are read with ld.volatile, which ptxas may not
// drop, so the traffic is real (the probe prints the loop's LDG count);
// on the TPU the block's DMA read them all.

#include <cuda_runtime.h>

#include <cstdint>

#include "acs.cuh"

namespace viterbi_soft16_ablation {

using viterbi::Bm;
using viterbi::kStates;

constexpr int kCols = 128;   // arrays of a program
constexpr int kThreads = 64; // K1's CUDA block

// A word of the block that is read and not used.
__device__ __forceinline__ void touch(const int* p) {
  int v;
  asm volatile("ld.volatile.global.b32 %0, [%1];" : "=r"(v) : "l"(p));
}

template <int V>
__global__ void __launch_bounds__(kThreads)
soft16_ablation_kernel(const int* __restrict__ words, int* __restrict__ out,
                       int programs, int n_packs) {
  constexpr int kWpp = V % 2 ? 32 : 16;
  constexpr bool kUnpack = V >= 2;
  const int arrays = programs * kCols;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= arrays) return;
  const int g = i / kCols, l = i % kCols;
  const int* w = words + static_cast<size_t>(g) * n_packs * kWpp * kCols + l;
  int pm_a[kStates], pm_b[kStates];
  uint32_t pp_a[kStates], pp_b[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    pm_a[s] = 0;
    pp_a[s] = 0u;
  }
  const int n_words = n_packs * kWpp;
  auto load = [&](int idx) {
    return idx < n_words ? static_cast<uint32_t>(__ldg(w + idx * kCols)) : 0u;
  };
  // the words of the next pass of the stage loop, loaded a pass ahead: one
  // (SOFT8) or two (SOFT16) words of the unpack, or noup's raw u and d
  int next = 0;
  uint32_t w0 = 0u, w1 = 0u;
  if constexpr (kUnpack) {
    w0 = load(next++);
    if constexpr (kWpp == 32) w1 = load(next++);
  }
  Bm raw;
  raw.u = __ldg(w);
  raw.d = __ldg(w + kCols);
  for (int p = 0; p < n_packs; ++p) {
    const int* block = w + static_cast<size_t>(p) * kWpp * kCols;
    Bm pack_bm = raw;
    pack_bm.nu = viterbi::neg<true>(raw.u);
    pack_bm.nd = viterbi::neg<true>(raw.d);
    if constexpr (!kUnpack) {
      if (p + 1 < n_packs) {
        raw.u = __ldg(block + kWpp * kCols);
        raw.d = __ldg(block + (kWpp + 1) * kCols);
      }
    }
#pragma unroll 1
    for (int t = 0; t < 32; t += 2) {
      Bm m0, m1;
      if constexpr (!kUnpack) {
#pragma unroll
        for (int k = 0; k < kWpp / 16; ++k)
          touch(block + ((t / 2) * (kWpp / 16) + k) * kCols);
        m0 = pack_bm;
        m1 = pack_bm;
      } else if constexpr (kWpp == 16) {
        viterbi::int_bm(static_cast<int>(w0) >> 24,
                        static_cast<int>(w0 << 8) >> 24, m0);
        viterbi::int_bm(static_cast<int>(w0 << 16) >> 24,
                        static_cast<int>(w0 << 24) >> 24, m1);
        w0 = load(next++);
      } else {
        viterbi::int_bm(static_cast<int>(w0) >> 16,
                        static_cast<int>(w0 << 16) >> 16, m0);
        viterbi::int_bm(static_cast<int>(w1) >> 16,
                        static_cast<int>(w1 << 16) >> 16, m1);
        w0 = load(next++);
        w1 = load(next++);
      }
      viterbi::acs_stage<true>(pm_a, pp_a, pm_b, pp_b, m0);
      viterbi::acs_stage<true>(pm_b, pp_b, pm_a, pp_a, m1);
    }
  }
  out[i] = static_cast<int>(static_cast<uint32_t>(pm_a[0]) + pp_a[0]);
}

template <int V>
cudaError_t launch(const int* words, int* out, int programs, int n_packs,
                   cudaStream_t stream) {
  const int arrays = programs * kCols;
  soft16_ablation_kernel<V><<<(arrays + kThreads - 1) / kThreads, kThreads, 0,
                              stream>>>(words, out, programs, n_packs);
  return cudaGetLastError();
}

}  // namespace viterbi_soft16_ablation

using namespace viterbi_soft16_ablation;

// Launch variant `variant` (0 s8/noup, 1 s16/noup, 2 s8/unpack, 3
// s16/unpack) over `programs` programs of n_packs (>= 1) packs: words holds
// programs x n_packs x wpp x 128 int32 (wpp 16 for variants 0 and 2, 32 for
// 1 and 3), out programs x 128 int32.  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int viterbi_k25_launch(int variant, const void* words, void* out,
                                  int programs, int n_packs, void* stream) {
  const int* w = static_cast<const int*>(words);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (programs <= 0 || n_packs < 1 || words == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(w, o, programs, n_packs, s));
    case 1: return static_cast<int>(launch<1>(w, o, programs, n_packs, s));
    case 2: return static_cast<int>(launch<2>(w, o, programs, n_packs, s));
    case 3: return static_cast<int>(launch<3>(w, o, programs, n_packs, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
