// Kernel K13: K1 built up piece by piece, the ablation probe.  Replaces the
// TPU probe kernel scripts/kernel_ablation.py:_kernel (:71, launched by
// time_variant at :162).
//
// A program is n_packs (16, 128) int32 word blocks of `words`; each of its
// 128 columns is one time-block (array) of 64 states, with pm and pp
// starting at zero and n_packs x 32 stages.  Each variant adds one piece:
//   0 body        bm from raw rows: stage s of every pack reads u = row s
//                 of packs 0-1 and d = row s of packs 2-3 (JAX :74-78)
//   1 +unpack     SOFT8 word mode: stage s of pack p unpacks word s / 2 of
//                 block p, fields MSB first (the JAX probe's _make_ud_soft8,
//                 K1's IntReader<8>)
//   2 +dump       the survivor store: pp, unmasked, after every pack, into
//                 the (n_packs, 64, arrays) device store laid out as K1's
//   3 +traceback  the chase from state 0 down the store, next state =
//                 (pack >> 26) & 63: output row kp - 1 gets the pack of kp
//                 for kp = n_packs - 2 .. 1, and row n_packs - 2, which the
//                 JAX kernel never writes, gets 0
//   4 +tb(bisect) the same chase, each pack chosen by a select tree (JAX
//                 :102-108): the thread loads all 64 words of its column of
//                 pack kp, addresses that do not depend on the state, then
//                 halves them 6 times on the state's bits 5 .. 0.  Its
//                 output equals +traceback's.
// Output: (programs, 1, 128) = (pm + pp)[0] per program, or (programs,
// n_packs - 1, 128) with +traceback.  The stage is K1's acs_stage (acs.cuh),
// wrapping.  The plain PyTorch version is ablation_torch in
// tpu_viterbi_torch/scripts/kernel_ablation.py; each variant agrees with it
// bit for bit, the store too.
//
// What bounds it: the ACS' issue, as K1's (256 operations an array-stage);
// the dump writes 256 bytes an array a pack, 134 MB at the JAX shape: 0.04
// ms at the memory rate against the ACS' 0.13 ms of issue.  What the
// design does about it: it is K1's, piece for piece: one thread per array,
// 64 CUDA threads a block, a loop of two stages whose next input loads
// while it runs (K1's reader runs a word ahead), the store's 32
// neighbouring arrays a warp written as one coalesced row.  The bisect
// trades +traceback's one load a pack, whose address waits for the last
// one, for 64 loads a pack that can all be in flight, and 63 selects.

#include <cuda_runtime.h>

#include <cstdint>

#include "acs.cuh"

namespace viterbi_ablation {

using viterbi::Bm;
using viterbi::kStates;

constexpr int kCols = 128;   // arrays of a program
constexpr int kWpp = 16;     // SOFT8 words of a 32-stage pack
constexpr int kThreads = 64; // K1's CUDA block

// The body's branch metrics of stage s: u = row s of packs 0-1, d = row s
// of packs 2-3, raw.
__device__ __forceinline__ Bm raw_bm(const int* w, int s) {
  Bm m;
  m.u = __ldg(w + s * kCols);
  m.d = __ldg(w + (32 + s) * kCols);
  m.nu = viterbi::neg<true>(m.u);
  m.nd = viterbi::neg<true>(m.d);
  return m;
}

// One level of the bisect's select tree: x[0 .. H) = the upper or lower
// half of x[0 .. 2H) by the state's bit log2(H).  H is a template argument
// so that every index is a constant and x stays in registers.
template <int H>
__device__ __forceinline__ void halve(uint32_t (&x)[kStates], int state) {
  const bool hi = (state / H) & 1;
#pragma unroll
  for (int j = 0; j < H; ++j) x[j] = hi ? x[H + j] : x[j];
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ablation_kernel(const int* __restrict__ words, uint32_t* __restrict__ surv,
                int* __restrict__ out, int programs, int n_packs) {
  constexpr bool kUnpack = V >= 1, kDump = V >= 2, kTrace = V >= 3;
  constexpr bool kBisect = V == 4;
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
  // the next two stages' input loads while the ACS runs, as K1's reader
  // runs a word ahead: the next word (+unpack) or the next rows (body)
  const int n_words = n_packs * kWpp;
  int next = 0;
  uint32_t wd = static_cast<uint32_t>(__ldg(w));
  Bm r0 = raw_bm(w, 0), r1 = raw_bm(w, 1);
  for (int p = 0; p < n_packs; ++p) {
#pragma unroll 1
    for (int t = 0; t < 32; t += 2) {
      Bm m0, m1;
      if constexpr (kUnpack) {
        viterbi::int_bm(static_cast<int>(wd) >> 24,
                        static_cast<int>(wd << 8) >> 24, m0);
        viterbi::int_bm(static_cast<int>(wd << 16) >> 24,
                        static_cast<int>(wd << 24) >> 24, m1);
        ++next;
        wd = next < n_words ? static_cast<uint32_t>(__ldg(w + next * kCols))
                            : 0u;
      } else {
        m0 = r0;
        m1 = r1;
        r0 = raw_bm(w, (t + 2) % 32);
        r1 = raw_bm(w, (t + 3) % 32);
      }
      viterbi::acs_stage<true>(pm_a, pp_a, pm_b, pp_b, m0);
      viterbi::acs_stage<true>(pm_b, pp_b, pm_a, pp_a, m1);
    }
    if constexpr (kDump) {
      uint32_t* dst = surv + static_cast<size_t>(p) * kStates * arrays + i;
#pragma unroll
      for (int s = 0; s < kStates; ++s)
        dst[static_cast<size_t>(s) * arrays] = pp_a[s];
    }
  }
  if constexpr (kTrace) {
    const int n_emit = n_packs - 1;
    int* o = out + static_cast<size_t>(g) * n_emit * kCols + l;
    int state = 0;
    for (int k = 0; k < n_emit; ++k) {
      const int kp = n_packs - 1 - k;
      uint32_t pack;
      if constexpr (kBisect) {
        const uint32_t* col = surv + static_cast<size_t>(kp) * kStates * arrays
                              + i;
        uint32_t x[kStates];
#pragma unroll
        for (int s = 0; s < kStates; ++s)
          x[s] = col[static_cast<size_t>(s) * arrays];
        halve<32>(x, state);
        halve<16>(x, state);
        halve<8>(x, state);
        halve<4>(x, state);
        halve<2>(x, state);
        halve<1>(x, state);
        pack = x[0];
      } else {
        pack = surv[(static_cast<size_t>(kp) * kStates + state) * arrays + i];
      }
      if (k >= 1) o[(kp - 1) * kCols] = static_cast<int>(pack);
      state = static_cast<int>((pack >> 26) & 63u);
    }
    o[(n_emit - 1) * kCols] = 0;
  } else {
    out[static_cast<size_t>(g) * kCols + l] =
        static_cast<int>(static_cast<uint32_t>(pm_a[0]) + pp_a[0]);
  }
}

template <int V>
cudaError_t launch(const int* words, uint32_t* surv, int* out, int programs,
                   int n_packs, cudaStream_t stream) {
  const int arrays = programs * kCols;
  ablation_kernel<V><<<(arrays + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(words, surv, out, programs, n_packs);
  return cudaGetLastError();
}

}  // namespace viterbi_ablation

using namespace viterbi_ablation;

// Launch variant `variant` (0 body, 1 +unpack, 2 +dump, 3 +traceback, 4
// +tb(bisect)) over
// `programs` programs of n_packs (>= 4) packs: words holds programs x
// n_packs x 16 x 128 int32, surv n_packs x 64 x programs x 128 uint32 (used
// only by variants 2-4), out programs x (1 or n_packs - 1) x 128 int32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k13_launch(int variant, const void* words, void* surv,
                                  void* out, int programs, int n_packs,
                                  void* stream) {
  const int* w = static_cast<const int*>(words);
  uint32_t* sv = static_cast<uint32_t*>(surv);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (programs <= 0 || n_packs < 4 || words == nullptr || out == nullptr ||
      (variant >= 2 && surv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(w, sv, o, programs, n_packs, s));
    case 1: return static_cast<int>(launch<1>(w, sv, o, programs, n_packs, s));
    case 2: return static_cast<int>(launch<2>(w, sv, o, programs, n_packs, s));
    case 3: return static_cast<int>(launch<3>(w, sv, o, programs, n_packs, s));
    case 4: return static_cast<int>(launch<4>(w, sv, o, programs, n_packs, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
