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
// Output: (programs, 128) = (pm + pp)[0] of every program, wrapping: the
// natural-order int32 ACS of acs.cuh's acs_stage (the noup variants feed
// raw full-range words as u and d, so int16x2 metrics cannot compute it).
// The plain PyTorch version is soft16_ablation_torch in
// tpu_viterbi_torch/scripts/soft16_ablation.py, with which every variant
// agrees bit for bit at every lane count.
//
// What bounds it: the ACS' issue, 256 operations an array-stage (260 with
// the unpack); the words are 4 (SOFT8) or 8 (SOFT16) bytes an array-stage,
// 67 MB for SOFT16 at the JAX shape, 0.02 ms at the memory rate against
// 0.13 ms of issue.  At the JAX shape's 2,048 arrays one thread an array
// (K13's layout, lanes = 1) runs 32 CTAs of 64 threads on 132 SMs: a
// warp's pace is the latency of its ACS chain, whatever the card's issue.
//
// What the design does about it: each array is split over `lanes` L of a
// warp (1, 2, 4, 8, 16 or 32; the wrapper picks L from the array count so
// that the card holds several warps a scheduler), in place, as lanes.cuh
// lays it out (its rol6, bm_bits, lane_stage and the SOFT8 unpack are
// shared with K13 and K19).  A pass's words load a pass ahead, each into
// the register its stage has just read (no moves); every lane of an array
// loads the same word (one broadcast request).  The words noup does not
// use are read with ld.volatile, which ptxas may not drop, spread over the
// array's lanes, so the traffic is real (the probe prints the loop's LDG
// count); on the TPU the block's DMA read them all.  L = 1 is K13's loop
// of two stages with acs_stage, the pass's words a pass ahead.

#include <cuda_runtime.h>

#include <cstdint>

#include "acs.cuh"
#include "lanes.cuh"

namespace viterbi_soft16_ablation {

using viterbi::Bm;
using viterbi::kPass;
using viterbi::kStates;
using viterbi::lane_stage;
using viterbi::soft8_bm;

constexpr int kCols = 128;        // arrays of a program
constexpr int kThreads = 64;      // K1's CUDA block (lanes = 1)
constexpr int kLaneThreads = 128; // the lane-split kernels' CUDA block

// A word of the block that is read and not used.
__device__ __forceinline__ void touch(const int* p) {
  int v;
  asm volatile("ld.volatile.global.b32 %0, [%1];" : "=r"(v) : "l"(p));
}

// The same where `on`, as a predicated load: no branch splits the warp.
__device__ __forceinline__ void touch_if(bool on, const int* p) {
  int v;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %1, 0;\n"
      " @q ld.volatile.global.b32 %0, [%2];\n}"
      : "=r"(v)
      : "r"(static_cast<unsigned>(on)), "l"(p));
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

// --- the lane-split layout (lanes >= 2, lanes.cuh) ---

// One array's lane: its S = 64 / L positions, double-buffered, and the
// words of the next pass of the stage loop.
template <int V, int L>
struct LaneArray {
  static constexpr int S = kStates / L;
  static constexpr int kWpp = V % 2 ? 32 : 16;
  static constexpr bool kUnpack = V >= 2;
  // words a pass reads: SOFT16's one a stage, SOFT8's one a stage pair
  static constexpr int kPassWords = kWpp == 32 ? kPass : kPass / 2;

  const int* w;
  int n_packs, n_words, lane;
  uint32_t flips;
  int pm_a[S], pm_b[S];
  uint32_t pp_a[S], pp_b[S];
  int pw[kPassWords];       // unpack: the pass's words
  int ru[kPass], rd[kPass]; // noup: each stage's raw u and d

  __device__ __forceinline__ LaneArray(const int* col, int packs, int ln)
      : w(col), n_packs(packs), n_words(packs * kWpp), lane(ln), flips(0u) {
    // lanes.cuh's add_lane_flips written out: through the helper (or any
    // function that returns the flips) ptxas gives the stage loop other
    // registers and other SASS counts at 4, 8 and 32 lanes
#pragma unroll
    for (int f = 0; f < kPass; ++f) {
      const int b = viterbi::bm_bits(lane * S, f);
      flips |= static_cast<uint32_t>(b & 1) << f;
      flips |= static_cast<uint32_t>(b >> 1) << (6 + f);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      pm_a[s] = 0;
      pp_a[s] = 0u;
    }
#pragma unroll
    for (int k = 0; k < kPassWords; ++k) pw[k] = kUnpack ? load(k) : 0;
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      ru[j] = kUnpack ? 0 : raw(j, 0);
      rd[j] = kUnpack ? 0 : raw(j, 1);
    }
  }

  __device__ __forceinline__ int load(int idx) const {
    return idx < n_words ? __ldg(w + idx * kCols) : 0;
  }
  // noup: row 0 (u) or 1 (d) of stage t's pack
  __device__ __forceinline__ int raw(int t, int row) const {
    const int p = t >> 5;
    return p < n_packs ? __ldg(w + (p * kWpp + row) * kCols) : 0;
  }

  // Stage t0 + J, phase J (t0 % 6 == 0); AHEAD: then load the next pass's
  // word or raw u and d into the register this stage has read.
  template <int J, bool AHEAD>
  __device__ __forceinline__ void stage(int t0) {
    Bm m;
    if constexpr (!kUnpack) {
      m.u = ru[J];
      m.d = rd[J];
      m.nu = viterbi::neg<true>(m.u);
      m.nd = viterbi::neg<true>(m.d);
      if constexpr (AHEAD) {
        if ((t0 + J) >> 5 != (t0 + kPass + J) >> 5) {
          ru[J] = raw(t0 + kPass + J, 0);
          rd[J] = raw(t0 + kPass + J, 1);
        }
      }
    } else if constexpr (kWpp == 32) {
      const uint32_t x = static_cast<uint32_t>(pw[J]);
      viterbi::int_bm(static_cast<int>(x) >> 16,
                      static_cast<int>(x << 16) >> 16, m);
      if constexpr (AHEAD) pw[J] = load(t0 + kPass + J);
    } else {
      m = soft8_bm<J>(pw[J / 2]);
      if constexpr (AHEAD && J % 2 == 1)
        pw[J / 2] = load((t0 + kPass) / 2 + J / 2);
    }
    if constexpr (J % 2 == 0)
      lane_stage<L, J>(pm_a, pp_a, pm_b, pp_b, m, flips, lane);
    else
      lane_stage<L, J>(pm_b, pp_b, pm_a, pp_a, m, flips, lane);
  }

  template <int J, int N, bool AHEAD>
  __device__ __forceinline__ void stages(int t0) {
    if constexpr (J < N) {
      stage<J, AHEAD>(t0);
      stages<J + 1, N, AHEAD>(t0);
    }
  }

  // Stages t0 .. t0 + N - 1 (N even, so the result is back in pm_a, pp_a);
  // noup first reads the words the unpack would, one lane each.
  template <int N, bool AHEAD>
  __device__ __forceinline__ void pass(int t0) {
    if constexpr (!kUnpack) {
#pragma unroll
      for (int k = 0; k < (kWpp == 32 ? N : N / 2); ++k) {
        const int idx = (kWpp == 32 ? t0 : t0 / 2) + k;
        touch_if(k % L == lane && idx < n_words, w + idx * kCols);
      }
    }
    stages<0, N, AHEAD>(t0);
  }
};

template <int V, int L>
__global__ void __launch_bounds__(kLaneThreads)
soft16_lanes_kernel(const int* __restrict__ words, int* __restrict__ out,
                    int programs, int n_packs) {
  constexpr int kWpp = V % 2 ? 32 : 16;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = i / L, lane = i % L;
  const int g = a / kCols, l = a % kCols;
  LaneArray<V, L> arr(
      words + static_cast<size_t>(g) * n_packs * kWpp * kCols + l, n_packs,
      lane);
  const int stages = n_packs * 32;
  int t0 = 0;
#pragma unroll 1
  for (; t0 + kPass <= stages; t0 += kPass) arr.template pass<kPass, true>(t0);
  // 32 n_packs % 6 is 0, 2 or 4
  if (stages - t0 == 4)
    arr.template pass<4, false>(t0);
  else if (stages - t0 == 2)
    arr.template pass<2, false>(t0);
  if (lane == 0)
    out[a] = static_cast<int>(static_cast<uint32_t>(arr.pm_a[0]) +
                              arr.pp_a[0]);
}

template <int V, int L>
cudaError_t launch(const int* words, int* out, int programs, int n_packs,
                   cudaStream_t stream) {
  const int arrays = programs * kCols;
  if constexpr (L == 1) {
    soft16_ablation_kernel<V><<<(arrays + kThreads - 1) / kThreads, kThreads,
                                0, stream>>>(words, out, programs, n_packs);
  } else {
    // arrays * L threads: a whole number of blocks (kCols * L % 128 == 0)
    static_assert(kCols * L % kLaneThreads == 0, "whole CUDA blocks");
    soft16_lanes_kernel<V, L><<<arrays / kLaneThreads * L, kLaneThreads, 0,
                                stream>>>(words, out, programs, n_packs);
  }
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_variant(int variant, const int* w, int* o, int programs,
                           int n_packs, cudaStream_t s) {
  switch (variant) {
    case 0: return launch<0, L>(w, o, programs, n_packs, s);
    case 1: return launch<1, L>(w, o, programs, n_packs, s);
    case 2: return launch<2, L>(w, o, programs, n_packs, s);
    case 3: return launch<3, L>(w, o, programs, n_packs, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace viterbi_soft16_ablation

using namespace viterbi_soft16_ablation;

// Launch variant `variant` (0 s8/noup, 1 s16/noup, 2 s8/unpack, 3
// s16/unpack) split over `lanes` (1, 2, 4, 8, 16 or 32) lanes an array,
// over `programs` programs of n_packs (>= 1) packs: words holds programs x
// n_packs x wpp x 128 int32 (wpp 16 for variants 0 and 2, 32 for 1 and 3),
// out programs x 128 int32.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int viterbi_k25_launch(int variant, int lanes, const void* words,
                                  void* out, int programs, int n_packs,
                                  void* stream) {
  const int* w = static_cast<const int*>(words);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (programs <= 0 || n_packs < 1 || words == nullptr || out == nullptr ||
      variant < 0 || variant > 3 ||
      static_cast<long long>(programs) * kCols * lanes > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(viterbi::dispatch_lanes(lanes, [&](auto l) {
    return launch_variant<decltype(l)::value>(variant, w, o, programs,
                                              n_packs, s);
  }));
}
