// Kernel K18: the int16x2 SWAR ACS probe, two states' path metrics in one
// 32-bit word against the int32 stage.  Replaces the TPU probe kernels of
// scripts/swar_probe.py: _baseline_kernel (:74) and _swar_kernel (:109),
// launched by time_kernel at :168.
//
// Program g reads its block of x, rows g x rows_in .. of a (programs x
// rows_in, 128) int32 array; column c of it is one array, a thread each.
// bm[q] (q = 0..31) is a row of the block, the same every stage.  out[g]
// (64, 128) int32, wrapping:
//   0 baseline      pm = rows 0-63, pp = 64-127, bm = 128-159.  A stage:
//                   lo = pm[q], hi = pm[q + 32], e = max(lo + bm, hi - bm)
//                   and o = max(lo - bm, hi + bm) with strict decisions de,
//                   do; pp[q] = de ? 2 pp[q + 32] + 1 : 2 pp[q] and pp[q +
//                   32] likewise with do; pm = e | o.  out = pm + pp
//   1 swar/stage    pmw = rows 0-31, words (lo | hi << 16); pp = 32-95, bm
//                   = 96-127.  ce = pmw +16x2 (bm | -bm << 16), co = pmw
//                   +16x2 (-bm | bm << 16); e, o = the larger half of each
//                   (strict hi > lo); pp as baseline; then the children
//                   repacked: pmw[2k] = e[k] | e[16 + k] << 16, pmw[2k + 1]
//                   = o[k] | o[16 + k] << 16.  out row q and q + 32 = pmw[q]
//                   + pp[q], pmw[q] + pp[q + 32]
//   2 swar/4stages  as 1, but the first three stages of every four keep
//                   pmw[q] = e[q] | o[q] << 16; the fourth repacks
// The Hopper form of the packed stage: the JAX mask-fix add is __vadd2; X =
// __byte_perm(ce, co) of the low halves (c0e, c0o) and Y of the high halves
// (c1e, c1o); __vibmax_s16x2(X, Y) gives (e, o) in one word and the
// predicates X >= Y per half, whose negations are JAX's strict decisions;
// the repack is two __byte_perm a word pair.  The plain PyTorch version is
// swar_torch in tpu_viterbi_torch/scripts/swar_probe.py; each variant agrees
// with it bit for bit.
//
// What bounds it: the stage's issue at one thread an array, at few warps a
// scheduler its dependency latency; memory is a load of the block and a
// store of the output.  At one lane an array (lanes = 1) every value lives
// in registers (baseline 64 pm + 64 pp + 32 bm, swar 32 pm words + 64 pp +
// 64 packed bm words), and each predecessor pair q updates its own slots q
// and q + 32 in place, so a stage needs no second buffer.  The probe reads
// the registers and spills from -res-usage.  At the JAX shape's 2,048
// arrays that is 32 CTAs of 64 threads on 132 SMs, each warp's time its
// stage chain's latency.
//
// What the design does about it: each array is split over `lanes` L of a
// warp (2-32; the wrapper picks L from the array count), S = 32 / L
// predecessor pairs (baseline) or pm words (swar) a lane: pair or word q
// in lane q mod L, slot q div L, with pp[q], pp[q + 32] and bm[q] in the
// same slot, a loop of four stages.  The baseline's pairs never meet, so
// it needs no exchange.  In the swar variants only the repack moves data:
// new word w = 2k + b (lane w mod L, slot r = w div L) takes half b of
// m[k] and of m[k + 16], which lie in slot r >> 1 of lane (lane >> 1) +
// (r & 1) L / 2 and in slot (r >> 1) + 16 / L of the same lane (L = 32:
// slot 0 of lanes (lane >> 1) and (lane >> 1) + 16).  The slots are
// compile-time constants, so a repack is two __shfl_sync a word and one
// __byte_perm whose selector (0x5410 or 0x7632 by b = lane & 1) is fixed
// for the lane: no register is indexed at run time.

#include <cuda_runtime.h>

#include <cstdint>

#include "build_part.cuh"
#include "lanes.cuh"

// Build parts (build_part.cuh): part 0 holds the entry point, the one-lane
// kernels and the baseline's lane-split ones, part 1 the swar variants'
// lane-split kernels.
// nvcc parts: 2

namespace viterbi_swar {

constexpr int kCols = 128;
constexpr int kThreads = 64;
constexpr int kLaneThreads = 128;  // the lane-split kernels' CUDA block
constexpr int kLoopStages = 4;     // stages of a lane-split loop pass
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t wadd(uint32_t a, uint32_t b) {
  return a + b;
}

// One predecessor pair's stage (the baseline's), in place.
__device__ __forceinline__ void pair_stage(uint32_t& lo, uint32_t& hi,
                                           uint32_t& pl, uint32_t& ph,
                                           uint32_t bm) {
  const int c0e = static_cast<int>(lo + bm);
  const int c1e = static_cast<int>(hi - bm);
  const int c0o = static_cast<int>(lo - bm);
  const int c1o = static_cast<int>(hi + bm);
  const bool de = c1e > c0e, dod = c1o > c0o;
  const uint32_t fl = pl << 1, fh = (ph << 1) | 1u;
  lo = static_cast<uint32_t>(de ? c1e : c0e);
  hi = static_cast<uint32_t>(dod ? c1o : c0o);
  pl = de ? fh : fl;
  ph = dod ? fh : fl;
}

// One word's packed stage: returns its children (e | o << 16) and updates
// its survivors in place.
__device__ __forceinline__ uint32_t word_stage(uint32_t pmw, uint32_t bme,
                                               uint32_t bmo, uint32_t& pl,
                                               uint32_t& ph) {
  const uint32_t ce = __vadd2(pmw, bme);
  const uint32_t co = __vadd2(pmw, bmo);
  bool ge_o, ge_e;  // c0o >= c1o (high half), c0e >= c1e (low)
  const uint32_t m = __vibmax_s16x2(__byte_perm(ce, co, 0x5410),
                                    __byte_perm(ce, co, 0x7632), &ge_o,
                                    &ge_e);
  const uint32_t fl = pl << 1, fh = (ph << 1) | 1u;
  pl = ge_e ? fl : fh;
  ph = ge_o ? fl : fh;
  return m;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
swar_kernel(const int* __restrict__ x, int* __restrict__ out, int stages,
            int programs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t / kCols, c = t % kCols;
  if (g >= programs) return;
  int* o = out + static_cast<size_t>(g) * 64 * kCols + c;
  if constexpr (V == 0) {
    const int* b = x + static_cast<size_t>(g) * 160 * kCols + c;
    uint32_t pm[64], pp[64], bm[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      pm[i] = static_cast<uint32_t>(b[i * kCols]);
      pp[i] = static_cast<uint32_t>(b[(64 + i) * kCols]);
    }
#pragma unroll
    for (int q = 0; q < 32; ++q)
      bm[q] = static_cast<uint32_t>(b[(128 + q) * kCols]);
#pragma unroll 1
    for (int s = 0; s < stages; ++s) {
#pragma unroll
      for (int q = 0; q < 32; ++q)
        pair_stage(pm[q], pm[q + 32], pp[q], pp[q + 32], bm[q]);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i)
      o[i * kCols] = static_cast<int>(wadd(pm[i], pp[i]));
  } else {
    constexpr int kRepack = V == 1 ? 1 : 4;
    const int* b = x + static_cast<size_t>(g) * 128 * kCols + c;
    uint32_t pmw[32], pp[64], bme[32], bmo[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      pmw[q] = static_cast<uint32_t>(b[q * kCols]);
      const uint32_t m = static_cast<uint32_t>(b[(96 + q) * kCols]);
      const uint32_t nm = 0u - m;
      bme[q] = __byte_perm(m, nm, 0x5410);  // (bm, -bm)
      bmo[q] = __byte_perm(nm, m, 0x5410);  // (-bm, bm)
    }
#pragma unroll
    for (int i = 0; i < 64; ++i)
      pp[i] = static_cast<uint32_t>(b[(32 + i) * kCols]);
#pragma unroll 1
    for (int s = 0; s < stages / kRepack; ++s) {
#pragma unroll
      for (int r = 0; r < kRepack; ++r) {
        uint32_t m[32];
#pragma unroll
        for (int q = 0; q < 32; ++q)
          m[q] = word_stage(pmw[q], bme[q], bmo[q], pp[q], pp[q + 32]);
        if (r == kRepack - 1) {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            pmw[2 * k] = __byte_perm(m[k], m[16 + k], 0x5410);
            pmw[2 * k + 1] = __byte_perm(m[k], m[16 + k], 0x7632);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 32; ++q) pmw[q] = m[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      o[q * kCols] = static_cast<int>(wadd(pmw[q], pp[q]));
      o[(q + 32) * kCols] = static_cast<int>(wadd(pmw[q], pp[q + 32]));
    }
  }
}

template <int V>
cudaError_t launch(const int* x, int* out, int stages, int programs,
                   cudaStream_t stream) {
  const int threads = programs * kCols;
  swar_kernel<V><<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                   stream>>>(x, out, stages, programs);
  return cudaGetLastError();
}

// --- split over lanes (lanes >= 2) ---

template <int V, int L>
__global__ void __launch_bounds__(kLaneThreads)
swar_lanes_kernel(const int* __restrict__ x, int* __restrict__ out,
                  int stages) {
  constexpr int S = 32 / L;  // pairs or words a lane
  const int i = blockIdx.x * kLaneThreads + threadIdx.x;
  const int a = i / L, lane = i % L;
  const int g = a / kCols, c = a % kCols;
  int* o = out + static_cast<size_t>(g) * 64 * kCols + c;
  if constexpr (V == 0) {
    const int* b = x + static_cast<size_t>(g) * 160 * kCols + c;
    uint32_t lo[S], hi[S], pl[S], ph[S], bm[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int q = k * L + lane;
      lo[k] = static_cast<uint32_t>(b[q * kCols]);
      hi[k] = static_cast<uint32_t>(b[(32 + q) * kCols]);
      pl[k] = static_cast<uint32_t>(b[(64 + q) * kCols]);
      ph[k] = static_cast<uint32_t>(b[(96 + q) * kCols]);
      bm[k] = static_cast<uint32_t>(b[(128 + q) * kCols]);
    }
#pragma unroll 1
    for (int t = 0; t < stages; t += kLoopStages) {
#pragma unroll
      for (int j = 0; j < kLoopStages; ++j) {
#pragma unroll
        for (int k = 0; k < S; ++k)
          pair_stage(lo[k], hi[k], pl[k], ph[k], bm[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int q = k * L + lane;
      o[q * kCols] = static_cast<int>(lo[k] + pl[k]);
      o[(q + 32) * kCols] = static_cast<int>(hi[k] + ph[k]);
    }
  } else {
    constexpr int kRepack = V == 1 ? 1 : 4;
    const int* b = x + static_cast<size_t>(g) * 128 * kCols + c;
    uint32_t pmw[S], pl[S], ph[S], bme[S], bmo[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int q = k * L + lane;
      pmw[k] = static_cast<uint32_t>(b[q * kCols]);
      const uint32_t m = static_cast<uint32_t>(b[(96 + q) * kCols]);
      const uint32_t nm = 0u - m;
      bme[k] = __byte_perm(m, nm, 0x5410);  // (bm, -bm)
      bmo[k] = __byte_perm(nm, m, 0x5410);  // (-bm, bm)
      pl[k] = static_cast<uint32_t>(b[(32 + q) * kCols]);
      ph[k] = static_cast<uint32_t>(b[(64 + q) * kCols]);
    }
    const uint32_t half = (lane & 1) ? 0x7632u : 0x5410u;  // b = lane & 1
#pragma unroll 1
    for (int t = 0; t < stages; t += kLoopStages) {
#pragma unroll
      for (int j = 0; j < kLoopStages; ++j) {
        uint32_t m[S];
#pragma unroll
        for (int k = 0; k < S; ++k)
          m[k] = word_stage(pmw[k], bme[k], bmo[k], pl[k], ph[k]);
        if (j % kRepack == kRepack - 1) {
#pragma unroll
          for (int r = 0; r < S; ++r) {
            const int src = (lane >> 1) + (r & 1) * (L / 2);
            uint32_t wk, wk16;  // words k and k + 16
            if constexpr (L == 32) {
              wk = __shfl_sync(kFull, m[0], src, L);
              wk16 = __shfl_sync(kFull, m[0], src + 16, L);
            } else {
              wk = __shfl_sync(kFull, m[r >> 1], src, L);
              wk16 = __shfl_sync(kFull, m[(r >> 1) + 16 / L], src, L);
            }
            pmw[r] = __byte_perm(wk, wk16, half);
          }
        } else {
#pragma unroll
          for (int k = 0; k < S; ++k) pmw[k] = m[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int q = k * L + lane;
      o[q * kCols] = static_cast<int>(pmw[k] + pl[k]);
      o[(q + 32) * kCols] = static_cast<int>(pmw[k] + ph[k]);
    }
  }
}

template <int V, int L>
cudaError_t launch_split_at(const int* x, int* out, int stages, int programs,
                            cudaStream_t s) {
  static_assert(kCols % kLaneThreads == 0, "whole CUDA blocks");
  swar_lanes_kernel<V, L>
      <<<programs * (kCols / kLaneThreads) * L, kLaneThreads, 0, s>>>(
          x, out, stages);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_split(int lanes, const int* x, int* out, int stages,
                         int programs, cudaStream_t s) {
  return viterbi::dispatch_lanes<2>(lanes, [&](auto l) {
    return launch_split_at<V, decltype(l)::value>(x, out, stages, programs,
                                                  s);
  });
}

cudaError_t launch_split_swar(int, int, const int*, int*, int, int,
                              cudaStream_t);

#if IN_PART(1)
cudaError_t launch_split_swar(int variant, int lanes, const int* x, int* out,
                              int stages, int programs, cudaStream_t s) {
  return variant == 1 ? launch_split<1>(lanes, x, out, stages, programs, s)
                      : launch_split<2>(lanes, x, out, stages, programs, s);
}
#endif

}  // namespace viterbi_swar

using namespace viterbi_swar;

#if IN_PART(0)
// Launch variant `variant` (0 baseline, 1 swar/stage, 2 swar/4stages) split
// over `lanes` (1, 2, 4, 8, 16 or 32) lanes an array for `stages` stages
// (a multiple of 4) on x, (programs x rows_in, 128) int32 with rows_in 160
// for baseline and 128 for the swar variants, into out, (programs, 64, 128)
// int32.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k18_launch(int variant, int lanes, const void* x,
                                  void* out, int stages, int programs,
                                  void* stream) {
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages < 0 || stages % 4 != 0 || programs <= 0 || x == nullptr ||
      out == nullptr || variant < 0 || variant > 2 || lanes < 1 ||
      static_cast<long long>(programs) * kCols * lanes > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes > 1)
    return static_cast<int>(
        variant == 0 ? launch_split<0>(lanes, xi, o, stages, programs, s)
                     : launch_split_swar(variant, lanes, xi, o, stages,
                                         programs, s));
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(xi, o, stages, programs, s));
    case 1: return static_cast<int>(launch<1>(xi, o, stages, programs, s));
    case 2: return static_cast<int>(launch<2>(xi, o, stages, programs, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif  // IN_PART(0)
