// Kernel K16: the ACS construct microbenchmark, one construct changed a
// variant.  Replaces the TPU probe kernel of scripts/kernel_microbench.py:
// make_kernel (:39), launched by run_variant at :85.
//
// Input rs: (n_packs, 32, 2, width) int32; column c is one array, stage t =
// 32 p + s reads bm = rs[p, s, 0, c] + rs[p, s, 1, c], the same for all 64
// states.  pm and pp start at zero; out (64, width) = pm + pp after n_packs
// x 32 stages, wrapping.  The JAX variants (row i of the new pm reads the
// predecessors lo = pm[src(i)], hi = pm[src(i) + 32]):
//   0 no_acs        pm[i] += bm, pp[i] += 1
//   1 concat        src(i) = i mod 32 (the rows [x; x]); c0 = lo + bm, c1 =
//                   hi - bm, dec = c1 > c0, pm = the larger, pp[i] =
//                   (pp[dec ? src + 32 : src] << 1) | dec
//   2 no_pp         pm as bcast; pp[i] += 1
//   3 bcast         src(i) = i / 2 (rows 2i, 2i+1 = x[i]); as concat
//   4 pltpu_repeat  pltpu.repeat(x, 2, 0) is [x; x]: concat's code
// The TPU kernel's relayouts are register renaming here: the variants
// differ only in which registers a child reads.  Every state starts at
// zero and sees the stage's one bm, so all 64 stay equal; ptxas proves it
// for bcast and no_pp (one state a stage) but not for concat and
// pltpu_repeat, whose 32 distinct child expressions it computes.  The
// plain PyTorch version is microbench_torch in
// tpu_viterbi_torch/scripts/kernel_microbench.py; each variant agrees with
// it bit for bit.
//
// What bounds it: the function needs one state's ACS a stage, so reading
// the input; the code issues what ptxas keeps of 64 states' ACS, at one
// thread an array, and at few warps a scheduler its dependency latency.
// At one lane an array the design is K14's shape (64 threads a block,
// metrics and survivors in registers, a loop of two stages whose next input
// loads while it runs), so that the variants differ in the construct alone.
//
// What the design does about it: each array is split over `lanes` L of a warp
// (2-32; the wrapper picks L from the array count), each variant keeping its
// construct, all 64 states' update a stage as the variant defines it, S = 64
// / L of them a lane, in a loop of six-stage passes whose input loads a pass
// ahead (lanes.cuh's PairPass).  no_acs, concat and pltpu_repeat take the
// fixed-partner layout: pair q = k L + lane holds rows q and q + 32 in its
// lane, in natural order, so concat's children, whose predecessors are always
// rows i mod 32 and i mod 32 + 32, never leave the lane and no stage
// shuffles.  bcast and no_pp run the trellis' src = i / 2 wiring, so they
// take lanes.cuh's in-place layout (lane_probe_stage, SAME: the position
// holding hi adds -bm to itself, +bm to its partner; the tie rule turns with
// the position's x bit, and no_pp's survivors count in place); after T stages
// row rol6(P, T % 6) gets position P's sum.  Blocks of 64 threads hold 64 / L
// arrays.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "build_part.cuh"
#include "lanes.cuh"

// Build parts (build_part.cuh): part 0 holds no_acs, no_pp and the entry
// point, part 1 concat and pltpu_repeat, part 2 bcast, each variant at
// every lane count.
// nvcc parts: 3

namespace viterbi_microbench {

using viterbi::kStates;
constexpr int kBpp = 32;
constexpr int kThreads = 64;

using viterbi::add;
using viterbi::sub;

template <int V>
__device__ __forceinline__ void stage(const int (&pm)[kStates],
                                      const uint32_t (&pp)[kStates],
                                      int (&pmo)[kStates],
                                      uint32_t (&ppo)[kStates], int bm) {
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    if constexpr (V == 0) {
      pmo[i] = add<true>(pm[i], bm);
      ppo[i] = pp[i] + 1u;
    } else {
      constexpr bool kConcat = V == 1 || V == 4;
      const int src = kConcat ? i % 32 : i / 2;
      const int c0 = add<true>(pm[src], bm), c1 = sub<true>(pm[src + 32], bm);
      const bool dec = c1 > c0;
      pmo[i] = dec ? c1 : c0;
      if constexpr (V == 2)
        ppo[i] = pp[i] + 1u;
      else
        ppo[i] = ((dec ? pp[src + 32] : pp[src]) << 1) | (dec ? 1u : 0u);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
microbench_kernel(const int* __restrict__ rs, int* __restrict__ out,
                  int n_packs, int width) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  const int* r = rs + c;  // stage t's pair at rows 2t, 2t + 1 of width
  const size_t w = static_cast<size_t>(width);
  const int stages = n_packs * kBpp;
  int pm_a[kStates], pm_b[kStates];
  uint32_t pp_a[kStates], pp_b[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    pm_a[i] = 0;
    pp_a[i] = 0u;
  }
  int x0 = __ldg(r), y0 = __ldg(r + w), x1 = __ldg(r + 2 * w),
      y1 = __ldg(r + 3 * w);
#pragma unroll 1
  for (int t = 0; t < stages; t += 2) {
    const int bm0 = add<true>(x0, y0), bm1 = add<true>(x1, y1);
    if (t + 2 < stages) {
      const int* rt = r + static_cast<size_t>(2 * (t + 2)) * w;
      x0 = __ldg(rt);
      y0 = __ldg(rt + w);
      x1 = __ldg(rt + 2 * w);
      y1 = __ldg(rt + 3 * w);
    }
    stage<V>(pm_a, pp_a, pm_b, pp_b, bm0);
    stage<V>(pm_b, pp_b, pm_a, pp_a, bm1);
  }
#pragma unroll
  for (int i = 0; i < kStates; ++i)
    out[i * w + c] = add<true>(pm_a[i], static_cast<int>(pp_a[i]));
}

// --- the lane-split layouts (lanes >= 2) ---

// The parent's stage over a lane's Q = 32 / L pairs of the fixed-partner
// layout: register i holds row (i mod Q) L + lane + 32 (i / Q), and its
// child reads registers i mod Q and i mod Q + Q, rows q and q + 32 of its
// pair (concat's i mod 32 and i mod 32 + 32).
template <int V, int Q>
__device__ __forceinline__ void fixed_stage(const int (&pm)[2 * Q],
                                            const uint32_t (&pp)[2 * Q],
                                            int (&pmo)[2 * Q],
                                            uint32_t (&ppo)[2 * Q], int bm) {
#pragma unroll
  for (int i = 0; i < 2 * Q; ++i) {
    if constexpr (V == 0) {
      pmo[i] = add<true>(pm[i], bm);
      ppo[i] = pp[i] + 1u;
    } else {
      const int src = i % Q;
      const int c0 = add<true>(pm[src], bm), c1 = sub<true>(pm[src + Q], bm);
      const bool dec = c1 > c0;
      pmo[i] = dec ? c1 : c0;
      ppo[i] = ((dec ? pp[src + Q] : pp[src]) << 1) | (dec ? 1u : 0u);
    }
  }
}

// One array's lane in the fixed-partner layout (no_acs, concat,
// pltpu_repeat): pair q = k L + lane, k < Q = 32 / L, in registers k (row
// q) and Q + k (row q + 32), double-buffered as lanes.cuh's ProbeLane.
template <int V, int L>
struct FixedLane {
  static constexpr int Q = 32 / L, S = 2 * Q;
  int lane;
  int pm_a[S], pm_b[S];
  uint32_t pp_a[S], pp_b[S];

  __device__ __forceinline__ explicit FixedLane(int ln) : lane(ln) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      pm_a[k] = 0;
      pp_a[k] = 0u;
    }
  }

  template <int J>
  __device__ __forceinline__ void stage(int bm) {
    if constexpr (J % 2 == 0)
      fixed_stage<V, Q>(pm_a, pp_a, pm_b, pp_b, bm);
    else
      fixed_stage<V, Q>(pm_b, pp_b, pm_a, pp_a, bm);
  }

  // Each register's pm + pp into its row of column c (natural order).
  __device__ __forceinline__ void store(int* out, size_t w, int c, int,
                                        bool live) const {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int v = add<true>(pm_a[k], static_cast<int>(pp_a[k]));
      if (live) out[((k % Q) * L + lane + 32 * (k / Q)) * w + c] = v;
    }
  }
};

// A variant's lane: bcast and no_pp on lanes.cuh's in-place layout, the
// others in the fixed-partner layout.
template <int V, int L>
using MicroLane = std::conditional_t<
    V == 2 || V == 3,
    viterbi::ProbeLane<L, true,
                       V == 2 ? viterbi::LanePp::kCount
                              : viterbi::LanePp::kExchange>,
    FixedLane<V, L>>;

template <int V, int L>
__global__ void __launch_bounds__(kThreads)
microbench_lanes_kernel(const int* __restrict__ rs, int* __restrict__ out,
                        int n_packs, int width) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int c = i / L, lane = i % L;
  // a ragged last block's spare arrays run on the last column, store
  // nothing, and keep their warps whole for the shuffles
  const bool live = c < width;
  const int stages = n_packs * kBpp;
  viterbi::PairPass in(rs + (live ? c : width - 1), width, stages);
  MicroLane<V, L> a(lane);
  viterbi::pair_stages(a, in);
  a.store(out, static_cast<size_t>(width), c, stages, live);
}

template <int V, int L>
cudaError_t launch(const int* rs, int* out, int n_packs, int width,
                   cudaStream_t stream) {
  if constexpr (L == 1) {
    microbench_kernel<V>
        <<<(width + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
            rs, out, n_packs, width);
  } else {
    microbench_lanes_kernel<V, L>
        <<<(width * L + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
            rs, out, n_packs, width);
  }
  return cudaGetLastError();
}

// Every kernel of variant V: one lane the parent's, 2-32 lanes the split.
template <int V>
cudaError_t launch_variant(int lanes, const int* rs, int* out, int n_packs,
                           int width, cudaStream_t s) {
  return viterbi::dispatch_lanes(lanes, [&](auto l) {
    return launch<V, decltype(l)::value>(rs, out, n_packs, width, s);
  });
}

// The variants of each build part.
cudaError_t launch_part0(int, int, const int*, int*, int, int, cudaStream_t);
cudaError_t launch_part1(int, int, const int*, int*, int, int, cudaStream_t);
cudaError_t launch_part2(int, int, const int*, int*, int, int, cudaStream_t);

#if IN_PART(0)
cudaError_t launch_part0(int v, int n, const int* rs, int* out, int n_packs,
                         int width, cudaStream_t s) {
  switch (v) {
    case 0: return launch_variant<0>(n, rs, out, n_packs, width, s);
    case 2: return launch_variant<2>(n, rs, out, n_packs, width, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif
#if IN_PART(1)
cudaError_t launch_part1(int v, int n, const int* rs, int* out, int n_packs,
                         int width, cudaStream_t s) {
  switch (v) {
    case 1: return launch_variant<1>(n, rs, out, n_packs, width, s);
    case 4: return launch_variant<4>(n, rs, out, n_packs, width, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif
#if IN_PART(2)
cudaError_t launch_part2(int v, int n, const int* rs, int* out, int n_packs,
                         int width, cudaStream_t s) {
  return v == 3 ? launch_variant<3>(n, rs, out, n_packs, width, s)
                : cudaErrorInvalidValue;
}
#endif

}  // namespace viterbi_microbench

using namespace viterbi_microbench;

#if IN_PART(0)
// Launch variant `variant` (0 no_acs, 1 concat, 2 no_pp, 3 bcast, 4
// pltpu_repeat) split over `lanes` (1, 2, 4, 8, 16 or 32) lanes an array on
// rs, (n_packs, 32, 2, width) int32, into out, (64, width) int32.  Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k16_launch(int variant, const void* rs, void* out,
                                  int n_packs, int width, int lanes,
                                  void* stream) {
  const int* r = static_cast<const int*>(rs);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_packs <= 0 || width <= 0 || rs == nullptr || out == nullptr ||
      static_cast<long long>(width) * lanes > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0:
    case 2: return static_cast<int>(launch_part0(variant, lanes, r, o,
                                                 n_packs, width, s));
    case 1:
    case 4: return static_cast<int>(launch_part1(variant, lanes, r, o,
                                                 n_packs, width, s));
    case 3: return static_cast<int>(launch_part2(variant, lanes, r, o,
                                                 n_packs, width, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif  // IN_PART(0)
