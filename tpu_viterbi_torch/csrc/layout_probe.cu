// Kernel K12: the layout probe, three ways to lay the 64-state ACS out on
// the card, timed on the same stage arithmetic.  Replaces the TPU probe
// kernels of scripts/layout_probe.py (launched by time_kernel at :216):
// _real_kernel (:109), _dual_kernel (:126) and _lanes_kernel (:174).
//
// A program is a (192, 128) int32 tile of x: rows 0-63 hold pm, 64-127 pp,
// 128-159 the u rows, 160-191 the d rows; each of its 128 columns is one
// 64-state array, and stage t reads row t % 32 of u and d.  After `stages`
// stages (a multiple of 32) out[program] = pm + pp, (64, 128) int32, all
// arithmetic wrapping in two's complement.
//   0 real   A: K1's layout, one thread per array, 64 path metrics and 64
//            survivor registers in registers; the stage is K1's acs_stage
//            (acs.cuh) with bm = (same sign ? u : d) * s0 and pm, pp taken
//            from the tile.  The TPU kernel's rotating layout is back in
//            natural state order after every multiple of 4 stages, so the
//            result is the natural-order ACS's.
//   1 dual   B: two independent arrays a thread, interleaved stage by stage:
//            program g of the dual grid is the tiles 2g (array A) and 2g+1
//            (array B) of the same x, and out[g] = pmA + ppA + pmB + ppB.
//   2 lanes  C: the reference's warp layout (SURVEY §2.3 P2): one warp an
//            array, states 2t and 2t+1 in lane t.  The JAX kernel's states
//            on lanes: in phase k = 1 << ((t % 32) % 6) state j meets its
//            partner j ^ k, a register swap for k = 1 and
//            __shfl_xor_sync(k >> 1) for k >= 2; bm is per state, c_self =
//            pm + bm, c_part = partner pm - bm, the partner wins if strictly
//            greater, and pp becomes 2 pp + (1 - h) or 2 partner pp + h,
//            h = bit 5 of the state.
// The plain PyTorch version is layout_torch in
// tpu_viterbi_torch/scripts/layout_probe.py; each variant agrees with it
// bit for bit.
//
// What bounds it: instruction issue and, with few warps a scheduler, the
// ACS' dependency latency; the tile is read once and the output written
// once.  At one lane an array (lanes = 1) A is K1's stage body with its
// loop of two stages, the next two stages' u and d loading while the ACS
// runs, as K1's reader runs a word ahead, so that a load's latency does
// not stall the pass that needs it.  B doubles the independent work a
// thread, and its registers: 256 live values against the 255-register
// cap, so B spills.  C trades A's 64 registers of each kind for two and a
// warp's shuffles, and so fills the SMs with 32 times the threads.  At
// the JAX shape's 2,048 arrays A and B run 32 CTAs of 64 threads on 132
// SMs, each warp's time its ACS chain's latency.
//
// What the design does about it: A and B split each array over `lanes` L
// of a warp (2-32; the wrapper picks L from the threads they run at one
// lane, arrays for A, array pairs for B), in place, as lanes.cuh lays it
// out: a lane holds S = 64 / L positions of each of its arrays, B's two
// interleaved stage by stage; a loop of six-stage passes, each stage's u
// and d rows (row t % 32, at a runtime offset, since a pass is not a
// divisor of 32) loaded a pass ahead, every lane of an array reading the
// same address, so a warp's row is one request of 32 / L neighbouring
// words.  The tile's pm and pp are in natural order at t = 0, so position
// P starts as state P; after `stages` stages it holds state rol6(P,
// stages % 6), its row of the output.  B's two arrays rotate alike, so its
// sum is taken position by position.  A lane's positions are
// double-buffered; B at two lanes has 128 metrics and survivors live.  C
// is left as it was: it is one warp, 32 lanes, an array.

#include <cuda_runtime.h>

#include <cstdint>

#include "acs.cuh"
#include "build_part.cuh"
#include "lanes.cuh"

// Build parts (build_part.cuh): part 0 holds the entry point, the one-lane
// kernels and C, part 1 A's lane-split kernels and part 2 B's.
// nvcc parts: 3

namespace viterbi_layout {

using viterbi::Bm;
using viterbi::kPass;
using viterbi::kStates;
using viterbi::lane_stage;
using viterbi::rol6;

constexpr int kCols = 128;     // arrays of a program (the TPU's lanes)
constexpr int kRows = 192;     // rows of a program
constexpr int kRowPp = 64;
constexpr int kRowU = 128;
constexpr int kRowD = 160;
constexpr int kThreadsA = 64;  // K1's CUDA block
constexpr int kThreadsC = 128; // four warps: four arrays
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ Bm bm_of(int u, int d) {
  Bm m;
  m.u = u;
  m.nu = viterbi::neg<true>(u);
  m.d = d;
  m.nd = viterbi::neg<true>(d);
  return m;
}

// The array of column p's program: pm at p[s * kCols], pp 64 rows below.
__device__ __forceinline__ void load_array(const int* p, int (&pm)[kStates],
                                           uint32_t (&pp)[kStates]) {
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    pm[s] = __ldg(p + s * kCols);
    pp[s] = static_cast<uint32_t>(__ldg(p + (kRowPp + s) * kCols));
  }
}

// The branch metrics of stages t and t + 1 (t even) of column p's program,
// rows t % 32 and t % 32 + 1 of u and d; a loop reads a pair while the next
// pair loads, as K1's word reader runs a word ahead of its stages.
struct UdRows {
  const int* p;
  Bm m0, m1;

  __device__ __forceinline__ explicit UdRows(const int* col) : p(col) {
    fetch(0);
  }
  __device__ __forceinline__ void fetch(int t) {
    const int r = t % 32;
    m0 = bm_of(__ldg(p + (kRowU + r) * kCols), __ldg(p + (kRowD + r) * kCols));
    m1 = bm_of(__ldg(p + (kRowU + r + 1) * kCols),
               __ldg(p + (kRowD + r + 1) * kCols));
  }
};

#if IN_PART(0)
__global__ void __launch_bounds__(kThreadsA)
layout_real_kernel(const int* __restrict__ x, int* __restrict__ out,
                   int stages, int programs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= programs * kCols) return;
  const int g = i / kCols, l = i % kCols;
  const int* p = x + static_cast<size_t>(g) * kRows * kCols + l;
  int pm_a[kStates], pm_b[kStates];
  uint32_t pp_a[kStates], pp_b[kStates];
  load_array(p, pm_a, pp_a);
  UdRows ud(p);
#pragma unroll 1
  for (int t = 0; t < stages; t += 2) {
    const Bm m0 = ud.m0, m1 = ud.m1;
    ud.fetch(t + 2);
    viterbi::acs_stage<true>(pm_a, pp_a, pm_b, pp_b, m0);
    viterbi::acs_stage<true>(pm_b, pp_b, pm_a, pp_a, m1);
  }
  int* o = out + static_cast<size_t>(g) * kStates * kCols + l;
#pragma unroll
  for (int s = 0; s < kStates; ++s)
    o[s * kCols] = static_cast<int>(static_cast<uint32_t>(pm_a[s]) + pp_a[s]);
}

__global__ void __launch_bounds__(kThreadsA)
layout_dual_kernel(const int* __restrict__ x, int* __restrict__ out,
                   int stages, int programs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= programs * kCols) return;
  const int g = i / kCols, l = i % kCols;
  const int* pa = x + static_cast<size_t>(2 * g) * kRows * kCols + l;
  const int* pb = pa + kRows * kCols;
  int am_a[kStates], am_b[kStates], bm_a[kStates], bm_b[kStates];
  uint32_t ap_a[kStates], ap_b[kStates], bp_a[kStates], bp_b[kStates];
  load_array(pa, am_a, ap_a);
  load_array(pb, bm_a, bp_a);
  UdRows uda(pa), udb(pb);
#pragma unroll 1
  for (int t = 0; t < stages; t += 2) {
    const Bm ma0 = uda.m0, ma1 = uda.m1, mb0 = udb.m0, mb1 = udb.m1;
    uda.fetch(t + 2);
    udb.fetch(t + 2);
    viterbi::acs_stage<true>(am_a, ap_a, am_b, ap_b, ma0);
    viterbi::acs_stage<true>(bm_a, bp_a, bm_b, bp_b, mb0);
    viterbi::acs_stage<true>(am_b, ap_b, am_a, ap_a, ma1);
    viterbi::acs_stage<true>(bm_b, bp_b, bm_a, bp_a, mb1);
  }
  int* o = out + static_cast<size_t>(g) * kStates * kCols + l;
#pragma unroll
  for (int s = 0; s < kStates; ++s)
    o[s * kCols] = static_cast<int>(static_cast<uint32_t>(am_a[s]) + ap_a[s] +
                                    static_cast<uint32_t>(bm_a[s]) + bp_a[s]);
}

// One state of the lanes layout: the partner's (qm, qp) against its own.
__device__ __forceinline__ void lane_state(int& pm, uint32_t& pp, int qm,
                                           uint32_t qp, int bm, uint32_t h) {
  const int c_self = viterbi::add<true>(pm, bm);
  const int c_part = viterbi::sub<true>(qm, bm);
  const bool dec = c_part > c_self;
  pm = dec ? c_part : c_self;
  pp = dec ? (qp << 1) + h : (pp << 1) + (1u - h);
}

__global__ void __launch_bounds__(kThreadsC)
layout_lanes_kernel(const int* __restrict__ x, int* __restrict__ out,
                    int stages, int programs) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // the array
  const int lane = threadIdx.x & 31;
  if (w >= programs * kCols) return;  // whole warps: blockDim % 32 == 0
  const int g = w / kCols, r = (w % kCols) >> 1, half = w & 1;
  const int col = half * 64 + 2 * lane;  // states j0 = 2 lane, j1 = j0 + 1
  const int* p = x + static_cast<size_t>(g) * kRows * kCols + col;
  const int2* rows = reinterpret_cast<const int2*>(p);  // a row: kCols / 2
  const int2 m0 = __ldg(rows + r * (kCols / 2));
  const int2 p0 = __ldg(rows + (kRowPp + r) * (kCols / 2));
  int pm0 = m0.x, pm1 = m0.y;
  uint32_t pp0 = static_cast<uint32_t>(p0.x), pp1 = static_cast<uint32_t>(p0.y);
  const int j0 = 2 * lane, j1 = j0 + 1;
  const bool same0 = viterbi::sign0(j0) == viterbi::sign1(j0);
  const bool same1 = viterbi::sign0(j1) == viterbi::sign1(j1);
  const bool pos0 = viterbi::sign0(j0) > 0, pos1 = viterbi::sign0(j1) > 0;
  const uint32_t h = static_cast<uint32_t>(lane >> 4);  // bit 5 of j0, j1
  const int2* u = reinterpret_cast<const int2*>(p + kRowU * kCols);
  const int2* d = reinterpret_cast<const int2*>(p + kRowD * kCols);
#pragma unroll 1
  for (int t = 0; t < stages; t += 32) {
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      const int k = 1 << (s % 6);
      const int2 uu = __ldg(u + s * (kCols / 2));
      const int2 dd = __ldg(d + s * (kCols / 2));
      const int b0 = same0 ? uu.x : dd.x, b1 = same1 ? uu.y : dd.y;
      const int bm0 = pos0 ? b0 : viterbi::neg<true>(b0);
      const int bm1 = pos1 ? b1 : viterbi::neg<true>(b1);
      int qm0, qm1;
      uint32_t qp0, qp1;
      if (k == 1) {
        qm0 = pm1;
        qm1 = pm0;
        qp0 = pp1;
        qp1 = pp0;
      } else {
        qm0 = __shfl_xor_sync(kFull, pm0, k >> 1);
        qm1 = __shfl_xor_sync(kFull, pm1, k >> 1);
        qp0 = __shfl_xor_sync(kFull, pp0, k >> 1);
        qp1 = __shfl_xor_sync(kFull, pp1, k >> 1);
      }
      lane_state(pm0, pp0, qm0, qp0, bm0, h);
      lane_state(pm1, pp1, qm1, qp1, bm1, h);
    }
  }
  int2 o;
  o.x = static_cast<int>(static_cast<uint32_t>(pm0) + pp0);
  o.y = static_cast<int>(static_cast<uint32_t>(pm1) + pp1);
  int* dst = out + (static_cast<size_t>(g) * kStates + r) * kCols + col;
  *reinterpret_cast<int2*>(dst) = o;
}
#endif  // IN_PART(0)

// --- A and B split over lanes (lanes >= 2, lanes.cuh) ---

constexpr int kLaneThreads = 128;  // the lane-split kernels' CUDA block

// A thread's N arrays (A: 1, B: 2, the tiles 2g and 2g + 1), each over L
// lanes: the lane's S = 64 / L positions of each, double-buffered, and the
// u and d of each stage of the next pass.
template <int L, int N>
struct SplitArrays {
  static constexpr int S = kStates / L;

  const int* u;  // row 0 of u, column l, of the first array's tile
  int lane;
  uint32_t flips;
  int pm_a[N][S], pm_b[N][S];
  uint32_t pp_a[N][S], pp_b[N][S];
  int ru[N][kPass], rd[N][kPass];

  __device__ __forceinline__ SplitArrays(const int* col, int ln)
      : u(col + kRowU * kCols), lane(ln), flips(0u) {
    viterbi::add_lane_flips<L>(lane, flips);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int* tile = col + n * kRows * kCols;
#pragma unroll
      for (int r = 0; r < S; ++r) {
        pm_a[n][r] = __ldg(tile + (lane * S + r) * kCols);
        pp_a[n][r] = static_cast<uint32_t>(
            __ldg(tile + (kRowPp + lane * S + r) * kCols));
      }
    }
#pragma unroll
    for (int j = 0; j < kPass; ++j) rows(j, j);
  }

  // Stage t's u and d (row t % 32) of every array into slot j (a constant
  // once unrolled): one address for all L lanes of an array, one 64-bit
  // add for the thread's loads (the rest are immediate offsets from it).
  __device__ __forceinline__ void rows(int t, int j) {
    const int* at = u + (t & 31) * kCols;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      ru[n][j] = __ldg(at + n * kRows * kCols);
      rd[n][j] = __ldg(at + n * kRows * kCols + (kRowD - kRowU) * kCols);
    }
  }

  // Stage t0 + J, phase J (t0 % 6 == 0), of each array in turn; AHEAD:
  // then load the next pass's rows into the registers it has read.
  template <int J, bool AHEAD>
  __device__ __forceinline__ void stage(int t0) {
    Bm m[N];
#pragma unroll
    for (int n = 0; n < N; ++n) m[n] = bm_of(ru[n][J], rd[n][J]);
    if constexpr (AHEAD) rows(t0 + kPass + J, J);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if constexpr (J % 2 == 0)
        lane_stage<L, J>(pm_a[n], pp_a[n], pm_b[n], pp_b[n], m[n], flips,
                         lane);
      else
        lane_stage<L, J>(pm_b[n], pp_b[n], pm_a[n], pp_a[n], m[n], flips,
                         lane);
    }
  }

  template <int J, int M, bool AHEAD>
  __device__ __forceinline__ void pass(int t0) {
    if constexpr (J < M) {
      stage<J, AHEAD>(t0);
      pass<J + 1, M, AHEAD>(t0);
    }
  }
};

// V = 0: A, V = 1: B.  programs x kCols x L threads, whole blocks.
template <int V, int L>
__global__ void __launch_bounds__(kLaneThreads)
layout_split_kernel(const int* __restrict__ x, int* __restrict__ out,
                    int stages) {
  constexpr int N = V + 1, S = kStates / L;
  const int i = blockIdx.x * kLaneThreads + threadIdx.x;
  const int a = i / L, lane = i % L;  // a: the array (A) or pair (B)
  const int g = a / kCols, l = a % kCols;
  SplitArrays<L, N> arr(x + static_cast<size_t>(N * g) * kRows * kCols + l,
                        lane);
  int t0 = 0;
#pragma unroll 1
  for (; t0 + kPass <= stages; t0 += kPass)
    arr.template pass<0, kPass, true>(t0);
  // stages % 32 == 0: a tail of 0, 2 or 4
  if (stages - t0 == 4)
    arr.template pass<0, 4, false>(t0);
  else if (stages - t0 == 2)
    arr.template pass<0, 2, false>(t0);
  const int f = stages % kPass;
  int* o = out + static_cast<size_t>(g) * kStates * kCols + l;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    uint32_t v = 0u;
#pragma unroll
    for (int n = 0; n < N; ++n)
      v += static_cast<uint32_t>(arr.pm_a[n][r]) + arr.pp_a[n][r];
    o[rol6(lane * S + r, f) * kCols] = static_cast<int>(v);
  }
}

template <int V, int L>
cudaError_t launch_split_at(const int* x, int* out, int stages, int programs,
                            cudaStream_t s) {
  static_assert(kCols % kLaneThreads == 0, "whole CUDA blocks");
  layout_split_kernel<V, L>
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

cudaError_t launch_split_real(int, const int*, int*, int, int, cudaStream_t);
cudaError_t launch_split_dual(int, const int*, int*, int, int, cudaStream_t);

#if IN_PART(1)
cudaError_t launch_split_real(int lanes, const int* x, int* out, int stages,
                              int programs, cudaStream_t s) {
  return launch_split<0>(lanes, x, out, stages, programs, s);
}
#endif
#if IN_PART(2)
cudaError_t launch_split_dual(int lanes, const int* x, int* out, int stages,
                              int programs, cudaStream_t s) {
  return launch_split<1>(lanes, x, out, stages, programs, s);
}
#endif

}  // namespace viterbi_layout

using namespace viterbi_layout;

#if IN_PART(0)
// Launch variant `variant` (0 real, 1 dual, 2 lanes) split over `lanes`
// lanes an array (A and B: 1, 2, 4, 8, 16 or 32; C: 32, one warp an
// array) for `stages` stages (a multiple of 32) over `programs` programs:
// x holds programs x 192 rows of 128 int32 (a dual program is two of
// them), out programs x 64 rows.  Returns the cudaError_t of the launch (0
// = launched).
extern "C" int viterbi_k12_launch(int variant, int lanes, const void* x,
                                  void* out, int stages, int programs,
                                  void* stream) {
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages < 0 || stages % 32 != 0 || programs <= 0 || x == nullptr ||
      out == nullptr || lanes < 1 ||
      static_cast<long long>(programs) * kCols * lanes > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = programs * kCols;
  switch (variant) {
    case 0:
      if (lanes > 1)
        return static_cast<int>(
            launch_split_real(lanes, xi, o, stages, programs, s));
      layout_real_kernel<<<(threads + kThreadsA - 1) / kThreadsA, kThreadsA,
                           0, s>>>(xi, o, stages, programs);
      break;
    case 1:
      if (lanes > 1)
        return static_cast<int>(
            launch_split_dual(lanes, xi, o, stages, programs, s));
      layout_dual_kernel<<<(threads + kThreadsA - 1) / kThreadsA, kThreadsA,
                           0, s>>>(xi, o, stages, programs);
      break;
    case 2:
      if (lanes != 32) return static_cast<int>(cudaErrorInvalidValue);
      layout_lanes_kernel<<<threads * 32 / kThreadsC, kThreadsC, 0, s>>>(
          xi, o, stages, programs);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // IN_PART(0)
