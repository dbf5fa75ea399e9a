// Kernel K19: the even/odd ACS with int32 or int16 path metrics and
// survivors.  Replaces the TPU probe kernel of scripts/opt_bench.py:
// make_kernel (:30), launched by run at :73.
//
// Input rs: (n_packs, 32, 2, width) int32; column c is one array, a thread
// each, stage t = 32 p + s reads bm = rs[p, s, 0, c] + rs[p, s, 1, c] (in
// the metric's type: int16 keeps its low half).  States 0..63 start at
// zero.  A stage: lo = pm[q], hi = pm[q + 32] (q = 0..31); e = max(lo + bm,
// hi - bm) and o = max(lo - bm, hi + bm) with strict decisions de, do; the
// children are states 2q and 2q + 1; survivors pe = (de ? pp[q + 32] :
// pp[q]) << 1 | de and po likewise.  out[i] = pm[i] + pp[i] in the metric's
// type, sign-extended.  Variants:
//   0 i32_split  int32 metrics and survivors, a state a register
//   1 i16        int16 metrics and survivors, two neighbouring states a
//                register (int16x2): W[k] = (state 2k, state 2k + 1)
//   2 i16_pm     int16x2 metrics as i16, int32 survivors as i32_split
// The int16x2 stage, for a word pair j = 0..15 (L = W[j] holds lo of q =
// 2j, 2j + 1, H = W[16 + j] their hi): c0e = __vadd2(L, B), c1e =
// __vsub2(H, B), c0o = __vsub2(L, B), c1o = __vadd2(H, B) with B = (bm,
// bm); E = __vibmax_s16x2(c0e, c1e) holds e of q = 2j, 2j + 1 and sets the
// predicates c0e >= c1e per half, the negations of JAX's de; O likewise;
// the children of q = 2j are states 4j, 4j + 1 and of 2j + 1 states 4j + 2,
// 4j + 3, so the next words are __byte_perm(E, O) of the low halves and of
// the high halves: JAX's merge interleave.  The int16x2 survivors select a
// half at a time between the pre-shifted words (PL << 1) and (PH << 1) | 1
// (each half shifted in int16) and interleave the same way.  The plain
// PyTorch version is opt_bench_torch in
// tpu_viterbi_torch/scripts/opt_bench.py; each variant agrees with it bit
// for bit at every block size.
//
// What bounds it: the ACS' issue at one thread an array (256 operations an
// array-stage in int32, half the metric's with two states a register), at
// few warps a scheduler its dependency latency.  At one lane an array the
// design is K14's shape (metrics and survivors in registers, a loop of two
// stages whose next input loads while it runs); the JAX lane-tile width
// is the block size (128, 256 or 512 threads), a kernel each with its own
// launch bound: at 512 threads a block a thread may hold 128 registers, so
// the int32 variant's 128 metrics and survivors spill there, while the
// int16x2 metrics take half the registers.  4,096 arrays at 128 threads a
// block are 32 blocks: a quarter of the SMs, one warp a scheduler.
//
// What the design does about it: each array is split over `lanes` L of a
// warp (2-32; the wrapper picks L from the array count), in place, as
// lanes.cuh lays it out: a block of lt threads holds lt / L arrays, a lane
// S = 64 / L positions, a loop of six-stage passes whose input loads a pass
// ahead.  bm is the same for every state, so each position adds +bm to
// itself and -bm to its partner.  i32_split is lanes.cuh's int32 stage.
// The int16x2 variants keep positions (P, P ^ 1) in one register: in the
// phase whose pair bit is 0 (t % 6 == 5) the partner is the other half of
// the same word (a half swap, one PRMT); else the same half of another
// register or lane.  The tie rule turns with the position's x bit h (the
// partner wins a tie where h = 1): __vibmax_s16x2(a, b) gives a >= b a
// half, so a half with h = 1 takes (cp, cs) and one with h = 0 (cs, cp),
// and its decision is that predicate == h; in the half-swap phase the two
// halves' h differ, so the operands' halves are swapped per half (PRMT),
// elsewhere h is a register's bit (a constant) or a lane's (a select, no
// branch).  i16's survivors shift per half, masked.  After T stages row
// rol6(P, T % 6) of the output gets position P's sum.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "build_part.cuh"
#include "lanes.cuh"

// Build parts (build_part.cuh): part i holds the kernels of one block size
// (128, 256, 512), part 0 the entry point.
// nvcc parts: 3

namespace viterbi_opt_bench {

using viterbi::kPass;
using viterbi::kStates;
using viterbi::lane_acs_stage;
using viterbi::lane_partner;
using viterbi::lane_survivor;
using viterbi::log2_of;
using viterbi::rol6;

constexpr int kBpp = 32;

__device__ __forceinline__ uint32_t lo_halves(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5410);  // (a.lo, b.lo)
}
__device__ __forceinline__ uint32_t hi_halves(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);  // (a.hi, b.hi)
}
__device__ __forceinline__ uint32_t halves(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7610);  // (lo.lo, hi.hi)
}

// The metrics of one variant: 64 int32 states, or 32 int16x2 words.
template <int V>
struct Metrics {
  static constexpr int kWords = V == 0 ? 64 : 32;
};

// The survivors: 64 uint32 states (i32_split, i16_pm) or 32 int16x2 words.
template <int V>
struct Survivors {
  static constexpr int kWords = V == 1 ? 32 : 64;
};

template <int V>
__device__ __forceinline__ void stage(
    const uint32_t (&pm)[Metrics<V>::kWords],
    const uint32_t (&pp)[Survivors<V>::kWords],
    uint32_t (&pmo)[Metrics<V>::kWords],
    uint32_t (&ppo)[Survivors<V>::kWords], uint32_t bm) {
  if constexpr (V == 0) {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int c0e = static_cast<int>(pm[q] + bm);
      const int c1e = static_cast<int>(pm[q + 32] - bm);
      const int c0o = static_cast<int>(pm[q] - bm);
      const int c1o = static_cast<int>(pm[q + 32] + bm);
      const bool de = c1e > c0e, dod = c1o > c0o;
      pmo[2 * q] = static_cast<uint32_t>(de ? c1e : c0e);
      pmo[2 * q + 1] = static_cast<uint32_t>(dod ? c1o : c0o);
      const uint32_t fl = pp[q] << 1, fh = (pp[q + 32] << 1) | 1u;
      ppo[2 * q] = de ? fh : fl;
      ppo[2 * q + 1] = dod ? fh : fl;
    }
  } else {
    const uint32_t b = __byte_perm(bm, 0u, 0x1010);  // (bm, bm), int16
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t l = pm[j], h = pm[16 + j];
      bool ge_e1, ge_e0, ge_o1, ge_o0;  // c0 >= c1 for q = 2j + 1, 2j
      const uint32_t e = __vibmax_s16x2(__vadd2(l, b), __vsub2(h, b),
                                        &ge_e1, &ge_e0);
      const uint32_t o = __vibmax_s16x2(__vsub2(l, b), __vadd2(h, b),
                                        &ge_o1, &ge_o0);
      pmo[2 * j] = lo_halves(e, o);
      pmo[2 * j + 1] = hi_halves(e, o);
      if constexpr (V == 1) {
        const uint32_t fl = (pp[j] << 1) & 0xFFFEFFFEu;
        const uint32_t fh = ((pp[16 + j] << 1) & 0xFFFEFFFEu) | 0x00010001u;
        const uint32_t pe = halves(ge_e0 ? fl : fh, ge_e1 ? fl : fh);
        const uint32_t po = halves(ge_o0 ? fl : fh, ge_o1 ? fl : fh);
        ppo[2 * j] = lo_halves(pe, po);
        ppo[2 * j + 1] = hi_halves(pe, po);
      } else {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int q = 2 * j + k;
          const bool ge_e = k ? ge_e1 : ge_e0, ge_o = k ? ge_o1 : ge_o0;
          const uint32_t fl = pp[q] << 1, fh = (pp[q + 32] << 1) | 1u;
          ppo[2 * q] = ge_e ? fl : fh;
          ppo[2 * q + 1] = ge_o ? fl : fh;
        }
      }
    }
  }
}

template <int V, int THREADS>
__global__ void __launch_bounds__(THREADS)
opt_kernel(const int* __restrict__ rs, int* __restrict__ out, int n_packs,
           int width) {
  constexpr int kM = Metrics<V>::kWords, kP = Survivors<V>::kWords;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  const int* r = rs + c;  // stage t's pair at rows 2t, 2t + 1 of width
  const size_t w = static_cast<size_t>(width);
  const int stages = n_packs * kBpp;
  uint32_t pm_a[kM], pm_b[kM], pp_a[kP], pp_b[kP];
#pragma unroll
  for (int i = 0; i < kM; ++i) pm_a[i] = 0u;
#pragma unroll
  for (int i = 0; i < kP; ++i) pp_a[i] = 0u;
  int x0 = __ldg(r), y0 = __ldg(r + w), x1 = __ldg(r + 2 * w),
      y1 = __ldg(r + 3 * w);
#pragma unroll 1
  for (int t = 0; t < stages; t += 2) {
    const uint32_t bm0 = static_cast<uint32_t>(x0) + static_cast<uint32_t>(y0);
    const uint32_t bm1 = static_cast<uint32_t>(x1) + static_cast<uint32_t>(y1);
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
  for (int i = 0; i < 64; ++i) {
    int v;
    if constexpr (V == 0) {
      v = static_cast<int>(pm_a[i] + pp_a[i]);
    } else {
      const uint32_t m = pm_a[i / 2] >> (16 * (i % 2));
      uint32_t p;
      if constexpr (V == 1)
        p = pp_a[i / 2] >> (16 * (i % 2));
      else
        p = pp_a[i];
      v = static_cast<int16_t>((m + p) & 0xFFFFu);
    }
    out[i * w + c] = v;
  }
}

// --- the lane-split layout (lanes >= 2, lanes.cuh) ---

// One array's lane: its S = 64 / L positions (metrics int32 a position or
// int16x2 a pair, survivors likewise for i16, int32 for i16_pm),
// double-buffered, and the stage pairs of the next pass.
template <int V, int L>
struct OptLanes {
  static constexpr int S = kStates / L;
  static constexpr int kM = V == 0 ? S : S / 2;   // metric registers
  static constexpr int kP = V == 1 ? S / 2 : S;   // survivor registers
  static constexpr int kRegBits = 6 - log2_of(L);
  using Pm = std::conditional_t<V == 0, int, uint32_t>;

  const int* r;
  size_t w;
  int stages, lane;
  Pm pm_a[kM], pm_b[kM];
  uint32_t pp_a[kP], pp_b[kP];
  int x[kPass], y[kPass];  // each stage's pair

  __device__ __forceinline__ OptLanes(const int* col, size_t width,
                                      int n_stages, int ln)
      : r(col), w(width), stages(n_stages), lane(ln) {
#pragma unroll
    for (int k = 0; k < kM; ++k) pm_a[k] = 0;
#pragma unroll
    for (int k = 0; k < kP; ++k) pp_a[k] = 0u;
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      x[j] = load(j, 0);
      y[j] = load(j, 1);
    }
  }

  // stage t's value k of its pair
  __device__ __forceinline__ int load(int t, int k) const {
    return t < stages ? __ldg(r + static_cast<size_t>(2 * t + k) * w) : 0;
  }

  // The int16x2 stage in phase F, bm in the low half of bm.
  template <int F>
  __device__ __forceinline__ void step16(const uint32_t (&pm)[kM],
                                         const uint32_t (&pp)[kP],
                                         uint32_t (&pm_o)[kM],
                                         uint32_t (&pp_o)[kP], uint32_t bm) {
    constexpr int B = 5 - F;
    const uint32_t b2 = __byte_perm(bm, 0u, 0x1010);  // (bm, bm)
#pragma unroll
    for (int k = 0; k < kM; ++k) {
      uint32_t q;  // the partners of the word's two positions
      if constexpr (B == 0)
        q = __byte_perm(pm[k], pm[k], 0x1032);
      else
        q = lane_partner<B, 1>(pm, k);
      const uint32_t cs = __vadd2(pm[k], b2), cp = __vsub2(q, b2);
      bool p_hi, p_lo, d_lo, d_hi, h_lo, h_hi;
      if constexpr (B == 0) {
        h_lo = false;
        h_hi = true;
        pm_o[k] = __vibmax_s16x2(__byte_perm(cs, cp, 0x7610),
                                 __byte_perm(cp, cs, 0x7610), &p_hi, &p_lo);
      } else {
        if constexpr (B < kRegBits)
          h_lo = (k >> (B - 1)) & 1;
        else
          h_lo = (lane >> (B - kRegBits)) & 1;
        h_hi = h_lo;
        pm_o[k] = __vibmax_s16x2(h_lo ? cp : cs, h_lo ? cs : cp, &p_hi,
                                 &p_lo);
      }
      d_lo = p_lo == h_lo;
      d_hi = p_hi == h_hi;
      if constexpr (V == 1) {
        uint32_t qp;
        if constexpr (B == 0)
          qp = __byte_perm(pp[k], pp[k], 0x1032);
        else
          qp = lane_partner<B, 1>(pp, k);
        const uint32_t hb = (h_lo ? 0x00000001u : 0u) |
                            (h_hi ? 0x00010000u : 0u);
        const uint32_t fs = ((pp[k] << 1) & 0xFFFEFFFEu) | hb;
        const uint32_t fp = ((qp << 1) & 0xFFFEFFFEu) | (hb ^ 0x00010001u);
        pp_o[k] = __byte_perm(d_lo ? fp : fs, d_hi ? fp : fs, 0x7610);
      } else {
        pp_o[2 * k] = lane_survivor(pp[2 * k], lane_partner<B, 0>(pp, 2 * k),
                                    d_lo, h_lo);
        pp_o[2 * k + 1] = lane_survivor(
            pp[2 * k + 1], lane_partner<B, 0>(pp, 2 * k + 1), d_hi, h_hi);
      }
    }
  }

  // Stage t0 + J, phase J (t0 % 6 == 0); AHEAD: then load the next pass's
  // pair into the registers this stage has read.
  template <int J, bool AHEAD>
  __device__ __forceinline__ void stage(int t0) {
    const uint32_t bm = static_cast<uint32_t>(x[J]) +
                        static_cast<uint32_t>(y[J]);
    if constexpr (AHEAD) {
      x[J] = load(t0 + kPass + J, 0);
      y[J] = load(t0 + kPass + J, 1);
    }
    if constexpr (V == 0) {
      const auto bm_at = [bm](int) { return static_cast<int>(bm); };
      if constexpr (J % 2 == 0)
        lane_acs_stage<L, J>(pm_a, pp_a, pm_b, pp_b, bm_at, lane);
      else
        lane_acs_stage<L, J>(pm_b, pp_b, pm_a, pp_a, bm_at, lane);
    } else if constexpr (J % 2 == 0) {
      step16<J>(pm_a, pp_a, pm_b, pp_b, bm);
    } else {
      step16<J>(pm_b, pp_b, pm_a, pp_a, bm);
    }
  }

  template <int J, int N, bool AHEAD>
  __device__ __forceinline__ void pass(int t0) {
    if constexpr (J < N) {
      stage<J, AHEAD>(t0);
      pass<J + 1, N, AHEAD>(t0);
    }
  }

  // Each position's pm + pp (in pm's type, sign-extended) into its logical
  // state's row of column c.
  __device__ __forceinline__ void store(int* out, int c, bool live) const {
    const int f = stages % kPass;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      int v;
      if constexpr (V == 0) {
        v = static_cast<int>(static_cast<uint32_t>(pm_a[k]) + pp_a[k]);
      } else {
        const uint32_t m = pm_a[k / 2] >> (16 * (k % 2));
        const uint32_t p = V == 1 ? pp_a[k / 2] >> (16 * (k % 2)) : pp_a[k];
        v = static_cast<int16_t>((m + p) & 0xFFFFu);
      }
      if (live) out[rol6(lane * S + k, f) * w + c] = v;
    }
  }
};

template <int V, int L, int THREADS>
__global__ void __launch_bounds__(THREADS)
opt_lanes_kernel(const int* __restrict__ rs, int* __restrict__ out,
                 int n_packs, int width) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int c = i / L, lane = i % L;
  // a ragged last block's spare arrays run on the last column, store
  // nothing, and keep their warps whole for the shuffles
  const bool live = c < width;
  OptLanes<V, L> arr(rs + (live ? c : width - 1), width, n_packs * kBpp,
                     lane);
  const int stages = n_packs * kBpp;
  int t0 = 0;
#pragma unroll 1
  for (; t0 + kPass <= stages; t0 += kPass)
    arr.template pass<0, kPass, true>(t0);
  // 32 n_packs % 6 is 0, 2 or 4
  if (stages - t0 == 4)
    arr.template pass<0, 4, false>(t0);
  else if (stages - t0 == 2)
    arr.template pass<0, 2, false>(t0);
  arr.store(out, c, live);
}

template <int V, int L, int THREADS>
cudaError_t launch_lt(const int* rs, int* out, int n_packs, int width,
                      cudaStream_t stream) {
  if constexpr (L == 1) {
    opt_kernel<V, THREADS>
        <<<(width + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
            rs, out, n_packs, width);
  } else {
    opt_lanes_kernel<V, L, THREADS>
        <<<(width * L + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
            rs, out, n_packs, width);
  }
  return cudaGetLastError();
}

template <int V, int THREADS>
cudaError_t launch_lanes(int lanes, const int* rs, int* out, int n_packs,
                         int width, cudaStream_t s) {
  return viterbi::dispatch_lanes(lanes, [&](auto l) {
    return launch_lt<V, decltype(l)::value, THREADS>(rs, out, n_packs, width,
                                                     s);
  });
}

// Every kernel of block size THREADS (one build part's).
template <int THREADS>
cudaError_t launch_threads(int variant, int lanes, const int* rs, int* out,
                           int n_packs, int width, cudaStream_t s) {
  switch (variant) {
    case 0: return launch_lanes<0, THREADS>(lanes, rs, out, n_packs, width, s);
    case 1: return launch_lanes<1, THREADS>(lanes, rs, out, n_packs, width, s);
    case 2: return launch_lanes<2, THREADS>(lanes, rs, out, n_packs, width, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_128(int, int, const int*, int*, int, int, cudaStream_t);
cudaError_t launch_256(int, int, const int*, int*, int, int, cudaStream_t);
cudaError_t launch_512(int, int, const int*, int*, int, int, cudaStream_t);

#if IN_PART(0)
cudaError_t launch_128(int v, int n, const int* rs, int* out, int n_packs,
                       int width, cudaStream_t s) {
  return launch_threads<128>(v, n, rs, out, n_packs, width, s);
}
#endif
#if IN_PART(1)
cudaError_t launch_256(int v, int n, const int* rs, int* out, int n_packs,
                       int width, cudaStream_t s) {
  return launch_threads<256>(v, n, rs, out, n_packs, width, s);
}
#endif
#if IN_PART(2)
cudaError_t launch_512(int v, int n, const int* rs, int* out, int n_packs,
                       int width, cudaStream_t s) {
  return launch_threads<512>(v, n, rs, out, n_packs, width, s);
}
#endif

}  // namespace viterbi_opt_bench

using namespace viterbi_opt_bench;

#if IN_PART(0)
// Launch variant `variant` (0 i32_split, 1 i16, 2 i16_pm) split over
// `lanes` (1, 2, 4, 8, 16 or 32) lanes an array on rs, (n_packs, 32, 2,
// width) int32, into out, (64, width) int32, in blocks of `threads` (128,
// 256 or 512: the JAX lane-tile width).  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int viterbi_k19_launch(int variant, int lanes, const void* rs,
                                  void* out, int n_packs, int width,
                                  int threads, void* stream) {
  const int* r = static_cast<const int*>(rs);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_packs <= 0 || width <= 0 || rs == nullptr || out == nullptr ||
      static_cast<long long>(width) * lanes > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (threads) {
    case 128: return static_cast<int>(launch_128(variant, lanes, r, o,
                                                 n_packs, width, s));
    case 256: return static_cast<int>(launch_256(variant, lanes, r, o,
                                                 n_packs, width, s));
    case 512: return static_cast<int>(launch_512(variant, lanes, r, o,
                                                 n_packs, width, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif  // IN_PART(0)
