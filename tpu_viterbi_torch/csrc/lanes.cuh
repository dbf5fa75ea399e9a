// The lane-split layout of an array's 64 states, shared by K25
// (soft16_ablation.cu), K13 (kernel_ablation.cu), K19 (opt_bench.cu), K12's
// layouts A and B (layout_probe.cu), K14's and K16's trellis variants
// (acs_variants.cu, kernel_microbench.cu: lane_probe_stage, ProbeLane and
// the stage-pair passes below) and K23's split roll decode
// (staging_cost.cu); K28's split interleave (interleave.cu) renames its
// rows in the same rol6 frame.  Every split kernel takes its lane count
// through dispatch_lanes.
//
// An array is split over L lanes of a warp (1, 2, 4, 8, 16 or 32), S = 64 /
// L positions a lane.  The states move in place: after t stages physical
// position P = lane * S + register holds logical state rol6(P, t % 6), so
// stage t pairs P with P ^ (1 << b), b = 5 - t % 6, the two predecessors
// (x, q) of the children (q, x): a register of the same thread when b <
// 6 - log2 L, else the same register of lane ^ (1 << (b - 6 + log2 L)),
// read with __shfl_xor_sync (K12's layout C, csrc/layout_probe.cu, shuffles
// the same trellis).  Position P keeps child (q, x_P): c_self = pm[P] +
// bm(q), c_part = pm[P'] - bm(q), the partner taken when c_part > c_self
// (x_P = 0) or c_part >= c_self (x_P = 1), the j=0 branch winning ties as
// in acs_stage, and the survivor gets the winner's x.  State 0 stays at P =
// 0.  bm(q)'s choice among u, -u, d, -d is linear in P's bits: its register
// part is a compile-time index, its lane part two flip bits a phase read
// once a thread.  A pass of a stage loop is the six phases; a run of 32 n
// stages ends with a tail of 0, 2 or 4.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "acs.cuh"

namespace viterbi {

constexpr int kPass = 6;          // stages of a pass of the lane-split loop
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ constexpr int log2_of(int x) {
  return x <= 1 ? 0 : 1 + log2_of(x / 2);
}
// The logical state position p holds after f stages of a pass (p's 6 bits
// rotated left by f): linear in p's bits, so rol6(lane * S + r, f) =
// rol6(lane * S, f) | rol6(r, f).
__host__ __device__ constexpr int rol6(int p, int f) {
  return f == 0 ? p : ((p << f) | (p >> (6 - f))) & 63;
}
// bit 0: bm's sign is + (sign0 > 0); bit 1: sign0 != sign1 (bm is +-d),
// for the pair q that physical position P holds in phase f.  Both are XORs
// of P's bits, so bits(lane * S + r) = bits(lane * S) ^ bits(r).
__host__ __device__ constexpr int bm_bits(int P, int f) {
  const int q = rol6(P, f) & 31;
  return (sign0(q) > 0 ? 1 : 0) | (sign0(q) != sign1(q) ? 2 : 0);
}
// Whether the lane part of bm_bits can be non-zero in phase f (else the
// flips are compile-time zero).
template <int L>
__host__ __device__ constexpr int lane_bm_bits(int f) {
  int any = 0;
  for (int lane = 0; lane < L; ++lane) any |= bm_bits(lane * (kStates / L), f);
  return any;
}
// A lane's flips, OR-ed into `flips`: bit f its sign flip, bit 6 + f its
// u/d flip in phase f (bm_bits of the lane's part).  K25 writes this loop
// out in its constructor, where it keeps that kernel's SASS the same as
// before this header.
template <int L>
__device__ __forceinline__ void add_lane_flips(int lane, uint32_t& flips) {
#pragma unroll
  for (int f = 0; f < kPass; ++f) {
    const int b = bm_bits(lane * (kStates / L), f);
    flips |= static_cast<uint32_t>(b & 1) << f;
    flips |= static_cast<uint32_t>(b >> 1) << (6 + f);
  }
}

// The partner of unit k of a lane's N units (a unit: 2^LOW neighbouring
// positions, LOW = 0 for a position a register, 1 for an int16x2 pair) in
// the phase whose pair bit is B >= LOW: register k ^ (1 << (B - LOW)) of
// the same thread while that bit is a register bit, else the same register
// of the lane the bit names.
template <int B, int LOW, int N, typename T>
__device__ __forceinline__ T lane_partner(const T (&x)[N], int k) {
  constexpr int kBits = log2_of(N), u = B - LOW;
  if constexpr (u < kBits)
    return x[k ^ (1 << u)];
  else
    return __shfl_xor_sync(kFull, x[k], 1 << (u - kBits));
}

// The x bit in phase F of register r of `lane`'s positions (P = lane * S +
// r): P's pair bit b = 5 - F, a compile-time constant once unrolled while b
// is a register bit, else the lane's bit.
template <int L, int F>
__device__ __forceinline__ bool lane_x(int r, int lane) {
  constexpr int kRegBits = 6 - log2_of(L), B = 5 - F;
  if constexpr (B < kRegBits)
    return (r >> B) & 1;
  else
    return (lane >> (B - kRegBits)) & 1;
}

// The survivor of a position whose partner won (dec) or not, h its x bit.
__device__ __forceinline__ uint32_t lane_survivor(uint32_t pp_s, uint32_t pp_p,
                                                  bool dec, bool h) {
  return ((dec ? pp_p : pp_s) << 1) | static_cast<uint32_t>(dec != h);
}

// Position update: (pm_o, pp_o) = the child (q, h) from own (pm_s, pp_s)
// and the partner's (pm_p, pp_p), h = the position's x bit: the partner
// wins on c_part > c_self, and on a tie where h = 1 (the j=0 branch is then
// the partner).  Written without a branch on h, which is a lane's bit in
// the phases that shuffle: a branch there would split the warp around its
// shuffles.
__device__ __forceinline__ void lane_acs(int pm_s, uint32_t pp_s, int pm_p,
                                         uint32_t pp_p, int bm, bool h,
                                         int& pm_o, uint32_t& pp_o) {
  const int cs = add<true>(pm_s, bm);
  const int cp = sub<true>(pm_p, bm);
  const bool dec = (cp > cs) | ((cp == cs) & h);
  pm_o = dec ? cp : cs;
  pp_o = lane_survivor(pp_s, pp_p, dec, h);
}

// One int32 stage in phase F of a lane's S = 64 / L positions, from (pm,
// pp) into (pm_o, pp_o), position r's bm bm_at(r) (r a compile-time index
// once unrolled); lane: the array's lane.
template <int L, int F, typename BmAt>
__device__ __forceinline__ void lane_acs_stage(
    const int (&pm)[kStates / L], const uint32_t (&pp)[kStates / L],
    int (&pm_o)[kStates / L], uint32_t (&pp_o)[kStates / L], BmAt bm_at,
    int lane) {
  constexpr int S = kStates / L, B = 5 - F;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int bm = bm_at(r);
    const bool h = lane_x<L, F>(r, lane);
    const int qm = lane_partner<B, 0>(pm, r);
    const uint32_t qp = lane_partner<B, 0>(pp, r);
    lane_acs(pm[r], pp[r], qm, qp, bm, h, pm_o[r], pp_o[r]);
  }
}

// One stage of the trellis' ACS (acs_stage's bm choice) in phase F.
// flips: the lane's (add_lane_flips).
template <int L, int F>
__device__ __forceinline__ void lane_stage(const int (&pm)[kStates / L],
                                           const uint32_t (&pp)[kStates / L],
                                           int (&pm_o)[kStates / L],
                                           uint32_t (&pp_o)[kStates / L],
                                           const Bm& m, uint32_t flips,
                                           int lane) {
  constexpr int kLane = lane_bm_bits<L>(F);
  const bool fp = (kLane & 1) && ((flips >> F) & 1u);
  const bool fd = (kLane & 2) && ((flips >> (6 + F)) & 1u);
  // bm of the register part's (sign +, +-d) bits, the lane's flips applied
  const int su = fd ? m.d : m.u, sun = fd ? m.nd : m.nu;
  const int sd = fd ? m.u : m.d, sdn = fd ? m.nu : m.nd;
  const int bm4[4] = {fp ? su : sun, fp ? sun : su, fp ? sd : sdn,
                      fp ? sdn : sd};
  lane_acs_stage<L, F>(pm, pp, pm_o, pp_o,
                       [&](int r) { return bm4[bm_bits(r, F)]; }, lane);
}

// --- K14's and K16's trellis variants on this layout ---
//
// Their input gives every pair of a stage one bm (stage_pairs_input), and
// their variants differ in the candidates and in the survivor.  SAME: both
// children of pair q take max(lo + bm, hi - bm) (K14's full and pp_noshuf,
// K16's bcast and no_pp), so the position holding hi (x bit h = 1) adds
// -bm to itself and +bm to its partner; else the even child takes that and
// the odd child max(lo - bm, hi + bm) (K14's eo and decbits: K1's
// butterfly), +bm to itself at every position.  The tie rule, the decision
// and the survivor's bit (the winner's x bit) are lane_acs's.

// How a position's survivor moves: the exchange (lane_survivor), a shift-in
// of the stage's bit in place (the word of the row the position held, for
// survivors keyed by fixed rows: K14's pp_noshuf and decbits, put back
// together at the end), or a count (pp + 1: K16's no_pp).
enum class LanePp { kExchange, kShiftIn, kCount };

// One stage in phase F of a lane's S = 64 / L positions, from (pm, pp) into
// (pm_o, pp_o).  SAME's sign is taken arithmetically, (bm ^ m) - m with m =
// -h: a select on a lane's bit may compile to a branch around the
// shuffles.
template <int L, int F, bool SAME, LanePp PP>
__device__ __forceinline__ void lane_probe_stage(
    const int (&pm)[kStates / L], const uint32_t (&pp)[kStates / L],
    int (&pm_o)[kStates / L], uint32_t (&pp_o)[kStates / L], int bm,
    int lane) {
  constexpr int S = kStates / L, B = 5 - F;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const bool h = lane_x<L, F>(r, lane);
    const int m = SAME ? -static_cast<int>(h) : 0;
    const int b = sub<true>(bm ^ m, m);
    const int qm = lane_partner<B, 0>(pm, r);
    if constexpr (PP == LanePp::kExchange) {
      lane_acs(pm[r], pp[r], qm, lane_partner<B, 0>(pp, r), b, h, pm_o[r],
               pp_o[r]);
    } else {
      const int cs = add<true>(pm[r], b);
      const int cp = sub<true>(qm, b);
      const bool dec = (cp > cs) | ((cp == cs) & h);
      pm_o[r] = dec ? cp : cs;
      if constexpr (PP == LanePp::kCount)
        pp_o[r] = pp[r] + 1u;
      else
        pp_o[r] = (pp[r] << 1) | static_cast<uint32_t>(dec != h);
    }
  }
}

// One array's lane of a K14 / K16 trellis variant: its S positions' metrics
// and survivors from zero, double-buffered (stage J of a pass reads the a
// registers when J is even); after an even number of stages the a
// registers hold them.
template <int L, bool SAME, LanePp PP>
struct ProbeLane {
  static constexpr int S = kStates / L;
  int lane;
  int pm_a[S], pm_b[S];
  uint32_t pp_a[S], pp_b[S];

  __device__ __forceinline__ explicit ProbeLane(int ln) : lane(ln) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      pm_a[k] = 0;
      pp_a[k] = 0u;
    }
  }

  template <int J>
  __device__ __forceinline__ void stage(int bm) {
    if constexpr (J % 2 == 0)
      lane_probe_stage<L, J, SAME, PP>(pm_a, pp_a, pm_b, pp_b, bm, lane);
    else
      lane_probe_stage<L, J, SAME, PP>(pm_b, pp_b, pm_a, pp_a, bm, lane);
  }

  // Position k's pm + pp, wrapping, into its logical state's row
  // rol6(lane * S + k, stages % 6) of column c (the exchange and the count;
  // a shift-in's words are keyed by rows, not positions).
  __device__ __forceinline__ void store(int* out, size_t w, int c, int stages,
                                        bool live) const {
    const int f = stages % kPass;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int v = add<true>(pm_a[k], static_cast<int>(pp_a[k]));
      if (live) out[rol6(lane * S + k, f) * w + c] = v;
    }
  }
};

// The stage pairs of K14's and K16's input, rs (n_packs, 32, 2, width)
// int32 (stage t's pair at rows 2t, 2t + 1 of an array's column), a pass
// of six read a pass ahead of the stages that take them.  Each load is one
// address from the pass's row pointer and an offset held in a register
// (the stride is the run's width), with no bound test while the next pass
// is whole: K19's OptLanes computes each address and tests each stage.
struct PairPass {
  const int* r;                // the column at row 2 t0 of the running pass
  size_t step;                 // a pass' rows: 2 * 6 * width
  int stages;
  int off[2 * kPass];          // (2 j + k) width: stage t0 + j's value k
  int x[kPass], y[kPass];      // each stage's pair

  __device__ __forceinline__ PairPass(const int* col, int width, int n_stages)
      : r(col), step(static_cast<size_t>(2 * kPass) * width),
        stages(n_stages) {
#pragma unroll
    for (int i = 0; i < 2 * kPass; ++i) off[i] = i * width;
    // every run has at least 32 stages: the first pass is whole
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      x[j] = __ldg(r + off[2 * j]);
      y[j] = __ldg(r + off[2 * j + 1]);
    }
  }
};

// How a pass loads the next one's pairs: all six (the next pass is whole),
// those of stages j < `ahead` (the last whole pass: the tail's), or none.
enum class Ahead { kAll, kSome, kNone };

// Stages t0 + J .. t0 + N - 1 of a pass into `a` (a.stage<J>(bm), phase J),
// each stage's registers then loading the next pass's pair from `next`.
template <int J, int N, Ahead A, typename Arr>
__device__ __forceinline__ void pair_pass(Arr& a, PairPass& in,
                                          const int* next, int ahead) {
  if constexpr (J < N) {
    const int bm = add<true>(in.x[J], in.y[J]);
    if constexpr (A == Ahead::kAll) {
      in.x[J] = __ldg(next + in.off[2 * J]);
      in.y[J] = __ldg(next + in.off[2 * J + 1]);
    } else if constexpr (A == Ahead::kSome) {
      in.x[J] = J < ahead ? __ldg(next + in.off[2 * J]) : 0;
      in.y[J] = J < ahead ? __ldg(next + in.off[2 * J + 1]) : 0;
    }
    a.template stage<J>(bm);
    pair_pass<J + 1, N, A>(a, in, next, ahead);
  }
}

// Every stage of `in` into `a`: passes of six while the next one is whole,
// the last whole pass, then a tail of 0, 2 or 4 stages (32 n_packs % 6).
template <typename Arr>
__device__ __forceinline__ void pair_stages(Arr& a, PairPass& in) {
  int t0 = 0;
#pragma unroll 1
  for (; t0 + 2 * kPass <= in.stages; t0 += kPass) {
    const int* next = in.r + in.step;
    pair_pass<0, kPass, Ahead::kAll>(a, in, next, 0);
    in.r = next;
  }
  const int tail = in.stages - t0 - kPass;  // 0, 2 or 4
  pair_pass<0, kPass, Ahead::kSome>(a, in, in.r + in.step, tail);
  if (tail == 4)
    pair_pass<0, 4, Ahead::kNone>(a, in, nullptr, 0);
  else if (tail == 2)
    pair_pass<0, 2, Ahead::kNone>(a, in, nullptr, 0);
}

// SOFT8's unpack (K13's +unpack, K1's IntReader<8>): stage J of a pass
// reads word J / 2 of the pass, its fields MSB first.
template <int J>
__device__ __forceinline__ Bm soft8_bm(int word) {
  const uint32_t x = static_cast<uint32_t>(word) << (J % 2 ? 16 : 0);
  Bm m;
  int_bm(static_cast<int>(x) >> 24, static_cast<int>(x << 8) >> 24, m);
  return m;
}

// The one place a launch turns a lane count into a template argument:
// returns f(std::integral_constant<int, L>{}) for lanes == L, L one of 1,
// 2, 4, 8, 16 or 32 and at least FIRST (2 where one lane is another
// kernel's), else cudaErrorInvalidValue.
template <int FIRST = 1, typename F>
cudaError_t dispatch_lanes(int lanes, F&& f) {
  static_assert(FIRST == 1 || FIRST == 2, "FIRST is 1 or 2");
  switch (lanes) {
    case 1:
      if constexpr (FIRST == 1) return f(std::integral_constant<int, 1>{});
      break;
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace viterbi
