// The add-compare-select stages of the decode kernels in viterbi.cu.
//   - acs_stage: 64 int32 path metrics, a state a register.  K1, K3 and K4
//     run it on SOFT16 (|bm| reaches 65,536: int16 cannot hold its metrics,
//     as the JAX package's options_valid forbids M_B16 there), and K4 on
//     its unclamped f32 values (they saturate at +-2^31, and its adds wrap
//     as the plain version's int32 adds do); so do the int32 A/B entries
//     (viterbi_k1_i32_launch, _k2_i32_, _k3_i32_).  So do the probes that
//     time it on its own, K12's layout A (layout_probe.cu) and K13's
//     ablation (kernel_ablation.cu), which keep measuring the int32 stage
//     of their JAX scripts, and K23 and K25; K14 and K16 take its wrapping
//     add and sub.
//   - acs_stage16: 32 int16x2 words of path metrics, two neighbouring
//     states a register.  K1 runs it on HARD, SOFT4, SOFT8 and the FP32
//     channel's u/d words, K2 on the FP32 wire, K3 on all five, K4 on
//     HARD, SOFT4 and SOFT8 words and integer values (within the channel's
//     field range, so the words' bounds hold) and K5 on the clamped f32
//     planes (the FP32 wire's bound), at bpp 32 and 16, whatever the metric
//     mode: the metric's width never changes a decision while no metric
//     wraps (tests/test_metric_equiv.py holds that invariant on the JAX
//     side).
//
// The no-wrap bound of acs_stage16.  Let M be the largest |bm| of the
// channel (256 for SOFT8: u = a0 + a1 of two 8-bit fields; 128 for the u/d
// words; 16 for the FP32 wire: the clamp gives r0, r1 in [-8, 7], so u and
// d are trunc of values in [-16, 15], and a NaN truncates to 0; 16 for
// SOFT4, 2 for HARD).  Every state reaches every other in 6 stages, so 6
// stages after any stage t every metric is at least t's best less 6M (the
// path from t's best state) and at most t's best plus 6M: the metrics'
// spread is at most 12M (3,072 for SOFT8; from the zero start it grows by
// at most 2M a stage).  The kernels subtract state 0's metric from all 64
// once a pack (renorm16), so a pack starts with |pm| <= 12M and each of
// its bpp stages moves a metric by at most M: every candidate of the pack
// has |c| <= (12 + bpp) M, at most (12 + 32) * 256 = 11,264 < 32,767
// (kPm16Bound); on the FP32 wire (12 + 32) * 16 = 704 at bpp 32 and
// (12 + 16) * 16 = 448 at bpp 16.  tests/test_torch_k1_int16.py,
// tests/test_torch_k2_k3_int16.py and tests/test_torch_k4_k5_int16.py
// check the largest |c| of the plain versions (core_torch's
// decode_blocks_i16_torch, decode_staged_i16_torch and
// decode_planes_i16_torch) against it.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace viterbi {

constexpr int kStates = 64;

__host__ __device__ constexpr int parity6(int x) {
  return (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4) ^ (x >> 5)) & 1;
}

// +-1 sign of each coded bit on the j=0 branch into the even child 2q: tap
// masks 0o117 & 63 and 0o155 & 63 of the bit-reversed polynomials
// (tpu_viterbi_torch/trellis.py, core_pallas.py _TAP_MASK0/1).
__host__ __device__ constexpr int sign0(int q) {
  return 2 * parity6((2 * q) & (0117 & 63)) - 1;
}
__host__ __device__ constexpr int sign1(int q) {
  return 2 * parity6((2 * q) & (0155 & 63)) - 1;
}

// The four branch metrics a stage can have: u = r0 + r1, d = r0 - r1 and
// their negations nu, nd.  An integer reader sets nu = -u, nd = -d; the
// unclamped f32 reader takes ~u where the conversion saturated, because a
// saturated conversion is not odd (-INT32_MAX != INT32_MIN): the plain
// version, as the JAX core, converts each state's correlation
// trunc(s0*r0 + s1*r1) itself (viterbi.cu's neg_trunc).
struct Bm {
  int u, nu, d, nd;
};

// a + b, a - b and -a, wrapping in two's complement when WRAP (the plain
// version's int32 adds wrap; signed overflow in C++ does not).
template <bool WRAP>
__device__ __forceinline__ int add(int a, int b) {
  if constexpr (WRAP)
    return static_cast<int>(static_cast<uint32_t>(a) +
                            static_cast<uint32_t>(b));
  return a + b;
}
template <bool WRAP>
__device__ __forceinline__ int sub(int a, int b) {
  if constexpr (WRAP)
    return static_cast<int>(static_cast<uint32_t>(a) -
                            static_cast<uint32_t>(b));
  return a - b;
}
template <bool WRAP>
__device__ __forceinline__ int neg(int a) {
  return sub<WRAP>(0, a);
}

// One ACS stage from (pm, pp) into (pm_out, pp_out).  Children 2q and 2q+1
// share the predecessors q and q+32 and see negated branch metrics:
//   E = max(pm[q] + bm, pm[q+32] - bm),  O = max(pm[q] + bmo, pm[q+32] - bmo)
// with bmo the negation of bm, and a strict '>' so the j=0 branch wins
// ties; the survivor register becomes 2*pp[q] or 2*pp[q+32]+1
// (core_pallas.py:396-435).  bm is +-u where the two coded bits have the
// same sign, else +-d.
template <bool WRAP>
__device__ __forceinline__ void acs_stage(const int (&pm)[kStates],
                                          const uint32_t (&pp)[kStates],
                                          int (&pm_out)[kStates],
                                          uint32_t (&pp_out)[kStates],
                                          const Bm& m) {
#pragma unroll
  for (int q = 0; q < kStates / 2; ++q) {
    const bool same = sign0(q) == sign1(q);
    const bool pos = sign0(q) > 0;
    const int bm = same ? (pos ? m.u : m.nu) : (pos ? m.d : m.nd);
    const int bmo = same ? (pos ? m.nu : m.u) : (pos ? m.nd : m.d);
    const int lo = pm[q];
    const int hi = pm[q + 32];
    const int c0e = add<WRAP>(lo, bm), c1e = sub<WRAP>(hi, bm);
    const int c0o = add<WRAP>(lo, bmo), c1o = sub<WRAP>(hi, bmo);
    const bool de = c1e > c0e;
    const bool dodd = c1o > c0o;
    pm_out[2 * q] = de ? c1e : c0e;
    pm_out[2 * q + 1] = dodd ? c1o : c0o;
    const uint32_t from_lo = pp[q] << 1;
    const uint32_t from_hi = (pp[q + 32] << 1) | 1u;
    pp_out[2 * q] = de ? from_hi : from_lo;
    pp_out[2 * q + 1] = dodd ? from_hi : from_lo;
  }
}

// --- int16x2 path metrics (K1-K5) ---

// The largest |candidate metric| of acs_stage16 with renorm16 once a pack
// of 32 stages on SOFT8, the widest channel that takes it (the header's
// bound); core_torch.PM16_BOUND is the same number.
constexpr int kPm16Bound = (12 + 32) * 256;
static_assert(kPm16Bound <= 32767, "int16 metrics would wrap");

// Which of u, nu, d, nd (0..3) is butterfly q's bm (acs_stage's choice).
__host__ __device__ constexpr int bm_code(int q) {
  return sign0(q) == sign1(q) ? (sign0(q) > 0 ? 0 : 1)
                              : (sign0(q) > 0 ? 2 : 3);
}

// The int16x2 pair (bm(2j), bm(2j + 1)) of word pair j is one of four:
// 0 (nu, d), 1 (u, nd), 2 (nd, u), 3 (d, nu); pair k ^ 1 is pair k's
// negation.  -1 where it is none of them (the static_assert below rules
// that out for this code).
__host__ __device__ constexpr int bm_pair(int j) {
  const int lo = bm_code(2 * j), hi = bm_code(2 * j + 1);
  return lo == 1 && hi == 2   ? 0
         : lo == 0 && hi == 3 ? 1
         : lo == 3 && hi == 0 ? 2
         : lo == 2 && hi == 1 ? 3
                              : -1;
}
__host__ __device__ constexpr bool bm_pairs_closed() {
  for (int j = 0; j < kStates / 4; ++j)
    if (bm_pair(j) < 0) return false;
  return true;
}
static_assert(bm_pairs_closed(), "a word pair's bm is not one of four pairs");

// (lo, hi) -> the int16x2 word of their low halves.
__device__ __forceinline__ uint32_t pair16(int lo, int hi) {
  return __byte_perm(static_cast<uint32_t>(lo), static_cast<uint32_t>(hi),
                     0x5410);
}

// One ACS stage on int16x2 metrics: pm[k] holds states (2k, 2k + 1), so
// for word pair j = 0..15, L = pm[j] holds the lo predecessors of
// butterflies q = 2j, 2j + 1 and H = pm[16 + j] their hi ones, and with B
// the pair bm_pair(j) (its negation nB):
//   E = max(L + B, H + nB): children 2q of q = 2j (low half), 2j + 1 (high)
//   O = max(L + nB, H + B): children 2q + 1
// each add one VIADD.16x2, each max one VIMNMX.S16x2 that also gives c0 >=
// c1 per half, the negation of acs_stage's strict c1 > c0, so the j=0
// branch keeps winning ties.  The children of q = 2j are states 4j, 4j + 1
// and of 2j + 1 states 4j + 2, 4j + 3: the next words are the low halves
// and the high halves of (E, O), one PRMT each (the JAX merge interleave).
// Survivors stay 64 uint32 registers, selected as acs_stage selects them.
// The adds wrap in int16: the caller keeps the metrics under kPm16Bound.
__device__ __forceinline__ void acs_stage16(const uint32_t (&pm)[kStates / 2],
                                            const uint32_t (&pp)[kStates],
                                            uint32_t (&pm_out)[kStates / 2],
                                            uint32_t (&pp_out)[kStates],
                                            const Bm& m) {
  const uint32_t pair[4] = {pair16(m.nu, m.d), pair16(m.u, m.nd),
                            pair16(m.nd, m.u), pair16(m.d, m.nu)};
#pragma unroll
  for (int j = 0; j < kStates / 4; ++j) {
    const uint32_t b = pair[bm_pair(j)], nb = pair[bm_pair(j) ^ 1];
    const uint32_t l = pm[j], h = pm[kStates / 4 + j];
    bool ge_e1, ge_e0, ge_o1, ge_o0;  // c0 >= c1 of q = 2j + 1, 2j
    const uint32_t e =
        __vibmax_s16x2(__vadd2(l, b), __vadd2(h, nb), &ge_e1, &ge_e0);
    const uint32_t o =
        __vibmax_s16x2(__vadd2(l, nb), __vadd2(h, b), &ge_o1, &ge_o0);
    pm_out[2 * j] = __byte_perm(e, o, 0x5410);
    pm_out[2 * j + 1] = __byte_perm(e, o, 0x7632);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = 2 * j + k;
      const bool ge_e = k ? ge_e1 : ge_e0, ge_o = k ? ge_o1 : ge_o0;
      const uint32_t from_lo = pp[q] << 1;
      const uint32_t from_hi = (pp[q + 32] << 1) | 1u;
      pp_out[2 * q] = ge_e ? from_lo : from_hi;
      pp_out[2 * q + 1] = ge_o ? from_lo : from_hi;
    }
  }
}

// Subtract state 0's metric from all 64 (decision-invariant): 1 PRMT and
// 32 VIADD.16x2 a pack.
__device__ __forceinline__ void renorm16(uint32_t (&pm)[kStates / 2]) {
  const uint32_t neg0 = __byte_perm(0u - pm[0], 0u, 0x1010);  // (-pm0, -pm0)
#pragma unroll
  for (int k = 0; k < kStates / 2; ++k) pm[k] = __vadd2(pm[k], neg0);
}

__device__ __forceinline__ void int_bm(int a0, int a1, Bm& m) {
  m.u = a0 + a1;
  m.d = a0 - a1;
  m.nu = -m.u;
  m.nd = -m.d;
}

}  // namespace viterbi
