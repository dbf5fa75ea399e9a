// The add-compare-select stage of the decode kernels (K1-K5 in
// viterbi.cu), shared with the probes that time it on its own: K12's layout
// A (layout_probe.cu) and K13's ablation (kernel_ablation.cu) run this very
// stage body, so what they measure is K1's.
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
// unclamped f32 reader converts -u and -d on their own, because a
// saturated conversion is not odd (-INT32_MAX != INT32_MIN): the plain
// version, as the JAX core, converts each state's correlation
// trunc(s0*r0 + s1*r1) itself.
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

__device__ __forceinline__ void int_bm(int a0, int a1, Bm& m) {
  m.u = a0 + a1;
  m.d = a0 - a1;
  m.nu = -m.u;
  m.nd = -m.d;
}

}  // namespace viterbi
