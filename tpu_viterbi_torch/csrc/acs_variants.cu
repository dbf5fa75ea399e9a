// Kernel K14: ACS variants and the bit-granular traceback, each on its own.
// Replaces the TPU probe kernels of scripts/acs_variants_bench.py:
// make_fwd_kernel (:44) and make_tb_kernel (:108), launched by run at :132.
//
// Input rs: (n_packs, 32, 2, width) int32; column c is one array, stage t =
// 32 p + s reads bm = rs[p, s, 0, c] + rs[p, s, 1, c].  pm and pp start at
// zero; out (64, width) = pm + pp after n_packs x 32 stages, wrapping.  The
// JAX variants, each with its own arithmetic (q = 0..31, L = pm[q], H =
// pm[q + 32], the same bm for every state):
//   0 full       both children 2q, 2q+1 of the JAX kernel's rep2 rows:
//                dec = H - bm > L + bm, pm = the larger, pp = (pp[dec ? q +
//                32 : q] << 1) | dec, the register exchange
//   1 pp_noshuf  pm as full; pp[i] = (pp[i] << 1) | dec(i / 2), no exchange
//   2 eo         the true even/odd children: e = max(L + bm, H - bm) at row
//                2q, o = max(L - bm, H + bm) at row 2q + 1, pp by the
//                exchange with each child's own decision
//   3 decbits    pm as eo; pp[q] = (pp[q] << 1) | dec_e(q) and pp[q + 32] =
//                (pp[q + 32] << 1) | dec_o(q): decision bits, no exchange
//   4 bit_tb     the chase alone: for t < n_packs x 32, pack = rs[t % n_packs,
//                t % 32, 0, c], d = bit 31 - t % 32 of it, state = (state >>
//                1) | (d << 5), acc += pack; every row of out is acc + state
// The TPU kernel's merge and rep2 interleaves are register renaming here:
// the kernel computes the same output with no relayout.  The plain PyTorch
// version is acs_variants_torch in
// tpu_viterbi_torch/scripts/acs_variants_bench.py; each variant agrees with
// it bit for bit.
//
// What bounds it: the forward variants' issue (2 adds, a max and a select a
// state, 256 operations an array-stage), at one thread an array with few
// warps a scheduler their dependency latency; bit_tb's load a stage, whose
// address, as in the JAX probe, does not depend on the state.  What the
// design does about it: K1's shape (64 threads a block, 64 metrics and
// survivors in registers, a loop of two stages whose next input loads while
// it runs), so that the variants differ from K1 and from each other in the
// ACS alone.  full and pp_noshuf give both children of a pair the same path
// metric, so ptxas keeps only the distinct values: fewer instructions than
// the ACS, which the probe reads from the SASS.

#include <cuda_runtime.h>

#include <cstdint>

#include "acs.cuh"

namespace viterbi_acs_variants {

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
  for (int q = 0; q < kStates / 2; ++q) {
    const int lo = pm[q], hi = pm[q + 32];
    if constexpr (V <= 1) {
      const int c0 = add<true>(lo, bm), c1 = sub<true>(hi, bm);
      const bool dec = c1 > c0;
      const uint32_t b = dec ? 1u : 0u;
      pmo[2 * q] = pmo[2 * q + 1] = dec ? c1 : c0;
      if constexpr (V == 0) {
        ppo[2 * q] = ppo[2 * q + 1] = ((dec ? pp[q + 32] : pp[q]) << 1) | b;
      } else {
        ppo[2 * q] = (pp[2 * q] << 1) | b;
        ppo[2 * q + 1] = (pp[2 * q + 1] << 1) | b;
      }
    } else {
      const int c0e = add<true>(lo, bm), c1e = sub<true>(hi, bm);
      const int c0o = sub<true>(lo, bm), c1o = add<true>(hi, bm);
      const bool de = c1e > c0e, dod = c1o > c0o;
      const uint32_t be = de ? 1u : 0u, bo = dod ? 1u : 0u;
      pmo[2 * q] = de ? c1e : c0e;
      pmo[2 * q + 1] = dod ? c1o : c0o;
      if constexpr (V == 2) {
        ppo[2 * q] = ((de ? pp[q + 32] : pp[q]) << 1) | be;
        ppo[2 * q + 1] = ((dod ? pp[q + 32] : pp[q]) << 1) | bo;
      } else {
        ppo[q] = (pp[q] << 1) | be;
        ppo[q + 32] = (pp[q + 32] << 1) | bo;
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
acs_kernel(const int* __restrict__ rs, int* __restrict__ out, int n_packs,
           int width) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  const int* r = rs + c;  // stage t's pair at rows 2t, 2t + 1 of width
  const size_t w = static_cast<size_t>(width);
  const int stages = n_packs * kBpp;
  int v[kStates];
  if constexpr (V == 4) {
    int state = 0, acc = 0, p = 0;  // p = t % n_packs
#pragma unroll 1
    for (int t = 0; t < stages; ++t) {
      const int s = t % kBpp;
      const int pack = __ldg(r + static_cast<size_t>(2 * (p * kBpp + s)) * w);
      const int d = (pack >> (31 - s)) & 1;
      state = (state >> 1) | (d << 5);
      acc = add<true>(acc, pack);
      p = p + 1 == n_packs ? 0 : p + 1;
    }
#pragma unroll
    for (int i = 0; i < kStates; ++i) v[i] = add<true>(acc, state);
  } else {
    int pm_a[kStates], pm_b[kStates];
    uint32_t pp_a[kStates], pp_b[kStates];
#pragma unroll
    for (int i = 0; i < kStates; ++i) {
      pm_a[i] = 0;
      pp_a[i] = 0u;
    }
    // the next two stages' pairs load while the ACS runs, as K1's reader
    // runs a word ahead
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
      v[i] = add<true>(pm_a[i], static_cast<int>(pp_a[i]));
  }
#pragma unroll
  for (int i = 0; i < kStates; ++i) out[i * w + c] = v[i];
}

template <int V>
cudaError_t launch(const int* rs, int* out, int n_packs, int width,
                   cudaStream_t stream) {
  acs_kernel<V><<<(width + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      rs, out, n_packs, width);
  return cudaGetLastError();
}

}  // namespace viterbi_acs_variants

using namespace viterbi_acs_variants;

// Launch variant `variant` (0 full, 1 pp_noshuf, 2 eo, 3 decbits, 4 bit_tb)
// on rs, (n_packs, 32, 2, width) int32, into out, (64, width) int32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k14_launch(int variant, const void* rs, void* out,
                                  int n_packs, int width, void* stream) {
  const int* r = static_cast<const int*>(rs);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_packs <= 0 || width <= 0 || rs == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(r, o, n_packs, width, s));
    case 1: return static_cast<int>(launch<1>(r, o, n_packs, width, s));
    case 2: return static_cast<int>(launch<2>(r, o, n_packs, width, s));
    case 3: return static_cast<int>(launch<3>(r, o, n_packs, width, s));
    case 4: return static_cast<int>(launch<4>(r, o, n_packs, width, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
