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
// address, as in the JAX probe, does not depend on the state.  At one lane
// an array the design is K1's shape (64 threads a block, 64 metrics and
// survivors in registers, a loop of two stages whose next input loads
// while it runs), so that the variants differ from K1 and from each other
// in the ACS alone.  full and pp_noshuf give both children of a pair the
// same path metric, so ptxas keeps only the distinct values: fewer
// instructions than the ACS, which the probe reads from the SASS.
//
// What the design does about it: each array is split over `lanes` L of a warp
// (2-32; the wrapper picks L from the array count), each variant keeping its
// construct.  The forward variants run all 64 states a stage, S = 64 / L a
// lane, in place, as lanes.cuh lays it out (lane_probe_stage), in a loop of
// six-stage passes whose input loads a pass ahead (PairPass): full and
// pp_noshuf with SAME (the position holding hi adds -bm to itself, +bm to its
// partner), eo and decbits with +bm everywhere (K19's i32_split); the tie
// rule turns with the position's x bit.  full and eo exchange their survivors
// with the partner (lane_survivor).  pp_noshuf's and decbits' survivors are
// keyed by fixed rows, which the rotation that moves pm does not move: each
// position shifts its stage's bit into a word in place (no exchange, the
// one-lane construct), and the end puts each row's word back together from
// the six positions that held its key (store_rows: the block's shared memory,
// six loads a row, once).  After T stages row rol6(P, T % 6) gets position
// P's metric.  bit_tb splits the stage range: each lane chases and sums its
// span of T / L stages from state 0, and log2 L shuffle rounds join the
// spans, the sums added and the states composed as one shift register
// (chase_lanes).  Blocks of 64 threads hold 64 / L arrays.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "build_part.cuh"
#include "lanes.cuh"

// Build parts (build_part.cuh): part 0 holds full, bit_tb and the entry
// point, part 1 pp_noshuf and decbits, part 2 eo, each variant at every
// lane count.
// nvcc parts: 3

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

// --- the lane-split layouts (lanes >= 2) ---

using viterbi::kPass;
using viterbi::LanePp;
using viterbi::rol6;

// A forward variant's lane (lanes.cuh): full SAME with the exchange,
// pp_noshuf SAME with the shift-in, eo the exchange, decbits the shift-in.
template <int V, int L>
using AcsLane = viterbi::ProbeLane<
    L, V <= 1, V % 2 == 0 ? LanePp::kExchange : LanePp::kShiftIn>;

// pp_noshuf's (PAIR) and decbits' rows from a lane's shifted-in words.  At
// stage t position P shifted in the decision of the row its logical state
// rol6(P, t % 6) keys: decbits' row of that state (the even child's
// decision where it holds q, the odd child's where it holds q + 32);
// pp_noshuf's rows 2q and 2q + 1 of its pair q, which both positions of the
// pair hold.  Row s's word, bit j from stage T - 1 - j in phase f = (T - 1
// - j) % 6, comes from the position that held s's key (s, or s / 2 for
// pp_noshuf) in phase f: ror6(key, f) = rol6(key, 6 - f).  tile: the
// array's 64 words in the block's shared memory.
template <int L, bool PAIR, typename Lane>
__device__ __forceinline__ void store_rows(const Lane& a, uint32_t* tile,
                                           int* out, size_t w, int c,
                                           int stages, bool live) {
  constexpr int S = kStates / L;
#pragma unroll
  for (int k = 0; k < S; ++k) tile[a.lane * S + k] = a.pp_a[k];
  __syncwarp();
  uint32_t mask[kPass];  // the bits j < 32 of phase f: j = T - 1 - f mod 6
#pragma unroll
  for (int f = 0; f < kPass; ++f)
    mask[f] = 0x41041041u << ((stages - 1 - f) % kPass);
  const int F = stages % kPass;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int s = rol6(a.lane * S + k, F);
    const int key = PAIR ? s >> 1 : s;
    uint32_t pp = 0u;
#pragma unroll
    for (int f = 0; f < kPass; ++f)
      pp |= tile[rol6(key, (kPass - f) % kPass)] & mask[f];
    const int v = add<true>(a.pm_a[k], static_cast<int>(pp));
    if (live) out[s * w + c] = v;
  }
}

// bit_tb over L lanes: lane l chases stages [l n, (l + 1) n), n = T / L,
// from state 0 and sums their packs, as the one-lane loop does.  The sums
// add, wrapping; the states compose as one shift register: a span of n
// stages run from state s0 leaves (s0 >> n) | the span's own state (s0
// shifted out after 6 stages), so round k (k = 1, 2, 4, ...) joins lanes l
// and l ^ k, each a span of n k stages, the earlier one's state shifted.
// Every lane ends with the array's acc + state and writes 64 / L rows.
template <int L>
__device__ __forceinline__ void chase_lanes(const int* r, int* out,
                                            size_t w, int c, int lane,
                                            int n_packs, bool live) {
  const int n = n_packs * kBpp / L, t0 = lane * n;
  int state = 0, acc = 0, p = t0 % n_packs;  // p = t % n_packs
#pragma unroll 1
  for (int t = t0; t < t0 + n; ++t) {
    const int s = t % kBpp;
    const int pack = __ldg(r + static_cast<size_t>(2 * (p * kBpp + s)) * w);
    const int d = (pack >> (31 - s)) & 1;
    state = (state >> 1) | (d << 5);
    acc = add<true>(acc, pack);
    p = p + 1 == n_packs ? 0 : p + 1;
  }
#pragma unroll
  for (int k = 1; k < L; k *= 2) {
    const int acc_p = __shfl_xor_sync(viterbi::kFull, acc, k);
    const int state_p = __shfl_xor_sync(viterbi::kFull, state, k);
    const bool later = lane & k;
    const int first = later ? state_p : state;
    const int second = later ? state : state_p;
    const int shift = n * k;  // the later span's stages
    acc = add<true>(acc, acc_p);
    state = (shift >= 6 ? 0 : first >> shift) | second;
  }
  const int v = add<true>(acc, state);
#pragma unroll
  for (int k = 0; k < kStates / L; ++k)
    if (live) out[(k * L + lane) * w + c] = v;
}

template <int V, int L>
__global__ void __launch_bounds__(kThreads)
acs_lanes_kernel(const int* __restrict__ rs, int* __restrict__ out,
                 int n_packs, int width) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int c = i / L, lane = i % L;
  // a ragged last block's spare arrays run on the last column, store
  // nothing, and keep their warps whole for the shuffles
  const bool live = c < width;
  const int* r = rs + (live ? c : width - 1);
  const size_t w = static_cast<size_t>(width);
  const int stages = n_packs * kBpp;
  if constexpr (V == 4) {
    chase_lanes<L>(r, out, w, c, lane, n_packs, live);
  } else {
    viterbi::PairPass in(r, width, stages);
    AcsLane<V, L> a(lane);
    viterbi::pair_stages(a, in);
    if constexpr (V % 2 == 0) {
      a.store(out, w, c, stages, live);
    } else {
      __shared__ uint32_t tile[kThreads / L][kStates];
      store_rows<L, V == 1>(a, tile[threadIdx.x / L], out, w, c, stages,
                            live);
    }
  }
}

template <int V, int L>
cudaError_t launch(const int* rs, int* out, int n_packs, int width,
                   cudaStream_t stream) {
  if constexpr (L == 1) {
    acs_kernel<V><<<(width + kThreads - 1) / kThreads, kThreads, 0,
                    stream>>>(rs, out, n_packs, width);
  } else {
    acs_lanes_kernel<V, L>
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
    case 4: return launch_variant<4>(n, rs, out, n_packs, width, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif
#if IN_PART(1)
cudaError_t launch_part1(int v, int n, const int* rs, int* out, int n_packs,
                         int width, cudaStream_t s) {
  switch (v) {
    case 1: return launch_variant<1>(n, rs, out, n_packs, width, s);
    case 3: return launch_variant<3>(n, rs, out, n_packs, width, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif
#if IN_PART(2)
cudaError_t launch_part2(int v, int n, const int* rs, int* out, int n_packs,
                         int width, cudaStream_t s) {
  return v == 2 ? launch_variant<2>(n, rs, out, n_packs, width, s)
                : cudaErrorInvalidValue;
}
#endif

}  // namespace viterbi_acs_variants

using namespace viterbi_acs_variants;

#if IN_PART(0)
// Launch variant `variant` (0 full, 1 pp_noshuf, 2 eo, 3 decbits, 4 bit_tb)
// split over `lanes` (1, 2, 4, 8, 16 or 32) lanes an array on rs, (n_packs,
// 32, 2, width) int32, into out, (64, width) int32.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k14_launch(int variant, const void* rs, void* out,
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
    case 4: return static_cast<int>(launch_part0(variant, lanes, r, o,
                                                 n_packs, width, s));
    case 1:
    case 3: return static_cast<int>(launch_part1(variant, lanes, r, o,
                                                 n_packs, width, s));
    case 2: return static_cast<int>(launch_part2(variant, lanes, r, o,
                                                 n_packs, width, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif  // IN_PART(0)
