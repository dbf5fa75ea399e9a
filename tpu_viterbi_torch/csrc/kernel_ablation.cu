// Kernel K13: K1 built up piece by piece, the ablation probe.  Replaces the
// TPU probe kernel scripts/kernel_ablation.py:_kernel (:71, launched by
// time_variant at :162).
//
// A program is n_packs (16, 128) int32 word blocks of `words`; each of its
// 128 columns is one time-block (array) of 64 states, with pm and pp
// starting at zero and n_packs x 32 stages.  Each variant adds one piece:
//   0 body        bm from raw rows: stage s of every pack reads u = row s
//                 of packs 0-1 and d = row s of packs 2-3 (JAX :74-78)
//   1 +unpack     SOFT8 word mode: stage s of pack p unpacks word s / 2 of
//                 block p, fields MSB first (the JAX probe's _make_ud_soft8,
//                 K1's IntReader<8>)
//   2 +dump       the survivor store: pp, unmasked, after every pack, into
//                 the (n_packs, 64, arrays) device store laid out as K1's
//   3 +traceback  the chase from state 0 down the store, next state =
//                 (pack >> 26) & 63: output row kp - 1 gets the pack of kp
//                 for kp = n_packs - 2 .. 1, and row n_packs - 2, which the
//                 JAX kernel never writes, gets 0
//   4 +tb(bisect) the same chase, each pack chosen by a select tree (JAX
//                 :102-108): the array loads all 64 words of its column of
//                 pack kp, addresses that do not depend on the state, then
//                 halves them 6 times on the state's bits 5 .. 0.  Its
//                 output equals +traceback's.
// Output: (programs, 1, 128) = (pm + pp)[0] per program, or (programs,
// n_packs - 1, 128) with +traceback.  The stage is K1's acs_stage (acs.cuh),
// wrapping.  The plain PyTorch version is ablation_torch in
// tpu_viterbi_torch/scripts/kernel_ablation.py; each variant agrees with it
// bit for bit at every lane count, the store too.
//
// What bounds it: the ACS' issue, as K1's (256 operations an array-stage);
// the dump writes 256 bytes an array a pack, 134 MB at the JAX shape: 0.04
// ms at the memory rate against the ACS' 0.13 ms of issue.  At one thread
// an array (lanes = 1, K1's layout piece for piece: 64 CUDA threads a
// block, a loop of two stages whose next input loads while it runs, the
// store's 32 neighbouring arrays a warp written as one coalesced row) the
// JAX shape's 2,048 arrays run 32 CTAs on 132 SMs, each warp paced by its
// ACS chain's latency.  The bisect trades +traceback's one load a pack,
// whose address waits for the last one, for 64 loads a pack that can all
// be in flight, and 63 selects.
//
// What the design does about it: each array is split over `lanes` L of a
// warp (2-32; the wrapper picks L from the array count), in place, as
// lanes.cuh lays it out: K25's stage loop of six-stage passes, its
// lane_stage and its SOFT8 unpack, the body's rows loaded a pass ahead.  A
// pack ends after stage 31 mod 32, always at an odd stage of a pass, whose
// result is in (pm_a, pp_a) and whose next phase f is 2, 4 or 0 in turn:
// position P holds logical state rol6(P, f), so the dump writes each
// lane's S survivors to those rows.  They go through shared memory: a CUDA
// block holds at least 8 arrays (128 or 8 L threads), and between two
// barriers its threads write the block's 64 rows, 8 or more adjacent
// arrays each, so every row covers whole 32-byte sectors.  (On the H100,
// in turns, neither a double-buffered tile with one barrier a pack nor
// stores straight from the registers, a row a lane, ran the dump faster
// at 16 and 32 lanes; which of the three led moved with each build's
// register allocation.)  The store ends in natural order, so the chase
// does not depend on the layout: every lane of an array follows it (one
// request a load), lane 0 writes.  The bisect spreads a pack's 64
// loads over the array's lanes, 64 / L each, selects on the state's low
// bits inside a lane and takes the lane its high bits name with one
// __shfl_sync, with no branch on a lane's bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "acs.cuh"
#include "lanes.cuh"

namespace viterbi_ablation {

using viterbi::Bm;
using viterbi::kFull;
using viterbi::kPass;
using viterbi::kStates;
using viterbi::lane_stage;
using viterbi::log2_of;
using viterbi::rol6;
using viterbi::soft8_bm;

constexpr int kCols = 128;   // arrays of a program
constexpr int kWpp = 16;     // SOFT8 words of a 32-stage pack
constexpr int kThreads = 64; // K1's CUDA block

// The body's branch metrics of stage s: u = row s of packs 0-1, d = row s
// of packs 2-3, raw.
__device__ __forceinline__ Bm raw_bm(const int* w, int s) {
  Bm m;
  m.u = __ldg(w + s * kCols);
  m.d = __ldg(w + (32 + s) * kCols);
  m.nu = viterbi::neg<true>(m.u);
  m.nd = viterbi::neg<true>(m.d);
  return m;
}

// One level of the bisect's select tree: x[0 .. H) = the upper or lower
// half of x[0 .. 2H) by the state's bit log2(H).  H is a template argument
// so that every index is a constant and x stays in registers.
template <int H, int N>
__device__ __forceinline__ void halve(uint32_t (&x)[N], int state) {
  const bool hi = (state / H) & 1;
#pragma unroll
  for (int j = 0; j < H; ++j) x[j] = hi ? x[H + j] : x[j];
}

// The levels H, H / 2, ..., 1: x[0] = x[state % 2H].
template <int H, int N>
__device__ __forceinline__ void halve_down(uint32_t (&x)[N], int state) {
  if constexpr (H >= 1) {
    halve<H>(x, state);
    halve_down<H / 2>(x, state);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
ablation_kernel(const int* __restrict__ words, uint32_t* __restrict__ surv,
                int* __restrict__ out, int programs, int n_packs) {
  constexpr bool kUnpack = V >= 1, kDump = V >= 2, kTrace = V >= 3;
  constexpr bool kBisect = V == 4;
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
  // the next two stages' input loads while the ACS runs, as K1's reader
  // runs a word ahead: the next word (+unpack) or the next rows (body)
  const int n_words = n_packs * kWpp;
  int next = 0;
  uint32_t wd = static_cast<uint32_t>(__ldg(w));
  Bm r0 = raw_bm(w, 0), r1 = raw_bm(w, 1);
  for (int p = 0; p < n_packs; ++p) {
#pragma unroll 1
    for (int t = 0; t < 32; t += 2) {
      Bm m0, m1;
      if constexpr (kUnpack) {
        viterbi::int_bm(static_cast<int>(wd) >> 24,
                        static_cast<int>(wd << 8) >> 24, m0);
        viterbi::int_bm(static_cast<int>(wd << 16) >> 24,
                        static_cast<int>(wd << 24) >> 24, m1);
        ++next;
        wd = next < n_words ? static_cast<uint32_t>(__ldg(w + next * kCols))
                            : 0u;
      } else {
        m0 = r0;
        m1 = r1;
        r0 = raw_bm(w, (t + 2) % 32);
        r1 = raw_bm(w, (t + 3) % 32);
      }
      viterbi::acs_stage<true>(pm_a, pp_a, pm_b, pp_b, m0);
      viterbi::acs_stage<true>(pm_b, pp_b, pm_a, pp_a, m1);
    }
    if constexpr (kDump) {
      uint32_t* dst = surv + static_cast<size_t>(p) * kStates * arrays + i;
#pragma unroll
      for (int s = 0; s < kStates; ++s)
        dst[static_cast<size_t>(s) * arrays] = pp_a[s];
    }
  }
  if constexpr (kTrace) {
    const int n_emit = n_packs - 1;
    int* o = out + static_cast<size_t>(g) * n_emit * kCols + l;
    int state = 0;
    for (int k = 0; k < n_emit; ++k) {
      const int kp = n_packs - 1 - k;
      uint32_t pack;
      if constexpr (kBisect) {
        const uint32_t* col = surv + static_cast<size_t>(kp) * kStates * arrays
                              + i;
        uint32_t x[kStates];
#pragma unroll
        for (int s = 0; s < kStates; ++s)
          x[s] = col[static_cast<size_t>(s) * arrays];
        halve<32>(x, state);
        halve<16>(x, state);
        halve<8>(x, state);
        halve<4>(x, state);
        halve<2>(x, state);
        halve<1>(x, state);
        pack = x[0];
      } else {
        pack = surv[(static_cast<size_t>(kp) * kStates + state) * arrays + i];
      }
      if (k >= 1) o[(kp - 1) * kCols] = static_cast<int>(pack);
      state = static_cast<int>((pack >> 26) & 63u);
    }
    o[(n_emit - 1) * kCols] = 0;
  } else {
    out[static_cast<size_t>(g) * kCols + l] =
        static_cast<int>(static_cast<uint32_t>(pm_a[0]) + pp_a[0]);
  }
}

// --- the lane-split layout (lanes >= 2, lanes.cuh) ---

// The lane-split kernels' CUDA block: 128 threads, and at least 8 arrays
// (8 L threads) so that the dump's rows cover whole 32-byte sectors.
template <int L>
__host__ __device__ constexpr int lane_block() {
  return 8 * L > 128 ? 8 * L : 128;
}

// One array's lane: its S = 64 / L positions, double-buffered, the input of
// the next pass of the stage loop, and where its dump goes.
template <int V, int L>
struct AblationLanes {
  static constexpr int S = kStates / L;
  static constexpr bool kUnpack = V >= 1, kDump = V >= 2;
  static constexpr int kArrays = lane_block<L>() / L;  // arrays a block

  const int* w;
  int n_words, lane;
  uint32_t flips;
  int pm_a[S], pm_b[S];
  uint32_t pp_a[S], pp_b[S];
  int pw[kPass / 2];        // +unpack: the pass's words
  int ru[kPass], rd[kPass]; // body: each stage's raw u and d
  uint32_t* surv;           // +dump: the store,
  uint32_t (*tile)[kArrays + 1];  // the block's staging rows,
  int arrays, a_local, a_first;   // the array's column in both

  __device__ __forceinline__ AblationLanes(const int* col, int n_packs,
                                           int ln, uint32_t* store,
                                           uint32_t (*rows)[kArrays + 1],
                                           int n_arrays)
      : w(col), n_words(n_packs * kWpp), lane(ln), flips(0u), surv(store),
        tile(rows), arrays(n_arrays), a_local(threadIdx.x / L),
        a_first(blockIdx.x * kArrays) {
    viterbi::add_lane_flips<L>(lane, flips);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      pm_a[s] = 0;
      pp_a[s] = 0u;
    }
#pragma unroll
    for (int k = 0; k < kPass / 2; ++k) pw[k] = kUnpack ? load(k) : 0;
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      ru[j] = kUnpack ? 0 : row(j, 0);
      rd[j] = kUnpack ? 0 : row(j, 32);
    }
  }

  __device__ __forceinline__ int load(int idx) const {
    return idx < n_words ? __ldg(w + idx * kCols) : 0;
  }
  // body: row (t mod 32) + base of the program's first packs (u base 0,
  // d base 32)
  __device__ __forceinline__ int row(int t, int base) const {
    return __ldg(w + ((t & 31) + base) * kCols);
  }

  // Stage t0 + J, phase J (t0 % 6 == 0); AHEAD: then load the next pass's
  // input into the register this stage has read.
  template <int J, bool AHEAD>
  __device__ __forceinline__ void stage(int t0) {
    Bm m;
    if constexpr (kUnpack) {
      m = soft8_bm<J>(pw[J / 2]);
      if constexpr (AHEAD && J % 2 == 1)
        pw[J / 2] = load((t0 + kPass) / 2 + J / 2);
    } else {
      m.u = ru[J];
      m.d = rd[J];
      m.nu = viterbi::neg<true>(m.u);
      m.nd = viterbi::neg<true>(m.d);
      if constexpr (AHEAD) {
        ru[J] = row(t0 + kPass + J, 0);
        rd[J] = row(t0 + kPass + J, 32);
      }
    }
    if constexpr (J % 2 == 0) {
      lane_stage<L, J>(pm_a, pp_a, pm_b, pp_b, m, flips, lane);
    } else {
      lane_stage<L, J>(pm_b, pp_b, pm_a, pp_a, m, flips, lane);
      // the same for the whole block: no thread skips the barriers
      if constexpr (kDump)
        if (((t0 + J) & 31) == 31) dump<(J + 1) % kPass>((t0 + J) >> 5);
    }
  }

  // Pack p's survivors, in (pp_a) with the next stage in phase F, into
  // rows rol6(P, F) of the store, through the block's tile.
  template <int F>
  __device__ __forceinline__ void dump(int p) {
    __syncthreads();  // the last pack's rows have left the tile
    const int base = rol6(lane * S, F);
#pragma unroll
    for (int r = 0; r < S; ++r) tile[base | rol6(r, F)][a_local] = pp_a[r];
    __syncthreads();
    // the block's 64 x kArrays words, S a thread, a warp on whole rows
    uint32_t* dst = surv + static_cast<size_t>(p) * kStates * arrays +
                    a_first;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int e = k * lane_block<L>() + static_cast<int>(threadIdx.x);
      const int rw = e / kArrays, cl = e % kArrays;
      dst[static_cast<size_t>(rw) * arrays + cl] = tile[rw][cl];
    }
  }

  template <int J, int N, bool AHEAD>
  __device__ __forceinline__ void stages(int t0) {
    if constexpr (J < N) {
      stage<J, AHEAD>(t0);
      stages<J + 1, N, AHEAD>(t0);
    }
  }
};

template <int V, int L>
__global__ void __launch_bounds__(lane_block<L>())
ablation_lanes_kernel(const int* __restrict__ words,
                      uint32_t* __restrict__ surv, int* __restrict__ out,
                      int programs, int n_packs) {
  constexpr bool kTrace = V >= 3, kBisect = V == 4;
  constexpr int S = kStates / L, kArrays = lane_block<L>() / L;
  __shared__ uint32_t tile[V >= 2 ? kStates : 1][kArrays + 1];
  const int arrays = programs * kCols;
  const int i = blockIdx.x * lane_block<L>() + threadIdx.x;
  const int a = i / L, lane = i % L;
  const int g = a / kCols, l = a % kCols;
  AblationLanes<V, L> arr(
      words + static_cast<size_t>(g) * n_packs * kWpp * kCols + l, n_packs,
      lane, surv, tile, arrays);
  const int stages = n_packs * 32;
  int t0 = 0;
#pragma unroll 1
  for (; t0 + kPass <= stages; t0 += kPass)
    arr.template stages<0, kPass, true>(t0);
  // 32 n_packs % 6 is 0, 2 or 4
  if (stages - t0 == 4)
    arr.template stages<0, 4, false>(t0);
  else if (stages - t0 == 2)
    arr.template stages<0, 2, false>(t0);
  if constexpr (kTrace) {
    __syncthreads();  // every row of the store written, seen by the block
    const int n_emit = n_packs - 1;
    int* o = out + static_cast<size_t>(g) * n_emit * kCols + l;
    int state = 0;
    for (int k = 0; k < n_emit; ++k) {
      const int kp = n_packs - 1 - k;
      const uint32_t* col = surv + static_cast<size_t>(kp) * kStates * arrays
                            + a;
      uint32_t pack;
      if constexpr (kBisect) {
        uint32_t x[S];
#pragma unroll
        for (int s = 0; s < S; ++s)
          x[s] = col[static_cast<size_t>(lane * S + s) * arrays];
        halve_down<S / 2>(x, state);
        pack = __shfl_sync(kFull, x[0], state >> log2_of(S), L);
      } else {
        pack = col[static_cast<size_t>(state) * arrays];
      }
      if (k >= 1 && lane == 0) o[(kp - 1) * kCols] = static_cast<int>(pack);
      state = static_cast<int>((pack >> 26) & 63u);
    }
    if (lane == 0) o[(n_emit - 1) * kCols] = 0;
  } else if (lane == 0) {
    out[a] = static_cast<int>(static_cast<uint32_t>(arr.pm_a[0]) +
                              arr.pp_a[0]);
  }
}

template <int V, int L>
cudaError_t launch(const int* words, uint32_t* surv, int* out, int programs,
                   int n_packs, cudaStream_t stream) {
  const int arrays = programs * kCols;
  if constexpr (L == 1) {
    ablation_kernel<V><<<(arrays + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(words, surv, out, programs, n_packs);
  } else {
    // arrays * L threads: whole CUDA blocks (kCols * L % lane_block == 0)
    static_assert(kCols * L % lane_block<L>() == 0, "whole CUDA blocks");
    ablation_lanes_kernel<V, L><<<arrays * L / lane_block<L>(),
                                  lane_block<L>(), 0, stream>>>(
        words, surv, out, programs, n_packs);
  }
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_variant(int variant, const int* w, uint32_t* sv, int* o,
                           int programs, int n_packs, cudaStream_t s) {
  switch (variant) {
    case 0: return launch<0, L>(w, sv, o, programs, n_packs, s);
    case 1: return launch<1, L>(w, sv, o, programs, n_packs, s);
    case 2: return launch<2, L>(w, sv, o, programs, n_packs, s);
    case 3: return launch<3, L>(w, sv, o, programs, n_packs, s);
    case 4: return launch<4, L>(w, sv, o, programs, n_packs, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace viterbi_ablation

using namespace viterbi_ablation;

// Launch variant `variant` (0 body, 1 +unpack, 2 +dump, 3 +traceback, 4
// +tb(bisect)) split over `lanes` (1, 2, 4, 8, 16 or 32) lanes an array,
// over `programs` programs of n_packs (>= 4) packs: words holds programs x
// n_packs x 16 x 128 int32, surv n_packs x 64 x programs x 128 uint32 (used
// only by variants 2-4), out programs x (1 or n_packs - 1) x 128 int32.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k13_launch(int variant, int lanes, const void* words,
                                  void* surv, void* out, int programs,
                                  int n_packs, void* stream) {
  const int* w = static_cast<const int*>(words);
  uint32_t* sv = static_cast<uint32_t*>(surv);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (programs <= 0 || n_packs < 4 || words == nullptr || out == nullptr ||
      variant < 0 || variant > 4 || (variant >= 2 && surv == nullptr) ||
      static_cast<long long>(programs) * kCols * lanes > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(viterbi::dispatch_lanes(lanes, [&](auto l) {
    return launch_variant<decltype(l)::value>(variant, w, sv, o, programs,
                                              n_packs, s);
  }));
}
