// Kernel K28: the ACS' perfect shuffle on its own.  Replaces the TPU probe
// kernel scripts/interleave_bench.py:make_kernel (:51, launched by
// run_variant at :76 and by check_correct at :113), which timed lowerings of
// the sublane interleave I[2q] = E[q], I[2q+1] = O[q] of two (32, 128)
// arrays into (64, 128).
//
// Every column of x (64 rows, cols columns, int32) is one problem: E = rows
// 0-31, O = rows 32-63.  A rep merges them and adds `one` to every value:
// E' = I[0:32] + one, O' = I[32:64] + one; after `reps` reps the column is
// written back in place of x's (out has x's shape).  one = 0 and reps = 1
// give the bare merge, the JAX script's correctness check (:99-127).
// Variants, the GPU forms of the JAX ones:
//   0 regs    (bcast) a thread holds its column's 64 values in registers and
//             the shuffle is register renaming: it has order 6 on 64 rows,
//             so the rep loop is unrolled by 6 and the renaming is static;
//             a rep is 64 adds, the last reps % 6 moves and adds
//   1 shfl    (new) a warp holds a column, lane q rows q and 32 + q; a rep
//             fetches rows q >> 1 and 16 + (q >> 1) of E and of O with four
//             __shfl_sync and selects by the lane's parity
//   2 smem    (scratch) a thread stores its column's E and O to the even and
//             odd rows of a shared-memory column and reads all 64 back
//             (merge_scratch :44-48), volatile so that the round trip is
//             not forwarded in registers
//   3 concat  the wrong-result floor: I = [E; O], so a rep only adds; its
//             loop is regs' (unrolled by 6), so the two differ only where
//             regs renames
// Every add is inline PTX.  In regs' and concat's passes of 6 reps, rep j
// adds its own register o[j], read from shared memory where each holds
// `one`, so that ptxas cannot fold a value's 6 adds into one multiply (it
// may still fuse two adds into one IADD3, as the hardware allows).  The
// plain PyTorch version is interleave_torch in
// tpu_viterbi_torch/scripts/interleave_bench.py; each variant agrees with
// it bit for bit at every lane count.
//
// What bounds it: issue, 64 adds a column-rep (regs, concat: 32 IADD3 at
// best, each adding two); shfl adds 4 shuffles and 2 selects a lane-rep,
// 256 lane-operations a column-rep, on the shuffle unit; smem 128 shared
// accesses a column-rep on the load/store unit.  A thread a column leaves
// the JAX shape (1,024 columns) on 8 CUDA blocks, 8 of the card's 132 SMs,
// which run regs and concat at 8 SMs' IADD3 rate and smem at 8 SMs'
// shared-memory rate.
//
// What the design does about it: regs, smem and concat split each column's
// 64 rows over `lanes` L threads (2-32; one lane is the kernel above,
// unchanged), S = 64 / L rows each, so 1,024 columns run 1,024 L threads.
//   regs, concat  nothing moves between threads, so a column's lanes need
//                 not share a warp: a warp holds 32 adjacent columns at one
//                 lane, each row's loads and stores coalesced.  Lane l's
//                 register r is position P = l S + r, and regs renames in
//                 place across lanes as within one: the shuffle is I[r] =
//                 X[ror6(r, 1)], so after t reps position P holds logical
//                 row rol6(P, t % 6) (lanes.cuh's convention).  A rep adds
//                 to the S values where they are, reps % 6 included, and
//                 the write-out puts position P in row rol6(P, reps % 6);
//                 concat writes it to row P.  A loop iteration runs
//                 kPassesPerIter passes of 6 reps, 96 adds or more a
//                 thread, so that few values a thread do not leave the
//                 loop's control to pace it.
//   smem          a real round trip through shared memory every rep, as the
//                 JAX scratch variant's: a column's L lanes share a warp
//                 (C = 32 / L columns a warp), lane l holds the H = 32 / L
//                 pairs (E[q], O[q]), q = j L + l, stores each as one 64-bit
//                 word to rows (2q, 2q + 1) of the merged column and reads
//                 back rows q and q + 32, its new E[q] and O[q].  The
//                 scratch is the warp's, [pair row m / 2][column]: store j of
//                 a warp writes 256 contiguous bytes and each load's 32
//                 words fall in 32 distinct banks (smem_word).  Two scratch
//                 buffers alternate, so one __syncwarp a rep orders a rep's
//                 stores before its loads and its loads before the stores
//                 into the same buffer two reps later.
// shfl is one warp a column already (lanes 32) and keeps its kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "lanes.cuh"

namespace viterbi_interleave {

constexpr int kRows = 64;
constexpr int kHalf = 32;
constexpr int kThreads = 128;   // a tile of 128 columns a CUDA block
constexpr int kOrder = 6;       // the perfect shuffle of 64 rows: order 6

__device__ __forceinline__ int add(int a, int one) {
  asm volatile("add.s32 %0, %0, %1;" : "+r"(a) : "r"(one));
  return a;
}

// Row r of I comes from row src(r) of [E; O]: E[r / 2] or O[r / 2].
__host__ __device__ constexpr int src_row(int r) {
  return (r % 2) * kHalf + r / 2;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
interleave_kernel(const int* __restrict__ x, int* __restrict__ out,
                  int cols, int reps, int one) {
  if constexpr (V == 1) {
    const int w = (blockIdx.x * kThreads + threadIdx.x) / 32;
    const int q = threadIdx.x % 32;
    if (w >= cols) return;
    int e = x[static_cast<size_t>(q) * cols + w];
    int o = x[static_cast<size_t>(kHalf + q) * cols + w];
    const int lo = q >> 1, hi = 16 + (q >> 1);
    const bool odd = q & 1;
#pragma unroll 1
    for (int k = 0; k < reps; ++k) {
      const int e_lo = __shfl_sync(0xffffffffu, e, lo);
      const int o_lo = __shfl_sync(0xffffffffu, o, lo);
      const int e_hi = __shfl_sync(0xffffffffu, e, hi);
      const int o_hi = __shfl_sync(0xffffffffu, o, hi);
      e = add(odd ? o_lo : e_lo, one);
      o = add(odd ? o_hi : e_hi, one);
    }
    out[static_cast<size_t>(q) * cols + w] = e;
    out[static_cast<size_t>(kHalf + q) * cols + w] = o;
    return;
  }
  __shared__ int ones[kOrder];
  if constexpr (V != 2) {
    if (threadIdx.x < kOrder) ones[threadIdx.x] = one;
    __syncthreads();
  }
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  int v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = x[static_cast<size_t>(r) * cols + c];
  if constexpr (V == 0 || V == 3) {
    // regs: every value gets one add a rep wherever it moves, and 6
    // shuffles bring every row back, so a pass of 6 reps is 6 x 64 adds on
    // the registers in place, the shuffles being static renaming; concat
    // moves nothing at all
    const volatile int* vo = ones;
    int o[kOrder];
#pragma unroll
    for (int j = 0; j < kOrder; ++j) o[j] = vo[j];
    int k = 0;
#pragma unroll 1
    for (; k + kOrder <= reps; k += kOrder) {
#pragma unroll
      for (int j = 0; j < kOrder; ++j) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = add(v[r], o[j]);
      }
    }
    for (; k < reps; ++k) {       // the last reps % 6 (regs: renamed by moves)
      int t[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        t[r] = add(v[V == 0 ? src_row(r) : r], one);
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = t[r];
    }
  } else {
    __shared__ int s[kRows][kThreads];
    volatile int* col = &s[0][threadIdx.x];
#pragma unroll 1
    for (int k = 0; k < reps; ++k) {
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        col[(2 * q) * kThreads] = v[q];
        col[(2 * q + 1) * kThreads] = v[kHalf + q];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = add(col[r * kThreads], one);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    out[static_cast<size_t>(r) * cols + c] = v[r];
}

template <int V>
cudaError_t launch(const int* x, int* out, int cols, int reps, int one,
                   cudaStream_t stream) {
  const long long threads = V == 1 ? 32LL * cols : cols;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  interleave_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(x, out, cols, reps, one);
  return cudaGetLastError();
}

// --- the columns split over lanes (lanes >= 2) ---

constexpr int kWarps = kThreads / 32;
constexpr int kShflLanes = 32;  // shfl: a warp a column
// regs' and concat's passes of 6 reps a loop iteration at L lanes: 16 / S
// passes of a thread's S = 64 / L values from 4 values up
template <int L>
constexpr int kPassesPerIter = L >= 8 ? L / 4 : 1;

// smem's scratch word of merged row m of the warp's column cw, C columns a
// warp: [pair row m / 2][column][m % 2], a pair row (2q, 2q + 1) one 64-bit
// word.  tests/test_torch_k23_k28.py holds its banks.
template <int C>
__host__ __device__ constexpr int smem_word(int cw, int m) {
  return ((m >> 1) * C + cw) * 2 + (m & 1);
}

// One rep of smem at L lanes through the scratch buffer buf: pairs (e[j],
// o[j]) = (E[q], O[q]), q = j L + lane, to rows (2q, 2q + 1) as 64-bit
// words, then rows q and q + 32 back, plus one.  Pair q of column cw is
// 64-bit word q C + cw = 32 j + t (t the warp's thread), so a warp's store j
// is 256 contiguous bytes; the loads are smem_word's.
template <int L>
__device__ __forceinline__ void smem_rep(int (&e)[kHalf / L],
                                         int (&o)[kHalf / L],
                                         volatile unsigned long long* buf,
                                         int t, int lane, int cw, int one) {
  constexpr int C = 32 / L, H = kHalf / L;
#pragma unroll
  for (int j = 0; j < H; ++j)
    buf[32 * j + t] = (static_cast<unsigned long long>(
                           static_cast<uint32_t>(o[j])) << 32) |
                      static_cast<uint32_t>(e[j]);
  __syncwarp();
  const volatile int* rows = reinterpret_cast<const volatile int*>(buf);
  const int w = smem_word<C>(cw, lane);   // row q = lane of pair j = 0
#pragma unroll
  for (int j = 0; j < H; ++j) {
    // row j L + lane is word w + 32 j, row j L + lane + 32 16 C pairs on
    e[j] = add(rows[w + 32 * j], one);
    o[j] = add(rows[w + 32 * j + 32 * C], one);
  }
}

template <int V, int L>
__global__ void __launch_bounds__(kThreads)
interleave_lanes_kernel(const int* __restrict__ x, int* __restrict__ out,
                        int cols, int reps, int one) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int t = threadIdx.x % 32;
  if constexpr (V == 2) {
    constexpr int C = 32 / L, H = kHalf / L;
    __shared__ unsigned long long scratch[kWarps][2][kHalf * C];
    const int lane = t / C, cw = t % C;
    const int c0 = g / 32 * C;            // the warp's first column
    if (c0 >= cols) return;               // the whole warp: no column
    const int c = c0 + cw;
    const bool live = c < cols;
    int e[H], o[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const int q = j * L + lane;
      e[j] = live ? x[static_cast<size_t>(q) * cols + c] : 0;
      o[j] = live ? x[static_cast<size_t>(kHalf + q) * cols + c] : 0;
    }
    volatile unsigned long long* b0 = scratch[threadIdx.x / 32][0];
    volatile unsigned long long* b1 = scratch[threadIdx.x / 32][1];
    int k = 0;
#pragma unroll 1
    for (; k + 2 <= reps; k += 2) {
      smem_rep<L>(e, o, b0, t, lane, cw, one);
      smem_rep<L>(e, o, b1, t, lane, cw, one);
    }
    if (k < reps) smem_rep<L>(e, o, b0, t, lane, cw, one);
    if (!live) return;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const int q = j * L + lane;
      out[static_cast<size_t>(q) * cols + c] = e[j];
      out[static_cast<size_t>(kHalf + q) * cols + c] = o[j];
    }
  } else {
    // regs, concat: warp w holds lane w % L of columns 32 (w / L) + t
    constexpr int S = kRows / L;
    __shared__ int ones[kOrder];
    if (threadIdx.x < kOrder) ones[threadIdx.x] = one;
    __syncthreads();
    const int w = g / 32, lane = w % L;
    const int c = w / L * 32 + t;
    if (c >= cols) return;
    int v[S];
#pragma unroll
    for (int r = 0; r < S; ++r)
      v[r] = x[static_cast<size_t>(lane * S + r) * cols + c];
    const volatile int* vo = ones;
    int o[kOrder];
#pragma unroll
    for (int j = 0; j < kOrder; ++j) o[j] = vo[j];
    // U passes of 6 reps a loop iteration, 96 adds or more as at one lane:
    // with a few values a thread, the loop's control would else pace it
    constexpr int U = kPassesPerIter<L>;
    int k = 0;
#pragma unroll 1
    for (; k + kOrder * U <= reps; k += kOrder * U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < kOrder; ++j) {
#pragma unroll
          for (int r = 0; r < S; ++r) v[r] = add(v[r], o[j]);
        }
      }
    }
#pragma unroll 1
    for (; k < reps; ++k) {       // the last reps % 6 U: adds in place
#pragma unroll
      for (int r = 0; r < S; ++r) v[r] = add(v[r], one);
    }
    // position P holds logical row rol6(P, reps % 6) (regs), P (concat)
    const int f = V == 0 ? reps % kOrder : 0;
#pragma unroll
    for (int r = 0; r < S; ++r)
      out[static_cast<size_t>(viterbi::rol6(lane * S + r, f)) * cols + c] =
          v[r];
  }
}

// Variant V (0 regs, 2 smem, 3 concat) at L lanes a column: one lane the
// thread-a-column kernel, else the split.
template <int V, int L>
cudaError_t launch_lanes(const int* x, int* out, int cols, int reps, int one,
                         cudaStream_t stream) {
  if constexpr (L == 1) {
    return launch<V>(x, out, cols, reps, one, stream);
  } else {
    // regs, concat: L warps for each 32 columns; smem: a warp for each
    // 32 / L columns
    const long long warps =
        V == 2 ? (cols + 32 / L - 1) / (32 / L) : (cols + 31) / 32 * 1LL * L;
    const long long blocks = (warps + kWarps - 1) / kWarps;
    if (blocks > 0x7fffffffLL || blocks * kThreads > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    interleave_lanes_kernel<V, L><<<static_cast<unsigned>(blocks), kThreads,
                                    0, stream>>>(x, out, cols, reps, one);
    return cudaGetLastError();
  }
}

template <int V>
cudaError_t launch_variant(int lanes, const int* x, int* out, int cols,
                           int reps, int one, cudaStream_t stream) {
  return viterbi::dispatch_lanes(lanes, [&](auto l) {
    return launch_lanes<V, decltype(l)::value>(x, out, cols, reps, one,
                                               stream);
  });
}

}  // namespace viterbi_interleave

using namespace viterbi_interleave;

// Launch variant `variant` (0 regs, 1 shfl, 2 smem, 3 concat) for `reps`
// reps adding `one` on x, (64, cols) int32, each column over `lanes` lanes
// (regs, smem, concat: 1, 2, 4, 8, 16 or 32; shfl: 32); out has x's shape.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k28_launch(int variant, const void* x, void* out,
                                  int cols, int reps, int one, int lanes,
                                  void* stream) {
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols <= 0 || reps < 0 || x == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0:
      return static_cast<int>(launch_variant<0>(lanes, xi, o, cols, reps,
                                                one, s));
    case 1:
      return static_cast<int>(lanes == kShflLanes
                                  ? launch<1>(xi, o, cols, reps, one, s)
                                  : cudaErrorInvalidValue);
    case 2:
      return static_cast<int>(launch_variant<2>(lanes, xi, o, cols, reps,
                                                one, s));
    case 3:
      return static_cast<int>(launch_variant<3>(lanes, xi, o, cols, reps,
                                                one, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
