// Kernel K23: the roll-halo decode of the staging-cost probe, the
// counterpart of scripts/staging_cost.py's _kernel_roll (:219-229, call
// build_call_roll :241): the fused word-mode decode of the SOFT8 channel
// (the probe's), full survivor store, in which each block reads only its
// body words from device memory and takes its halo from the next block of
// its tile.
//
// _kernel_roll transposes a 128-block tile's bodies into VMEM and makes the
// halo packs by pltpu.roll(words, 127, 1): block 128q + l takes the first
// wph words of block 128q + (l + 1) % 128, so the tile wraps and block
// 128q + 127 decodes the head of block 128q, not the stream's (a timing
// probe: the production kernel patches that lane from an edge input).
// This kernel keeps that wrap exactly, so its packs equal the JAX
// kernel's on the same stream.
//
// At one lane a CUDA block is that tile: 128 threads, one time-block each
// (K1 has 64).  Each thread loads its first wph words into shared memory,
// the block synchronizes, and a thread's halo words are read from its
// neighbour's row there: no halo word is read from device memory, the
// question the probe asks (K1 reads its halo from the stream past its
// body).  The unpack, ACS, survivor store and traceback are K1's
// (viterbi.cu's IntReader<8> and full-store branch, acs.cuh), bits_per_pack
// 32; SOFT8's metrics need no renormalisation below 4M stages a block,
// which the wrapper refuses.
//
// num_blocks is the padded block count b_pad, a multiple of 128: a thread
// for every block of every tile, blocks past the plan decoding the
// stream's words there (zero past its end), as the JAX probe decodes its
// pre-padded input.  The plain PyTorch version is roll_decode_torch in
// tpu_viterbi_torch/scripts/staging_cost.py (core_torch's staged decode on
// the rolled words); the kernel agrees with it bit for bit at every lane
// count.
//
// What bounds it on an H100: the ACS, as K1 (~400 integer instructions a
// stage); it reads the body once (wpb words a block) and writes the store
// and the packs.  A thread a time-block leaves the probe's 3,968 blocks
// (32M bits, dec_len 8192) on 31 CUDA blocks of 4 warps, 124 warps for the
// card's 528 schedulers, each warp paced by its ACS chain's latency.
//
// What the design does about it: each time-block splits over `lanes` L
// threads of a warp (2-32; one lane is the kernel above, unchanged), K13's
// lane-split decode piece for piece (kernel_ablation.cu's AblationLanes<3,
// L>, csrc/lanes.cuh's layout): six-stage passes of lane_stage on SOFT8's
// unpack, the words of the next pass loaded a pass ahead, the survivors
// dumped at each pack's end to rows rol6(P, F) through the CUDA block's
// tile, and the chase that every lane of a time-block follows while lane 0
// writes.  The passes whose read-ahead stays in the body run a loop of
// their own, each word one predicated load; the last few, which reach
// into the halo, follow in a second loop (one loop with a word reader that
// chose between the body and the halo at every load issued 76.7 SASS a
// stage at 32 lanes and ran 4.05 ms on the H100, the body's loop 52.3 and
// 2.86 ms).  A 128-block tile becomes a thread-block cluster of 8 CUDA
// blocks of 16 time-blocks (16 L threads each), so 31 tiles run 248 CUDA
// blocks.  Each CUDA block writes its 16 time-blocks' heads into its own
// shared memory; after a cluster barrier, time-block 15 of cluster rank k
// copies the heads of time-block 0 of rank (k + 1) % 8 through distributed
// shared memory, and a second cluster barrier keeps every CUDA block alive
// until its peers have read it.  No halo word is read from device memory
// at any lane count.

#include <cuda_runtime.h>

#include <cooperative_groups.h>
#include <cstdint>

#include "acs.cuh"
#include "lanes.cuh"

namespace viterbi_roll {

using viterbi::acs_stage;
using viterbi::Bm;
using viterbi::int_bm;
using viterbi::kStates;

constexpr int kTile = 128;  // blocks a tile: a CUDA block at one lane
constexpr int kWidth = 8;                   // SOFT8 field bits
constexpr int kPairsPerWord = 16 / kWidth;  // stages a word

// Word reader of one block: body words 0 .. wpb - 1 from the flat stream
// (zero past its end), halo words wpb .. wpb + wph - 1 from the
// neighbour's row of the shared heads.  Fields MSB first, as K1's.  The
// reader runs a word ahead, so its last prefetch (word wpb + wph) reads
// nothing.
struct RollReader {
  const int* words;
  long long n_words;
  long long base;
  int wpb;
  int wph;
  const uint32_t* heads;
  int next_idx;
  uint32_t cur;
  uint32_t nxt;

  __device__ __forceinline__ uint32_t load(int idx) const {
    if (idx >= wpb)
      return idx - wpb < wph ? heads[(idx - wpb) * kTile] : 0u;
    return base + idx < n_words ? static_cast<uint32_t>(__ldg(words + base +
                                                               idx))
                                : 0u;
  }

  __device__ __forceinline__ RollReader(const int* w, long long n,
                                        long long b, int body, int halo,
                                        const uint32_t* nbr_heads)
      : words(w), n_words(n), base(b), wpb(body), wph(halo),
        heads(nbr_heads), next_idx(0), cur(0u), nxt(0u) {
    nxt = load(next_idx++);
  }

  __device__ __forceinline__ void next(int s, Bm& m) {
    if (s % kPairsPerWord == 0) {
      cur = nxt;
      nxt = load(next_idx++);
    }
    const int a0 = static_cast<int>(cur) >> (32 - kWidth);
    const int a1 = static_cast<int>(cur << kWidth) >> (32 - kWidth);
    cur <<= 2 * kWidth;
    int_bm(a0, a1, m);
  }
};

// surv: (n_packs, 64, num_blocks) full store; out: (num_blocks, n_emit)
// packs; heads: wph x kTile words of dynamic shared memory.
__global__ void __launch_bounds__(kTile)
roll_kernel(const int* __restrict__ words, long long n_words,
            uint32_t* __restrict__ surv, int* __restrict__ out, int num_blocks,
            int wpb, int wph, int n_packs, int n_conv, int n_emit) {
  extern __shared__ uint32_t heads[];
  const int lane = threadIdx.x;
  const int blk = blockIdx.x * kTile + lane;
  const long long base = static_cast<long long>(blk) * wpb;
  for (int i = 0; i < wph; ++i)
    heads[i * kTile + lane] =
        base + i < n_words ? static_cast<uint32_t>(__ldg(words + base + i))
                           : 0u;
  __syncthreads();

  const size_t plane = static_cast<size_t>(num_blocks);
  const int emit_lo = n_packs - n_conv - n_emit;
  int* const dst_out = out + static_cast<size_t>(blk) * n_emit;
  int pm_a[kStates], pm_b[kStates];
  uint32_t pp_a[kStates], pp_b[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    pm_a[s] = 0;
    pp_a[s] = 0u;
  }

  RollReader reader(words, n_words, base, wpb, wph,
                    heads + (lane + 1) % kTile);
  int stage = 0;
  for (int p = 0; p < n_packs; ++p) {
#pragma unroll 1
    for (int t = 0; t < 32; t += 2) {
      Bm m;
      reader.next(stage++, m);
      acs_stage<false>(pm_a, pp_a, pm_b, pp_b, m);
      reader.next(stage++, m);
      acs_stage<false>(pm_b, pp_b, pm_a, pp_a, m);
    }
    uint32_t* dst = surv + static_cast<size_t>(p) * kStates * plane + blk;
#pragma unroll
    for (int s = 0; s < kStates; ++s) dst[s * plane] = pp_a[s];
  }

  int state = 0;
  for (int k = 0; k < n_conv + n_emit; ++k) {
    const int kp = n_packs - 1 - k;
    const uint32_t pack =
        surv[(static_cast<size_t>(kp) * kStates + state) * plane + blk];
    if (k >= n_conv) dst_out[kp - emit_lo] = static_cast<int>(pack);
    state = static_cast<int>((pack >> 26) & 63u);
  }
}

// --- the time-blocks split over lanes (lanes >= 2) ---

namespace cg = cooperative_groups;
using viterbi::kPass;
using viterbi::lane_stage;
using viterbi::rol6;
using viterbi::soft8_bm;

constexpr int kCluster = 8;                // CUDA blocks a tile's cluster
constexpr int kSlots = kTile / kCluster;   // time-blocks a CUDA block
constexpr int kMaxHalo = 96;               // wph's limit (the entry's)

// One time-block's lane: its S = 64 / L positions, double-buffered, the
// SOFT8 words of the running pass, and where its dump goes (K13's
// AblationLanes<3, L> with K23's input: the body from the flat stream, the
// halo from the next time-block's heads in shared memory).
template <int L>
struct RollLanes {
  static constexpr int S = kStates / L;

  const int* body;          // the block's body in the stream,
  const uint32_t* halo;     // its halo: the next time-block's heads
  int valid, wpb, wph;      // body words in the stream, wpb, wph
  int lane;
  uint32_t flips;
  int pm_a[S], pm_b[S];
  uint32_t pp_a[S], pp_b[S];
  int pw[kPass / 2];        // the pass's words
  uint32_t* surv;           // the store,
  uint32_t (*tile)[kSlots + 1];  // the CUDA block's staging rows,
  int plane, slot, first;   // the time-block's column in both

  __device__ __forceinline__ RollLanes(const int* words, long long n_words,
                                       int wpb_, int wph_, int ln,
                                       const uint32_t* next, uint32_t* store,
                                       uint32_t (*rows)[kSlots + 1],
                                       int num_blocks)
      : lane(ln), flips(0u), surv(store), tile(rows), plane(num_blocks),
        slot(threadIdx.x / L), first(blockIdx.x * kSlots) {
    const long long base = static_cast<long long>(first + slot) * wpb_;
    const long long left = n_words - base;
    body = words + base;
    halo = next;
    valid = left <= 0 ? 0 : left < wpb_ ? static_cast<int>(left) : wpb_;
    wpb = wpb_;
    wph = wph_;
    viterbi::add_lane_flips<L>(lane, flips);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      pm_a[s] = 0;
      pp_a[s] = 0u;
    }
#pragma unroll
    for (int k = 0; k < kPass / 2; ++k) pw[k] = load<true>(k);
  }

  // Word idx of the block: the body from the stream (zero past its end),
  // then (HALO) the halo, then zero (the last pass's read-ahead).  Without
  // HALO idx lies in the body: the stage loop's passes whose read-ahead
  // stays in the body (all but the last few) load with one predicated
  // load and no branch.
  template <bool HALO>
  __device__ __forceinline__ int load(int idx) const {
    if (!HALO || idx < wpb) return idx < valid ? __ldg(body + idx) : 0;
    return idx - wpb < wph ? static_cast<int>(halo[idx - wpb]) : 0;
  }

  // Stage t0 + J, phase J (t0 % 6 == 0); AHEAD: then load the next pass's
  // word into the register this stage pair has read (HALO: load's).
  template <int J, bool AHEAD, bool HALO>
  __device__ __forceinline__ void stage(int t0) {
    const Bm m = soft8_bm<J>(pw[J / 2]);
    if constexpr (AHEAD && J % 2 == 1)
      pw[J / 2] = load<HALO>((t0 + kPass) / 2 + J / 2);
    if constexpr (J % 2 == 0) {
      lane_stage<L, J>(pm_a, pp_a, pm_b, pp_b, m, flips, lane);
    } else {
      lane_stage<L, J>(pm_b, pp_b, pm_a, pp_a, m, flips, lane);
      // the same for the whole CUDA block: no thread skips the barriers
      if (((t0 + J) & 31) == 31) dump<(J + 1) % kPass>((t0 + J) >> 5);
    }
  }

  // Pack p's survivors, in (pp_a) with the next stage in phase F, into
  // rows rol6(P, F) of the store, through the CUDA block's tile.
  template <int F>
  __device__ __forceinline__ void dump(int p) {
    __syncthreads();  // the last pack's rows have left the tile
    const int row0 = rol6(lane * S, F);
#pragma unroll
    for (int r = 0; r < S; ++r) tile[row0 | rol6(r, F)][slot] = pp_a[r];
    __syncthreads();
    // the CUDA block's 64 x 16 words, S a thread, a warp on whole rows
    uint32_t* dst = surv + static_cast<size_t>(p) * kStates * plane + first;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int e = k * kSlots * L + static_cast<int>(threadIdx.x);
      const int rw = e / kSlots, cl = e % kSlots;
      dst[static_cast<size_t>(rw) * plane + cl] = tile[rw][cl];
    }
  }

  template <int J, int N, bool AHEAD, bool HALO>
  __device__ __forceinline__ void stages(int t0) {
    if constexpr (J < N) {
      stage<J, AHEAD, HALO>(t0);
      stages<J + 1, N, AHEAD, HALO>(t0);
    }
  }
};

// surv: (n_packs, 64, num_blocks) full store; out: (num_blocks, n_emit)
// packs.  Cluster rank k holds time-blocks 16 k .. 16 k + 15 of its tile.
template <int L>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kSlots * L)
roll_lanes_kernel(const int* __restrict__ words, long long n_words,
                  uint32_t* __restrict__ surv, int* __restrict__ out,
                  int num_blocks, int wpb, int wph, int n_packs, int n_conv,
                  int n_emit) {
  // row a < 16: the heads of time-block a; row 16: those of the next
  // rank's time-block 0 (the padding column keeps a warp's rows on
  // distinct banks)
  __shared__ uint32_t heads[kSlots + 1][kMaxHalo + 1];
  __shared__ uint32_t tile[kStates][kSlots + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int a = threadIdx.x / L, lane = threadIdx.x % L;
  const int blk = blockIdx.x * kSlots + a;
  const long long base = static_cast<long long>(blk) * wpb;
  for (int i = lane; i < wph; i += L)
    heads[a][i] = base + i < n_words
                      ? static_cast<uint32_t>(__ldg(words + base + i))
                      : 0u;
  cluster.sync();  // every CUDA block's heads written, seen by the cluster
  if (a == kSlots - 1) {
    const uint32_t* next = cluster.map_shared_rank(
        &heads[0][0], (cluster.block_rank() + 1) % kCluster);
    for (int i = lane; i < wph; i += L) heads[kSlots][i] = next[i];
  }
  cluster.sync();  // the copy seen by the block; no peer reads it later

  RollLanes<L> arr(words, n_words, wpb, wph, lane, heads[a + 1], surv, tile,
                   num_blocks);
  const int stages = n_packs * 32;
  int t0 = 0;
  // the passes whose read-ahead (words t0 / 2 + 3 .. + 5) is body, then
  // the last few, which reach into the halo
#pragma unroll 1
  for (; t0 + kPass <= stages && t0 / 2 + kPass - 1 < wpb; t0 += kPass)
    arr.template stages<0, kPass, true, false>(t0);
#pragma unroll 1
  for (; t0 + kPass <= stages; t0 += kPass)
    arr.template stages<0, kPass, true, true>(t0);
  // 32 n_packs % 6 is 0, 2 or 4
  if (stages - t0 == 4)
    arr.template stages<0, 4, false, true>(t0);
  else if (stages - t0 == 2)
    arr.template stages<0, 2, false, true>(t0);

  __syncthreads();  // every row of the store written, seen by the block
  const size_t plane = static_cast<size_t>(num_blocks);
  const int emit_lo = n_packs - n_conv - n_emit;
  int* const dst_out = out + static_cast<size_t>(blk) * n_emit;
  int state = 0;
  for (int k = 0; k < n_conv + n_emit; ++k) {
    const int kp = n_packs - 1 - k;
    const uint32_t pack =
        surv[(static_cast<size_t>(kp) * kStates + state) * plane + blk];
    if (k >= n_conv && lane == 0)
      dst_out[kp - emit_lo] = static_cast<int>(pack);
    state = static_cast<int>((pack >> 26) & 63u);
  }
}

// The time-blocks at L lanes: one lane the tile-a-CUDA-block kernel, else
// the split, a cluster a tile.
template <int L>
cudaError_t launch(const int* words, long long n, uint32_t* surv, int* out,
                   int num_blocks, int wpb, int wph, int n_packs, int n_conv,
                   int n_emit, cudaStream_t stream) {
  if constexpr (L == 1) {
    const size_t smem = static_cast<size_t>(wph) * kTile * sizeof(uint32_t);
    roll_kernel<<<num_blocks / kTile, kTile, smem, stream>>>(
        words, n, surv, out, num_blocks, wpb, wph, n_packs, n_conv, n_emit);
  } else {
    roll_lanes_kernel<L><<<num_blocks / kSlots, kSlots * L, 0, stream>>>(
        words, n, surv, out, num_blocks, wpb, wph, n_packs, n_conv, n_emit);
  }
  return cudaGetLastError();
}

}  // namespace viterbi_roll

using namespace viterbi_roll;

// Plain C entry point (bound with ctypes): words, the flat stream of n
// int32 SOFT8 words; surv, (n_packs, 64, num_blocks) words; out,
// (num_blocks, n_emit) int32; num_blocks a positive multiple of 128; wph
// halo words a block, at most wpb and 96 (48 KB of shared memory at one
// lane); each time-block over `lanes` (1, 2, 4, 8, 16 or 32) lanes.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k23_launch(const void* words, long long n, void* surv,
                                  void* out, int num_blocks, int wpb, int wph,
                                  int n_packs, int n_conv, int n_emit,
                                  int lanes, void* stream) {
  if (num_blocks <= 0 || num_blocks % kTile || wph <= 0 || wph > wpb ||
      wph > kMaxHalo || words == nullptr || surv == nullptr ||
      out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(viterbi::dispatch_lanes(lanes, [&](auto l) {
    return launch<decltype(l)::value>(
        static_cast<const int*>(words), n, static_cast<uint32_t*>(surv),
        static_cast<int*>(out), num_blocks, wpb, wph, n_packs, n_conv,
        n_emit, static_cast<cudaStream_t>(stream));
  }));
}
