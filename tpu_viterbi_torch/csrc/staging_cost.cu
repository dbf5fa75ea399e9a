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
// Here a CUDA block is that tile: 128 threads, one time-block each (K1 has
// 64).  Each thread loads its first wph words into shared memory, the block
// synchronizes, and a thread's halo words are read from its neighbour's
// row there: no halo word is read from device memory, the question the
// probe asks (K1 reads its halo from the stream past its body).  The
// unpack, ACS, survivor store and traceback are K1's (viterbi.cu's
// IntReader<8> and full-store branch, acs.cuh), bits_per_pack 32; SOFT8's
// metrics need no renormalisation below 4M stages a block, which the
// wrapper refuses.
//
// num_blocks is the padded block count b_pad, a multiple of 128: a thread
// for every block of every tile, blocks past the plan decoding the
// stream's words there (zero past its end), as the JAX probe decodes its
// pre-padded input.  The plain PyTorch version is roll_decode_torch in
// tpu_viterbi_torch/scripts/staging_cost.py (core_torch's staged decode on
// the rolled words); the two agree bit for bit.
//
// What bounds it on an H100: the ACS, as K1 (~400 integer instructions a
// stage); it reads the body once (wpb words a block) and writes the store
// and the packs.

#include <cuda_runtime.h>

#include <cstdint>

#include "acs.cuh"

namespace viterbi_roll {

using viterbi::acs_stage;
using viterbi::Bm;
using viterbi::int_bm;
using viterbi::kStates;

constexpr int kTile = 128;  // blocks a tile: threads a CUDA block
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

}  // namespace viterbi_roll

using namespace viterbi_roll;

// Plain C entry point (bound with ctypes): words, the flat stream of n
// int32 SOFT8 words; surv, (n_packs, 64, num_blocks) words; out,
// (num_blocks, n_emit) int32; num_blocks a positive multiple of 128; wph
// halo words a block, at most wpb and 96 (48 KB of shared memory).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k23_launch(const void* words, long long n, void* surv,
                                  void* out, int num_blocks, int wpb, int wph,
                                  int n_packs, int n_conv, int n_emit,
                                  void* stream) {
  if (num_blocks <= 0 || num_blocks % kTile || wph <= 0 || wph > wpb ||
      wph > 96 || words == nullptr || surv == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(wph) * kTile * sizeof(uint32_t);
  roll_kernel<<<num_blocks / kTile, kTile, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(words), n, static_cast<uint32_t*>(surv),
      static_cast<int*>(out), num_blocks, wpb, wph, n_packs, n_conv, n_emit);
  return static_cast<int>(cudaGetLastError());
}
