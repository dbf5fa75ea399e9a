// Kernels K7 and K8: the fused workload generator of the in-graph
// simulation.  Message bits -> K=7 rate-1/2 convolutional encode -> BPSK ->
// AWGN -> quantize -> pack, with every random draw recomputed from a counter
// (threefry2x32 at 13 rounds, threefry.cuh, which K20 times), so the only
// device-memory traffic is the outputs.
//   - K7, viterbi_k7_launch: the four integer channels (HARD/SOFT4/SOFT8/
//     SOFT16) -> ceil(n/32) int32 message-bit packs and ceil(2n/vpw) int32
//     channel words.  Replaces the TPU kernel
//     tpu_viterbi/chain/genkernel.py:_gen_kernel; its message-bit packs are
//     drawn once a CTA, the GPU form of that kernel's fast_window branch.
//   - K8, viterbi_k8_launch: the FP32 wire -> ceil(n/32) int32 packs and 2n
//     f32 values [r0, r1] per stage.  Replaces _gen_kernel_f32.
//   - viterbi_k7_old_launch, viterbi_k8_old_launch: the first design's
//     draws (every thread draws its window's two packs) with this design's
//     Box-Muller, kept for the A/B of chip_smoke.py only, which so measures
//     the shared packs alone: no main path launches them.
// Its plain PyTorch version is tpu_viterbi_torch/chain/genkernel.py
// (gen_words_torch, gen_values_torch): the bit packs and the noiseless
// streams agree bit for bit; under noise a field may differ where torch's
// and this file's logf/sinf/cosf differ by an ulp at a rounding boundary.
//
// Counter assignment (the JAX kernel's, so both draw the same streams):
//   message-bit pack p (32 bits, MSB = earliest):
//       threefry(key, c0 = p >> 1, c1 = 1), half p & 1; packs p < 0 are 0
//   noise of stage j of channel word w (K7):  threefry(key, w, 2 + j)
//   noise of stage s (K8):                    threefry(key, s, 2)
//   two words -> Box-Muller over 24-bit uniforms -> (z0, z1), one per stream
// Every value is a pure function of the key and its position, so a launch
// at word offset `base` writes exactly that slice of the base = 0 stream
// (the TPU kernel's key_ref[2]; the multi-rank split uses it).
//
// What bounds it on an H100: every stage draws one threefry-13 call for
// its noise pair (13 rounds of add/funnel-shift/xor plus 4 key injections)
// and runs one Box-Muller (log, sqrt, and the sine and cosine of one
// angle); the message bits need only one call per 64 stages.  A SOFT8
// word writes 4 bytes for two stages, so K7's operations bound it; a K8
// stage writes 8 bytes, which bound K8, a little ahead of its operations.
//
// What the design does about it: draw each message-bit pack once a CTA.
// The first design rebuilt every thread's encoder window from its two
// covering packs, two threefry calls a thread: 16 SOFT8 threads (32 K8
// threads) drew each pack again, and the window draws were half of K7's
// calls and two thirds of K8's.  Now the threads of a CTA draw the range of
// packs their windows cover into shared memory, one call (q, 1) giving
// packs 2q and 2q + 1, and after one barrier each thread funnel-shifts its
// window from there; the CTA's first threads write its bit packs from the
// same table, coalesced.  One thread a channel word (K7) or a stage (K8), as
// before, so the channel writes stay coalesced int32 (K7) or float2 (K8).
// Box-Muller takes the sine and cosine of its angle from one sincosf, one
// range reduction where the first design's sinf and cosf ran two (nvcc
// does not merge them), with the same values bit for bit.
//
// Float rules (the plain version rounds each operation once): built without
// --use_fast_math (the fast intrinsics miss K8's relative gate where z is
// small); sym*scale + nscale*z is __fmul_rn/__fadd_rn, so nvcc does not
// contract it into an FMA; rintf rounds half to even as torch.round does;
// sqrtf is IEEE.  Positions are int32, as in the JAX kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace viterbi_gen {

constexpr int kGenThreads = 256;
constexpr int kGenRounds = 13;  // BigCrush-passing minimum (genkernel.py:85)
constexpr int kHistory = 6;     // message bits before a stage in its window
constexpr uint32_t kBitsTag = 1u;
constexpr uint32_t kNoiseTag = 2u;
constexpr float kTwoPi = 6.283185307179586f;  // f32(2 pi), as genkernel.py:128

// Message-bit pack idx (MSB = earliest bit); the encoder's pre-history
// (idx < 0) is zero.
__device__ __forceinline__ uint32_t bit_pack(uint32_t k0, uint32_t k1,
                                             int idx) {
  if (idx < 0) return 0u;
  const uint2 x = threefry<kGenRounds>(k0, k1, static_cast<uint32_t>(idx >> 1),
                                       kBitsTag);
  return (idx & 1) ? x.y : x.x;
}

// The encoder's two parity windows from the window u of message bits
// first - 6 .. first + 25 (MSB first): bit 25 - j of o0/o1 is the out0/out1
// of stage first + j.
__device__ __forceinline__ void parities(uint32_t u, uint32_t& o0,
                                         uint32_t& o1) {
  // tap delays {6, 3, 2, 1, 0} of 0o171 and {6, 5, 3, 2, 0} of 0o133
  o0 = u ^ (u >> 1) ^ (u >> 2) ^ (u >> 3) ^ (u >> 6);
  o1 = u ^ (u >> 2) ^ (u >> 3) ^ (u >> 5) ^ (u >> 6);
}

// The first design's window: u cut from the two covering packs, each drawn
// by this thread; `own` returns the second one.  off >> 5 floors for the
// negative off of the first word, as JAX's int32 shift does.
__device__ __forceinline__ void parity_windows(uint32_t k0, uint32_t k1,
                                               int first, uint32_t& o0,
                                               uint32_t& o1, uint32_t& own) {
  const int off = first - kHistory;
  const uint32_t p1 = bit_pack(k0, k1, off >> 5);
  own = bit_pack(k0, k1, (off >> 5) + 1);
  parities(__funnelshift_l(own, p1, off & 31), o0, o1);
}

// The packs a CTA's windows cover when its threads start SPT stages apart:
// pack (first - 6) >> 5 of its first thread to the second pack of its last
// one, rounded out to whole threefry calls (an even first pack).  kWords
// bounds the table over every alignment of the CTA's first stage.
template <int SPT>
struct PackTable {
  static constexpr int kWords = ((kGenThreads - 1) * SPT + 31) / 32 + 4;
  static_assert(kWords / 2 + 1 <= kGenThreads,
                "one threefry call a thread fills the table");
};

// Fill `table` with the packs the windows of this CTA's threads cover, the
// CTA's first thread starting at stage `first` and each next one SPT
// stages later: thread t draws call (q0 + t, 1), packs 2 (q0 + t) and
// 2 (q0 + t) + 1, zero where negative.  Every thread of the CTA must call
// it (it ends in the barrier).  Returns the table's first pack.
template <int SPT>
__device__ __forceinline__ int fill_packs(uint32_t* table, uint32_t k0,
                                          uint32_t k1, int first) {
  const int lo = (first - kHistory) >> 5;
  const int hi = ((first + (kGenThreads - 1) * SPT - kHistory) >> 5) + 1;
  const int even = lo & ~1;
  const int calls = ((hi - even) >> 1) + 1;
  if (static_cast<int>(threadIdx.x) < calls) {
    const int q = (even >> 1) + static_cast<int>(threadIdx.x);
    uint2 x = make_uint2(0u, 0u);
    if (q >= 0)
      x = threefry<kGenRounds>(k0, k1, static_cast<uint32_t>(q), kBitsTag);
    table[2 * threadIdx.x] = x.x;
    table[2 * threadIdx.x + 1] = x.y;
  }
  __syncthreads();
  return even;
}

// The parity windows of stages first .. first + 25 from the CTA's table
// (its first pack `even`).
__device__ __forceinline__ void table_windows(const uint32_t* table, int even,
                                              int first, uint32_t& o0,
                                              uint32_t& o1) {
  const int off = first - kHistory;
  const int at = (off >> 5) - even;
  parities(__funnelshift_l(table[at + 1], table[at], off & 31), o0, o1);
}

// Message bits of pack p kept: the first `keep` = n_bits - 32 p (clipped to
// 0 .. 32), so bits past the message are zero.
__device__ __forceinline__ uint32_t tail_mask(int keep) {
  if (keep >= 32) return 0xFFFFFFFFu;
  if (keep <= 0) return 0u;
  return 0xFFFFFFFFu << (32 - keep);
}

// Box-Muller on two 24-bit uniforms (genkernel.py:116-129); u1 is in
// (0, 1], so the log is finite.  One sincosf reduces theta once and gives
// libm's sinf and cosf bit for bit.
__device__ __forceinline__ void normal_pair(uint2 x, float& z0, float& z1) {
  const float u1 = __fmul_rn(
      __fadd_rn(static_cast<float>(x.x & 0xFFFFFFu), 1.0f), 0x1p-24f);
  const float u2 = __fmul_rn(static_cast<float>(x.y & 0xFFFFFFu), 0x1p-24f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  float s, c;
  sincosf(__fmul_rn(kTwoPi, u2), &s, &c);
  z0 = __fmul_rn(r, c);
  z1 = __fmul_rn(r, s);
}

// One channel value: BPSK of `bit` times scale, plus nscale * z.
__device__ __forceinline__ float channel_value(uint32_t bit, float scale,
                                               float nscale, float z,
                                               bool noisy) {
  const float v = __fmul_rn(bit ? 1.0f : -1.0f, scale);
  return noisy ? __fadd_rn(v, __fmul_rn(nscale, z)) : v;
}

// Quantized field of a value: HARD v > 0; soft fields rint, saturate to the
// width's two's-complement range and mask (viterbiDF.h:105-125).
template <int WIDTH>
__device__ __forceinline__ uint32_t quantize(float v) {
  if constexpr (WIDTH == 1) {
    return v > 0.0f ? 1u : 0u;
  } else {
    constexpr float lo = -static_cast<float>(1 << (WIDTH - 1));
    constexpr float hi = static_cast<float>((1 << (WIDTH - 1)) - 1);
    const float q = fminf(fmaxf(rintf(v), lo), hi);
    return static_cast<uint32_t>(static_cast<int>(q)) &
           ((1u << WIDTH) - 1u);
  }
}

// K7: thread i writes channel word w = base + i (of n_out); bits and words
// are the outputs from word `base` and pack base / wpl on (base is a
// multiple of wpl, and so is every CTA's first word).  SHARED: the packs
// come from the CTA's table and its first threads write the CTA's bit
// packs; else (the first design) each thread draws its window and the
// thread of a pack's first word writes it.
template <int WIDTH, bool SHARED>
__global__ void __launch_bounds__(kGenThreads)
gen_words_kernel(int* __restrict__ bits, int* __restrict__ words, int n_bits,
                 int base, int n_out, int n_packs, uint32_t k0, uint32_t k1,
                 float scale, float nscale, int noisy) {
  constexpr int kVpw = 32 / WIDTH;  // values per word
  constexpr int kSpw = kVpw / 2;    // stages per word
  constexpr int kWpl = 64 / kVpw;   // words per bit pack
  static_assert(kGenThreads % kWpl == 0, "a CTA holds whole bit packs");
  const int i = blockIdx.x * kGenThreads + threadIdx.x;
  const int w = base + i;
  uint32_t o0, o1;
  if constexpr (SHARED) {
    __shared__ uint32_t table[PackTable<kSpw>::kWords];
    const int w0 = w - static_cast<int>(threadIdx.x);  // the CTA's first word
    const int even = fill_packs<kSpw>(table, k0, k1, w0 * kSpw);
    if (threadIdx.x < kGenThreads / kWpl) {
      const int p = w0 / kWpl + static_cast<int>(threadIdx.x);
      if (p * kWpl - base < n_out && p < n_packs)
        bits[p - base / kWpl] =
            static_cast<int>(table[p - even] & tail_mask(n_bits - 32 * p));
    }
    if (i >= n_out) return;
    table_windows(table, even, w * kSpw, o0, o1);
  } else {
    if (i >= n_out) return;
    uint32_t own;
    parity_windows(k0, k1, w * kSpw, o0, o1, own);
    if (w % kWpl == 0 && w / kWpl < n_packs) {
      const int p = w / kWpl;
      bits[p - base / kWpl] =
          static_cast<int>(own & tail_mask(n_bits - 32 * p));
    }
  }
  uint32_t acc = 0u;
#pragma unroll
  for (int j = 0; j < kSpw; ++j) {
    float z0 = 0.0f, z1 = 0.0f;
    if (noisy)
      normal_pair(threefry<kGenRounds>(k0, k1, static_cast<uint32_t>(w),
                                       kNoiseTag + j),
                  z0, z1);
    if (w * kSpw + j < n_bits) {  // one stage per message bit
      const uint32_t f0 = quantize<WIDTH>(
          channel_value((o0 >> (25 - j)) & 1u, scale, nscale, z0, noisy));
      const uint32_t f1 = quantize<WIDTH>(
          channel_value((o1 >> (25 - j)) & 1u, scale, nscale, z1, noisy));
      acc |= f0 << (32 - (2 * j + 1) * WIDTH);
      acc |= f1 << (32 - (2 * j + 2) * WIDTH);
    }
  }
  words[i] = static_cast<int>(acc);
}

// K8: thread i writes stage s = base_stage + i (of n_out) as the float2
// [r0, r1] at values 2i, 2i + 1; every s < n_bits (the wrapper sizes n_out
// so) and base_stage is a multiple of 32.  SHARED: the CTA's first threads
// write its bit packs from its table; else the thread of a pack's first
// stage writes it.
template <bool SHARED>
__global__ void __launch_bounds__(kGenThreads)
gen_values_kernel(int* __restrict__ bits, float2* __restrict__ vals,
                  int n_bits, int base_stage, int n_out, uint32_t k0,
                  uint32_t k1, float scale, float nscale, int noisy) {
  const int i = blockIdx.x * kGenThreads + threadIdx.x;
  const int s = base_stage + i;
  uint32_t o0, o1;
  if constexpr (SHARED) {
    __shared__ uint32_t table[PackTable<1>::kWords];
    const int s0 = s - static_cast<int>(threadIdx.x);  // the CTA's first stage
    const int even = fill_packs<1>(table, k0, k1, s0);
    if (threadIdx.x < kGenThreads / 32) {
      const int p = s0 / 32 + static_cast<int>(threadIdx.x);
      if (32 * p - base_stage < n_out)
        bits[p - base_stage / 32] =
            static_cast<int>(table[p - even] & tail_mask(n_bits - 32 * p));
    }
    if (i >= n_out) return;
    table_windows(table, even, s, o0, o1);
  } else {
    if (i >= n_out) return;
    uint32_t own;
    parity_windows(k0, k1, s, o0, o1, own);
    if (s % 32 == 0)
      bits[(s - base_stage) / 32] =
          static_cast<int>(own & tail_mask(n_bits - s));
  }
  float z0 = 0.0f, z1 = 0.0f;
  if (noisy)
    normal_pair(threefry<kGenRounds>(k0, k1, static_cast<uint32_t>(s),
                                     kNoiseTag),
                z0, z1);
  vals[i] = make_float2(channel_value((o0 >> 25) & 1u, scale, nscale, z0,
                                      noisy),
                        channel_value((o1 >> 25) & 1u, scale, nscale, z1,
                                      noisy));
}

template <bool SHARED>
cudaError_t launch_words(int* bits, int* words, int n_bits, int base,
                         int n_out, int n_packs, uint32_t k0, uint32_t k1,
                         int width, float scale, float nscale, int noisy,
                         cudaStream_t stream) {
  const int grid = (n_out + kGenThreads - 1) / kGenThreads;
  switch (width) {
#define GEN_WORDS(W)                                                      \
  case W:                                                                 \
    if (base % (2 * W)) return cudaErrorInvalidValue; /* wpl = 2 W */     \
    gen_words_kernel<W, SHARED><<<grid, kGenThreads, 0, stream>>>(        \
        bits, words, n_bits, base, n_out, n_packs, k0, k1, scale, nscale, \
        noisy);                                                           \
    break;
    GEN_WORDS(1)
    GEN_WORDS(4)
    GEN_WORDS(8)
    GEN_WORDS(16)
#undef GEN_WORDS
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool SHARED>
cudaError_t launch_values(int* bits, float2* vals, int n_bits,
                          int base_stage, int n_out, uint32_t k0, uint32_t k1,
                          float scale, float nscale, int noisy,
                          cudaStream_t stream) {
  if (base_stage % 32 || base_stage + n_out > n_bits)
    return cudaErrorInvalidValue;
  const int grid = (n_out + kGenThreads - 1) / kGenThreads;
  gen_values_kernel<SHARED><<<grid, kGenThreads, 0, stream>>>(
      bits, vals, n_bits, base_stage, n_out, k0, k1, scale, nscale, noisy);
  return cudaGetLastError();
}

}  // namespace viterbi_gen

using namespace viterbi_gen;

// Plain C entry points (bound with ctypes); each returns the cudaError_t of
// the launch (0 = launched).  K7: width 1, 4, 8 or 16; base, a multiple of
// the words per bit pack; n_out words from base on; n_packs = ceil(n_bits /
// 32), the whole stream's.  K8: base_stage, a multiple of 32; n_out stages
// from it on, all below n_bits; vals 8-byte aligned.  noisy = 0 writes the
// noiseless streams (nscale unused).  The _old_ entries take the same
// arguments and run the first design's draws.
extern "C" int viterbi_k7_launch(void* bits, void* words, int n_bits, int base,
                                 int n_out, int n_packs, unsigned k0,
                                 unsigned k1, int width, float scale,
                                 float nscale, int noisy, void* stream) {
  if (n_out <= 0 || base < 0 || bits == nullptr || words == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_words<true>(
      static_cast<int*>(bits), static_cast<int*>(words), n_bits, base, n_out,
      n_packs, k0, k1, width, scale, nscale, noisy,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int viterbi_k7_old_launch(void* bits, void* words, int n_bits,
                                     int base, int n_out, int n_packs,
                                     unsigned k0, unsigned k1, int width,
                                     float scale, float nscale, int noisy,
                                     void* stream) {
  if (n_out <= 0 || base < 0 || bits == nullptr || words == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_words<false>(
      static_cast<int*>(bits), static_cast<int*>(words), n_bits, base, n_out,
      n_packs, k0, k1, width, scale, nscale, noisy,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int viterbi_k8_launch(void* bits, void* vals, int n_bits,
                                 int base_stage, int n_out, unsigned k0,
                                 unsigned k1, float scale, float nscale,
                                 int noisy, void* stream) {
  if (n_out <= 0 || base_stage < 0 || bits == nullptr || vals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_values<true>(
      static_cast<int*>(bits), static_cast<float2*>(vals), n_bits, base_stage,
      n_out, k0, k1, scale, nscale, noisy,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int viterbi_k8_old_launch(void* bits, void* vals, int n_bits,
                                     int base_stage, int n_out, unsigned k0,
                                     unsigned k1, float scale, float nscale,
                                     int noisy, void* stream) {
  if (n_out <= 0 || base_stage < 0 || bits == nullptr || vals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_values<false>(
      static_cast<int*>(bits), static_cast<float2*>(vals), n_bits, base_stage,
      n_out, k0, k1, scale, nscale, noisy,
      static_cast<cudaStream_t>(stream)));
}
