// Kernels K7 and K8: the fused workload generator of the in-graph
// simulation.  Message bits -> K=7 rate-1/2 convolutional encode -> BPSK ->
// AWGN -> quantize -> pack, with every random draw recomputed from a counter
// (threefry2x32 at 13 rounds, threefry.cuh, which K20 times), so the only
// device-memory traffic is the outputs.
//   - K7, viterbi_k7_launch: the four integer channels (HARD/SOFT4/SOFT8/
//     SOFT16) -> ceil(n/32) int32 message-bit packs and ceil(2n/vpw) int32
//     channel words.  Replaces the TPU kernel
//     tpu_viterbi/chain/genkernel.py:_gen_kernel (its naive window branch; the
//     fast_window branch measured slower on the TPU and is not ported).
//   - K8, viterbi_k8_launch: the FP32 wire -> ceil(n/32) int32 packs and 2n
//     f32 values [r0, r1] per stage.  Replaces _gen_kernel_f32.
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
// What bounds it on an H100: integer ALU work.  A SOFT8 word costs 4
// threefry-13 calls (2 for its encoder window, 1 per noise pair), each 13
// rounds of add/funnel-shift/xor plus 4 key injections, and two precise
// logf/sqrtf/sinf/cosf sequences; it writes 4 bytes (plus 4 per 16 words
// of bit packs).  K8 costs 3 threefry calls and one Box-Muller per stage
// and writes 8 bytes.
//
// What the design does about it: recompute over communicate, as on the TPU.
// One thread per channel word (K7) or per stage (K8) rebuilds its encoder
// window from the two covering bit packs (one funnel shift), so threads
// share nothing and the writes are coalesced int32 (K7) or float2 (K8).  The
// thread that owns bit pack p (the first word of it) writes p: its window's
// second pack IS pack p, so the pack costs no extra threefry call.
//
// Float rules (the plain version rounds each operation once): built without
// --use_fast_math; sym*scale + nscale*z is __fmul_rn/__fadd_rn, so nvcc does
// not contract it into an FMA; rintf rounds half to even as torch.round
// does; sqrtf is IEEE.  Positions are int32, as in the JAX kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace viterbi_gen {

constexpr int kGenThreads = 256;
constexpr int kGenRounds = 13;  // BigCrush-passing minimum (genkernel.py:85)
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

// The encoder's two parity windows for stages first .. first + 25: bit
// 25 - j of o0/o1 is the out0/out1 of stage first + j.  The window u holds
// message bits first - 6 .. first + 25 from the MSB, cut from the two
// covering packs; `own` returns the second one.  off >> 5 floors for the
// negative off of the first word, as JAX's int32 shift does.
__device__ __forceinline__ void parity_windows(uint32_t k0, uint32_t k1,
                                               int first, uint32_t& o0,
                                               uint32_t& o1, uint32_t& own) {
  const int off = first - 6;
  const uint32_t p1 = bit_pack(k0, k1, off >> 5);
  own = bit_pack(k0, k1, (off >> 5) + 1);
  const uint32_t u = __funnelshift_l(own, p1, off & 31);
  // tap delays {6, 3, 2, 1, 0} of 0o171 and {6, 5, 3, 2, 0} of 0o133
  o0 = u ^ (u >> 1) ^ (u >> 2) ^ (u >> 3) ^ (u >> 6);
  o1 = u ^ (u >> 2) ^ (u >> 3) ^ (u >> 5) ^ (u >> 6);
}

// Message bits of pack p kept: the first `keep` = n_bits - 32 p (clipped to
// 0 .. 32), so bits past the message are zero.
__device__ __forceinline__ uint32_t tail_mask(int keep) {
  if (keep >= 32) return 0xFFFFFFFFu;
  if (keep <= 0) return 0u;
  return 0xFFFFFFFFu << (32 - keep);
}

// Box-Muller on two 24-bit uniforms (genkernel.py:116-129); u1 is in
// (0, 1], so the log is finite.
__device__ __forceinline__ void normal_pair(uint2 x, float& z0, float& z1) {
  const float u1 = __fmul_rn(
      __fadd_rn(static_cast<float>(x.x & 0xFFFFFFu), 1.0f), 0x1p-24f);
  const float u2 = __fmul_rn(static_cast<float>(x.y & 0xFFFFFFu), 0x1p-24f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  const float theta = __fmul_rn(kTwoPi, u2);
  z0 = __fmul_rn(r, cosf(theta));
  z1 = __fmul_rn(r, sinf(theta));
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

// K7: thread i writes channel word w = base + i (of n_out) and, when it
// owns one, bit pack w / wpl.  bits and words are the outputs from word
// `base` and pack base / wpl on (base is a multiple of wpl).
template <int WIDTH>
__global__ void __launch_bounds__(kGenThreads)
gen_words_kernel(int* __restrict__ bits, int* __restrict__ words, int n_bits,
                 int base, int n_out, int n_packs, uint32_t k0, uint32_t k1,
                 float scale, float nscale, int noisy) {
  constexpr int kVpw = 32 / WIDTH;  // values per word
  constexpr int kSpw = kVpw / 2;    // stages per word
  constexpr int kWpl = 64 / kVpw;   // words per bit pack
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int w = base + i;
  uint32_t o0, o1, own;
  parity_windows(k0, k1, w * kSpw, o0, o1, own);
  if (w % kWpl == 0 && w / kWpl < n_packs) {
    const int p = w / kWpl;
    bits[p - base / kWpl] = static_cast<int>(own & tail_mask(n_bits - 32 * p));
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
// [r0, r1] at values 2i, 2i + 1, and bit pack s / 32 when s is its first
// stage.  Every s < n_bits (the wrapper sizes n_out so).
__global__ void __launch_bounds__(kGenThreads)
gen_values_kernel(int* __restrict__ bits, float2* __restrict__ vals,
                  int n_bits, int base_stage, int n_out, uint32_t k0,
                  uint32_t k1, float scale, float nscale, int noisy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int s = base_stage + i;
  uint32_t o0, o1, own;
  parity_windows(k0, k1, s, o0, o1, own);
  if (s % 32 == 0)
    bits[(s - base_stage) / 32] =
        static_cast<int>(own & tail_mask(n_bits - s));
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

template <int WIDTH>
cudaError_t launch_words(int* bits, int* words, int n_bits, int base,
                         int n_out, int n_packs, uint32_t k0, uint32_t k1,
                         float scale, float nscale, int noisy,
                         cudaStream_t stream) {
  const int grid = (n_out + kGenThreads - 1) / kGenThreads;
  gen_words_kernel<WIDTH><<<grid, kGenThreads, 0, stream>>>(
      bits, words, n_bits, base, n_out, n_packs, k0, k1, scale, nscale,
      noisy);
  return cudaGetLastError();
}

}  // namespace viterbi_gen

using namespace viterbi_gen;

// Plain C entry points (bound with ctypes); each returns the cudaError_t of
// the launch (0 = launched).  K7: width 1, 4, 8 or 16; base, a multiple of
// the words per bit pack; n_out words from base on; n_packs = ceil(n_bits /
// 32), the whole stream's.  K8: base_stage, a multiple of 32; n_out stages
// from it on, all below n_bits; vals 8-byte aligned.  noisy = 0 writes the
// noiseless streams (nscale unused).
extern "C" int viterbi_k7_launch(void* bits, void* words, int n_bits, int base,
                                 int n_out, int n_packs, unsigned k0,
                                 unsigned k1, int width, float scale,
                                 float nscale, int noisy, void* stream) {
  int* b = static_cast<int*>(bits);
  int* w = static_cast<int*>(words);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_out <= 0 || base < 0 || bits == nullptr || words == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (width) {
    case 1:
      return static_cast<int>(launch_words<1>(
          b, w, n_bits, base, n_out, n_packs, k0, k1, scale, nscale, noisy, s));
    case 4:
      return static_cast<int>(launch_words<4>(
          b, w, n_bits, base, n_out, n_packs, k0, k1, scale, nscale, noisy, s));
    case 8:
      return static_cast<int>(launch_words<8>(
          b, w, n_bits, base, n_out, n_packs, k0, k1, scale, nscale, noisy, s));
    case 16:
      return static_cast<int>(launch_words<16>(
          b, w, n_bits, base, n_out, n_packs, k0, k1, scale, nscale, noisy, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int viterbi_k8_launch(void* bits, void* vals, int n_bits,
                                 int base_stage, int n_out, unsigned k0,
                                 unsigned k1, float scale, float nscale,
                                 int noisy, void* stream) {
  if (n_out <= 0 || base_stage < 0 || base_stage % 32 ||
      base_stage + n_out > n_bits || bits == nullptr || vals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_out + kGenThreads - 1) / kGenThreads;
  gen_values_kernel<<<grid, kGenThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(bits), static_cast<float2*>(vals), n_bits, base_stage,
      n_out, k0, k1, scale, nscale, noisy);
  return static_cast<int>(cudaGetLastError());
}
