// threefry2x32 in counter mode, shared by the generator kernels K7 and K8
// (genkernel.cu, at 13 rounds) and the generator probe K20
// (genkernel_probe.cu, at 20 and 13), so what K20 times is K7's draw.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace viterbi_gen {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 with the Threefry rotation and key-injection schedule
// (tpu_viterbi/chain/genkernel.py:92-113): rotation t % 8 in round t, key
// injection after every 4th round and after the last.  At 20 rounds it is
// jax._src.prng.threefry_2x32.
template <int ROUNDS>
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t c0, uint32_t c1) {
  constexpr int kRots[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int t = 0; t < ROUNDS; ++t) {
    x0 += x1;
    x1 = rotl(x1, kRots[t % 8]);
    x1 ^= x0;
    if (t % 4 == 3 || t == ROUNDS - 1) {
      const int g = t / 4 + 1;
      x0 += ks[g % 3];
      x1 += ks[(g + 1) % 3] + static_cast<uint32_t>(g);
    }
  }
  return make_uint2(x0, x1);
}

}  // namespace viterbi_gen
