// Kernel K20: the generator probe, the counterpart of the three Pallas
// kernels of scripts/genkernel_probe.py, which asked whether the TPU could
// run the fused generator's pieces and how fast its threefry ran:
//   - entry 0, tf (tf_kernel :33, call :59): threefry2x32 at ROUNDS on n
//     counter pairs (c0 plane, then c1 plane) -> the two output words;
//   - entry 1, log_sqrt (log_kernel :39, call :75): logf(x) + sqrtf(x) on n
//     f32 values, the precise libm sequences the Box-Muller of K7 and K8
//     runs (this file, as genkernel.cu, is built without --use_fast_math);
//   - entry 2, many (many_kernel :87, call :101): the XOR of x0 ^ x1 over
//     reps threefry calls on counters (c0 + r, c1), r = 0 .. reps - 1, the
//     add wrapping in 32 bits -> one word a counter pair.
// threefry is threefry.cuh's, K7's own: ROUNDS 20 is the JAX probe's count
// (and jax._src.prng.threefry_2x32), 13 is K7's kGenRounds, so the rate of
// `many` at 13 reads straight into K7's bound.
// The plain PyTorch version is tpu_viterbi_torch/scripts/genkernel_probe.py
// (threefry2x32 of chain/genkernel.py, torch.log + torch.sqrt); tf and many
// agree with it bit for bit, log_sqrt within 2 ulp (logf is 1-ulp).
//
// What bounds it on an H100: integer ALU work.  A threefry-20 call is 20
// rounds of add, funnel shift and xor plus 5 two-add key injections and
// the counter's two adds, ~72 lane-instructions, against 8 bytes of
// counters read and 4 or 8 written; `many` reads and writes once for reps
// calls.  One thread a counter pair, 256 a CUDA block: nothing is shared.

#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace viterbi_gen_probe {

using viterbi_gen::threefry;

constexpr int kThreads = 256;

template <int ROUNDS>
__global__ void __launch_bounds__(kThreads)
tf_kernel(const uint32_t* __restrict__ c, uint32_t* __restrict__ o0,
          uint32_t* __restrict__ o1, long long n, uint32_t k0, uint32_t k1) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const uint2 x = threefry<ROUNDS>(k0, k1, c[i], c[n + i]);
  o0[i] = x.x;
  o1[i] = x.y;
}

__global__ void __launch_bounds__(kThreads)
log_sqrt_kernel(const float* __restrict__ x, float* __restrict__ o,
                long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  o[i] = __fadd_rn(logf(x[i]), sqrtf(x[i]));
}

template <int ROUNDS>
__global__ void __launch_bounds__(kThreads)
many_kernel(const uint32_t* __restrict__ c, uint32_t* __restrict__ o,
            long long n, uint32_t k0, uint32_t k1, int reps) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const uint32_t c0 = c[i], c1 = c[n + i];
  uint32_t acc = 0u;
#pragma unroll 4
  for (int r = 0; r < reps; ++r) {
    const uint2 x = threefry<ROUNDS>(k0, k1, c0 + static_cast<uint32_t>(r),
                                     c1);
    acc ^= x.x ^ x.y;
  }
  o[i] = acc;
}

template <int ROUNDS>
cudaError_t launch(int entry, const void* in, void* out0, void* out1,
                   long long n, uint32_t k0, uint32_t k1, int reps,
                   cudaStream_t stream) {
  const long long grid = (n + kThreads - 1) / kThreads;
  const uint32_t* c = static_cast<const uint32_t*>(in);
  if (entry == 0)
    tf_kernel<ROUNDS><<<grid, kThreads, 0, stream>>>(
        c, static_cast<uint32_t*>(out0), static_cast<uint32_t*>(out1), n, k0,
        k1);
  else
    many_kernel<ROUNDS><<<grid, kThreads, 0, stream>>>(
        c, static_cast<uint32_t*>(out0), n, k0, k1, reps);
  return cudaGetLastError();
}

}  // namespace viterbi_gen_probe

using namespace viterbi_gen_probe;

// Plain C entry point (bound with ctypes): entry 0 tf, 1 log_sqrt, 2 many.
// in: (2, n) uint32 counters (tf, many) or n f32 values (log_sqrt); out0
// (and out1 for tf): n words; rounds 20 or 13 (tf, many); reps >= 1
// (many).  Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k20_launch(int entry, const void* in, void* out0,
                                  void* out1, long long n, unsigned k0,
                                  unsigned k1, int reps, int rounds,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || (n + kThreads - 1) / kThreads > 0x7FFFFFFFLL ||
      in == nullptr || out0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (entry == 1) {
    log_sqrt_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out0), n);
    return static_cast<int>(cudaGetLastError());
  }
  if ((entry == 0 && out1 == nullptr) || (entry == 2 && reps < 1) ||
      (entry != 0 && entry != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rounds == 20)
    return static_cast<int>(launch<20>(entry, in, out0, out1, n, k0, k1, reps,
                                       s));
  if (rounds == 13)
    return static_cast<int>(launch<13>(entry, in, out0, out1, n, k0, k1, reps,
                                       s));
  return static_cast<int>(cudaErrorInvalidValue);
}
