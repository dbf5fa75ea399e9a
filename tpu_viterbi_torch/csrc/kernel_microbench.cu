// Kernel K16: the ACS construct microbenchmark, one construct changed a
// variant.  Replaces the TPU probe kernel of scripts/kernel_microbench.py:
// make_kernel (:39), launched by run_variant at :85.
//
// Input rs: (n_packs, 32, 2, width) int32; column c is one array, stage t =
// 32 p + s reads bm = rs[p, s, 0, c] + rs[p, s, 1, c], the same for all 64
// states.  pm and pp start at zero; out (64, width) = pm + pp after n_packs
// x 32 stages, wrapping.  The JAX variants (row i of the new pm reads the
// predecessors lo = pm[src(i)], hi = pm[src(i) + 32]):
//   0 no_acs        pm[i] += bm, pp[i] += 1
//   1 concat        src(i) = i mod 32 (the rows [x; x]); c0 = lo + bm, c1 =
//                   hi - bm, dec = c1 > c0, pm = the larger, pp[i] =
//                   (pp[dec ? src + 32 : src] << 1) | dec
//   2 no_pp         pm as bcast; pp[i] += 1
//   3 bcast         src(i) = i / 2 (rows 2i, 2i+1 = x[i]); as concat
//   4 pltpu_repeat  pltpu.repeat(x, 2, 0) is [x; x]: concat's code
// The TPU kernel's relayouts are register renaming here: the variants
// differ only in which registers a child reads.  Every state starts at
// zero and sees the stage's one bm, so all 64 stay equal; ptxas proves it
// for bcast and no_pp (one state a stage) but not for concat and
// pltpu_repeat, whose 32 distinct child expressions it computes.  The
// plain PyTorch version is microbench_torch in
// tpu_viterbi_torch/scripts/kernel_microbench.py; each variant agrees with
// it bit for bit.
//
// What bounds it: the function needs one state's ACS a stage, so reading
// the input; the code issues what ptxas keeps of 64 states' ACS, at one
// thread an array, and at few warps a scheduler its dependency latency.
// What the design does about it: K14's shape (64 threads a block, metrics
// and survivors in registers, a loop of two stages whose next input loads
// while it runs), so that the variants differ in the construct alone.

#include <cuda_runtime.h>

#include <cstdint>

#include "acs.cuh"

namespace viterbi_microbench {

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
  for (int i = 0; i < kStates; ++i) {
    if constexpr (V == 0) {
      pmo[i] = add<true>(pm[i], bm);
      ppo[i] = pp[i] + 1u;
    } else {
      constexpr bool kConcat = V == 1 || V == 4;
      const int src = kConcat ? i % 32 : i / 2;
      const int c0 = add<true>(pm[src], bm), c1 = sub<true>(pm[src + 32], bm);
      const bool dec = c1 > c0;
      pmo[i] = dec ? c1 : c0;
      if constexpr (V == 2)
        ppo[i] = pp[i] + 1u;
      else
        ppo[i] = ((dec ? pp[src + 32] : pp[src]) << 1) | (dec ? 1u : 0u);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
microbench_kernel(const int* __restrict__ rs, int* __restrict__ out,
                  int n_packs, int width) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  const int* r = rs + c;  // stage t's pair at rows 2t, 2t + 1 of width
  const size_t w = static_cast<size_t>(width);
  const int stages = n_packs * kBpp;
  int pm_a[kStates], pm_b[kStates];
  uint32_t pp_a[kStates], pp_b[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    pm_a[i] = 0;
    pp_a[i] = 0u;
  }
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
    out[i * w + c] = add<true>(pm_a[i], static_cast<int>(pp_a[i]));
}

template <int V>
cudaError_t launch(const int* rs, int* out, int n_packs, int width,
                   cudaStream_t stream) {
  microbench_kernel<V>
      <<<(width + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          rs, out, n_packs, width);
  return cudaGetLastError();
}

}  // namespace viterbi_microbench

using namespace viterbi_microbench;

// Launch variant `variant` (0 no_acs, 1 concat, 2 no_pp, 3 bcast, 4
// pltpu_repeat) on rs, (n_packs, 32, 2, width) int32, into out, (64,
// width) int32.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k16_launch(int variant, const void* rs, void* out,
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
