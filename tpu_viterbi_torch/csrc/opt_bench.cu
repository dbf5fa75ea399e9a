// Kernel K19: the even/odd ACS with int32 or int16 path metrics and
// survivors.  Replaces the TPU probe kernel of scripts/opt_bench.py:
// make_kernel (:30), launched by run at :73.
//
// Input rs: (n_packs, 32, 2, width) int32; column c is one array, a thread
// each, stage t = 32 p + s reads bm = rs[p, s, 0, c] + rs[p, s, 1, c] (in
// the metric's type: int16 keeps its low half).  States 0..63 start at
// zero.  A stage: lo = pm[q], hi = pm[q + 32] (q = 0..31); e = max(lo + bm,
// hi - bm) and o = max(lo - bm, hi + bm) with strict decisions de, do; the
// children are states 2q and 2q + 1; survivors pe = (de ? pp[q + 32] :
// pp[q]) << 1 | de and po likewise.  out[i] = pm[i] + pp[i] in the metric's
// type, sign-extended.  Variants:
//   0 i32_split  int32 metrics and survivors, a state a register
//   1 i16        int16 metrics and survivors, two neighbouring states a
//                register (int16x2): W[k] = (state 2k, state 2k + 1)
//   2 i16_pm     int16x2 metrics as i16, int32 survivors as i32_split
// The int16x2 stage, for a word pair j = 0..15 (L = W[j] holds lo of q =
// 2j, 2j + 1, H = W[16 + j] their hi): c0e = __vadd2(L, B), c1e =
// __vsub2(H, B), c0o = __vsub2(L, B), c1o = __vadd2(H, B) with B = (bm,
// bm); E = __vibmax_s16x2(c0e, c1e) holds e of q = 2j, 2j + 1 and sets the
// predicates c0e >= c1e per half, the negations of JAX's de; O likewise;
// the children of q = 2j are states 4j, 4j + 1 and of 2j + 1 states 4j + 2,
// 4j + 3, so the next words are __byte_perm(E, O) of the low halves and of
// the high halves: JAX's merge interleave.  The int16x2 survivors select a
// half at a time between the pre-shifted words (PL << 1) and (PH << 1) | 1
// (each half shifted in int16) and interleave the same way.  The plain
// PyTorch version is opt_bench_torch in
// tpu_viterbi_torch/scripts/opt_bench.py; each variant agrees with it bit
// for bit at every block size.
//
// What bounds it: the ACS' issue at one thread an array (256 operations an
// array-stage in int32, half the metric's with two states a register), at
// few warps a scheduler its dependency latency.  What the design does about
// it: K14's shape (metrics and survivors in registers, a loop of two
// stages whose next input loads while it runs); the JAX lane-tile width is
// the block size (128, 256 or 512 threads), a kernel each with its own
// launch bound: at 512 threads a block a thread may hold 128 registers, so
// the int32 variant's 128 metrics and survivors spill there, while the
// int16x2 metrics take half the registers.

#include <cuda_runtime.h>

#include <cstdint>

namespace viterbi_opt_bench {

constexpr int kBpp = 32;

__device__ __forceinline__ uint32_t lo_halves(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5410);  // (a.lo, b.lo)
}
__device__ __forceinline__ uint32_t hi_halves(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);  // (a.hi, b.hi)
}
__device__ __forceinline__ uint32_t halves(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7610);  // (lo.lo, hi.hi)
}

// The metrics of one variant: 64 int32 states, or 32 int16x2 words.
template <int V>
struct Metrics {
  static constexpr int kWords = V == 0 ? 64 : 32;
};

// The survivors: 64 uint32 states (i32_split, i16_pm) or 32 int16x2 words.
template <int V>
struct Survivors {
  static constexpr int kWords = V == 1 ? 32 : 64;
};

template <int V>
__device__ __forceinline__ void stage(
    const uint32_t (&pm)[Metrics<V>::kWords],
    const uint32_t (&pp)[Survivors<V>::kWords],
    uint32_t (&pmo)[Metrics<V>::kWords],
    uint32_t (&ppo)[Survivors<V>::kWords], uint32_t bm) {
  if constexpr (V == 0) {
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int c0e = static_cast<int>(pm[q] + bm);
      const int c1e = static_cast<int>(pm[q + 32] - bm);
      const int c0o = static_cast<int>(pm[q] - bm);
      const int c1o = static_cast<int>(pm[q + 32] + bm);
      const bool de = c1e > c0e, dod = c1o > c0o;
      pmo[2 * q] = static_cast<uint32_t>(de ? c1e : c0e);
      pmo[2 * q + 1] = static_cast<uint32_t>(dod ? c1o : c0o);
      const uint32_t fl = pp[q] << 1, fh = (pp[q + 32] << 1) | 1u;
      ppo[2 * q] = de ? fh : fl;
      ppo[2 * q + 1] = dod ? fh : fl;
    }
  } else {
    const uint32_t b = __byte_perm(bm, 0u, 0x1010);  // (bm, bm), int16
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t l = pm[j], h = pm[16 + j];
      bool ge_e1, ge_e0, ge_o1, ge_o0;  // c0 >= c1 for q = 2j + 1, 2j
      const uint32_t e = __vibmax_s16x2(__vadd2(l, b), __vsub2(h, b),
                                        &ge_e1, &ge_e0);
      const uint32_t o = __vibmax_s16x2(__vsub2(l, b), __vadd2(h, b),
                                        &ge_o1, &ge_o0);
      pmo[2 * j] = lo_halves(e, o);
      pmo[2 * j + 1] = hi_halves(e, o);
      if constexpr (V == 1) {
        const uint32_t fl = (pp[j] << 1) & 0xFFFEFFFEu;
        const uint32_t fh = ((pp[16 + j] << 1) & 0xFFFEFFFEu) | 0x00010001u;
        const uint32_t pe = halves(ge_e0 ? fl : fh, ge_e1 ? fl : fh);
        const uint32_t po = halves(ge_o0 ? fl : fh, ge_o1 ? fl : fh);
        ppo[2 * j] = lo_halves(pe, po);
        ppo[2 * j + 1] = hi_halves(pe, po);
      } else {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int q = 2 * j + k;
          const bool ge_e = k ? ge_e1 : ge_e0, ge_o = k ? ge_o1 : ge_o0;
          const uint32_t fl = pp[q] << 1, fh = (pp[q + 32] << 1) | 1u;
          ppo[2 * q] = ge_e ? fl : fh;
          ppo[2 * q + 1] = ge_o ? fl : fh;
        }
      }
    }
  }
}

template <int V, int THREADS>
__global__ void __launch_bounds__(THREADS)
opt_kernel(const int* __restrict__ rs, int* __restrict__ out, int n_packs,
           int width) {
  constexpr int kM = Metrics<V>::kWords, kP = Survivors<V>::kWords;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  const int* r = rs + c;  // stage t's pair at rows 2t, 2t + 1 of width
  const size_t w = static_cast<size_t>(width);
  const int stages = n_packs * kBpp;
  uint32_t pm_a[kM], pm_b[kM], pp_a[kP], pp_b[kP];
#pragma unroll
  for (int i = 0; i < kM; ++i) pm_a[i] = 0u;
#pragma unroll
  for (int i = 0; i < kP; ++i) pp_a[i] = 0u;
  int x0 = __ldg(r), y0 = __ldg(r + w), x1 = __ldg(r + 2 * w),
      y1 = __ldg(r + 3 * w);
#pragma unroll 1
  for (int t = 0; t < stages; t += 2) {
    const uint32_t bm0 = static_cast<uint32_t>(x0) + static_cast<uint32_t>(y0);
    const uint32_t bm1 = static_cast<uint32_t>(x1) + static_cast<uint32_t>(y1);
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
  for (int i = 0; i < 64; ++i) {
    int v;
    if constexpr (V == 0) {
      v = static_cast<int>(pm_a[i] + pp_a[i]);
    } else {
      const uint32_t m = pm_a[i / 2] >> (16 * (i % 2));
      uint32_t p;
      if constexpr (V == 1)
        p = pp_a[i / 2] >> (16 * (i % 2));
      else
        p = pp_a[i];
      v = static_cast<int16_t>((m + p) & 0xFFFFu);
    }
    out[i * w + c] = v;
  }
}

template <int V, int THREADS>
cudaError_t launch_lt(const int* rs, int* out, int n_packs, int width,
                      cudaStream_t stream) {
  opt_kernel<V, THREADS>
      <<<(width + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
          rs, out, n_packs, width);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch(const int* rs, int* out, int n_packs, int width,
                   int threads, cudaStream_t stream) {
  switch (threads) {
    case 128: return launch_lt<V, 128>(rs, out, n_packs, width, stream);
    case 256: return launch_lt<V, 256>(rs, out, n_packs, width, stream);
    case 512: return launch_lt<V, 512>(rs, out, n_packs, width, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace viterbi_opt_bench

using namespace viterbi_opt_bench;

// Launch variant `variant` (0 i32_split, 1 i16, 2 i16_pm) on rs, (n_packs,
// 32, 2, width) int32, into out, (64, width) int32, in blocks of `threads`
// (128, 256 or 512: the JAX lane-tile width).  Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int viterbi_k19_launch(int variant, const void* rs, void* out,
                                  int n_packs, int width, int threads,
                                  void* stream) {
  const int* r = static_cast<const int*>(rs);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_packs <= 0 || width <= 0 || rs == nullptr || out == nullptr ||
      (threads != 128 && threads != 256 && threads != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(r, o, n_packs, width, threads, s));
    case 1: return static_cast<int>(launch<1>(r, o, n_packs, width, threads, s));
    case 2: return static_cast<int>(launch<2>(r, o, n_packs, width, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
