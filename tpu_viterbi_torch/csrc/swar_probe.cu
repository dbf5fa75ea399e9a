// Kernel K18: the int16x2 SWAR ACS probe, two states' path metrics in one
// 32-bit word against the int32 stage.  Replaces the TPU probe kernels of
// scripts/swar_probe.py: _baseline_kernel (:74) and _swar_kernel (:109),
// launched by time_kernel at :168.
//
// Program g reads its block of x, rows g x rows_in .. of a (programs x
// rows_in, 128) int32 array; column c of it is one array, a thread each.
// bm[q] (q = 0..31) is a row of the block, the same every stage.  out[g]
// (64, 128) int32, wrapping:
//   0 baseline      pm = rows 0-63, pp = 64-127, bm = 128-159.  A stage:
//                   lo = pm[q], hi = pm[q + 32], e = max(lo + bm, hi - bm)
//                   and o = max(lo - bm, hi + bm) with strict decisions de,
//                   do; pp[q] = de ? 2 pp[q + 32] + 1 : 2 pp[q] and pp[q +
//                   32] likewise with do; pm = e | o.  out = pm + pp
//   1 swar/stage    pmw = rows 0-31, words (lo | hi << 16); pp = 32-95, bm
//                   = 96-127.  ce = pmw +16x2 (bm | -bm << 16), co = pmw
//                   +16x2 (-bm | bm << 16); e, o = the larger half of each
//                   (strict hi > lo); pp as baseline; then the children
//                   repacked: pmw[2k] = e[k] | e[16 + k] << 16, pmw[2k + 1]
//                   = o[k] | o[16 + k] << 16.  out row q and q + 32 = pmw[q]
//                   + pp[q], pmw[q] + pp[q + 32]
//   2 swar/4stages  as 1, but the first three stages of every four keep
//                   pmw[q] = e[q] | o[q] << 16; the fourth repacks
// The Hopper form of the packed stage: the JAX mask-fix add is __vadd2; X =
// __byte_perm(ce, co) of the low halves (c0e, c0o) and Y of the high halves
// (c1e, c1o); __vibmax_s16x2(X, Y) gives (e, o) in one word and the
// predicates X >= Y per half, whose negations are JAX's strict decisions;
// the repack is two __byte_perm a word pair.  The plain PyTorch version is
// swar_torch in tpu_viterbi_torch/scripts/swar_probe.py; each variant agrees
// with it bit for bit.
//
// What bounds it: the stage's issue at one thread an array, at few warps a
// scheduler its dependency latency; memory is a load of the block and a
// store of the output.  What the design does about it: every value lives in
// registers (baseline 64 pm + 64 pp + 32 bm, swar 32 pm words + 64 pp + 64
// packed bm words), and each predecessor pair q updates its own slots q and
// q + 32 in place, so a stage needs no second buffer.  The probe reads the
// registers and spills from -res-usage.

#include <cuda_runtime.h>

#include <cstdint>

namespace viterbi_swar {

constexpr int kCols = 128;
constexpr int kThreads = 64;

__device__ __forceinline__ uint32_t wadd(uint32_t a, uint32_t b) {
  return a + b;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
swar_kernel(const int* __restrict__ x, int* __restrict__ out, int stages,
            int programs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t / kCols, c = t % kCols;
  if (g >= programs) return;
  int* o = out + static_cast<size_t>(g) * 64 * kCols + c;
  if constexpr (V == 0) {
    const int* b = x + static_cast<size_t>(g) * 160 * kCols + c;
    uint32_t pm[64], pp[64], bm[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      pm[i] = static_cast<uint32_t>(b[i * kCols]);
      pp[i] = static_cast<uint32_t>(b[(64 + i) * kCols]);
    }
#pragma unroll
    for (int q = 0; q < 32; ++q)
      bm[q] = static_cast<uint32_t>(b[(128 + q) * kCols]);
#pragma unroll 1
    for (int s = 0; s < stages; ++s) {
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int c0e = static_cast<int>(pm[q] + bm[q]);
        const int c1e = static_cast<int>(pm[q + 32] - bm[q]);
        const int c0o = static_cast<int>(pm[q] - bm[q]);
        const int c1o = static_cast<int>(pm[q + 32] + bm[q]);
        const bool de = c1e > c0e, dod = c1o > c0o;
        const uint32_t fl = pp[q] << 1, fh = (pp[q + 32] << 1) | 1u;
        pm[q] = static_cast<uint32_t>(de ? c1e : c0e);
        pm[q + 32] = static_cast<uint32_t>(dod ? c1o : c0o);
        pp[q] = de ? fh : fl;
        pp[q + 32] = dod ? fh : fl;
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i)
      o[i * kCols] = static_cast<int>(wadd(pm[i], pp[i]));
  } else {
    constexpr int kRepack = V == 1 ? 1 : 4;
    const int* b = x + static_cast<size_t>(g) * 128 * kCols + c;
    uint32_t pmw[32], pp[64], bme[32], bmo[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      pmw[q] = static_cast<uint32_t>(b[q * kCols]);
      const uint32_t m = static_cast<uint32_t>(b[(96 + q) * kCols]);
      const uint32_t nm = 0u - m;
      bme[q] = __byte_perm(m, nm, 0x5410);  // (bm, -bm)
      bmo[q] = __byte_perm(nm, m, 0x5410);  // (-bm, bm)
    }
#pragma unroll
    for (int i = 0; i < 64; ++i)
      pp[i] = static_cast<uint32_t>(b[(32 + i) * kCols]);
#pragma unroll 1
    for (int s = 0; s < stages / kRepack; ++s) {
#pragma unroll
      for (int r = 0; r < kRepack; ++r) {
        uint32_t m[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const uint32_t ce = __vadd2(pmw[q], bme[q]);
          const uint32_t co = __vadd2(pmw[q], bmo[q]);
          bool ge_o, ge_e;  // c0o >= c1o (high half), c0e >= c1e (low)
          m[q] = __vibmax_s16x2(__byte_perm(ce, co, 0x5410),
                                __byte_perm(ce, co, 0x7632), &ge_o, &ge_e);
          const uint32_t fl = pp[q] << 1, fh = (pp[q + 32] << 1) | 1u;
          pp[q] = ge_e ? fl : fh;
          pp[q + 32] = ge_o ? fl : fh;
        }
        if (r == kRepack - 1) {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            pmw[2 * k] = __byte_perm(m[k], m[16 + k], 0x5410);
            pmw[2 * k + 1] = __byte_perm(m[k], m[16 + k], 0x7632);
          }
        } else {
#pragma unroll
          for (int q = 0; q < 32; ++q) pmw[q] = m[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      o[q * kCols] = static_cast<int>(wadd(pmw[q], pp[q]));
      o[(q + 32) * kCols] = static_cast<int>(wadd(pmw[q], pp[q + 32]));
    }
  }
}

template <int V>
cudaError_t launch(const int* x, int* out, int stages, int programs,
                   cudaStream_t stream) {
  const int threads = programs * kCols;
  swar_kernel<V><<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                   stream>>>(x, out, stages, programs);
  return cudaGetLastError();
}

}  // namespace viterbi_swar

using namespace viterbi_swar;

// Launch variant `variant` (0 baseline, 1 swar/stage, 2 swar/4stages) for
// `stages` stages (a multiple of 4) on x, (programs x rows_in, 128) int32
// with rows_in 160 for baseline and 128 for the swar variants, into out,
// (programs, 64, 128) int32.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int viterbi_k18_launch(int variant, const void* x, void* out,
                                  int stages, int programs, void* stream) {
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages < 0 || stages % 4 != 0 || programs <= 0 || x == nullptr ||
      out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(xi, o, stages, programs, s));
    case 1: return static_cast<int>(launch<1>(xi, o, stages, programs, s));
    case 2: return static_cast<int>(launch<2>(xi, o, stages, programs, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
