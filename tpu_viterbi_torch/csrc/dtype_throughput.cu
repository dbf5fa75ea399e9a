// Kernel K17: the dtype-throughput probe, dependent add/max pairs in six
// element types, the narrow ones packed two or four to a 32-bit register.
// Replaces the TPU probe kernel of scripts/dtype_throughput.py: make_kernel
// (:29), launched at :50.
//
// Each thread owns kPack neighbouring elements e .. e + kPack - 1 (e = i x
// kPack mod 4096) of a (32, 128) int32 tile x, with c = x[1][col] (the JAX
// kernel's row 1, broadcast).  From a = x.astype(d) and c.astype(d) it runs
// `steps` steps of 16 pairs a = a + c, a = max(a, c - a) in type d and
// writes a.astype(int32): integers wrap and sign-extend, floats round to
// nearest even at every operation and convert toward zero, saturating
// (cvt.rzi, NaN to 0), as XLA converts.  So every output element equals the
// plain version's value at its tile position
// (tpu_viterbi_torch/scripts/dtype_throughput.py:dtype_torch).
//   0 int32  add.s32, sub.s32, max.s32 (inline PTX, as K15)
//   1 fp32   __fadd_rn, __fsub_rn, fmaxf
//   2 bf16   __nv_bfloat162: __hadd2, __hsub2, __hmax2
//   3 fp16   __half2: __hadd2, __hsub2, __hmax2
//   4 int16  int16x2: __vadd2, __vsub2, __vmaxs2
//   5 int8   four bytes: __vadd4, __vsub4, __vmaxs4
//
// What bounds it: instruction issue when the card holds enough warps, and
// the chain's dependency latency when it does not; the memory traffic is
// two loads and one store an element.  What the design does about it: the
// caller picks the occupancy (one tile, the JAX shape, or the SM's 2048
// threads), and the step loop is not unrolled, so its body holds the 16
// pairs and the loop's own instructions, which the probe reads from the
// SASS: the count shows whether a packed intrinsic is one instruction on
// sm_90 or a sequence.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace viterbi_dtype {

constexpr int kCols = 128;
constexpr int kTile = 32 * kCols;
constexpr int kUnroll = 16;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ int saturate(float f) { return __float2int_rz(f); }

template <int D>
struct Lane;

template <>
struct Lane<0> {  // int32
  using T = int;
  static constexpr int kPack = 1;
  static __device__ __forceinline__ T load(const int* v) { return v[0]; }
  static __device__ __forceinline__ T pair(T a, T c) {
    asm volatile(
        "{\n\t.reg .s32 t;\n\t"
        "add.s32 %0, %0, %1;\n\t"
        "sub.s32 t, %1, %0;\n\t"
        "max.s32 %0, %0, t;\n\t}"
        : "+r"(a)
        : "r"(c));
    return a;
  }
  static __device__ __forceinline__ void store(T a, int* o) { o[0] = a; }
};

template <>
struct Lane<1> {  // fp32
  using T = float;
  static constexpr int kPack = 1;
  static __device__ __forceinline__ T load(const int* v) {
    return __int2float_rn(v[0]);
  }
  static __device__ __forceinline__ T pair(T a, T c) {
    a = __fadd_rn(a, c);
    return fmaxf(a, __fsub_rn(c, a));
  }
  static __device__ __forceinline__ void store(T a, int* o) {
    o[0] = saturate(a);
  }
};

template <>
struct Lane<2> {  // bf16 x 2
  using T = __nv_bfloat162;
  static constexpr int kPack = 2;
  static __device__ __forceinline__ T load(const int* v) {
    return __floats2bfloat162_rn(__int2float_rn(v[0]), __int2float_rn(v[1]));
  }
  static __device__ __forceinline__ T pair(T a, T c) {
    a = __hadd2(a, c);
    return __hmax2(a, __hsub2(c, a));
  }
  static __device__ __forceinline__ void store(T a, int* o) {
    o[0] = saturate(__low2float(a));
    o[1] = saturate(__high2float(a));
  }
};

template <>
struct Lane<3> {  // fp16 x 2
  using T = __half2;
  static constexpr int kPack = 2;
  static __device__ __forceinline__ T load(const int* v) {
    return __floats2half2_rn(__int2float_rn(v[0]), __int2float_rn(v[1]));
  }
  static __device__ __forceinline__ T pair(T a, T c) {
    a = __hadd2(a, c);
    return __hmax2(a, __hsub2(c, a));
  }
  static __device__ __forceinline__ void store(T a, int* o) {
    o[0] = saturate(__low2float(a));
    o[1] = saturate(__high2float(a));
  }
};

template <>
struct Lane<4> {  // int16 x 2
  using T = uint32_t;
  static constexpr int kPack = 2;
  static __device__ __forceinline__ T load(const int* v) {
    return (static_cast<uint32_t>(v[0]) & 0xFFFFu) |
           (static_cast<uint32_t>(v[1]) << 16);
  }
  static __device__ __forceinline__ T pair(T a, T c) {
    a = __vadd2(a, c);
    return __vmaxs2(a, __vsub2(c, a));
  }
  static __device__ __forceinline__ void store(T a, int* o) {
    o[0] = static_cast<int16_t>(a & 0xFFFFu);
    o[1] = static_cast<int16_t>(a >> 16);
  }
};

template <>
struct Lane<5> {  // int8 x 4
  using T = uint32_t;
  static constexpr int kPack = 4;
  static __device__ __forceinline__ T load(const int* v) {
    uint32_t w = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w |= (static_cast<uint32_t>(v[k]) & 0xFFu) << (8 * k);
    return w;
  }
  static __device__ __forceinline__ T pair(T a, T c) {
    a = __vadd4(a, c);
    return __vmaxs4(a, __vsub4(c, a));
  }
  static __device__ __forceinline__ void store(T a, int* o) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = static_cast<int8_t>((a >> (8 * k)) & 0xFFu);
  }
};

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
dtype_kernel(const int* __restrict__ x, int* __restrict__ out, int steps) {
  using L = Lane<D>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int e = (i * L::kPack) % kTile;
  const typename L::T c = L::load(x + kCols + e % kCols);
  typename L::T a = L::load(x + e);
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) a = L::pair(a, c);
  }
  L::store(a, out + static_cast<size_t>(i) * L::kPack);
}

template <int D>
cudaError_t launch(const int* x, int* out, int steps, int blocks,
                   int threads, cudaStream_t stream) {
  dtype_kernel<D><<<blocks, threads, 0, stream>>>(x, out, steps);
  return cudaGetLastError();
}

}  // namespace viterbi_dtype

using namespace viterbi_dtype;

// Launch dtype `dtype` (0 int32, 1 fp32, 2 bf16, 3 fp16, 4 int16, 5 int8)
// for `steps` steps on blocks x threads threads (threads a multiple of 32,
// at most 256): x holds one (32, 128) int32 tile, out blocks x threads x
// pack int32 (pack 1, 1, 2, 2, 2, 4).  Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int viterbi_k17_launch(int dtype, const void* x, void* out,
                                  int steps, int blocks, int threads,
                                  void* stream) {
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps < 0 || blocks <= 0 || threads <= 0 || threads % 32 != 0 ||
      threads > kMaxThreads || x == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return static_cast<int>(launch<0>(xi, o, steps, blocks, threads, s));
    case 1: return static_cast<int>(launch<1>(xi, o, steps, blocks, threads, s));
    case 2: return static_cast<int>(launch<2>(xi, o, steps, blocks, threads, s));
    case 3: return static_cast<int>(launch<3>(xi, o, steps, blocks, threads, s));
    case 4: return static_cast<int>(launch<4>(xi, o, steps, blocks, threads, s));
    case 5: return static_cast<int>(launch<5>(xi, o, steps, blocks, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
