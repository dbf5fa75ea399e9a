// Kernel K11 (its op-cost part): the per-construct ALU cost probe behind
// the hardware model's ALU rate.  Replaces the TPU probe kernels of
// scripts/op_cost_probe.py:make_kernel (:45-105, launched at :129), which
// time one (32, 128) int32 vector construct of the ACS at a time.
//
// Each thread owns one element (r, l) of a (32, 128) int32 tile x: c =
// x[r][l], u = x[1][l] (the broadcast row), mask = (r % 3 == 0).  It starts
// from a = x[r][l] and applies its variant's construct `steps` x 8 times,
// then writes a; add4 carries four independent chains from x + k, k = 0..3,
// and writes their sum (scripts/op_cost_probe.py:87-97):
//   0 add       a = a + c
//   1 add4      four independent a_k = a_k + c
//   2 mul       a = a * c
//   3 cmpsel    a = a > c ? c - a : a
//   4 selconst  a = mask ? a + c : a - c
//   5 bcast     a = a + u
//   6 shiftor   a = (a << 1) | (c & 1)
// and the relayouts of the tile's rows (scripts/op_cost_probe.py:64-84),
// where e = a[:16] + c[:16] and o = a[16:] - c[16:]:
//   7 merge      rows e[0], o[0], e[1], o[1], ...   (the perfect shuffle)
//   8 halves     rows e, then o                     (no row moves)
//   9 cat8      10 cat4  11 cat2  12 cat1           runs of 8, 4, 2, 1 rows
//                of e and o in turns: e[0:g], o[0:g], e[g:2g], ...
//  13 permgather out[r] = a[(r + 1) mod 32] + c[r]  (jnp.take of [1..31, 0])
//  14 rollsub    out[r] = a[(r - 1) mod 32] + c[r]  (pltpu.roll(a, 1, 0))
// All arithmetic wraps in two's complement, as the plain version's int32
// does (tpu_viterbi_torch/scripts/op_cost_probe.py:op_cost_torch).  The
// grid is whole tiles, and every tile of the output equals the plain
// version's one tile.  Variants 0-6 give each thread one element of a tile,
// element e of thread i being i mod 4096.  The relayouts give a warp one
// column, lane r its row r: a row permutation is then one shfl.sync.idx
// from the lane the row comes from, the GPU form of a TPU sublane
// relayout.  In merge, halves and cat*, lane r holds c signed for its half
// (c above row 16, -c from it), so e and o are one add; halves moves no
// row and is that add alone.
//
// What bounds it: instruction issue, by design (the relayouts: the
// shuffle unit's rate); the only memory traffic is one load and one store
// a thread.  What the design does about it: the grid
// fills every SM (the wrapper launches a multiple of the SM count), each
// construct is written as inline PTX so that the front end cannot fold a
// chain of a + c into a + 8c (nor see that a shuffle is a permutation),
// and the step loop is not unrolled, so its body holds the 8 constructs
// and the loop's own 3 instructions.  ptxas
// still sees the PTX: the probe reads the loop's SASS (cuobjdump) and
// reports its instruction count beside each rate.

#include <cuda_runtime.h>

namespace viterbi_op_cost {

constexpr int kCols = 128;
constexpr int kTile = 32 * kCols;
constexpr int kUnroll = 8;
constexpr int kThreads = 256;

template <int V>
__device__ __forceinline__ int one(int a, int c, int u, int keep) {
  if constexpr (V == 0 || V == 1) {
    asm volatile("add.s32 %0, %0, %1;" : "+r"(a) : "r"(c));
  } else if constexpr (V == 2) {
    asm volatile("mul.lo.s32 %0, %0, %1;" : "+r"(a) : "r"(c));
  } else if constexpr (V == 3) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t.reg .s32 t;\n\t"
        "setp.gt.s32 p, %0, %1;\n\t"
        "sub.s32 t, %1, %0;\n\t"
        "selp.b32 %0, t, %0, p;\n\t}"
        : "+r"(a)
        : "r"(c));
  } else if constexpr (V == 4) {
    // keep >= 0 where the row's mask holds: slct picks a + c there
    asm volatile(
        "{\n\t.reg .s32 t0, t1;\n\t"
        "add.s32 t0, %0, %1;\n\t"
        "sub.s32 t1, %0, %1;\n\t"
        "slct.s32.s32 %0, t0, t1, %2;\n\t}"
        : "+r"(a)
        : "r"(c), "r"(keep));
  } else if constexpr (V == 5) {
    asm volatile("add.s32 %0, %0, %1;" : "+r"(a) : "r"(u));
  } else if constexpr (V == 6) {
    asm volatile(
        "{\n\t.reg .b32 t0, t1;\n\t"
        "shl.b32 t0, %0, 1;\n\t"
        "and.b32 t1, %1, 1;\n\t"
        "or.b32 %0, t0, t1;\n\t}"
        : "+r"(a)
        : "r"(c));
  }
  return a;
}

constexpr int kRelayout = 7;   // variants from here: a warp a column

// The lane whose row lands in row r of variant V's relayout.
template <int V>
__device__ __forceinline__ int source_lane(int r) {
  if constexpr (V == 13) return (r + 1) & 31;
  if constexpr (V == 14) return (r + 31) & 31;
  // merge (g 1) and cat<g>: block b = r / g of g rows is e's (b even) or
  // o's (b odd) rows (b / 2) g ..; o's rows live in lanes 16..31
  constexpr int g = V == 7 ? 1 : V == 9 ? 8 : V == 10 ? 4 : V == 11 ? 2 : 1;
  const int b = r / g;
  return (b & 1) * 16 + (b >> 1) * g + r % g;
}

template <int V>
__device__ __forceinline__ int relayout(int a, int cs, int src) {
  if constexpr (V <= 12) {
    asm volatile("add.s32 %0, %0, %1;" : "+r"(a) : "r"(cs));
    if constexpr (V != 8)
      asm volatile("shfl.sync.idx.b32 %0, %0, %1, 31, -1;"
                   : "+r"(a)
                   : "r"(src));
  } else {
    asm volatile(
        "shfl.sync.idx.b32 %0, %0, %2, 31, -1;\n\t"
        "add.s32 %0, %0, %1;"
        : "+r"(a)
        : "r"(cs), "r"(src));
  }
  return a;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
op_cost_kernel(const int* __restrict__ x, int* __restrict__ out, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (V >= kRelayout) {
    const int r = i % 32;                 // the lane's row
    const int w = i / 32;                 // the warp's column of its tile
    const int e = r * kCols + w % kCols;
    const int c = x[e];
    const int cs = V <= 12 && r >= 16 ? -c : c;
    const int src = source_lane<V>(r);
    int a = c;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) a = relayout<V>(a, cs, src);
    }
    out[(w / kCols) * kTile + e] = a;
    return;
  }
  const int e = i % kTile;
  const int r = e / kCols;
  const int c = x[e];
  const int u = x[kCols + e % kCols];
  const int keep = r % 3 == 0 ? 0 : -1;
  if constexpr (V == 1) {
    int a0 = c, a1 = c + 1, a2 = c + 2, a3 = c + 3;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        a0 = one<V>(a0, c, u, keep);
        a1 = one<V>(a1, c, u, keep);
        a2 = one<V>(a2, c, u, keep);
        a3 = one<V>(a3, c, u, keep);
      }
    }
    out[i] = a0 + a1 + a2 + a3;
  } else {
    int a = c;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) a = one<V>(a, c, u, keep);
    }
    out[i] = a;
  }
}

template <int V>
cudaError_t launch(const int* x, int* out, int steps, int tiles,
                   cudaStream_t stream) {
  op_cost_kernel<V><<<tiles * (kTile / kThreads), kThreads, 0, stream>>>(
      x, out, steps);
  return cudaGetLastError();
}

}  // namespace viterbi_op_cost

using namespace viterbi_op_cost;

// Launch variant `variant` (0..14, the list above) for `steps` steps over
// `tiles` tiles: x holds one (32, 128) int32 tile, out tiles of them.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k11_launch(int variant, const void* x, void* out,
                                  int steps, int tiles, void* stream) {
  const int* xi = static_cast<const int*>(x);
  int* o = static_cast<int*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps < 0 || tiles <= 0 || x == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: return static_cast<int>(launch<0>(xi, o, steps, tiles, s));
    case 1: return static_cast<int>(launch<1>(xi, o, steps, tiles, s));
    case 2: return static_cast<int>(launch<2>(xi, o, steps, tiles, s));
    case 3: return static_cast<int>(launch<3>(xi, o, steps, tiles, s));
    case 4: return static_cast<int>(launch<4>(xi, o, steps, tiles, s));
    case 5: return static_cast<int>(launch<5>(xi, o, steps, tiles, s));
    case 6: return static_cast<int>(launch<6>(xi, o, steps, tiles, s));
    case 7: return static_cast<int>(launch<7>(xi, o, steps, tiles, s));
    case 8: return static_cast<int>(launch<8>(xi, o, steps, tiles, s));
    case 9: return static_cast<int>(launch<9>(xi, o, steps, tiles, s));
    case 10: return static_cast<int>(launch<10>(xi, o, steps, tiles, s));
    case 11: return static_cast<int>(launch<11>(xi, o, steps, tiles, s));
    case 12: return static_cast<int>(launch<12>(xi, o, steps, tiles, s));
    case 13: return static_cast<int>(launch<13>(xi, o, steps, tiles, s));
    case 14: return static_cast<int>(launch<14>(xi, o, steps, tiles, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
