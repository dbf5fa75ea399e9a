// Kernels K1-K5: fused Viterbi decode (K=7, rate 1/2, polynomials
// 0o171/0o133), and K6: the staging transpose that feeds K4 and K5.  In
// the decode kernels one thread per overlap-save time-block reads its
// block's channel input, runs branch metrics and the even/odd
// add-compare-select (ACS) with register exchange, dumps a survivor pack
// every bpp stages and traces back from state 0.
//
// One kernel template over the stage reader (the input format), the pack
// width and the survivor mode, with one plain C entry point per kernel:
//   - K1, viterbi_k1_launch: IntReader<WIDTH> (HARD/SOFT4/SOFT8/SOFT16 packed
//     int32 words, read from the flat stream), full store.  Replaces the TPU
//     kernel tpu_viterbi/decoder/core_pallas.py:_viterbi_kernel_fused (the
//     word-mode unpack of _viterbi_kernel and the full-store branch of
//     _decode_core); with UdReader (width code kUdWidth) the FP32 channel's
//     u/d words, its ud_mode branch (:600-602), which the JAX package
//     reaches through _run_kernel_fused(..., ud_mode=True) (:1167-1177).
//     Path metrics: int16x2 (acs.cuh's acs_stage16, renormalised every
//     pack) for widths 1, 4, 8 and kUdWidth, int32 (acs_stage) for 16,
//     chosen at compile time by the width, whatever the metric mode.
//     Source.p1, where not null, is the stream's tail halo: the wph words
//     that logically follow it (decode_packed_pallas's tail_halo,
//     core_pallas.py:1128, placed by _body_and_edge into the last tile's
//     edge row, :828-860), read by K1's and K3's HaloReader instances on
//     the integer channels (k1_halo, k3_halo, in build parts of their own);
//     the sharded decoder hands each rank its neighbour's first words so.
//   - K2, viterbi_k2_launch: FloatReader (the FP32 channel's raw interleaved
//     f32 wire), full store, int16x2 metrics.  Replaces
//     _viterbi_kernel_fused_f32v; its TPU staging (_body_and_edge's roll
//     halo) is not needed: K2 reads the flat wire.  The u/d-word staging
//     core_xla.fp32_ud_words is core_torch.fp32_ud_words_torch, plain torch
//     ops as the JAX one is XLA.
//   - K3, viterbi_k3_launch: K1's and K2's readers with the windowed
//     survivor ring in shared memory, int16x2 metrics where K1 and K2 run
//     them (int32 on SOFT16).  Replaces the window=True branch of
//     _decode_core (:440-486) with its slot count survivor_window_slots
//     (:295-315), the reference's one-pointer circular buffer
//     (viterbi.cu:99-100).
//   - The int32 sides of the int16x2 A/Bs, never launched by a decode path:
//     viterbi_k1_i32_launch (K1 on SOFT8), viterbi_k2_i32_launch (K2) and
//     viterbi_k3_i32_launch (K3 on SOFT8 and the FP32 wire), each its
//     kernel's earlier acs_stage instances.
//   - K4, viterbi_k4_launch: the decode from STAGED input, full store or
//     window: IntReader<WIDTH, true> on the (Lw, B) word-major words of K6
//     (word mode), PlaneReader<int> / UnclampedReader on the (2 *
//     block_len, B) staged values (value mode; f32 NOT clamped, exact on any
//     value).  Replaces _viterbi_kernel called by _run_kernel
//     (core_pallas.py:951-997).
//   - K5, viterbi_k5_launch: PlaneReader<float> on the two f32 planes of
//     stage_floats_2streams, clamped to [-8, 7] by the staging (values
//     outside it are outside K5's contract), full store or window.  Replaces
//     _viterbi_kernel_f32_2s (:617) called by _run_kernel_f32_2s (:1000).
//   - K6, viterbi_k6_launch: out[i, k] = in[k * stride + i], the
//     overlapped-window transpose into the word-major layout.  Replaces
//     _stage_tr_kernel (:1061) called by stage_words_pallas (:1067).
// The full store lies in device memory as (n_packs, 64, B) 32-bit words,
// so the 32 threads of a warp write 32 neighbouring words; a staged input
// row is read the same way, one coalesced load per warp.
// The plain PyTorch versions are in tpu_viterbi_torch/decoder/core_torch.py
// (decode_blocks_torch: K1-K3, decode_staged_torch: K4,
// decode_planes_torch: K5, stage_transpose: K6); each kernel must agree
// with its plain version bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libviterbi.so viterbi.cu
// (no --use_fast_math: K2's clamp must keep NaN and its adds must round
// once; tpu_viterbi_torch/decoder/core_cuda.py builds it at first use and
// binds the entry points with ctypes).
//
// What bounds the decode on an H100: the ACS' instruction issue at one warp
// a scheduler.  Each stage of each block runs 32 butterflies; with int32
// metrics that is 4 adds, 2 compares and 4 selects plus the survivor
// shifts, 398 SASS a stage where the minimal ACS needs 256, against 2..64
// bits of channel input a stage and 64 x 4 bytes of survivors per bpp
// stages.  At the 32M-bit headline (dec_len 2048) 15,872 time-blocks make
// 496 warps for the card's 528 schedulers, so no second warp hides a
// warp's dependency latency and per-warp issue sets the time.
//
// What the design does about it: one thread per time-block (the JAX
// kernel's blocks-on-lanes layout).  The path metrics and 64 survivor
// registers live in registers, double-buffered and fully unrolled over the
// 32 butterflies, so the trellis' even/odd interleave is register renaming
// and the +-1 branch signs fold into add/sub at compile time: no shuffles,
// no per-stage memory traffic besides the channel input, prefetched ahead.
// K1, K2 and K3 keep two states' metrics in a register (int16x2): one
// VIADD.16x2 adds a branch metric to two states and one VIMNMX.S16x2 takes
// two maxima and both decisions, so a stage issues fewer instructions; the
// survivors stay int32.  At SOFT8 b32 K1's stage loop issues 272 SASS a
// stage against 395.5 for the int32 instance, in 134 registers against 176,
// no spills (chip_smoke.py phases 5b-5d read each kernel's two instances
// from the built library's cubin).  Path metrics start at zero in every
// block; int16x2 metrics subtract state 0's every pack, after the survivor
// dump (the window's ring write; acs.cuh: no int16 wraps), int32 ones the
// per-pack minimum only when the plan needs it (renorm flag).  The ring's
// chase reads only the survivors, whatever the metrics' width.
//
// K2's f32 work is 2 clamps, 2 adds and 2 conversions a stage against
// ~270-400 integer instructions; a stage reads 8 bytes of wire (4x
// SOFT8's), 0.5 GB at the 32M-bit headline: far under the card's bandwidth
// in the ACS' time.  K3's per-pack chase adds W - 1 shared loads a pack,
// and the survivor traffic to device memory (K1's 264 MB at the 32M-bit
// headline) is gone; its ring (64 or 96 KB a CTA of 64 threads) sets the
// occupancy, not the registers, so int16x2 gains it issue alone.
// K4/K5 read the same bytes as K1/K2 but coalesced (K1's flat reader loads
// each block's words at a stride of wpb words); K6 is a copy, bound by
// device-memory bandwidth: 32x33 tiles in shared memory make both its
// reads (along a block's words) and its writes (along the blocks)
// coalesced.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "acs.cuh"

// Build parts: library.load_library compiles this file once per part, all
// started together, with -DBUILD_PART=<i> for each i below the count on the
// next line; a part holds the entry points of its group (K1 K2 K6 and
// K1_I32 K2_I32 | K3 K3_I32 | K4's word mode | K4's value mode and K5 |
// K1's tail-halo instances | K3's), so the ptxas work of the ~80 decode
// instances runs on six cores.  Built by hand without the macro, one
// object holds every entry point.
// nvcc parts: 6
#ifdef BUILD_PART
#define IN_PART(i) (BUILD_PART == (i))
#else
#define IN_PART(i) 1
#endif

namespace viterbi {

constexpr int kThreads = 64;  // time-blocks (threads) per CUDA block

// Truncation toward zero into the integer ACS.  cvt.rzi saturates out of
// range values, as XLA's conversion does; a NaN becomes 0, as XLA makes
// it.
__device__ __forceinline__ int trunc_int(float x) {
  return x != x ? 0 : __float2int_rz(x);
}

// Where a reader finds its block's input.  Flat stream (K1-K3): p0 holds n
// words (f32 values), block k starts at word k * stride (stride = wpb) and
// reads its halo past its body; for the integer words p1 is null or the
// tail halo, the wph words that follow word n - 1.  Staged (K4, K5): p0
// (and p1) are planes of n rows, row i of block k at element i * stride + k.
struct Source {
  const void* p0;
  const void* p1;
  long long n;
  long long stride;
};

// Word reader of one block: each word holds 16 / WIDTH stage pairs, MSB
// first (viterbiDF.h:157-163).  STAGED = false (K1, K3): the block's words
// k*wpb ... k*wpb + wpb + wph - 1 of the flat stream, halo included (it may
// span several following bodies when dec_len < 64); words past the stream
// read as zero.  HALO = true (HaloReader: K1 and K3 given a tail halo):
// word n + j reads Source.p1[j] for j < kHaloWords = wph = 2 * WARMUP /
// (32 / WIDTH) (4 at HARD, 16 SOFT4, 32 SOFT8, 64 SOFT16), and zero past
// it, so a decode with the halo equals one of the stream with the halo
// appended, and no copy of the stream is made.  Its load selects the
// address and predicates one load on the halo's end: 4.5 SASS a stage
// over K1's 272 at SOFT8 b32, where a branch to the halo cost 10.5.  The
// instances without a halo keep their code, and so their speed (a halo
// test in every instance added 11.5 SASS a stage to K1's loop and 6
// registers; PERF.md, PR 13).  The wrapper refuses a halo below dec_len
// 64, where it would reach past the last block's neighbour.  STAGED = true
// (K4 word mode): row i of column k of K6's (Lw, B) output, so a warp's 32
// loads are one coalesced row segment; it takes no halo.
// UD = true (K1 and K3 on the FP32 channel's u/d words, WIDTH 8): the two
// fields of a stage ARE u and d, trunc(r0 + r1) and trunc(r0 - r1) packed
// by the staging (core_torch.fp32_ud_words_torch), so no add or sub
// follows the unpack (core_pallas.py:600-602).
template <int WIDTH, bool STAGED = false, bool UD = false,
          bool HALO = false>
struct IntReader {
  static_assert(!(HALO && STAGED), "the tail halo follows a flat stream");
  static constexpr int kPairsPerWord = 16 / WIDTH;
  static constexpr int kHaloWords = 2 * 64 / (32 / WIDTH);
  static constexpr bool kWrap = false;

  const int* words;
  const int* halo;  // the tail halo (HALO), non-null
  long long n_words;
  long long step;
  long long next_idx;
  uint32_t cur;
  uint32_t nxt;

  __device__ __forceinline__ uint32_t load(long long idx) const {
    if constexpr (HALO) {  // one predicated load from either array
      const int* p = idx < n_words ? words + idx : halo + (idx - n_words);
      return idx < n_words + kHaloWords ? static_cast<uint32_t>(__ldg(p))
                                        : 0u;
    } else {
      return idx < n_words
                 ? static_cast<uint32_t>(__ldg(words + (STAGED ? idx * step
                                                               : idx)))
                 : 0u;
    }
  }

  __device__ __forceinline__ IntReader(const Source& src, int blk)
      : words(static_cast<const int*>(src.p0) + (STAGED ? blk : 0)),
        halo(HALO ? static_cast<const int*>(src.p1) : nullptr),
        n_words(src.n), step(src.stride),
        next_idx(STAGED ? 0 : static_cast<long long>(blk) * src.stride),
        cur(0u), nxt(0u) {
    nxt = load(next_idx++);
  }

  // The branch metrics of global stage s of the block; stages must be read
  // in order.  HARD bits map to +-1 as bit*2-1; soft fields are two's
  // complement, sign-extended by an arithmetic shift (core_pallas.py:594-
  // 599).
  __device__ __forceinline__ void next(int s, Bm& m) {
    if (s % kPairsPerWord == 0) {  // fetch the word after the new one
      cur = nxt;
      nxt = load(next_idx++);
    }
    int a0, a1;
    if constexpr (WIDTH == 1) {
      a0 = static_cast<int>(cur >> 31) * 2 - 1;
      a1 = static_cast<int>((cur >> 30) & 1u) * 2 - 1;
    } else {
      a0 = static_cast<int>(cur) >> (32 - WIDTH);
      a1 = static_cast<int>(cur << WIDTH) >> (32 - WIDTH);
    }
    if constexpr (2 * WIDTH < 32) cur <<= 2 * WIDTH;
    if constexpr (UD) {
      m.u = a0;
      m.d = a1;
      m.nu = -a0;
      m.nd = -a1;
    } else {
      int_bm(a0, a1, m);
    }
  }
};

// K1's and K3's reader of the u/d words: SOFT8's framing (4 fields a word,
// so wph = 2 * WARMUP / 4, core_pallas.py:896), fields taken as (u, d).
using UdReader = IntReader<8, false, true>;
constexpr int kUdWidth = -8;  // the entry points' width code for UdReader
// K1's and K3's reader of integer words followed by a tail halo
template <int WIDTH>
using HaloReader = IntReader<WIDTH, false, false, true>;

// Reader of the FP32 channel's raw interleaved wire [r0, r1, r0, r1, ...]:
// one float4 holds two stages.  Block k starts at value `first` =
// k * 2 * dec_len, a multiple of 4 since dec_len is a multiple of 16, so the
// float4 loads are aligned (the wrapper checks the wire's 16-byte
// alignment); it reads its halo past its body.  Values past the stream read
// as zero, a ragged last float4 is zero-filled, as the plain version's zero
// fill does.  Each load is issued 4 stages before its values are used, as
// K1's word reader runs a word (4 SOFT8 stages) ahead: the FP32 wire is 8
// bytes a stage, so one stage of lead would expose the load's latency.
//
// Per stage: clamp to [-8, 7] (FP_PRECISION, config.py) with compares that
// keep a NaN a NaN (fminf/fmaxf would turn it into a bound), u = r0 + r1 and
// d = r0 - r1 as single f32 adds, then truncation toward zero into the
// integer ACS.  trunc is odd and the branch signs are +-1, so
// +-trunc(u or d) equals the plain core's trunc(s0*r0 + s1*r1)
// (core_xla.py:259-264); the clamp keeps it far from saturation.  Built
// without --use_fast_math so none of this is reassociated.
struct FloatReader {
  static constexpr bool kWrap = false;

  const float* vals;
  long long n_vals;
  long long next_quad;
  float4 cur, q1, q2;  // stages s, s+1 | s+2, s+3 | s+4, s+5

  __device__ __forceinline__ float4 load(long long quad) const {
    const long long v = 4 * quad;
    if (v + 3 < n_vals)
      return __ldg(reinterpret_cast<const float4*>(vals) + quad);
    float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (v < n_vals) r.x = __ldg(vals + v);
    if (v + 1 < n_vals) r.y = __ldg(vals + v + 1);
    if (v + 2 < n_vals) r.z = __ldg(vals + v + 2);
    return r;
  }

  __device__ __forceinline__ FloatReader(const Source& src, int blk)
      : vals(static_cast<const float*>(src.p0)), n_vals(src.n),
        next_quad(0), cur(make_float4(0.0f, 0.0f, 0.0f, 0.0f)) {
    const long long first_quad = static_cast<long long>(blk) * src.stride / 4;
    q1 = load(first_quad);
    q2 = load(first_quad + 1);
    next_quad = first_quad + 2;
  }

  static __device__ __forceinline__ float clamp(float x) {
    return x < -8.0f ? -8.0f : (x > 7.0f ? 7.0f : x);
  }

  __device__ __forceinline__ void next(int s, Bm& m) {
    float a, b;
    if (s % 2 == 0) {  // a new float4: shift the prefetch queue
      cur = q1;
      q1 = q2;
      q2 = load(next_quad++);
      a = cur.x;
      b = cur.y;
    } else {
      a = cur.z;
      b = cur.w;
    }
    const float r0 = clamp(a);
    const float r1 = clamp(b);
    m.u = trunc_int(__fadd_rn(r0, r1));
    m.d = trunc_int(__fsub_rn(r0, r1));
    m.nu = -m.u;
    m.nd = -m.d;
  }
};

// Reader of staged values (K4 value mode, K5): r0 of stage t at row t of
// plane p0, r1 at row t of plane p1, column k.  K4 value mode passes K6's
// (2 * block_len, B) output with p1 = p0 + B and a row step of 2B (rows 2t
// and 2t + 1); K5 the two planes of stage_floats_2streams.  Loads run kLead
// stages ahead of use, as K2's float4 queue does.
//
// int (K4): u = r0 + r1, d = r0 - r1 (values within the channel's field
// range, the contract of decode_blocks_cuda).  float: u and d are single
// f32 adds, truncated into the integer ACS.
//   - SATURATING = false (K5): the planes are clamped to [-8, 7] by the
//     staging, so |u|, |d| <= 15 and -trunc(u) is exact: nu = -u, nd = -d.
//   - SATURATING = true (K4 value mode): the values are NOT clamped (the
//     JAX entry decodes them as given, core_pallas.py:1050), so each of u,
//     -u, d, -d is converted on its own, saturating, as the plain version's
//     per-state conversion does, and the ACS wraps as its int32 adds do.
//     Exact on any input, NaN, +-inf and values past the int32 range
//     included, at a cost: at the 32M-bit FP32 headline this form measured
//     1.09 ms against 0.74 ms for the SATURATING = false form, with equal
//     static SASS counts (NVIDIA H100 80GB HBM3, 700 W).
template <typename T, bool SATURATING = false>
struct PlaneReader {
  static constexpr int kLead = 4;
  static constexpr bool kWrap = SATURATING;

  const T* r0;
  const T* r1;
  long long step;
  long long n_stages;
  long long next_t;
  T a[kLead], b[kLead];

  __device__ __forceinline__ T load(const T* p, long long t) const {
    return t < n_stages ? __ldg(p + t * step) : T(0);
  }

  __device__ __forceinline__ PlaneReader(const Source& src, int blk)
      : r0(static_cast<const T*>(src.p0) + blk),
        r1(static_cast<const T*>(src.p1) + blk), step(src.stride),
        n_stages(src.n), next_t(kLead) {
#pragma unroll
    for (int i = 0; i < kLead; ++i) {
      a[i] = load(r0, i);
      b[i] = load(r1, i);
    }
  }

  __device__ __forceinline__ void next(int s, Bm& m) {
    (void)s;
    const T x = a[0], y = b[0];
#pragma unroll
    for (int i = 0; i + 1 < kLead; ++i) {
      a[i] = a[i + 1];
      b[i] = b[i + 1];
    }
    a[kLead - 1] = load(r0, next_t);
    b[kLead - 1] = load(r1, next_t);
    ++next_t;
    if constexpr (SATURATING) {
      const float uf = __fadd_rn(x, y), df = __fsub_rn(x, y);
      m.u = trunc_int(uf);
      m.nu = trunc_int(-uf);
      m.d = trunc_int(df);
      m.nd = trunc_int(-df);
    } else if constexpr (std::is_floating_point<T>::value) {
      m.u = trunc_int(__fadd_rn(x, y));
      m.d = trunc_int(__fsub_rn(x, y));
      m.nu = -m.u;
      m.nd = -m.d;
    } else {
      int_bm(x, y, m);
    }
  }
};

// K4's word-mode reader: K1's unpack on the staged (Lw, B) words; and its
// f32 value-mode reader.
template <int WIDTH>
using StagedIntReader = IntReader<WIDTH, true>;
using UnclampedReader = PlaneReader<float, true>;

// Survivor pack of `state` in ring slot `slot`, laid out [slot][state]
// [thread] so that a chase whose state differs per thread still reads 32
// distinct banks: the word index differs from the thread's own column by a
// multiple of 64.
__device__ __forceinline__ uint32_t ring_at(const uint32_t* ring, int slot,
                                            int state) {
  return ring[(slot * kStates + state) * kThreads + threadIdx.x];
}

// Kernel arguments: src, where the reader finds the input; surv, the
// (n_packs, 64, num_blocks) device store of the full-store instances
// (unused by the window); out, the (num_blocks, n_emit) int32 packs, read
// as uint32.  n_conv: packs discarded by the traceback; n_slots: the
// window ring's W slots, in dynamic shared memory of W * 64 * kThreads
// words.
// PM16: int16x2 path metrics (acs_stage16, renorm16 every pack whatever
// the renorm flag), else int32 (acs_stage, the per-pack minimum subtracted
// where renorm is set).
template <class Reader, int BPP, bool WINDOW, bool PM16 = false>
__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const Source src, uint32_t* __restrict__ surv,
               int* __restrict__ out, int num_blocks, int n_packs,
               int n_conv, int n_emit, int renorm, int n_slots) {
  constexpr uint32_t kMask = BPP == 32 ? 0xFFFFFFFFu : 0xFFFFu;
  constexpr bool kWrap = Reader::kWrap;
  constexpr int kPmWords = PM16 ? kStates / 2 : kStates;
  using pm_t = std::conditional_t<PM16, uint32_t, int>;
  extern __shared__ uint32_t ring[];
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= num_blocks) return;
  const size_t plane = static_cast<size_t>(num_blocks);
  const int emit_lo = n_packs - n_conv - n_emit;  // lowest emitted pack
  const int n_disc = n_slots - 2;                 // window chase depth
  int* const dst_out = out + static_cast<size_t>(blk) * n_emit;

  pm_t pm_a[kPmWords], pm_b[kPmWords];
  uint32_t pp_a[kStates], pp_b[kStates];
#pragma unroll
  for (int s = 0; s < kPmWords; ++s) pm_a[s] = 0;
#pragma unroll
  for (int s = 0; s < kStates; ++s) pp_a[s] = 0u;

  Reader reader(src, blk);
  int stage = 0;
  for (int p = 0; p < n_packs; ++p) {
#pragma unroll 1
    for (int t = 0; t < BPP; t += 2) {
      Bm m;
      reader.next(stage++, m);
      if constexpr (PM16)
        acs_stage16(pm_a, pp_a, pm_b, pp_b, m);
      else
        acs_stage<kWrap>(pm_a, pp_a, pm_b, pp_b, m);
      reader.next(stage++, m);
      if constexpr (PM16)
        acs_stage16(pm_b, pp_b, pm_a, pp_a, m);
      else
        acs_stage<kWrap>(pm_b, pp_b, pm_a, pp_a, m);
    }
    if constexpr (WINDOW) {
      // one-pointer circular buffer (core_pallas.py:440-486): dump pack p
      // at slot p mod W, then a fresh chase from state 0 through n_disc
      // discard packs emits pack p - n_disc
      uint32_t* dst = ring + (p % n_slots) * kStates * kThreads + threadIdx.x;
#pragma unroll
      for (int s = 0; s < kStates; ++s) dst[s * kThreads] = pp_a[s] & kMask;
      if (p - n_disc >= emit_lo) {
        int state = 0;
        uint32_t pack = 0u;
        for (int t = 0; t <= n_disc; ++t) {
          pack = ring_at(ring, (p - t) % n_slots, state);
          state = static_cast<int>((pack >> (BPP - 6)) & 63u);
        }
        dst_out[p - n_disc - emit_lo] = static_cast<int>(pack);
      }
    } else {
      uint32_t* dst = surv + static_cast<size_t>(p) * kStates * plane + blk;
#pragma unroll
      for (int s = 0; s < kStates; ++s) dst[s * plane] = pp_a[s] & kMask;
    }
    if constexpr (PM16) {
      renorm16(pm_a);  // keeps every metric under kPm16Bound (acs.cuh)
    } else if (renorm) {  // decision-invariant min-subtract (:457-466)
      int mn = pm_a[0];
#pragma unroll
      for (int s = 1; s < kStates; ++s) mn = min(mn, pm_a[s]);
#pragma unroll
      for (int s = 0; s < kStates; ++s) pm_a[s] = sub<kWrap>(pm_a[s], mn);
    }
  }

  if constexpr (WINDOW) {
    // the top packs q have fewer than n_disc packs above them by framing:
    // each is chased at its full available depth n_packs - 1 - q, all
    // within the last W - 1 slots written
    const int q_lo = max(emit_lo, n_packs - n_disc);
    for (int q = q_lo; q < n_packs - n_conv; ++q) {
      int state = 0;
      uint32_t pack = 0u;
      for (int kp = n_packs - 1; kp >= q; --kp) {
        pack = ring_at(ring, kp % n_slots, state);
        state = static_cast<int>((pack >> (BPP - 6)) & 63u);
      }
      dst_out[q - emit_lo] = static_cast<int>(pack);
    }
  } else {
    // traceback from state 0 on the last pack: discard n_conv packs, emit
    // n_emit; next state = the pack's oldest 6 decisions (logical shift)
    int state = 0;
    for (int k = 0; k < n_conv + n_emit; ++k) {
      const int kp = n_packs - 1 - k;
      const uint32_t pack =
          surv[(static_cast<size_t>(kp) * kStates + state) * plane + blk];
      if (k >= n_conv) dst_out[kp - emit_lo] = static_cast<int>(pack);
      state = static_cast<int>((pack >> (BPP - 6)) & 63u);
    }
  }
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = launched).
// The window kernel's ring needs more than the 48 KB of static shared
// memory (64 KB at W = 4, 96 KB at W = 6), so it opts in to that much
// dynamic shared memory first.  At those sizes an SM holds 3 (W = 4) or
// 2 (W = 6) CUDA blocks; the 32M-bit headline plan needs 2.
template <class Reader, int BPP, bool WINDOW, bool PM16 = false>
cudaError_t launch(const Source& src, uint32_t* surv, int* out,
                   int num_blocks, int n_packs, int n_conv, int n_emit,
                   int renorm, int n_slots, cudaStream_t stream) {
  size_t smem = 0;
  if constexpr (WINDOW) {
    smem = static_cast<size_t>(n_slots) * kStates * kThreads *
           sizeof(uint32_t);
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<Reader, BPP, WINDOW, PM16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (num_blocks + kThreads - 1) / kThreads;
  viterbi_kernel<Reader, BPP, WINDOW, PM16><<<grid, kThreads, smem, stream>>>(
      src, surv, out, num_blocks, n_packs, n_conv, n_emit, renorm, n_slots);
  return cudaGetLastError();
}

// K6: out[i, k] = in[k * stride + i] for i < win, k < num, zero where
// k * stride + i >= n; 32-bit words of either dtype.  A CUDA block moves
// one 32 x 32 tile (blocks k0.. on grid.x, which allows 2^31 - 1 tiles;
// words i0.. on grid.y): it reads 32 rows of 32 consecutive words of the
// stream and writes 32 rows of 32 consecutive blocks of the output, through
// a 32 x 33 shared tile whose padding column keeps both the column-wise
// store and the column-wise read free of bank conflicts.
constexpr int kTile = 32;
constexpr int kTileRows = 8;

#if IN_PART(0)
__global__ void __launch_bounds__(kTile * kTileRows)
stage_transpose_kernel(const uint32_t* __restrict__ in, long long n,
                       uint32_t* __restrict__ out, long long stride, int win,
                       int num) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int k0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const int i_in = i0 + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kTile; r += kTileRows) {
    const int j = r + threadIdx.y;
    const int k = k0 + j;
    uint32_t v = 0u;
    if (k < num && i_in < win) {
      const long long idx = static_cast<long long>(k) * stride + i_in;
      if (idx < n) v = __ldg(in + idx);
    }
    tile[j][threadIdx.x] = v;
  }
  __syncthreads();
  const int k_out = k0 + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kTile; r += kTileRows) {
    const int j = r + threadIdx.y;
    const int i = i0 + j;
    if (i < win && k_out < num)
      out[static_cast<long long>(i) * num + k_out] = tile[threadIdx.x][j];
  }
}
#endif  // IN_PART(0)

}  // namespace viterbi

using namespace viterbi;

// Plain C entry points (bound with ctypes), one per decode kernel, all with
// one signature: p0, p1, n, stride make the reader's Source (K1 and K3 on
// integer words: p1 the tail halo, which takes the HaloReader instances
// of k1_halo and k3_halo, or null; the other flat-stream entries refuse a
// p1); surv: the full
// store, or null for the window (K4, K5; K1 and K2 need it, K3 ignores it);
// width: the channel's field width (1, 4, 8, 16) for words, kUdWidth (-8)
// for the FP32 channel's u/d words (K1, K3), 0 for f32 values, 32 for int32
// values (K4); n_slots: the ring's W >= 3 for the
// window.  Each returns the cudaError_t of the launch (0 = launched).
#define VITERBI_LAUNCH(W, R, B, WINDOW, PM16)                              \
  if (width == W && bpp == B)                                              \
    return static_cast<int>(launch<R, B, WINDOW, PM16>(                    \
        src, sv, o, num_blocks, n_packs, n_conv, n_emit, renorm, n_slots,  \
        static_cast<cudaStream_t>(stream)));
// int32 metrics; the int16x2 instances are VITERBI_LAUNCH(..., true)
#define VITERBI_CASE(W, R, B, WINDOW) VITERBI_LAUNCH(W, R, B, WINDOW, false)
// the four instances of a reader: bpp 32 and 16, window when surv is null
#define VITERBI_STAGED(W, R)       \
  if (sv == nullptr) {             \
    VITERBI_CASE(W, R, 32, true)   \
    VITERBI_CASE(W, R, 16, true)   \
  } else {                         \
    VITERBI_CASE(W, R, 32, false)  \
    VITERBI_CASE(W, R, 16, false)  \
  }
#define VITERBI_ARGS                                                       \
  const void *p0, const void *p1, long long n, long long stride,           \
      void *surv, void *out, int num_blocks, int n_packs, int n_conv,      \
      int n_emit, int width, int bpp, int renorm, int n_slots, void *stream
#define VITERBI_PROLOGUE                                                   \
  const Source src{p0, p1, n, stride};                                     \
  uint32_t* sv = static_cast<uint32_t*>(surv);                             \
  int* o = static_cast<int*>(out);                                         \
  if (num_blocks <= 0 || (sv == nullptr && n_slots < 3))                   \
    return static_cast<int>(cudaErrorInvalidValue);

// K1 and K3 with a tail halo, each in a build part of its own (k1_halo,
// k3_halo, declared before their entry points): HARD, SOFT4 and SOFT8 on
// int16x2 metrics, SOFT16 on int32, as without the halo.
int k1_halo(VITERBI_ARGS);
int k3_halo(VITERBI_ARGS);

#if IN_PART(0)
// K1: int16x2 metrics on HARD, SOFT4, SOFT8 and the u/d words, int32 on
// SOFT16 (acs.cuh's header).
extern "C" int viterbi_k1_launch(VITERBI_ARGS) {
  VITERBI_PROLOGUE
  if (sv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (p1 != nullptr)
    return k1_halo(p0, p1, n, stride, surv, out, num_blocks, n_packs, n_conv,
                   n_emit, width, bpp, renorm, n_slots, stream);
  VITERBI_LAUNCH(1, IntReader<1>, 32, false, true)
  VITERBI_LAUNCH(1, IntReader<1>, 16, false, true)
  VITERBI_LAUNCH(4, IntReader<4>, 32, false, true)
  VITERBI_LAUNCH(4, IntReader<4>, 16, false, true)
  VITERBI_LAUNCH(8, IntReader<8>, 32, false, true)
  VITERBI_LAUNCH(8, IntReader<8>, 16, false, true)
  VITERBI_CASE(16, IntReader<16>, 32, false)
  VITERBI_CASE(16, IntReader<16>, 16, false)
  VITERBI_LAUNCH(kUdWidth, UdReader, 32, false, true)
  VITERBI_LAUNCH(kUdWidth, UdReader, 16, false, true)
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int32 sides of the int16x2 A/Bs (chip_smoke.py phases 5b-5d,
// tests/test_torch_cuda.py), each its kernel's earlier arithmetic, built
// in its kernel's part (one cubin, read by phases 5b-5d); no decode path
// launches them.  K1_I32: SOFT8, full store.
extern "C" int viterbi_k1_i32_launch(VITERBI_ARGS) {
  VITERBI_PROLOGUE
  if (sv == nullptr || p1 != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  VITERBI_CASE(8, IntReader<8>, 32, false)
  VITERBI_CASE(8, IntReader<8>, 16, false)
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2: int16x2 metrics on the FP32 wire (|bm| <= 16, acs.cuh's header).
extern "C" int viterbi_k2_launch(VITERBI_ARGS) {
  VITERBI_PROLOGUE
  if (sv == nullptr || p1 != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  VITERBI_LAUNCH(0, FloatReader, 32, false, true)
  VITERBI_LAUNCH(0, FloatReader, 16, false, true)
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2_I32: the FP32 wire, full store.
extern "C" int viterbi_k2_i32_launch(VITERBI_ARGS) {
  VITERBI_PROLOGUE
  if (sv == nullptr || p1 != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  VITERBI_CASE(0, FloatReader, 32, false)
  VITERBI_CASE(0, FloatReader, 16, false)
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

#if IN_PART(1)
// K3: int16x2 metrics on the FP32 wire, HARD, SOFT4, SOFT8 and the u/d
// words, int32 on SOFT16, as K1 chooses.
extern "C" int viterbi_k3_launch(VITERBI_ARGS) {
  surv = nullptr;
  VITERBI_PROLOGUE
  if (p1 != nullptr)
    return k3_halo(p0, p1, n, stride, surv, out, num_blocks, n_packs, n_conv,
                   n_emit, width, bpp, renorm, n_slots, stream);
  VITERBI_LAUNCH(0, FloatReader, 32, true, true)
  VITERBI_LAUNCH(0, FloatReader, 16, true, true)
  VITERBI_LAUNCH(1, IntReader<1>, 32, true, true)
  VITERBI_LAUNCH(1, IntReader<1>, 16, true, true)
  VITERBI_LAUNCH(4, IntReader<4>, 32, true, true)
  VITERBI_LAUNCH(4, IntReader<4>, 16, true, true)
  VITERBI_LAUNCH(8, IntReader<8>, 32, true, true)
  VITERBI_LAUNCH(8, IntReader<8>, 16, true, true)
  VITERBI_CASE(16, IntReader<16>, 32, true)
  VITERBI_CASE(16, IntReader<16>, 16, true)
  VITERBI_LAUNCH(kUdWidth, UdReader, 32, true, true)
  VITERBI_LAUNCH(kUdWidth, UdReader, 16, true, true)
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3_I32: SOFT8 and the FP32 wire, window.
extern "C" int viterbi_k3_i32_launch(VITERBI_ARGS) {
  surv = nullptr;
  VITERBI_PROLOGUE
  if (p1 != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  VITERBI_CASE(8, IntReader<8>, 32, true)
  VITERBI_CASE(8, IntReader<8>, 16, true)
  VITERBI_CASE(0, FloatReader, 32, true)
  VITERBI_CASE(0, FloatReader, 16, true)
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

#if IN_PART(4)
int k1_halo(VITERBI_ARGS) {
  VITERBI_PROLOGUE
  VITERBI_LAUNCH(1, HaloReader<1>, 32, false, true)
  VITERBI_LAUNCH(1, HaloReader<1>, 16, false, true)
  VITERBI_LAUNCH(4, HaloReader<4>, 32, false, true)
  VITERBI_LAUNCH(4, HaloReader<4>, 16, false, true)
  VITERBI_LAUNCH(8, HaloReader<8>, 32, false, true)
  VITERBI_LAUNCH(8, HaloReader<8>, 16, false, true)
  VITERBI_CASE(16, HaloReader<16>, 32, false)
  VITERBI_CASE(16, HaloReader<16>, 16, false)
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

#if IN_PART(5)
int k3_halo(VITERBI_ARGS) {
  VITERBI_PROLOGUE
  VITERBI_LAUNCH(1, HaloReader<1>, 32, true, true)
  VITERBI_LAUNCH(1, HaloReader<1>, 16, true, true)
  VITERBI_LAUNCH(4, HaloReader<4>, 32, true, true)
  VITERBI_LAUNCH(4, HaloReader<4>, 16, true, true)
  VITERBI_LAUNCH(8, HaloReader<8>, 32, true, true)
  VITERBI_LAUNCH(8, HaloReader<8>, 16, true, true)
  VITERBI_CASE(16, HaloReader<16>, 32, true)
  VITERBI_CASE(16, HaloReader<16>, 16, true)
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

// K4 is one entry point over two parts: word mode here, value mode in part
// 3 (k4_values, declared before it).
int k4_values(VITERBI_ARGS);

#if IN_PART(2)
extern "C" int viterbi_k4_launch(VITERBI_ARGS) {
  VITERBI_PROLOGUE
  VITERBI_STAGED(1, StagedIntReader<1>)
  VITERBI_STAGED(4, StagedIntReader<4>)
  VITERBI_STAGED(8, StagedIntReader<8>)
  VITERBI_STAGED(16, StagedIntReader<16>)
  return k4_values(p0, p1, n, stride, surv, out, num_blocks, n_packs, n_conv,
                   n_emit, width, bpp, renorm, n_slots, stream);
}
#endif

#if IN_PART(3)
int k4_values(VITERBI_ARGS) {
  VITERBI_PROLOGUE
  VITERBI_STAGED(32, PlaneReader<int>)
  VITERBI_STAGED(0, UnclampedReader)
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int viterbi_k5_launch(VITERBI_ARGS) {
  VITERBI_PROLOGUE
  VITERBI_STAGED(0, PlaneReader<float>)
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif

#if IN_PART(0)
// K6: in holds n 32-bit words; out the (win, num) word-major layout.
extern "C" int viterbi_k6_launch(const void* in, long long n, void* out,
                                 long long stride, int win, int num,
                                 void* stream) {
  if (num <= 0 || win <= 0 || stride <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((num + kTile - 1) / kTile, (win + kTile - 1) / kTile);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  stage_transpose_kernel<<<grid, dim3(kTile, kTileRows), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), n, static_cast<uint32_t*>(out),
      stride, win, num);
  return static_cast<int>(cudaGetLastError());
}
#endif

#undef VITERBI_LAUNCH
#undef VITERBI_CASE
#undef VITERBI_STAGED
#undef VITERBI_ARGS
#undef VITERBI_PROLOGUE
