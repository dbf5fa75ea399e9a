// Kernels K1, K2 and K3: fused Viterbi decode (K=7, rate 1/2, polynomials
// 0o171/0o133).  One thread per overlap-save time-block reads its block's
// channel stream, runs branch metrics and the even/odd add-compare-select
// (ACS) with register exchange, dumps a survivor pack every bpp stages and
// traces back from state 0.
//
// One kernel template over the stage reader (the channel format), the pack
// width and the survivor mode, with one plain C entry point per kernel:
//   - K1, viterbi_k1_launch: IntReader<WIDTH> (HARD/SOFT4/SOFT8/SOFT16 packed
//     int32 words), full store.  Replaces the TPU kernel
//     tpu_viterbi/decoder/core_pallas.py:_viterbi_kernel_fused (the word-mode
//     unpack of _viterbi_kernel and the full-store branch of _decode_core).
//   - K2, viterbi_k2_launch: FloatReader (the FP32 channel's raw interleaved
//     f32 wire), full store.  Replaces _viterbi_kernel_fused_f32v; none of its
//     TPU staging is ported (_body_and_edge's roll halo, fp32_ud_words,
//     stage_floats_2streams).
//   - K3, viterbi_k3_launch: every reader with the windowed survivor ring in
//     shared memory.  Replaces the window=True branch of _decode_core
//     (:440-486) with its slot count survivor_window_slots (:295-315), the
//     reference's one-pointer circular buffer (viterbi.cu:99-100).
// The full store (K1, K2) lies in device memory as (n_packs, 64, B) 32-bit
// words, so the 32 threads of a warp write 32 neighbouring words.
// Its plain PyTorch version is tpu_viterbi_torch/decoder/core_torch.py
// (decode_blocks_torch); the two must agree bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libviterbi.so viterbi.cu
// (no --use_fast_math: K2's clamp must keep NaN and its adds must round
// once; tpu_viterbi_torch/decoder/core_cuda.py builds it at first use and
// binds the three entry points with ctypes).
//
// What bounds it on an H100: ALU work in the ACS.  Each stage of each block
// runs 32 butterflies of 4 adds, 2 compares and 4 selects plus the survivor
// shifts, ~400 integer instructions, against 2..64 bits of channel input a
// stage and 64 x 4 bytes of survivors per bpp stages.
//
// What the design does about it: one thread per time-block (the JAX
// kernel's blocks-on-lanes layout).  The 64 path metrics and 64 survivor
// registers live in registers, double-buffered and fully unrolled over the
// 32 butterflies, so the trellis' even/odd interleave is register renaming
// and the +-1 branch signs fold into add/sub at compile time: no shuffles,
// no per-stage memory traffic besides the channel input, prefetched ahead.
// Path metrics start at zero in every block; the per-pack minimum is
// subtracted only when the plan needs it (renorm flag).
//
// K2's f32 work is 2 clamps, 2 adds and 2 conversions a stage against ~400
// integer instructions; a stage reads 8 bytes of wire (4x SOFT8's), 0.5 GB
// at the 32M-bit headline: far under the card's bandwidth in the ACS' time.
// K3's per-pack chase adds W - 1 shared loads a pack, and the survivor
// traffic to device memory (K1's 264 MB at the 32M-bit headline) is gone.

#include <cuda_runtime.h>

#include <cstdint>

namespace viterbi {

constexpr int kStates = 64;
constexpr int kThreads = 64;  // time-blocks (threads) per CUDA block

__host__ __device__ constexpr int parity6(int x) {
  return (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4) ^ (x >> 5)) & 1;
}

// +-1 sign of each coded bit on the j=0 branch into the even child 2q: tap
// masks 0o117 & 63 and 0o155 & 63 of the bit-reversed polynomials
// (tpu_viterbi_torch/trellis.py, core_pallas.py _TAP_MASK0/1).
__host__ __device__ constexpr int sign0(int q) {
  return 2 * parity6((2 * q) & (0117 & 63)) - 1;
}
__host__ __device__ constexpr int sign1(int q) {
  return 2 * parity6((2 * q) & (0155 & 63)) - 1;
}

// One ACS stage from (pm, pp) into (pm_out, pp_out).  Children 2q and 2q+1
// share the predecessors q and q+32 and see negated branch metrics:
//   E = max(pm[q] + bm, pm[q+32] - bm),  O = max(pm[q] - bm, pm[q+32] + bm),
// with a strict '>' so the j=0 branch wins ties; the survivor register
// becomes 2*pp[q] or 2*pp[q+32]+1 (core_pallas.py:396-435).  u and d are
// the stage's r0 + r1 and r0 - r1; bm is +-u where the two coded bits have
// the same sign, else +-d.
__device__ __forceinline__ void acs_stage(const int (&pm)[kStates],
                                          const uint32_t (&pp)[kStates],
                                          int (&pm_out)[kStates],
                                          uint32_t (&pp_out)[kStates],
                                          int u, int d) {
#pragma unroll
  for (int q = 0; q < kStates / 2; ++q) {
    const int mag = sign0(q) == sign1(q) ? u : d;
    const int bm = sign0(q) > 0 ? mag : -mag;
    const int lo = pm[q];
    const int hi = pm[q + 32];
    const int c0e = lo + bm, c1e = hi - bm;
    const int c0o = lo - bm, c1o = hi + bm;
    const bool de = c1e > c0e;
    const bool dodd = c1o > c0o;
    pm_out[2 * q] = de ? c1e : c0e;
    pm_out[2 * q + 1] = dodd ? c1o : c0o;
    const uint32_t from_lo = pp[q] << 1;
    const uint32_t from_hi = (pp[q + 32] << 1) | 1u;
    pp_out[2 * q] = de ? from_hi : from_lo;
    pp_out[2 * q + 1] = dodd ? from_hi : from_lo;
  }
}

// Word reader of one block: each word holds 16 / WIDTH stage pairs, MSB
// first (viterbiDF.h:157-163).  Words past the stream read as zero.  Block
// k starts at word `first` = k * wpb and reads its halo past its body.
template <int WIDTH>
struct IntReader {
  static constexpr int kPairsPerWord = 16 / WIDTH;

  const int* words;
  long long n_words;
  long long next_idx;
  uint32_t cur;
  uint32_t nxt;

  __device__ __forceinline__ uint32_t load(long long idx) const {
    return idx < n_words ? static_cast<uint32_t>(__ldg(words + idx)) : 0u;
  }

  __device__ __forceinline__ IntReader(const void* w, long long n,
                                       long long first)
      : words(static_cast<const int*>(w)), n_words(n), next_idx(first + 1),
        cur(0u), nxt(load(first)) {}

  // (u, d) of global stage s of the block; stages must be read in order.
  // HARD bits map to +-1 as bit*2-1; soft fields are two's complement,
  // sign-extended by an arithmetic shift (core_pallas.py:594-599).
  __device__ __forceinline__ void next(int s, int& u, int& d) {
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
    u = a0 + a1;
    d = a0 - a1;
  }
};

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
// (core_xla.py:259-264).  A NaN becomes 0, as XLA's conversion makes it.
// Built without --use_fast_math so none of this is reassociated.
struct FloatReader {
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

  __device__ __forceinline__ FloatReader(const void* w, long long n,
                                         long long first)
      : vals(static_cast<const float*>(w)), n_vals(n),
        next_quad(first / 4 + 2), cur(make_float4(0.0f, 0.0f, 0.0f, 0.0f)),
        q1(load(first / 4)), q2(load(first / 4 + 1)) {}

  static __device__ __forceinline__ float clamp(float x) {
    return x < -8.0f ? -8.0f : (x > 7.0f ? 7.0f : x);
  }

  static __device__ __forceinline__ int trunc_int(float x) {
    return x != x ? 0 : __float2int_rz(x);
  }

  __device__ __forceinline__ void next(int s, int& u, int& d) {
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
    u = trunc_int(__fadd_rn(r0, r1));
    d = trunc_int(__fsub_rn(r0, r1));
  }
};

// Survivor pack of `state` in ring slot `slot`, laid out [slot][state]
// [thread] so that a chase whose state differs per thread still reads 32
// distinct banks: the word index differs from the thread's own column by a
// multiple of 64.
__device__ __forceinline__ uint32_t ring_at(const uint32_t* ring, int slot,
                                            int state) {
  return ring[(slot * kStates + state) * kThreads + threadIdx.x];
}

// Kernel arguments: words, the flat channel stream of n_words int32 words
// (or n_words f32 values); surv, the (n_packs, 64, num_blocks) device
// store of the full-store kernels (unused by the window); out, the
// (num_blocks, n_emit) int32 packs, read as uint32.  wpb: words (values) a
// block's body spans; n_conv: packs discarded by the traceback; n_slots:
// the window ring's W slots, in dynamic shared memory of W * 64 * kThreads
// words.
template <class Reader, int BPP, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
viterbi_kernel(const void* __restrict__ words, long long n_words,
               uint32_t* __restrict__ surv, int* __restrict__ out,
               int num_blocks, int n_packs, int wpb, int n_conv, int n_emit,
               int renorm, int n_slots) {
  constexpr uint32_t kMask = BPP == 32 ? 0xFFFFFFFFu : 0xFFFFu;
  extern __shared__ uint32_t ring[];
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= num_blocks) return;
  const size_t plane = static_cast<size_t>(num_blocks);
  const int emit_lo = n_packs - n_conv - n_emit;  // lowest emitted pack
  const int n_disc = n_slots - 2;                 // window chase depth
  int* const dst_out = out + static_cast<size_t>(blk) * n_emit;

  int pm_a[kStates], pm_b[kStates];
  uint32_t pp_a[kStates], pp_b[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    pm_a[s] = 0;
    pp_a[s] = 0u;
  }

  // block k reads its words k*wpb ... k*wpb + wpb + wph - 1 directly, halo
  // included (it may span several following bodies when dec_len < 64)
  Reader reader(words, n_words, static_cast<long long>(blk) * wpb);
  int stage = 0;
  for (int p = 0; p < n_packs; ++p) {
#pragma unroll 1
    for (int t = 0; t < BPP; t += 2) {
      int u, d;
      reader.next(stage++, u, d);
      acs_stage(pm_a, pp_a, pm_b, pp_b, u, d);
      reader.next(stage++, u, d);
      acs_stage(pm_b, pp_b, pm_a, pp_a, u, d);
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
    if (renorm) {  // decision-invariant min-subtract (core_pallas.py:457-466)
      int m = pm_a[0];
#pragma unroll
      for (int s = 1; s < kStates; ++s) m = min(m, pm_a[s]);
#pragma unroll
      for (int s = 0; s < kStates; ++s) pm_a[s] -= m;
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
template <class Reader, int BPP, bool WINDOW>
cudaError_t launch(const void* words, long long n_words, uint32_t* surv,
                   int* out, int num_blocks, int n_packs, int wpb, int n_conv,
                   int n_emit, int renorm, int n_slots, cudaStream_t stream) {
  size_t smem = 0;
  if constexpr (WINDOW) {
    smem = static_cast<size_t>(n_slots) * kStates * kThreads *
           sizeof(uint32_t);
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<Reader, BPP, WINDOW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (num_blocks + kThreads - 1) / kThreads;
  viterbi_kernel<Reader, BPP, WINDOW><<<grid, kThreads, smem, stream>>>(
      words, n_words, surv, out, num_blocks, n_packs, wpb, n_conv, n_emit,
      renorm, n_slots);
  return cudaGetLastError();
}

}  // namespace viterbi

using namespace viterbi;

// Plain C entry points (bound with ctypes), one per kernel, all with one
// signature; the arguments are viterbi_kernel's.  width: the channel's field
// width (1, 4, 8, 16), or 0 for the FP32 wire (then words holds n_words f32
// values); surv: the full store (K1, K2; unused by K3); n_slots: the ring's
// W >= 3 (K3; unused by K1, K2).  Each returns the cudaError_t of the launch
// (0 = launched).
#define VITERBI_CASE(W, R, B, WINDOW)                                      \
  if (width == W && bpp == B)                                              \
    return static_cast<int>(launch<R, B, WINDOW>(                          \
        words, n_words, sv, o, num_blocks, n_packs, wpb, n_conv, n_emit,   \
        renorm, n_slots, static_cast<cudaStream_t>(stream)));
#define VITERBI_ARGS                                                       \
  const void *words, long long n_words, void *surv, void *out,             \
      int num_blocks, int n_packs, int wpb, int n_conv, int n_emit,        \
      int width, int bpp, int renorm, int n_slots, void *stream

extern "C" int viterbi_k1_launch(VITERBI_ARGS) {
  uint32_t* sv = static_cast<uint32_t*>(surv);
  int* o = static_cast<int*>(out);
  if (num_blocks <= 0 || sv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  VITERBI_CASE(1, IntReader<1>, 32, false)
  VITERBI_CASE(1, IntReader<1>, 16, false)
  VITERBI_CASE(4, IntReader<4>, 32, false)
  VITERBI_CASE(4, IntReader<4>, 16, false)
  VITERBI_CASE(8, IntReader<8>, 32, false)
  VITERBI_CASE(8, IntReader<8>, 16, false)
  VITERBI_CASE(16, IntReader<16>, 32, false)
  VITERBI_CASE(16, IntReader<16>, 16, false)
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int viterbi_k2_launch(VITERBI_ARGS) {
  uint32_t* sv = static_cast<uint32_t*>(surv);
  int* o = static_cast<int*>(out);
  if (num_blocks <= 0 || sv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  VITERBI_CASE(0, FloatReader, 32, false)
  VITERBI_CASE(0, FloatReader, 16, false)
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int viterbi_k3_launch(VITERBI_ARGS) {
  uint32_t* sv = nullptr;
  int* o = static_cast<int*>(out);
  (void)surv;
  if (num_blocks <= 0 || n_slots < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  VITERBI_CASE(0, FloatReader, 32, true)
  VITERBI_CASE(0, FloatReader, 16, true)
  VITERBI_CASE(1, IntReader<1>, 32, true)
  VITERBI_CASE(1, IntReader<1>, 16, true)
  VITERBI_CASE(4, IntReader<4>, 32, true)
  VITERBI_CASE(4, IntReader<4>, 16, true)
  VITERBI_CASE(8, IntReader<8>, 32, true)
  VITERBI_CASE(8, IntReader<8>, 16, true)
  VITERBI_CASE(16, IntReader<16>, 32, true)
  VITERBI_CASE(16, IntReader<16>, 16, true)
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef VITERBI_CASE
#undef VITERBI_ARGS
