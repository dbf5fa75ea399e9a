// Kernel K1: fused Viterbi decode of overlap-save time-blocks (K=7, rate 1/2,
// polynomials 0o171/0o133) for the integer word channels HARD, SOFT4, SOFT8
// and SOFT16, at 32- and 16-bit output packs, with the full survivor store.
//
// Replaces the TPU kernel tpu_viterbi/decoder/core_pallas.py:
// _viterbi_kernel_fused (launched by _run_kernel_fused), that is the
// word-mode unpack of _viterbi_kernel and the full-store branch of
// _decode_core: unpack packed channel words, branch metrics, even/odd
// add-compare-select (ACS) with register exchange, a survivor-pack dump every
// bpp stages, and the pack-granular traceback from state 0.  Its plain
// PyTorch version is tpu_viterbi_torch/decoder/core_torch.py
// (decode_blocks_torch); the two must agree bit for bit.
//
// What bounds it on an H100: ALU work in the ACS.  Each stage of each block
// runs 32 butterflies of 4 adds, 2 compares and 4 selects plus the survivor
// shifts: about 64 add/compare/select pairs per stage, ~400 integer
// instructions.  Against that a stage reads 2..32 bits of channel input and
// writes 64 x 4 bytes of survivors per bpp stages (8 bytes a stage at bpp
// 32): some 40 instructions per byte of device memory traffic, well above
// what 3.35 TB/s against the SMs' integer rate would need to make memory the
// limit.
//
// What the design does about it: one thread per time-block (the JAX
// kernel's blocks-on-lanes layout).  The 64 path metrics and 64 survivor
// registers live in registers, double-buffered and fully unrolled over the
// 32 butterflies, so the trellis' even/odd interleave is register renaming
// and the +-1 branch signs fold into add/sub at compile time: no shuffles,
// no shared memory, no per-stage memory traffic besides one channel word per
// 1..16 stages, prefetched a word ahead.  The survivor store lies in device
// memory as (n_packs, 64, B) 32-bit words, so the 32 threads of a warp write
// 32 neighbouring words.  Path metrics start at zero in every block; the
// per-pack minimum is subtracted only when the plan needs it (renorm flag).
// Known cost: a main-path plan of B blocks runs only B threads, a few warps
// per SM; the warp-per-block layout, shared memory, the survivor window (K3)
// and DPX come later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libviterbi_k1.so viterbi_k1.cu
// (tpu_viterbi_torch/decoder/core_cuda.py builds it at first use and binds
// viterbi_k1_launch with ctypes).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

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
// becomes 2*pp[q] or 2*pp[q+32]+1 (core_pallas.py:396-435).
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
// first (viterbiDF.h:157-163).  Words past the stream read as zero.
template <int WIDTH>
struct StageReader {
  static constexpr int kPairsPerWord = 16 / WIDTH;

  const int* words;
  long long n_words;
  long long next_idx;
  uint32_t cur;
  uint32_t nxt;

  __device__ __forceinline__ uint32_t load(long long idx) const {
    return idx < n_words ? static_cast<uint32_t>(__ldg(words + idx)) : 0u;
  }

  __device__ __forceinline__ StageReader(const int* w, long long n,
                                         long long first)
      : words(w), n_words(n), next_idx(first + 1), cur(0u),
        nxt(load(first)) {}

  // (u, d) = (r0 + r1, r0 - r1) of global stage s of the block; stages must
  // be read in order.  HARD bits map to +-1 as bit*2-1; soft fields are
  // two's complement, sign-extended by an arithmetic shift
  // (core_pallas.py:594-599).
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

template <int WIDTH, int BPP>
__global__ void __launch_bounds__(kThreads)
viterbi_k1_kernel(const int* __restrict__ words, long long n_words,
                  uint32_t* __restrict__ surv, int* __restrict__ out,
                  int num_blocks, int n_packs, int wpb, int n_conv,
                  int n_emit, int renorm) {
  constexpr uint32_t kMask = BPP == 32 ? 0xFFFFFFFFu : 0xFFFFu;
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= num_blocks) return;
  const size_t plane = static_cast<size_t>(num_blocks);

  int pm_a[kStates], pm_b[kStates];
  uint32_t pp_a[kStates], pp_b[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    pm_a[s] = 0;
    pp_a[s] = 0u;
  }

  // block k reads words k*wpb ... k*wpb + wpb + wph - 1 directly, halo
  // included (it may span several following bodies when dec_len < 64)
  StageReader<WIDTH> reader(words, n_words, static_cast<long long>(blk) * wpb);
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
    uint32_t* dst = surv + static_cast<size_t>(p) * kStates * plane + blk;
#pragma unroll
    for (int s = 0; s < kStates; ++s) dst[s * plane] = pp_a[s] & kMask;
    if (renorm) {  // decision-invariant min-subtract (core_pallas.py:457-466)
      int m = pm_a[0];
#pragma unroll
      for (int s = 1; s < kStates; ++s) m = min(m, pm_a[s]);
#pragma unroll
      for (int s = 0; s < kStates; ++s) pm_a[s] -= m;
    }
  }

  // traceback from state 0 on the last pack: discard n_conv packs, emit
  // n_emit; next state = the pack's oldest 6 decisions (logical shift)
  const int emit_lo = n_packs - n_conv - n_emit;
  int state = 0;
  for (int k = 0; k < n_conv + n_emit; ++k) {
    const int kp = n_packs - 1 - k;
    const uint32_t pack =
        surv[(static_cast<size_t>(kp) * kStates + state) * plane + blk];
    if (k >= n_conv) {
      out[static_cast<size_t>(blk) * n_emit + (kp - emit_lo)] =
          static_cast<int>(pack);
    }
    state = static_cast<int>((pack >> (BPP - 6)) & 63u);
  }
}

template <int WIDTH, int BPP>
cudaError_t launch(const int* words, long long n_words, uint32_t* surv,
                   int* out, int num_blocks, int n_packs, int wpb, int n_conv,
                   int n_emit, int renorm, cudaStream_t stream) {
  const int grid = (num_blocks + kThreads - 1) / kThreads;
  viterbi_k1_kernel<WIDTH, BPP><<<grid, kThreads, 0, stream>>>(
      words, n_words, surv, out, num_blocks, n_packs, wpb, n_conv, n_emit,
      renorm);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  words: the flat int32 channel
// stream of n_words words; surv: (n_packs, 64, num_blocks) int32 scratch;
// out: (num_blocks, n_emit) int32 packs, read as uint32.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int viterbi_k1_launch(const void* words, long long n_words,
                                 void* surv, void* out, int num_blocks,
                                 int n_packs, int wpb, int n_conv, int n_emit,
                                 int width, int bpp, int renorm,
                                 void* stream) {
  const int* w = static_cast<const int*>(words);
  uint32_t* sv = static_cast<uint32_t*>(surv);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define K1_CASE(W, B)                                                     \
  if (width == W && bpp == B)                                             \
    return static_cast<int>(launch<W, B>(w, n_words, sv, o, num_blocks,   \
                                         n_packs, wpb, n_conv, n_emit,    \
                                         renorm, st));
  K1_CASE(1, 32) K1_CASE(1, 16)
  K1_CASE(4, 32) K1_CASE(4, 16)
  K1_CASE(8, 32) K1_CASE(8, 16)
  K1_CASE(16, 32) K1_CASE(16, 16)
#undef K1_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
