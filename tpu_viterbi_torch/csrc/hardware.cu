// Kernel K9: the shared-memory probe of the hardware model, and the device
// attribute reads beside it.
//   - K9, viterbi_k9_launch: one CUDA block of 128 threads with an
//     `nbytes` dynamic shared scratch, read as (nbytes / 512, 128) int32
//     rows; it zeroes rows 0..7 and copies them to the (8, 128) int32
//     output.  Replaces the TPU kernel of
//     tpu_viterbi/hardware.py:probe_vmem_budget (:103-155), which allocates
//     an (rows, 128) int32 VMEM scratch, writes its row 0 and reads rows
//     0..7 (rows 1..7 unwritten; here they are zeroed, so the output is
//     defined: zeros, its plain version).
//   - viterbi_device_attribute: cudaDeviceGetAttribute, read by
//     hardware.py for the peak SM clock and for
//     cudaDevAttrMaxSharedMemoryPerBlockOptin, the dynamic shared memory
//     one block may opt in to, which PyTorch's device properties do not
//     expose (they give the 48 KB default and the SM's total).  That
//     attribute read is K9's plain counterpart on the card.
//   - the empty kernel, viterbi_k9_empty_launch: one block of 128 threads
//     with `nbytes` of dynamic shared memory that touches nothing, its
//     attribute set once by viterbi_k9_empty_attribute.  It is K9's
//     bound: a launch of the same shape with no work, read by CUDA-graph
//     replay beside K9 (chip_smoke.py's hardware phase).
// The wrapper and the binary search are in tpu_viterbi_torch/hardware.py.
//
// What bounds it: the launch; it moves 4 KB, and its least time is the
// empty kernel's launch at the same shared memory.  What the design does
// about it: the probe is a search over about 20 launches of microseconds
// each, so it costs less than one TPU compile of the JAX probe.  Where the
// TPU's limit showed at compile time, here a request over the limit is
// refused at launch: by cudaFuncSetAttribute (above the opt-in maximum) or
// by the launch itself, both as cudaErrorInvalidValue.  Either refusal is
// cleared with cudaGetLastError, so the next probe reads no stale error.

#include <cuda_runtime.h>

// hardware.py passes these attributes by value (ATTR_CLOCK_RATE,
// ATTR_MAX_SMEM_PER_BLOCK_OPTIN)
static_assert(cudaDevAttrClockRate == 13, "hardware.py's ATTR_CLOCK_RATE");
static_assert(cudaDevAttrMaxSharedMemoryPerBlockOptin == 97,
              "hardware.py's ATTR_MAX_SMEM_PER_BLOCK_OPTIN");

namespace viterbi_hw {

constexpr int kCols = 128;
constexpr int kRows = 8;

__global__ void __launch_bounds__(kCols)
smem_probe_kernel(int* __restrict__ out) {
  extern __shared__ int scratch[];
  const int col = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRows; ++r) scratch[r * kCols + col] = 0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[r * kCols + col] = scratch[r * kCols + col];
}

// A launch with nothing in it: K9's floor.
__global__ void __launch_bounds__(kCols) empty_kernel() {}

}  // namespace viterbi_hw

using namespace viterbi_hw;

// Launch K9 with `nbytes` of dynamic shared memory on `stream`; returns the
// cudaError_t (0 = launched).  A request below the 8 x 128 ints the kernel
// touches is refused with cudaErrorInvalidConfiguration, never with the
// cudaErrorInvalidValue that reads as over budget.
extern "C" int viterbi_k9_launch(int nbytes, void* out, void* stream) {
  if (out == nullptr ||
      nbytes < static_cast<int>(kRows * kCols * sizeof(int)))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      smem_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  smem_probe_kernel<<<1, kCols, nbytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Opt the empty kernel in to `nbytes` of dynamic shared memory; returns the
// cudaError_t (cleared).  Called once, before its launches are timed.
extern "C" int viterbi_k9_empty_attribute(int nbytes) {
  cudaError_t err = cudaFuncSetAttribute(
      empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes);
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// Launch the empty kernel with `nbytes` of dynamic shared memory on
// `stream`, the attribute as viterbi_k9_empty_attribute left it; returns
// the cudaError_t (0 = launched).
extern "C" int viterbi_k9_empty_launch(int nbytes, void* stream) {
  empty_kernel<<<1, kCols, nbytes, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int viterbi_device_attribute(int attr, int device, int* out) {
  return static_cast<int>(cudaDeviceGetAttribute(
      out, static_cast<cudaDeviceAttr>(attr), device));
}
