"""Hardware model: the per-device-kind numbers the decode planner reads,
instead of literals baked in for one card; the counterpart of
``tpu_viterbi/hardware.py``.  Where the TPU's planner asks how much VMEM a
kernel's buffers may take, the GPU's asks how much dynamic shared memory
one CUDA block may opt in to (K3's survivor ring) and how much device
memory the full survivor store may take.

Resolution order for the shared-memory budget, as in the JAX package:

  1. the environment override ``TPU_VITERBI_SMEM_BUDGET`` (bytes), read on
     every call so tests and deployments can retarget without re-importing,
  2. the measured per-device-kind table below,
  3. the smallest measured value, so an unknown card refuses a ring it
     might not hold (a ValueError naming shared memory) rather than meet a
     refused launch.

Only MEASURED numbers go in the tables.  ``probe_smem_budget`` (kernel K9)
is how a new kind gets measured: ``python -m tpu_viterbi_torch.hardware``
on the card prints the probed budget to put here or in the variable.

The entry points' device rule is here too (``resolve_device``): they run
on the card unless the caller asks for the CPU, and never fall back.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys
from typing import Callable, Optional

import torch

from . import library

# Dynamic shared memory (bytes) one CUDA block may opt in to, by device-kind
# substring (matched case-insensitively, first hit wins).  "NVIDIA H100 80GB
# HBM3": 232448, K9's probe on the card, equal to the CUDA attribute
# cudaDevAttrMaxSharedMemoryPerBlockOptin (chip_smoke.py's hardware phase;
# PERF.md).
_SMEM_BUDGET_BY_KIND = (
    ("h100", 232448),
)
_SMEM_BUDGET_DEFAULT = min(v for _, v in _SMEM_BUDGET_BY_KIND)

# ALU model for utilisation figures, by device-kind substring:
# (floor_ns_per_block_stage, ops_per_block_stage, lane_ops_per_ns), all in
# issued SASS instructions, not in semantic ops.  ops_per_block_stage is
# the ACS' minimal instruction count (two adds, one max that yields the
# decision and one select of the path register, for each of the 64
# states); lane_ops_per_ns is the card-wide rate of the instructions that
# scripts/op_cost_probe.py's add4 loop issued (its SASS count over its
# time); the floor is their quotient.  A utilisation figure divides the
# ACS instructions a decode issues by this rate.  add4's semantic rate is
# 1.68 times higher (32 adds a step loop in 19 instructions: ptxas fuses
# two adds of one constant into an IADD3, which the ACS' adds of different
# metrics cannot use), so it would overstate the floor's pace.
# "NVIDIA H100 80GB HBM3", 700 W: add4 18357.7 lane-instructions/ns
# (70.2 a clock per SM at 1.98 GHz), chip_smoke.py's op-cost phase,
# PERF.md.  A kind with no measurement gets None, and no utilisation is
# reported against another card's rate.
_ALU_MODEL_BY_KIND = (
    ("h100", (256 / 18357.7, 256, 18357.7)),
)

# cudaError_t cudaErrorInvalidValue: a shared-memory request over the limit
CUDA_ERROR_INVALID_VALUE = 1
# cudaDeviceAttr values (csrc/hardware.cu static_asserts both): the peak SM
# clock in kHz, and the dynamic shared memory one block may opt in to
ATTR_CLOCK_RATE = 13
ATTR_MAX_SMEM_PER_BLOCK_OPTIN = 97


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``device`` itself, never
    another.  A CUDA device when torch finds none raises RuntimeError; the
    plain PyTorch versions run on the CPU only when the caller asks for
    device 'cpu'."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: torch.cuda.is_available() is false "
            f"(device={str(device)!r}); pass device='cpu' (--device cpu) "
            f"to run the plain PyTorch versions on the CPU")
    return dev


def device_kind() -> str:
    """Name of the current CUDA device, '' without one.  Cached per
    process (stable for its life)."""
    return _device_kind_cached()


@functools.lru_cache(maxsize=None)
def _device_kind_cached() -> str:
    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(torch.cuda.current_device())


def smi_cards() -> list:
    """Each card's name and power limit, a line each, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: a
    card set below its maximum runs slower under load, so every time
    taken on it is reported beside this."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def _lookup(table, kind: str):
    k = kind.lower()
    for sub, val in table:
        if sub in k:
            return val
    return None


def smem_budget_bytes(kind: Optional[str] = None) -> int:
    """Dynamic shared memory (bytes) one CUDA block may opt in to: the
    budget of K3's survivor ring (counterpart of ``vmem_budget_bytes``).

    The environment override ``TPU_VITERBI_SMEM_BUDGET`` (bytes, read on
    every call) beats the measured per-kind table, which beats the
    smallest measured value.  ``core_cuda.resolve_window`` and the window
    kernels' launch gate read it through here."""
    env = os.environ.get("TPU_VITERBI_SMEM_BUDGET")
    if env:
        return int(env)
    v = _lookup(_SMEM_BUDGET_BY_KIND,
                kind if kind is not None else device_kind())
    return v if v is not None else _SMEM_BUDGET_DEFAULT


def alu_model(kind: Optional[str] = None):
    """(floor_ns_per_block_stage, ops_per_block_stage, lane_ops_per_ns) of
    the ACS on this device kind, in issued instructions (counterpart of
    ``vpu_model``), or None when the kind has no measured rate."""
    return _lookup(_ALU_MODEL_BY_KIND,
                   kind if kind is not None else device_kind())


def survivor_store_budget_bytes(device) -> int:
    """Device memory (bytes) the full survivor store may take: half of the
    card's total memory.  The limit is fixed for a card, as the TPU's VMEM
    budget is for a chip, so a plan decodes alike whatever else holds
    memory at the time (the live free memory would make the output depend
    on it: window and full store differ on noisy input)."""
    return torch.cuda.get_device_properties(device).total_memory // 2


class SmemProbeKernel:
    """Wrapper of K9, bound to ``viterbi_k9_launch`` of the package's
    library.  ``launches`` counts the launches the card accepted and
    nothing else (refused requests and plain-version calls do not
    count)."""

    ROWS, COLS = 8, 128
    MIN_BYTES = ROWS * COLS * 4

    def __init__(self):
        self.name = "K9"
        self.entry = "viterbi_k9_launch"
        self.source = library.CSRC / "hardware.cu"
        self.launches = 0
        self._fn = None

    def build(self) -> None:
        """Build and load the library (once a process), bind the entry."""
        if self._fn is None:
            self._fn = library.bind(self.entry, [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

    def __call__(self, nbytes: int, out: torch.Tensor) -> int:
        """One launch with ``nbytes`` of dynamic shared memory writing the
        (8, 128) int32 ``out``; returns the cudaError_t (0: launched), on
        the current stream, without synchronizing.  On a CPU tensor, its
        plain version: ``out`` zeroed, 0."""
        if out.shape != (self.ROWS, self.COLS) or out.dtype != torch.int32 \
                or not out.is_contiguous():
            raise ValueError(f"K9 writes a contiguous (8, 128) int32 tensor, "
                             f"got {out.dtype} {tuple(out.shape)}")
        if nbytes < self.MIN_BYTES:
            raise ValueError(f"K9 needs at least {self.MIN_BYTES} bytes of "
                             f"scratch, got {nbytes}")
        if out.device.type == "cpu":
            out.zero_()
            return 0
        if out.device.type != "cuda":
            raise ValueError(f"K9 runs on CPU or CUDA tensors, got "
                             f"{out.device}")
        self.build()
        with torch.cuda.device(out.device):
            err = self._fn(int(nbytes), out.data_ptr(),
                           torch.cuda.current_stream(out.device).cuda_stream)
        if err == 0:
            self.launches += 1
        return err


K9 = SmemProbeKernel()


def k9_fits(out: torch.Tensor) -> Callable[[int], bool]:
    """The probe's predicate on the card of ``out``: True when K9 launches
    with that many bytes, False when the launch is refused for its shared
    memory (cudaErrorInvalidValue); any other error raises."""
    def fits(nbytes: int) -> bool:
        err = K9(nbytes, out)
        if err == 0:
            return True
        if err == CUDA_ERROR_INVALID_VALUE:
            return False
        # only the shared-memory refusal means "over budget": counting any
        # other failure as one would converge the search to a budget too
        # small and demote every later plan on this card
        raise RuntimeError(f"K9 launch at {nbytes} bytes failed for a "
                           f"reason other than the shared-memory limit: "
                           f"cudaError_t {err}")
    return fits


def probe_smem_budget(lo: int = 48 * 1024, hi: int = 1 << 20,
                      fits: Optional[Callable[[int], bool]] = None) -> int:
    """Measure the dynamic shared memory one CUDA block may opt in to, by
    binary search on the bytes K9 may launch with, until hi - lo == 1
    (about 20 launches of microseconds each).  Returns the largest size
    that launches: the number for TPU_VITERBI_SMEM_BUDGET or the table
    above on a new card.

    The range is the GPU's, not the JAX probe's 4 MB to 192 MB (a TPU's
    VMEM): every CUDA card since Volta gives a block 48 KB, and no card
    comes near 1 MiB.  ``fits`` (default: ``k9_fits`` on the current CUDA
    device) answers True or False, or raises for a failure that is not the
    limit; a floor that fails, or a ceiling that fits, raises too."""
    if not 0 < lo < hi:
        raise ValueError(f"probe range must satisfy 0 < lo < hi, got "
                         f"{lo}, {hi}")
    if fits is None:
        dev = resolve_device("cuda")
        out = torch.empty((SmemProbeKernel.ROWS, SmemProbeKernel.COLS),
                          dtype=torch.int32, device=dev)
        fits = k9_fits(out)
    if not fits(lo):
        raise RuntimeError(f"probe floor {lo} bytes already fails to launch "
                           f"— not a shared-memory limit")
    if fits(hi):
        raise RuntimeError(f"probe ceiling {hi} bytes launches: raise hi")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


def _attribute(device, attr: int) -> int:
    """cudaDeviceGetAttribute(attr) of a CUDA device (default: the current
    one), through the library's ``viterbi_device_attribute``."""
    dev = resolve_device("cuda" if device is None else device)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    fn = library.bind("viterbi_device_attribute", [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    val = ctypes.c_int(0)
    err = fn(attr, index, ctypes.byref(val))
    if err != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute({attr}) failed: "
                           f"cudaError_t {err}")
    return val.value


def optin_smem_bytes(device=None) -> int:
    """cudaDevAttrMaxSharedMemoryPerBlockOptin of a CUDA device (default:
    the current one): K9's plain counterpart on the card."""
    return _attribute(device, ATTR_MAX_SMEM_PER_BLOCK_OPTIN)


def sm_clock_hz(device=None) -> float:
    """The peak SM clock of a CUDA device (cudaDevAttrClockRate)."""
    return 1e3 * _attribute(device, ATTR_CLOCK_RATE)


# Bounds: the least time the card could take for a kernel's work, the
# larger of its bytes over the memory rate and its operations over the
# issue rate (SMs x 4 schedulers x 32 lanes x the peak SM clock; not the
# 64 INT32 lanes an SM, which IMAD-class work on the FMA pipe can beat),
# with special-function work (Box-Muller's log, sqrt, sin, cos) over the
# SFU rate, 16 an SM a clock.  Published H100 SXM peaks (NVIDIA's data
# sheet) at the card's full power limit of 700 W.
PEAK_BYTES_PER_S = 3.35e12
SFU_PER_SM_CLOCK = 16
ACS_OPS = 256           # a block-stage: 64 states x (2 adds, 1 max, 1 select)
# the same at int16x2 (acs.cuh's acs_stage16): the 128 adds and 64 maxima
# two to a lane-instruction (VIADD.16x2, VIMNMX.S16x2), the 64 selects one
ACS_OPS16 = 160


def bound_ms(nbytes: float, ops: float = 0.0, sfu: float = 0.0):
    """(least ms, "bytes" or "operations") for work that moves ``nbytes``
    (each input read once, each output written once) and issues ``ops``
    lane-instructions and ``sfu`` special-function lane-ops on the current
    CUDA device."""
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    clock = sm_clock_hz()
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max(ops / (sms * 4 * 32 * clock),
                sfu / (sms * SFU_PER_SM_CLOCK * clock))
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    """Print the device kind, the table's budget and the probed budget
    (``python -m tpu_viterbi_torch.hardware``, as JAX's :158-163)."""
    k = device_kind()
    print(f"device_kind: {k!r}")
    print(f"table/default budget: {smem_budget_bytes()} bytes")
    print("probing the dynamic shared-memory budget (K9 launches)...")
    budget = probe_smem_budget()
    torch.cuda.synchronize()
    print(f"probed budget: {budget} bytes (opt-in attribute "
          f"{optin_smem_bytes()} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
