"""Dtype-throughput probe on the card: kernel K17, the counterpart of
``scripts/dtype_throughput.py``, which asked whether the TPU's vector unit
runs 16-bit operations at twice the 32-bit rate.  Here it asks the same of
Hopper's packed types, where two 16-bit or four 8-bit elements share one
32-bit register.

    python -m tpu_viterbi_torch.scripts.dtype_throughput [dtypes]

From a = x.astype(d) and c = row 1 of it, each thread runs steps of UNROLL
dependent (a = a + c, a = max(a, c - a)) pairs in dtype d and writes
a.astype(int32) (JAX :29-42).  Dtypes and their Hopper form:
  int32  one element a register (add.s32, sub.s32, max.s32)
  fp32   one element a register (add.f32, sub.f32, max.f32)
  bf16   __nv_bfloat162, two a register (__hadd2, __hsub2, __hmax2)
  fp16   __half2, two a register (__hadd2, __hsub2, __hmax2)
  int16  int16x2, two a register (__vadd2, __vsub2, __vmaxs2)
  int8   four bytes a register (__vadd4, __vsub4, __vmaxs4)
A thread owns PACK neighbouring elements of the tile; element i of the
output is the plain value at tile position i mod 4096.

Each dtype is timed at two occupancies:
  tile   the JAX shape, one (32, 128) tile: 4096 / PACK threads in blocks
         of TILE_THREADS
  full   the SM's 2048 threads, K11's grid (op_cost_probe.grid_tiles)
The time of a step is the slope between STEPS_LO and STEPS_HI steps (the
method of op_cost_probe.run, which cancels the launch), each the median of
REPS CUDA-event launches after one untimed launch; printed as element-ops a
ns (two a pair, the JAX probe's count) and as lane-instructions a clock per
SM, with the SASS instructions of the step loop (cuobjdump), which show
whether each packed intrinsic is one instruction on sm_90.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import hardware
from .common import (ProbeKernel, check_names, describe_mix, sass_table,
                     timed)
from .op_cost_probe import grid_tiles, TILE_BLOCKS, THREADS as FULL_THREADS

ROWS, COLS = 32, 128
TILE = ROWS * COLS
STEPS = 2000                        # the JAX probe's
UNROLL = 16
STEPS_LO = 5000
STEPS_HI = 30000
REPS = 5
DTYPES = ("int32", "fp32", "bf16", "fp16", "int16", "int8")
TORCH_DTYPE = dict(int32=torch.int32, fp32=torch.float32,
                   bf16=torch.bfloat16, fp16=torch.float16,
                   int16=torch.int16, int8=torch.int8)
PACK = dict(int32=1, fp32=1, bf16=2, fp16=2, int16=2, int8=4)
OCCUPANCIES = ("tile", "full")
TILE_THREADS = 128
# operations a pair, the JAX probe's count (its :71), kept for the
# element-ops rate: the add and the max, each one packed lane-instruction of
# PACK elements.  The share of bound (chip_smoke.py's dtype phase) counts
# the 3 packed operations the pair needs: the add, the subtract, the max
OPS_A_PAIR = 2
MAX_THREADS = 256


def _check(dtype: str, x: torch.Tensor, steps: int) -> None:
    check_names((dtype,), DTYPES, "dtype")
    if x.shape != (ROWS, COLS) or x.dtype != torch.int32:
        raise ValueError(f"the probe's tile is (32, 128) int32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def _to_int32(a: torch.Tensor) -> torch.Tensor:
    """a.astype(int32) as XLA converts: integers sign-extend; floats
    truncate toward zero, saturate at the int32 range, and NaN gives 0."""
    if not a.is_floating_point():
        return a.to(torch.int32)
    f = torch.nan_to_num(a.double(), nan=0.0, posinf=2.0 ** 31 - 1,
                         neginf=-2.0 ** 31)
    return f.clamp(-2.0 ** 31, 2.0 ** 31 - 1).trunc().to(torch.int32)


def dtype_torch(dtype: str, x: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version: the (32, 128) int32 result of ``steps`` x UNROLL
    (a = a + c, a = max(a, c - a)) in ``dtype`` from a = x.astype(dtype),
    c = row 1 of a (JAX :29-42).  Integers wrap; floats round to nearest
    even at every operation (x converts through float32, exact below
    2**24)."""
    _check(dtype, x, steps)
    d = TORCH_DTYPE[dtype]
    a = x.to(torch.float32).to(d) if d.is_floating_point else x.to(d)
    c = a[1:2]
    for _ in range(steps * UNROLL):
        a = a + c
        a = torch.maximum(a, c - a)
    return _to_int32(a)


def grid(dtype: str, occupancy: str, device=None):
    """(blocks, threads a block) of a dtype at an occupancy on the card."""
    check_names((dtype,), DTYPES, "dtype")
    check_names((occupancy,), OCCUPANCIES, "occupancy")
    dev = hardware.resolve_device("cuda" if device is None else device)
    if occupancy == "tile":
        return TILE // PACK[dtype] // TILE_THREADS, TILE_THREADS
    return grid_tiles(dev) * TILE_BLOCKS, FULL_THREADS


class DtypeKernel(ProbeKernel):
    """K17, bound to ``viterbi_k17_launch``."""

    def __init__(self):
        super().__init__("K17", "viterbi_k17_launch", "dtype_throughput.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int])

    def __call__(self, dtype: str, x: torch.Tensor, steps: int,
                 blocks: int, threads: int) -> torch.Tensor:
        """(blocks x threads x PACK[dtype],) int32: element i is the plain
        value at tile position i mod 4096.  On a CUDA tensor one launch on
        the current stream, not synchronized; on a CPU tensor its plain
        version."""
        _check(dtype, x, steps)
        if blocks <= 0 or threads <= 0 or threads % 32 or \
                threads > MAX_THREADS or not x.is_contiguous():
            raise ValueError(f"K17 takes a contiguous tile and blocks > 0 of "
                             f"a multiple of 32 threads up to {MAX_THREADS}, "
                             f"got {blocks} x {threads}")
        n = blocks * threads * PACK[dtype]
        if not self.check_device(x):
            flat = dtype_torch(dtype, x, steps).reshape(-1)
            return flat.repeat(-(-n // TILE))[:n]
        out = torch.empty(n, dtype=torch.int32, device=x.device)
        self.launch(x.device, DTYPES.index(dtype), x.data_ptr(),
                    out.data_ptr(), int(steps), blocks, threads)
        return out


K17 = DtypeKernel()


def probe_input(device, seed: int = 0) -> torch.Tensor:
    """The probe's tile: int32 values 0..6 from numpy's generator (the JAX
    probe's inputs, :48-49)."""
    x = np.random.default_rng(seed).integers(0, 7, (ROWS, COLS))
    return torch.from_numpy(x.astype(np.int32)).to(device)


def sass_counts() -> dict:
    """{dtype: (SASS instructions of the step loop, {REG, STACK, ...}, the
    loop's opcode mix)} read from the built library."""
    return sass_table("viterbi_dtype", {d: ("dtype_kernel", f"ILi{i}E")
                                        for i, d in enumerate(DTYPES)})


def run(dtype: str, occupancy: str, x: torch.Tensor, clock_hz: float,
        sass: tuple) -> dict:
    """Time one dtype at one occupancy: the slope between STEPS_LO and
    STEPS_HI."""
    blocks, threads = grid(dtype, occupancy, x.device)
    ms = {}
    for steps in (STEPS_LO, STEPS_HI):
        ms[steps], _, _ = timed(
            lambda: K17(dtype, x, steps, blocks, threads), REPS)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    dt_ns = (ms[STEPS_HI] - ms[STEPS_LO]) * 1e6
    lanes = blocks * threads
    pairs = (STEPS_HI - STEPS_LO) * UNROLL
    loop, res, mix = sass
    return dict(dtype=dtype, occupancy=occupancy, blocks=blocks,
                threads=threads, pack=PACK[dtype], ms_lo=ms[STEPS_LO],
                ms_hi=ms[STEPS_HI], ns_per_pair=dt_ns / pairs,
                element_ops_per_ns=lanes * PACK[dtype] * pairs * OPS_A_PAIR /
                dt_ns,
                sass_loop=loop, mix=mix,
                sass_per_clock_per_sm=lanes * (STEPS_HI - STEPS_LO) * loop /
                dt_ns / (sms * clock_hz * 1e-9),
                regs=res.get("REG"), stack=res.get("STACK"))


def describe(r: dict) -> str:
    return (f"{r['dtype']:5s} {r['occupancy']:4s} ({r['blocks']} x "
            f"{r['threads']} x {r['pack']}): lo={r['ms_lo']:.4f} "
            f"hi={r['ms_hi']:.4f} ms, {r['ns_per_pair']:.4f} ns a dependent "
            f"pair, {r['element_ops_per_ns']:.1f} element-ops/ns; SASS "
            f"{r['sass_loop']} a step loop of {UNROLL} pairs "
            f"({describe_mix(r['mix'])}) = {r['sass_per_clock_per_sm']:.2f} "
            f"lane-instructions a clock per SM; registers {r['regs']}, stack "
            f"{r['stack']} B")


def probe(names=DTYPES) -> list:
    """Time each named dtype at both occupancies on the current CUDA device
    and print one line each; returns their ``run`` results."""
    check_names(names, DTYPES, "dtype")
    dev = hardware.resolve_device("cuda")
    x = probe_input(dev)
    clock = hardware.sm_clock_hz(dev)
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: peak SM clock "
          f"{clock / 1e9:.3f} GHz; steps {STEPS_LO} and {STEPS_HI} of "
          f"{UNROLL} pairs")
    results = []
    for occupancy in OCCUPANCIES:
        for d in names:
            results.append(run(d, occupancy, x, clock, sass[d]))
            print(describe(results[-1]), flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or DTYPES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
