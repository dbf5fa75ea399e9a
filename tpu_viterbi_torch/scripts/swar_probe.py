"""int16x2 SWAR ACS probe on the card: kernel K18, the counterpart of
``scripts/swar_probe.py``, which asked whether two states' path metrics in
one 32-bit word make the TPU's ACS stage cheaper.  Here it asks whether an
int16x2 ACS issues fewer instructions a stage than the int32 one.

    python -m tpu_viterbi_torch.scripts.swar_probe [variants]

Variants (JAX :74-164), on a program's block of rows: pm | pp | bm (a bm
per row, the same every stage):
  baseline      the int32 stage: 64 path metrics, children e | o
  swar/stage    pm packed two states a word (q | q+32 << 16); the children
                repacked into (q', q'+32) words every stage (JAX's "swar
                repack/stage")
  swar/4stages  as swar/stage, repacked every 4th stage and kept as (e | o
                << 16) words between (JAX's "swar repack/4stages")
The survivor registers stay 64 int32 in every variant.  The Hopper form
of the packed stage: swar_add is __vadd2; the horizontal lo/hi
compare-select is a __byte_perm pair and one DPX __vibmax_s16x2, whose
predicate (a >= b) is inverted to JAX's strict hi > lo; the repack is
__byte_perm.

Each runs STAGES stages at two array counts: the JAX probe's GRID programs
of 128 arrays (2048) and HEADLINE_TILES (15,872, K1's occupancy at the
headline).  A time is the median of REPS CUDA-event launches after one
untimed launch, printed as ns per stage per 128-array tile beside the SASS
instructions of the variant's stage loop a stage, its registers and stack
frame (cuobjdump -res-usage).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import hardware
from .common import (LT, ProbeKernel, check_names, describe_stages,
                     sass_table, time_stages)

STAGES = 8192
GRID = 16
HEADLINE_TILES = 124
REPS = 5
VARIANTS = ("baseline", "swar/stage", "swar/4stages")
ROWS_IN = {"baseline": 160, "swar/stage": 128, "swar/4stages": 128}
REPACK = {"baseline": 1, "swar/stage": 1, "swar/4stages": 4}
LOOP_STAGES = REPACK                # stages of one pass of the stage loop
# lane-operations an array-stage, for the bound, a predecessor pair q each:
# baseline the JAX docstring's 4 adds, 2 compares, 4 selects and 3
# register-exchange ops (13, :10-13); swar in packed lane-operations, two
# 16-bit states each: 2 packed adds, one packed max that also gives both
# decisions, and the survivors' 5 ops as baseline (8).  The JAX count of
# the swar stage (28: its mask-fix adds and half extractions, :15-25)
# counts the TPU's emulation of packed arithmetic that Hopper has, and
# would put the bound above the card's time; the half alignment and the
# repack are relayouts, not counted.  32 pairs an array.
OPS = {"baseline": 416, "swar/stage": 256, "swar/4stages": 256}
_M32 = 0xFFFFFFFF


def _check(variant: str, x: torch.Tensor, stages: int) -> int:
    """The number of programs of x; raises on what the kernel refuses."""
    check_names((variant,), VARIANTS)
    rows = ROWS_IN[variant]
    if x.dim() != 2 or x.shape[1] != LT or x.shape[0] % rows or \
            x.shape[0] == 0 or x.dtype != torch.int32:
        raise ValueError(f"{variant} takes a (programs x {rows}, {LT}) int32 "
                         f"block, got {x.dtype} {tuple(x.shape)}")
    if stages < 0 or stages % 4:
        raise ValueError(f"stages must be a multiple of 4 and >= 0, got "
                         f"{stages}")
    return x.shape[0] // rows


def _baseline(x: torch.Tensor, stages: int) -> torch.Tensor:
    """(G, 160, 128) -> (G, 64, 128): JAX :74-106, int32 wrapping."""
    pm, pp, bm = x[:, :64], x[:, 64:128], x[:, 128:160]
    for _ in range(stages):
        lo, hi = pm[:, :32], pm[:, 32:]
        c0e, c1e, c0o, c1o = lo + bm, hi - bm, lo - bm, hi + bm
        de, do = c1e > c0e, c1o > c0o
        fl = pp[:, :32] + pp[:, :32]
        fh = pp[:, 32:] + pp[:, 32:] + 1
        pm = torch.cat([torch.where(de, c1e, c0e),
                        torch.where(do, c1o, c0o)], 1)
        pp = torch.cat([torch.where(de, fh, fl), torch.where(do, fh, fl)], 1)
    return pm + pp


def _swar_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two 16-bit adds without a carry across, on uint32 bit patterns held
    in int64 (JAX :67-71; on the card __vadd2)."""
    return (((a & 0x7FFF7FFF) + (b & 0x7FFF7FFF)) ^ ((a ^ b) & 0x80008000)) \
        & _M32


def _lo16(w: torch.Tensor) -> torch.Tensor:
    """The low half of each word, sign-extended (JAX's (w << 16) >> 16)."""
    return ((w & 0xFFFF) ^ 0x8000) - 0x8000


def _hi16(w: torch.Tensor) -> torch.Tensor:
    """The high half of each word, sign-extended (JAX's w >> 16)."""
    return (((w >> 16) & 0xFFFF) ^ 0x8000) - 0x8000


def _pack(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo & 0xFFFF) | (hi << 16) as a uint32 pattern."""
    return (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    return (((w & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _swar(x: torch.Tensor, stages: int, repack: int) -> torch.Tensor:
    """(G, 128, 128) -> (G, 64, 128): JAX :109-164.  pm words are uint32
    patterns in int64, pp stays int32 (wrapping)."""
    pmw = x[:, :32].to(torch.int64) & _M32
    pp = x[:, 32:96]
    bm = x[:, 96:128].to(torch.int64)
    bme, bmo = _pack(bm, -bm), _pack(-bm, bm)
    for _ in range(stages // repack):
        for t in range(repack):
            ce, co = _swar_add(pmw, bme), _swar_add(pmw, bmo)
            c0e, c1e, c0o, c1o = _lo16(ce), _hi16(ce), _lo16(co), _hi16(co)
            de, do = c1e > c0e, c1o > c0o
            e, o = torch.where(de, c1e, c0e), torch.where(do, c1o, c0o)
            fl = pp[:, :32] + pp[:, :32]
            fh = pp[:, 32:] + pp[:, 32:] + 1
            pp = torch.cat([torch.where(de, fh, fl),
                            torch.where(do, fh, fl)], 1)
            if t == repack - 1:
                lo_rows = torch.stack([e[:, :16], o[:, :16]], 2).flatten(1, 2)
                hi_rows = torch.stack([e[:, 16:], o[:, 16:]], 2).flatten(1, 2)
                pmw = _pack(lo_rows, hi_rows)
            else:
                pmw = _pack(e, o)
    pmw = _to_int32(pmw)
    return torch.cat([pmw, pmw], 1) + pp


def swar_torch(variant: str, x: torch.Tensor, stages: int) -> torch.Tensor:
    """Plain version of one variant: x (programs x rows, 128) int32 ->
    (programs, 64, 128) int32, each program's output after ``stages``
    stages (the JAX kernel writes every program's result to one block, so
    its output is the last program's)."""
    _check(variant, x, stages)
    blocks = x.reshape(-1, ROWS_IN[variant], LT)
    if variant == "baseline":
        return _baseline(blocks, stages)
    return _swar(blocks, stages, REPACK[variant])


class SwarKernel(ProbeKernel):
    """K18, bound to ``viterbi_k18_launch``."""

    def __init__(self):
        super().__init__("K18", "viterbi_k18_launch", "swar_probe.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int])

    def __call__(self, variant: str, x: torch.Tensor,
                 stages: int) -> torch.Tensor:
        """(programs, 64, 128) int32: every program's output after
        ``stages`` stages.  On a CUDA tensor one launch on the current
        stream, not synchronized; on a CPU tensor its plain version."""
        programs = _check(variant, x, stages)
        if not x.is_contiguous():
            raise ValueError("K18 takes a contiguous block")
        if not self.check_device(x):
            return swar_torch(variant, x, stages)
        out = torch.empty((programs, 64, LT), dtype=torch.int32,
                          device=x.device)
        self.launch(x.device, VARIANTS.index(variant), x.data_ptr(),
                    out.data_ptr(), int(stages), programs)
        return out


K18 = SwarKernel()


def probe_input(variant: str, programs: int, device,
                seed: int = 0) -> torch.Tensor:
    """(programs x rows, 128) int32 values 0..7999 from numpy's generator
    (the JAX probe's randint range, :181-182)."""
    x = np.random.default_rng(seed).integers(
        0, 8000, (programs * ROWS_IN[variant], LT), dtype=np.int32)
    return torch.from_numpy(x).to(device)


def sass_counts() -> dict:
    """{variant: (SASS instructions of its stage loop, {REG, STACK, ...},
    the loop's opcode mix)} read from the built library."""
    return sass_table("viterbi_swar", {v: ("swar_kernel", f"ILi{i}E")
                                       for i, v in enumerate(VARIANTS)})


def run(variant: str, x: torch.Tensor, programs: int, sass: tuple) -> dict:
    """Time one variant at STAGES stages over the first ``programs``
    programs of x."""
    xv = x[:programs * ROWS_IN[variant]]
    return time_stages(lambda: K18(variant, xv, STAGES), REPS, STAGES,
                       programs * LT, sass, LOOP_STAGES[variant],
                       variant=variant, programs=programs)


def describe(r: dict) -> str:
    return describe_stages(r, f"{r['variant']:12s} {r['arrays']:6d} arrays")


def probe(names=VARIANTS) -> list:
    """Time each named variant on the current CUDA device at GRID and
    HEADLINE_TILES programs and print one line each; returns their ``run``
    results."""
    check_names(names, VARIANTS)
    dev = hardware.resolve_device("cuda")
    xs = {v: probe_input(v, HEADLINE_TILES, dev) for v in names}
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {STAGES} stages, CUDA blocks "
          f"of 64 threads")
    results = []
    for programs in (GRID, HEADLINE_TILES):
        for v in names:
            results.append(run(v, xs[v], programs, sass[v]))
            print(describe(results[-1]), flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
