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

Each array runs split over ``lanes`` lanes of a warp (``common.LANES``; 1
is one thread an array), ``common.lanes_for`` picking the count from the
arrays, as K13's, K19's and K25's wrappers do: predecessor pair or pm word
q in lane q mod L, slot q div L, its survivors and bm beside it, so the
baseline exchanges nothing and the swar variants only their repack (two
shuffles a word).  Each variant runs STAGES stages at every lane count in
turn with one lane (``common.TURNS``), at two array counts: the JAX
probe's GRID programs of 128 arrays (2048) and HEADLINE_TILES (15,872,
K1's occupancy at the headline).  A time is the median of REPS CUDA-event
launches after one untimed launch, printed as ns per stage per 128-array
tile beside the SASS instructions of the variant's stage loop a stage
(its SHFL count the repack's exchanges), its registers and stack frame
(cuobjdump -res-usage).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import hardware
from .common import (LANES, LT, TURNS, LaneKernel, check_lanes,
                     check_names, describe_stages, lanes_for, sass_table,
                     shfl_count, time_stages)

STAGES = 8192
GRID = 16
HEADLINE_TILES = 124
REPS = 5
VARIANTS = ("baseline", "swar/stage", "swar/4stages")
ROWS_IN = {"baseline": 160, "swar/stage": 128, "swar/4stages": 128}
REPACK = {"baseline": 1, "swar/stage": 1, "swar/4stages": 4}
SPLIT_LOOP_STAGES = 4               # the lane-split kernels' stage loop
# lane-operations an array-stage, for the bound, a predecessor pair q each,
# counted as hardware.ACS_OPS counts K1's stage (an add a candidate,
# one max that also gives its decision, a select a survivor): baseline 10
# on Hopper, 4 adds, 2 maxima with their decisions (__vibmax_s32 gives
# max(a, b) and a >= b in one instruction), 2 survivor selects, the low
# survivor's shift and the high one's shift-or.  The compiled one-lane
# stage issues a compare beside each max (387 SASS a stage), so it sits
# above this count.  swar in packed lane-operations, two 16-bit states
# each: 2 packed adds, one packed max that also gives both decisions
# (__vibmax_s16x2), and the survivors' 4 as baseline (7).  The JAX counts
# (13 a pair, :10-13; 28 for the swar stage, :15-25) count a register
# exchange the in-place stage does not need and the TPU's emulation of
# packed arithmetic that Hopper has, and would put the bound above the
# card's time; the half alignment and the repack are relayouts, not
# counted.  32 pairs an array, at any lanes.
OPS = {"baseline": 320, "swar/stage": 224, "swar/4stages": 224}
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


def stage_loop_stages(variant: str, lanes: int) -> int:
    """Stages of one pass of a variant's stage loop: REPACK's at one lane,
    SPLIT_LOOP_STAGES split."""
    return REPACK[variant] if lanes == 1 else SPLIT_LOOP_STAGES


class SwarKernel(LaneKernel):
    """K18, bound to ``viterbi_k18_launch``."""

    def __init__(self):
        super().__init__("K18", "viterbi_k18_launch", "swar_probe.cu",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int])

    def __call__(self, variant: str, x: torch.Tensor, stages: int,
                 lanes: int = None) -> torch.Tensor:
        """(programs, 64, 128) int32: every program's output after
        ``stages`` stages.  On a CUDA tensor one launch on the current
        stream, not synchronized, each array over ``lanes`` lanes
        (``lanes_for`` the arrays when None); on a CPU tensor its plain
        version."""
        programs = _check(variant, x, stages)
        lanes = self.pick_lanes(programs * LT, lanes)
        if not x.is_contiguous():
            raise ValueError("K18 takes a contiguous block")
        if not self.check_device(x):
            return swar_torch(variant, x, stages)
        out = torch.empty((programs, 64, LT), dtype=torch.int32,
                          device=x.device)
        self.launch_lanes(x.device, lanes, VARIANTS.index(variant), lanes,
                          x.data_ptr(), out.data_ptr(), int(stages), programs)
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
    """{(variant, lanes): (SASS instructions of its stage loop, {REG, STACK,
    ...}, the loop's opcode mix)} read from the built library."""
    return sass_table("viterbi_swar", {
        (v, n): ("swar_kernel", f"ILi{i}E") if n == 1 else
        ("swar_lanes_kernel", f"ILi{i}ELi{n}EE")
        for i, v in enumerate(VARIANTS) for n in LANES})


def run(variant: str, lanes: int, x: torch.Tensor, programs: int,
        sass: dict) -> dict:
    """Time one variant at one lane count at STAGES stages over the first
    ``programs`` programs of x."""
    xv = x[:programs * ROWS_IN[variant]]
    mix = sass[variant, lanes][2]
    return time_stages(lambda: K18(variant, xv, STAGES, lanes), REPS, STAGES,
                       programs * LT, sass[variant, lanes],
                       stage_loop_stages(variant, lanes), variant=variant,
                       programs=programs, lanes=lanes,
                       picked=lanes == lanes_for(programs * LT),
                       shfl_per_stage=shfl_count(mix) /
                       stage_loop_stages(variant, lanes))


def describe(r: dict) -> str:
    return (describe_stages(r, f"{r['variant']:12s} {r['arrays']:6d} arrays "
                               f"{r['lanes']:2d} lanes")
            + f"; SHFL a stage {r['shfl_per_stage']:g}")


def probe(names=VARIANTS, lanes=TURNS) -> list:
    """Time each named variant at each lane count of ``lanes`` in turn on
    the current CUDA device at GRID and HEADLINE_TILES programs and print
    one line each; returns their ``run`` results."""
    check_names(names, VARIANTS)
    for n in lanes:
        check_lanes(n, "K18")
    dev = hardware.resolve_device("cuda")
    xs = {v: probe_input(v, HEADLINE_TILES, dev) for v in names}
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {STAGES} stages, lanes "
          f"{list(lanes)} an array in turn; CUDA blocks of 64 threads at "
          f"one lane, 128 split")
    results = []
    for programs in (GRID, HEADLINE_TILES):
        for v in names:
            for n in lanes:
                results.append(run(v, n, xs[v], programs, sass))
                print(describe(results[-1]), flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
