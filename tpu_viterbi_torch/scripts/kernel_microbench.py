"""ACS construct microbenchmark on the card: kernel K16, the counterpart of
``scripts/kernel_microbench.py``, which changed one construct of the TPU's
ACS stage at a time to find the slow one.  Here it weighs the same
constructs, 64 metrics and survivors in registers, each array on one thread
(K1's shape) or split over ``lanes`` lanes of a warp (``common.LANES``,
``common.lanes_for`` picking the count from the arrays), each variant
keeping its construct: all 64 states' update a stage.

    python -m tpu_viterbi_torch.scripts.kernel_microbench [variants]

Variants (JAX :39-80; each stage's bm = r0 + r1 is the same for all 64
states):
  no_acs        pm += bm, pp += 1: the loop, the loads and the adds alone
  concat        the ACS with predecessor rows [x; x] (row i reads i mod 32)
  no_pp         the ACS of bcast without the survivor select: pp += 1
  bcast         the ACS with predecessor rows 2i, 2i+1 = x[i]
  pltpu_repeat  as concat: pltpu.repeat(x, 2, 0) is [x; x]
On the TPU the three relayouts (concat, bcast, pltpu_repeat) cost
different sublane shuffles; here they are register renaming: the three
differ only in which registers a child reads, and pltpu_repeat compiles
to concat's very code.  What they cost here is what ptxas can prove: the
64 states stay equal in every variant, ptxas proves it for bcast and
no_pp at one lane and computes one state, and computes concat's 32
distinct children.  Split, no_acs, concat and pltpu_repeat keep each pair
of rows q, q + 32 in one lane (concat's children never read another lane:
no shuffle); bcast and no_pp run the trellis' wiring in place
(csrc/lanes.cuh), exchanging across lanes.

Each runs N_PACKS packs of 32 stages at two array counts, the JAX probe's
N_TILES programs of 128 arrays (2048) and HEADLINE_TILES (15,872, K1's
occupancy at the headline), at every lane count in turn with one lane
(``common.TURNS``).  A time is the median of REPS CUDA-event launches after
one untimed launch, printed as ns per stage per 128-array tile beside the
SASS instructions of the variant's stage loop a stage (its SHFL count the
lanes' exchanges), its registers and stack frame (cuobjdump -res-usage).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from .. import hardware
from .common import (BPP, LANES, LT, TURNS, LaneKernel, check_lanes,
                     check_names, check_stage_pairs, describe_stages,
                     lanes_for, loop_stages, pick, sass_digests,
                     sass_table, shfl_count,
                     stage_pairs_input as probe_input, time_stages)

N_PACKS = 66
N_TILES = 16
HEADLINE_TILES = 124
REPS = 5
VARIANTS = ("no_acs", "concat", "no_pp", "bcast", "pltpu_repeat")
# lane-operations an array-stage, for the bound: the work the function
# needs.  All 64 states start at zero and see the stage's one bm, so they
# stay equal (common.stage_pairs_input) and a stage needs one state's:
# bm's add, then no_acs' 2 adds; the ACS' 2 adds, max and survivor select
# (K14's count a state); no_pp's 2 adds, max and pp's add.  ptxas proves
# the equality for bcast and no_pp only.
OPS = dict(no_acs=3, concat=5, no_pp=5, bcast=5, pltpu_repeat=5)
# lane-operations an array-stage of each variant's own construct, its 64
# states' update as the variant defines it (hardware.ACS_OPS' count: a
# state's 2 candidate adds, its max with the decision, its survivor
# update; no_pp's survivor an add, no_acs' 2 adds a state), for the
# construct's issue bound beside the function's: what the variant would
# take if nothing were folded.  No bound where ptxas folds the equal
# metrics (bcast and no_pp at one lane, no_pp split): it issues less than
# this counts, and a share over 100 % there says folded, not miscounted.
CONSTRUCT_OPS = dict(no_acs=128, concat=256, no_pp=256, bcast=256,
                     pltpu_repeat=256)


def _check(variant: str, rs: torch.Tensor) -> None:
    check_names((variant,), VARIANTS)
    check_stage_pairs("K16", rs)


def _rep(variant: str, x: torch.Tensor) -> torch.Tensor:
    """(32, w) -> (64, w): [x; x] for concat and pltpu_repeat, rows 2i and
    2i + 1 = x[i] for bcast and no_pp (JAX :26-36)."""
    if variant in ("concat", "pltpu_repeat"):
        return torch.cat([x, x])
    return x.repeat_interleave(2, 0)


def microbench_torch(variant: str, rs: torch.Tensor) -> torch.Tensor:
    """Plain version of one variant: rs (n_packs, 32, 2, width) int32 ->
    (64, width) int32, pm + pp after n_packs x 32 stages from zero, int32
    wrapping (JAX :39-80)."""
    _check(variant, rs)
    pm = torch.zeros((64, rs.shape[3]), dtype=torch.int32, device=rs.device)
    pp = torch.zeros_like(pm)
    for p in range(rs.shape[0]):
        for s in range(BPP):
            bm = rs[p, s, 0] + rs[p, s, 1]
            if variant == "no_acs":
                pm, pp = pm + bm, pp + 1
                continue
            c0 = _rep(variant, pm[:32]) + bm
            c1 = _rep(variant, pm[32:]) - bm
            dec = c1 > c0
            pm = torch.where(dec, c1, c0)
            if variant == "no_pp":
                pp = pp + 1
            else:
                sel = torch.where(dec, _rep(variant, pp[32:]),
                                  _rep(variant, pp[:32]))
                pp = (sel + sel) | dec.to(torch.int32)
    return pm + pp


class MicrobenchKernel(LaneKernel):
    """K16, bound to ``viterbi_k16_launch``."""

    def __init__(self):
        super().__init__("K16", "viterbi_k16_launch", "kernel_microbench.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int])

    def __call__(self, variant: str, rs: torch.Tensor,
                 lanes: int = None) -> torch.Tensor:
        """(64, width) int32.  On a CUDA tensor one launch on the current
        stream, not synchronized, each array over ``lanes`` lanes
        (``lanes_for`` the arrays when None); on a CPU tensor its plain
        version."""
        _check(variant, rs)
        lanes = self.pick_lanes(rs.shape[3], lanes)
        if not rs.is_contiguous():
            raise ValueError("K16 takes a contiguous input")
        if not self.check_device(rs):
            return microbench_torch(variant, rs)
        out = torch.empty((64, rs.shape[3]), dtype=torch.int32,
                          device=rs.device)
        self.launch_lanes(rs.device, lanes, VARIANTS.index(variant),
                          rs.data_ptr(), out.data_ptr(), rs.shape[0],
                          rs.shape[3], lanes)
        return out


K16 = MicrobenchKernel()


def _kernel(i: int, lanes: int) -> tuple:
    """The parts of variant i's kernel name at ``lanes``."""
    return (("microbench_kernel", f"ILi{i}E") if lanes == 1 else
            ("microbench_lanes_kernel", f"ILi{i}ELi{lanes}E"))


def sass_counts() -> dict:
    """{(variant, lanes): (SASS instructions of its stage loop, {REG,
    STACK, ...}, the loop's opcode mix)} read from the built library (a
    kernel each)."""
    return sass_table("viterbi_microbench",
                      {(v, n): _kernel(i, n) for i, v in enumerate(VARIANTS)
                       for n in LANES})


def one_lane_digests() -> dict:
    """{variant: (SASS instructions, digest, registers, stack)} of the
    one-lane kernels in the built library (``common.sass_digests``)."""
    d = sass_digests("viterbi_microbench")
    return {v: pick(d, *_kernel(i, 1)) for i, v in enumerate(VARIANTS)}


def run(variant: str, lanes: int, rs: torch.Tensor, sass: dict) -> dict:
    """Time one variant at one lane count on rs."""
    mix = sass[variant, lanes][2]
    return time_stages(lambda: K16(variant, rs, lanes), REPS,
                       rs.shape[0] * BPP, rs.shape[3], sass[variant, lanes],
                       loop_stages(lanes), variant=variant, lanes=lanes,
                       picked=lanes == lanes_for(rs.shape[3]),
                       shfl_per_stage=shfl_count(mix) / loop_stages(lanes))


def describe(r: dict) -> str:
    return (describe_stages(r, f"{r['variant']:12s} {r['arrays']:6d} arrays "
                               f"{r['lanes']:2d} lanes")
            + f"; SHFL a stage {r['shfl_per_stage']:g}")


def probe(names=VARIANTS, lanes=TURNS) -> list:
    """Time each named variant at each lane count of ``lanes`` in turn on
    the current CUDA device at N_TILES and HEADLINE_TILES tiles and print
    one line each; returns their ``run`` results."""
    check_names(names, VARIANTS)
    for n in lanes:
        check_lanes(n, "K16")
    dev = hardware.resolve_device("cuda")
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {N_PACKS * BPP} stages, CUDA "
          f"blocks of 64 threads, lanes {list(lanes)} an array in turn; "
          f"concat, bcast and pltpu_repeat differ only in the registers a "
          f"child reads")
    results = []
    for tiles in (N_TILES, HEADLINE_TILES):
        rs = probe_input(N_PACKS, tiles * LT, dev)
        for v in names:
            for n in lanes:
                results.append(run(v, n, rs, sass))
                print(describe(results[-1]), flush=True)
        del rs
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
