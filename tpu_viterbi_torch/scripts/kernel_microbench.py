"""ACS construct microbenchmark on the card: kernel K16, the counterpart of
``scripts/kernel_microbench.py``, which changed one construct of the TPU's
ACS stage at a time to find the slow one.  Here it weighs the same
constructs in K1's shape: one thread an array, 64 metrics and survivors in
registers.

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
no_pp and computes one state, and computes concat's 32 distinct children.

Each runs N_PACKS packs of 32 stages at two array counts: the JAX probe's
N_TILES programs of 128 arrays (2048) and HEADLINE_TILES (15,872, K1's
occupancy at the headline).  A time is the median of REPS CUDA-event
launches after one untimed launch, printed as ns per stage per 128-array
tile beside the SASS instructions of the variant's stage loop a stage, its
registers and stack frame (cuobjdump -res-usage).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from .. import hardware
from .common import (BPP, LT, ProbeKernel, check_names, check_stage_pairs,
                     describe_stages, sass_table,
                     stage_pairs_input as probe_input, time_stages)

N_PACKS = 66
N_TILES = 16
HEADLINE_TILES = 124
REPS = 5
VARIANTS = ("no_acs", "concat", "no_pp", "bcast", "pltpu_repeat")
LOOP_STAGES = 2                     # stages of one pass of the stage loop
# lane-operations an array-stage, for the bound: the work the function
# needs.  All 64 states start at zero and see the stage's one bm, so they
# stay equal (common.stage_pairs_input) and a stage needs one state's:
# bm's add, then no_acs' 2 adds; the ACS' 2 adds, max and survivor select
# (K14's count a state); no_pp's 2 adds, max and pp's add.  ptxas proves
# the equality for bcast and no_pp only.
OPS = dict(no_acs=3, concat=5, no_pp=5, bcast=5, pltpu_repeat=5)


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


class MicrobenchKernel(ProbeKernel):
    """K16, bound to ``viterbi_k16_launch``."""

    def __init__(self):
        super().__init__("K16", "viterbi_k16_launch", "kernel_microbench.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int])

    def __call__(self, variant: str, rs: torch.Tensor) -> torch.Tensor:
        """(64, width) int32.  On a CUDA tensor one launch on the current
        stream, not synchronized; on a CPU tensor its plain version."""
        _check(variant, rs)
        if not rs.is_contiguous():
            raise ValueError("K16 takes a contiguous input")
        if not self.check_device(rs):
            return microbench_torch(variant, rs)
        out = torch.empty((64, rs.shape[3]), dtype=torch.int32,
                          device=rs.device)
        self.launch(rs.device, VARIANTS.index(variant), rs.data_ptr(),
                    out.data_ptr(), rs.shape[0], rs.shape[3])
        return out


K16 = MicrobenchKernel()


def sass_counts() -> dict:
    """{variant: (SASS instructions of its stage loop, {REG, STACK, ...},
    the loop's opcode mix)} read from the built library."""
    return sass_table("viterbi_microbench",
                      {v: ("microbench_kernel", f"ILi{i}E")
                       for i, v in enumerate(VARIANTS)})


def run(variant: str, rs: torch.Tensor, sass: tuple) -> dict:
    """Time one variant on rs."""
    return time_stages(lambda: K16(variant, rs), REPS, rs.shape[0] * BPP,
                       rs.shape[3], sass, LOOP_STAGES, variant=variant)


def describe(r: dict) -> str:
    return describe_stages(r, f"{r['variant']:12s} {r['arrays']:6d} arrays")


def probe(names=VARIANTS) -> list:
    """Time each named variant on the current CUDA device at N_TILES and
    HEADLINE_TILES tiles and print one line each; returns their ``run``
    results."""
    check_names(names, VARIANTS)
    dev = hardware.resolve_device("cuda")
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {N_PACKS * BPP} stages, CUDA "
          f"blocks of 64 threads; concat, bcast and pltpu_repeat differ "
          f"only in the registers a child reads")
    results = []
    for tiles in (N_TILES, HEADLINE_TILES):
        rs = probe_input(N_PACKS, tiles * LT, dev)
        for v in names:
            results.append(run(v, rs, sass[v]))
            print(describe(results[-1]), flush=True)
        del rs
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
