"""ACS variants on the card: kernel K14, the counterpart of
``scripts/acs_variants_bench.py``, which isolated the costs of the TPU's
ACS formulations.  Here it weighs K1's register exchange against decision
bits and a bit-granular traceback, each array on one thread (K1's shape)
or split over ``lanes`` lanes of a warp (``common.LANES``,
``common.lanes_for`` picking the count from the arrays), each variant
keeping its construct.

    python -m tpu_viterbi_torch.scripts.acs_variants_bench [variants]

Variants (JAX :3-11; some decode wrongly by design, they time arithmetic):
  full       both children from the same predecessor pair and bm, with
             the register exchange
  pp_noshuf  as full, pp shifted in place with no exchange
  eo         the true even/odd children, with the register exchange
  decbits    as eo, pp rows [dec_e; dec_o]: decision bits, no exchange
  bit_tb     the bit-granular traceback chase alone

Split, the forward variants run all 64 states in place (csrc/lanes.cuh),
full and eo exchanging their survivors across lanes; pp_noshuf's and
decbits' survivors, keyed by fixed rows, shift in place and are put back
together from the positions that held each row once, at the end; bit_tb
splits the stage range over the lanes and joins their sums and states by
shuffles.

Each runs N_TILES x 128 arrays over N_PACKS packs of 32 stages (2112
stages, K1's per-thread count at the headline) at every lane count in turn
with one lane (``common.TURNS``): the median of REPS CUDA-event launches
after one untimed launch, printed as ns per stage per 128-array tile,
beside the SASS instructions of its stage loop a stage (its SHFL count the
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
from .layout_probe import _interleave

N_PACKS = 66
N_TILES = 16
REPS = 5
VARIANTS = ("full", "pp_noshuf", "eo", "decbits", "bit_tb")
# lane-operations an array-stage, for the bound: the work the function
# needs.  All 64 states start at zero and see the stage's one bm, so the
# path metrics stay equal (common.stage_pairs_input): bm's add, the 2
# candidates and the max (4) once a stage, and eo's and decbits' odd
# decision (1); then an update a distinct survivor row: full's select and
# pp_noshuf's shift keep one row, decbits' shift-or two ([dec_e; dec_o]),
# eo's select 64 (each holds the decisions along its own path; rows merge
# only where a recent bm is 0).  The chase: its shift, and, two shift-ors
# and the sum's add.
OPS = dict(full=5, pp_noshuf=5, eo=69, decbits=7, bit_tb=5)
# lane-operations an array-stage of each variant's own construct, its 64
# states' update as the TPU probe writes it (hardware.ACS_OPS' count: a
# state's 2 candidate adds, its max with the decision, its survivor
# update), for the construct's issue bound beside the function's: what the
# variant would take if nothing were folded.  The chase is OPS' own.  No
# bound where ptxas folds the equal metrics (full at one lane, pp_noshuf
# split): it issues less than this counts, and a share over 100 % there
# says folded, not miscounted.
CONSTRUCT_OPS = dict(full=256, pp_noshuf=256, eo=256, decbits=256, bit_tb=5)


def loop_stages_of(variant: str, lanes: int) -> int:
    """Stages of one pass of the variant's stage loop: the chase's loop
    takes one at every lane count, the forward variants'
    ``common.loop_stages``."""
    return 1 if variant == "bit_tb" else loop_stages(lanes)


def _check(variant: str, rs: torch.Tensor) -> None:
    check_names((variant,), VARIANTS)
    check_stage_pairs("K14", rs)


def acs_variants_torch(variant: str, rs: torch.Tensor) -> torch.Tensor:
    """Plain version of one variant: rs (n_packs, 32, 2, width) int32 ->
    (64, width) int32, pm + pp after n_packs x 32 stages from zero (the
    chase: every row acc + state), int32 wrapping (JAX :44-128)."""
    _check(variant, rs)
    n_packs, width = rs.shape[0], rs.shape[3]
    if variant == "bit_tb":
        state = torch.zeros(width, dtype=torch.int32, device=rs.device)
        acc = torch.zeros_like(state)
        for t in range(n_packs * BPP):
            pack = rs[t % n_packs, t % BPP, 0]
            d = (pack >> (31 - t % 32)) & 1
            state = (state >> 1) | (d << 5)
            acc = acc + pack
        return (acc + state).expand(64, width).contiguous()
    pm = torch.zeros((64, width), dtype=torch.int32, device=rs.device)
    pp = torch.zeros_like(pm)
    for p in range(n_packs):
        for s in range(BPP):
            bm = rs[p, s, 0] + rs[p, s, 1]
            lo, hi = pm[:32], pm[32:]
            if variant in ("full", "pp_noshuf"):
                c0, c1 = lo + bm, hi - bm
                dec = c1 > c0
                pm = torch.where(dec, c1, c0).repeat_interleave(2, 0)
                dec = dec.repeat_interleave(2, 0)
                if variant == "full":
                    sel = torch.where(dec, pp[32:].repeat_interleave(2, 0),
                                      pp[:32].repeat_interleave(2, 0))
                else:
                    sel = pp
                pp = (sel + sel) | dec.to(torch.int32)
                continue
            de, do = hi - bm > lo + bm, hi + bm > lo - bm
            pm = _interleave(torch.maximum(lo + bm, hi - bm),
                             torch.maximum(lo - bm, hi + bm), 0)
            if variant == "eo":
                pe = torch.where(de, pp[32:], pp[:32])
                po = torch.where(do, pp[32:], pp[:32])
                pp = _interleave((pe + pe) | de.to(torch.int32),
                                 (po + po) | do.to(torch.int32), 0)
            else:
                pp = (pp + pp) | torch.cat([de, do]).to(torch.int32)
    return pm + pp


class AcsVariantsKernel(LaneKernel):
    """K14, bound to ``viterbi_k14_launch``."""

    def __init__(self):
        super().__init__("K14", "viterbi_k14_launch", "acs_variants.cu",
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
            raise ValueError("K14 takes a contiguous input")
        if not self.check_device(rs):
            return acs_variants_torch(variant, rs)
        out = torch.empty((64, rs.shape[3]), dtype=torch.int32,
                          device=rs.device)
        self.launch_lanes(rs.device, lanes, VARIANTS.index(variant),
                          rs.data_ptr(), out.data_ptr(), rs.shape[0],
                          rs.shape[3], lanes)
        return out


K14 = AcsVariantsKernel()


def _kernel(i: int, lanes: int) -> tuple:
    """The parts of variant i's kernel name at ``lanes``."""
    return (("acs_kernel", f"ILi{i}E") if lanes == 1 else
            ("acs_lanes_kernel", f"ILi{i}ELi{lanes}E"))


def sass_counts() -> dict:
    """{(variant, lanes): (SASS instructions of its stage loop, {REG,
    STACK, ...}, the loop's opcode mix)} read from the built library (a
    kernel each)."""
    return sass_table("viterbi_acs_variants",
                      {(v, n): _kernel(i, n) for i, v in enumerate(VARIANTS)
                       for n in LANES})


def one_lane_digests() -> dict:
    """{variant: (SASS instructions, digest, registers, stack)} of the
    one-lane kernels in the built library (``common.sass_digests``)."""
    d = sass_digests("viterbi_acs_variants")
    return {v: pick(d, *_kernel(i, 1)) for i, v in enumerate(VARIANTS)}


def run(variant: str, lanes: int, rs: torch.Tensor, sass: dict) -> dict:
    """Time one variant at one lane count on rs."""
    mix = sass[variant, lanes][2]
    per = loop_stages_of(variant, lanes)
    return time_stages(lambda: K14(variant, rs, lanes), REPS,
                       rs.shape[0] * BPP, rs.shape[3], sass[variant, lanes],
                       per, variant=variant, lanes=lanes,
                       picked=lanes == lanes_for(rs.shape[3]),
                       shfl_per_stage=shfl_count(mix) / per)


def describe(r: dict) -> str:
    return (describe_stages(r, f"{r['variant']:9s} {r['arrays']:6d} arrays "
                               f"{r['lanes']:2d} lanes")
            + f"; SHFL a stage {r['shfl_per_stage']:g}")


def probe(names=VARIANTS, lanes=TURNS) -> list:
    """Time each named variant at each lane count of ``lanes`` in turn on
    the current CUDA device and print one line each; returns their ``run``
    results."""
    check_names(names, VARIANTS)
    for n in lanes:
        check_lanes(n, "K14")
    dev = hardware.resolve_device("cuda")
    rs = probe_input(N_PACKS, N_TILES * LT, dev)
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {N_TILES * LT} arrays x "
          f"{N_PACKS * BPP} stages, CUDA blocks of 64 threads, lanes "
          f"{list(lanes)} an array in turn")
    results = []
    for v in names:
        for n in lanes:
            results.append(run(v, n, rs, sass))
            print(describe(results[-1]), flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
