"""16-bit ACS variants on the card: kernel K19, the counterpart of
``scripts/opt_bench.py``, which timed the TPU's even/odd ACS with its path
metrics and survivors in int32 or int16.  Here it asks whether an ACS with
two states a 32-bit register issues fewer instructions a stage than the
int32 one.

    python -m tpu_viterbi_torch.scripts.opt_bench [variants]

Variants (JAX :30-69; the true even/odd butterfly, states in natural
order, bm = r0 + r1 the same for every state):
  i32_split  int32 path metrics and survivors
  i16        int16 path metrics and survivors
  i16_pm     int16 path metrics, int32 survivors
The int16 types wrap at every operation; the output (pm + pp) is taken in
the path metric's type and sign-extended.  The Hopper form of the int16
metrics: two neighbouring states a register (int16x2), __vadd2 and __vsub2
for the candidates, the DPX __vibmax_s16x2 for the maxima and decisions
(its a >= b predicate inverted to JAX's strict c1 > c0), and __byte_perm
for the even/odd interleave; i16's survivors are int16x2 too, selected by
halves.  i32_split is that butterfly in int32, one state a register.

The JAX probe's lane-tile width lt (128, 256, 512) only cuts the 4096
arrays into programs; outputs are equal at every lt (arrays are
independent).  Here lt is the number of threads a CUDA block, a kernel
each: at 512 a thread may hold 128 registers, where i32_split spills at
one lane an array.  Each array runs split over ``lanes`` lanes of a warp
(``common.LANES``; 1 is one thread an array), ``common.lanes_for`` picking
the count from the arrays, as K13's and K25's wrappers do; a block holds
lt / lanes arrays.  Each variant runs N_PACKS packs of 32 stages at each lt
at every lane count in turn with one lane (``common.TURNS``), at two array
counts: the JAX probe's LANES (4096) and HEADLINE_ARRAYS (15,872, K1's
occupancy at the headline); then i16 at lt 128 at every lane count at
CROSSOVER_ARRAYS, between the two.  A time is the median of REPS
CUDA-event launches after one untimed launch, printed as ns per stage per
128-array tile beside the SASS instructions of the variant's stage loop a
stage (its SHFL count the lanes' exchanges), its registers and stack frame
(cuobjdump -res-usage).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from .. import hardware
from .common import (BPP, TURNS, LaneKernel, check_lanes, check_names,
                     check_stage_pairs, describe_stages, lanes_for,
                     loop_stages, sass_table, shfl_count,
                     stage_pairs_input as probe_input, time_stages)
from .common import LANES as LANE_COUNTS
from .layout_probe import _interleave

N_PACKS = 66
LANES = 4096
HEADLINE_ARRAYS = 15872
CROSSOVER_ARRAYS = (6144, 8192, 10240, 12288)
LTS = (128, 256, 512)
REPS = 5
VARIANTS = ("i32_split", "i16", "i16_pm")
PM_DTYPE = dict(i32_split=torch.int32, i16=torch.int16, i16_pm=torch.int16)
PP_DTYPE = dict(i32_split=torch.int32, i16=torch.int16, i16_pm=torch.int32)
# lane-operations an array-stage, for the bound: the work the function
# needs.  All 64 states start at zero and see the stage's one bm, so the
# path metrics stay equal (common.stage_pairs_input): bm's add, the two
# distinct candidates, the max and the odd child's decision (5) once a
# stage.  The survivors differ (each holds the decisions along its own
# path; rows merge only where a recent bm is 0): a select a state (K14's
# count), two int16 states a packed select in i16.  At these counts the
# bound is the input's bytes.
OPS = dict(i32_split=69, i16=37, i16_pm=69)


def _check(variant: str, rs: torch.Tensor, lt: int) -> None:
    check_names((variant,), VARIANTS)
    if lt not in LTS:
        raise ValueError(f"unknown lane tile {lt!r}; one of {LTS}")
    check_stage_pairs("K19", rs)


def opt_bench_torch(variant: str, rs: torch.Tensor) -> torch.Tensor:
    """Plain version of one variant: rs (n_packs, 32, 2, width) int32 ->
    (64, width) int32, (pm + pp in pm's type) sign-extended after n_packs x
    32 stages from zero (JAX :30-69).  The same at every lt."""
    _check(variant, rs, LTS[0])
    pm_dt, pp_dt = PM_DTYPE[variant], PP_DTYPE[variant]
    width = rs.shape[3]
    lo = torch.zeros((32, width), dtype=pm_dt, device=rs.device)
    hi = torch.zeros_like(lo)
    pl = torch.zeros((32, width), dtype=pp_dt, device=rs.device)
    ph = torch.zeros_like(pl)
    for p in range(rs.shape[0]):
        for s in range(BPP):
            bm = (rs[p, s, 0] + rs[p, s, 1]).to(pm_dt)
            c0e, c1e, c0o, c1o = lo + bm, hi - bm, lo - bm, hi + bm
            de, do = c1e > c0e, c1o > c0o
            e, o = torch.where(de, c1e, c0e), torch.where(do, c1o, c0o)
            lo = _interleave(e[:16], o[:16], 0)
            hi = _interleave(e[16:], o[16:], 0)
            se, so = torch.where(de, ph, pl), torch.where(do, ph, pl)
            pe = (se + se) | de.to(pp_dt)
            po = (so + so) | do.to(pp_dt)
            pl = _interleave(pe[:16], po[:16], 0)
            ph = _interleave(pe[16:], po[16:], 0)
    return torch.cat([lo + pl.to(pm_dt), hi + ph.to(pm_dt)]).to(torch.int32)


class OptBenchKernel(LaneKernel):
    """K19, bound to ``viterbi_k19_launch``."""

    def __init__(self):
        super().__init__("K19", "viterbi_k19_launch", "opt_bench.cu",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int])

    def __call__(self, variant: str, rs: torch.Tensor, lt: int = LTS[0],
                 lanes: int = None) -> torch.Tensor:
        """(64, width) int32.  On a CUDA tensor one launch of blocks of
        ``lt`` threads on the current stream, not synchronized, each array
        over ``lanes`` lanes (``lanes_for`` the arrays when None); on a CPU
        tensor its plain version."""
        _check(variant, rs, lt)
        lanes = self.pick_lanes(rs.shape[3], lanes)
        if not rs.is_contiguous():
            raise ValueError("K19 takes a contiguous input")
        if not self.check_device(rs):
            return opt_bench_torch(variant, rs)
        out = torch.empty((64, rs.shape[3]), dtype=torch.int32,
                          device=rs.device)
        self.launch_lanes(rs.device, lanes, VARIANTS.index(variant), lanes,
                          rs.data_ptr(), out.data_ptr(), rs.shape[0],
                          rs.shape[3], lt)
        return out


K19 = OptBenchKernel()


def sass_counts() -> dict:
    """{(variant, lt, lanes): (SASS instructions of its stage loop, {REG,
    STACK, ...}, the loop's opcode mix)} read from the built library (a
    kernel each)."""
    return sass_table("viterbi_opt_bench", {
        (v, lt, n): ("opt_kernel", f"ILi{i}ELi{lt}E") if n == 1 else
        ("opt_lanes_kernel", f"ILi{i}ELi{n}ELi{lt}E")
        for i, v in enumerate(VARIANTS) for lt in LTS for n in LANE_COUNTS})


def run(variant: str, lt: int, lanes: int, rs: torch.Tensor,
        sass: dict) -> dict:
    """Time one variant at one lt and lane count on rs."""
    mix = sass[variant, lt, lanes][2]
    return time_stages(lambda: K19(variant, rs, lt, lanes), REPS,
                       rs.shape[0] * BPP, rs.shape[3], sass[variant, lt, lanes],
                       loop_stages(lanes), variant=variant, lt=lt,
                       lanes=lanes, picked=lanes == lanes_for(rs.shape[3]),
                       shfl_per_stage=shfl_count(mix) / loop_stages(lanes))


def describe(r: dict) -> str:
    return (describe_stages(r, f"{r['variant']:9s} lt={r['lt']:3d} "
                               f"{r['arrays']:6d} arrays {r['lanes']:2d} "
                               f"lanes")
            + f"; SHFL a stage {r['shfl_per_stage']:g}")


def probe(names=VARIANTS, lanes=TURNS) -> list:
    """Time each named variant at every lt and each lane count of ``lanes``
    in turn on the current CUDA device at LANES and HEADLINE_ARRAYS arrays
    and print one line each; then i16, if named, at lt 128 at every lane
    count at CROSSOVER_ARRAYS, with the fastest lane count at each.
    Returns the ``run`` results."""
    check_names(names, VARIANTS)
    for n in lanes:
        check_lanes(n, "K19")
    dev = hardware.resolve_device("cuda")
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {N_PACKS * BPP} stages; lt = "
          f"CUDA threads a block; lanes {list(lanes)} an array in turn")
    results = []
    for width in (LANES, HEADLINE_ARRAYS):
        rs = probe_input(N_PACKS, width, dev)
        for lt in LTS:
            for v in names:
                for n in lanes:
                    results.append(run(v, lt, n, rs, sass))
                    print(describe(results[-1]), flush=True)
        del rs
    if "i16" in names:
        for width in CROSSOVER_ARRAYS:
            rs = probe_input(N_PACKS, width, dev)
            mine = [run("i16", LTS[0], n, rs, sass)
                    for n in dict.fromkeys(lanes)]
            del rs
            for r in mine:
                print(describe(r), flush=True)
            results += mine
            best = min(mine, key=lambda r: r["ms"])["lanes"]
            print(f"{width} arrays: i16 lt {LTS[0]} fastest at {best} "
                  f"lanes, lanes_for picks {lanes_for(width)}", flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
