"""Layout probe on the card: kernel K12, the counterpart of
``scripts/layout_probe.py``, which timed three layouts of the 64-state ACS
on the TPU.  Here they answer K1's layout question: thread-per-array
against the reference's warp-per-array.

    python -m tpu_viterbi_torch.scripts.layout_probe [variants]

Variants (the JAX probe's, on the same tile of rows pm | pp | u | d):
  real   A: K1's layout and stage body, one thread per array
  dual   B: two arrays a thread, interleaved stage by stage, half the grid
  lanes  C: one warp per array, two states a lane, __shfl_xor_sync
            butterflies (the JAX kernel's states on lanes)

A and B run each array split over ``lanes`` lanes of a warp
(``common.LANES``; 1 is one thread an array, K1's layout) in the layout of
``csrc/lanes.cuh``, ``common.lanes_for`` picking the count from the
threads a variant runs at one lane (arrays for A, array pairs for B), as
K13's, K19's and K25's wrappers do; C is one warp an array, 32 lanes,
whatever the count.  Each variant runs STAGES stages, A and B at every
lane count in turn with one lane (``common.TURNS``), at two array counts:
the JAX probe's GRID programs of 128 arrays (2048, the canary's shape) and
HEADLINE_TILES (15,872 arrays: the headline's 15,625 time-blocks rounded
up to an even number of 128-array tiles, so that B's programs of two tiles
divide it).  All three read one input: B reads tiles 2g and 2g+1 as its
program g.  A time is the median of REPS CUDA-event launches after one
untimed launch (one launch is one sample, as in utils.timing); printed as
ns per stage per 128-array tile (the JAX probe's unit and canary_ns'),
beside the SASS instructions of the variant's stage loop per stage (its
SHFL count the lanes' exchanges) and per array-stage, its registers and
stack frame (cuobjdump -res-usage).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import hardware
from .common import (LANES, LT, TURNS, LaneKernel, branch_signs,
                     check_lanes, describe_mix, loop_stages, sass_table,
                     shfl_count, timed)

STAGES = 8192
GRID = 16
HEADLINE_TILES = 124
REPS = 5
ROWS = 192                          # a tile's program: pm, pp, u, d
VARIANTS = ("real", "dual", "lanes")
TILES_A_PROGRAM = dict(real=1, dual=2, lanes=1)
ARRAYS_A_THREAD = dict(real=1, dual=2, lanes=1)
SPLIT = ("real", "dual")            # the variants split over LANES
C_LANES = 32                        # C: one warp an array
# lane-operations an array-stage, for the bound: the ACS' 2 adds, max and
# select a state (hardware.ACS_OPS); C adds the exchange of pm and pp a
# state (a shuffle each, or a register swap)
OPS = dict(real=256, dual=256, lanes=384)
KERNEL = dict(real="layout_real_kernel", dual="layout_dual_kernel",
              lanes="layout_lanes_kernel")


def _check(variant: str, x: torch.Tensor, stages: int) -> int:
    """The number of programs of x; raises on what the kernel refuses."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    rows = ROWS * TILES_A_PROGRAM[variant]
    if x.dim() != 2 or x.shape[1] != LT or x.shape[0] % rows or \
            x.shape[0] == 0 or x.dtype != torch.int32:
        raise ValueError(f"{variant} takes a (programs x {rows}, {LT}) int32 "
                         f"tile, got {x.dtype} {tuple(x.shape)}")
    if stages < 0 or stages % 32:
        raise ValueError(f"stages must be a multiple of 32 and >= 0, got "
                         f"{stages}")
    return x.shape[0] // rows


def _interleave(e: torch.Tensor, o: torch.Tensor, dim: int) -> torch.Tensor:
    """Rows e[q] at 2q and o[q] at 2q + 1 along ``dim``."""
    shape = list(e.shape)
    shape[dim] *= 2
    return torch.stack([e, o], dim=dim + 1).reshape(shape)


def _natural(x: torch.Tensor, stages: int) -> torch.Tensor:
    """A on (G, 192, 128): the natural-order ACS of every column, bm =
    (same sign ? u : d) * s0, strict '>' (the j=0 branch wins ties), int32
    wrapping -> (G, 64, 128) pm + pp."""
    s0, s1 = branch_signs()
    dev = x.device
    same = torch.from_numpy(s0 == s1).to(dev)[None, :, None]
    neg = torch.from_numpy(s0 < 0).to(dev)[None, :, None]
    pm, pp = x[:, 0:64], x[:, 64:128]
    u_all, d_all = x[:, 128:160], x[:, 160:192]
    for t in range(stages):
        u, d = u_all[:, t % 32, None], d_all[:, t % 32, None]
        bm = torch.where(same, u, d)
        bm = torch.where(neg, -bm, bm)
        lo, hi = pm[:, :32], pm[:, 32:]
        c0e, c1e = lo + bm, hi - bm
        c0o, c1o = lo - bm, hi + bm
        de, do = c1e > c0e, c1o > c0o
        from_lo, from_hi = pp[:, :32] + pp[:, :32], pp[:, 32:] + pp[:, 32:] + 1
        pm = _interleave(torch.where(de, c1e, c0e), torch.where(do, c1o, c0o),
                         1)
        pp = _interleave(torch.where(de, from_hi, from_lo),
                         torch.where(do, from_hi, from_lo), 1)
    return pm + pp


def _lanes(x: torch.Tensor, stages: int) -> torch.Tensor:
    """C on (G, 192, 128): each row's two 64-lane halves are arrays of
    states j = lane & 63; in phase k = 1 << ((t % 32) % 6) state j meets
    j ^ k (JAX :147-211) -> (G, 64, 128) pm + pp."""
    s0, s1 = branch_signs()
    j = np.arange(64)
    dev = x.device
    same = torch.from_numpy(s0[j % 32] == s1[j % 32]).to(dev)
    neg = torch.from_numpy(s0[j % 32] < 0).to(dev)
    h = torch.from_numpy((j >> 5) & 1).to(dev, torch.int32)
    g = x.shape[0]
    pm = x[:, 0:64].reshape(g, 64, 2, 64)
    pp = x[:, 64:128].reshape(g, 64, 2, 64)
    u_all = x[:, 128:160].reshape(g, 32, 1, 2, 64)
    d_all = x[:, 160:192].reshape(g, 32, 1, 2, 64)
    for t in range(stages):
        k = 1 << ((t % 32) % 6)
        partner = torch.from_numpy(j ^ k).to(dev)
        bm = torch.where(same, u_all[:, t % 32], d_all[:, t % 32])
        bm = torch.where(neg, -bm, bm)
        qm, qp = pm[..., partner], pp[..., partner]
        c_self, c_part = pm + bm, qm - bm
        dec = c_part > c_self
        pm = torch.where(dec, c_part, c_self)
        pp = torch.where(dec, qp + qp + h, pp + pp + (1 - h))
    return (pm + pp).reshape(g, 64, LT)


def layout_torch(variant: str, x: torch.Tensor, stages: int) -> torch.Tensor:
    """Plain version of one variant: x (programs x rows, 128) int32 ->
    (programs, 64, 128) int32, each program's pm + pp after ``stages``
    stages (JAX :109-211; the JAX kernel writes every program's result to
    one block, so its output is the last program's)."""
    programs = _check(variant, x, stages)
    tiles = x.reshape(-1, ROWS, LT)
    if variant == "lanes":
        return _lanes(tiles, stages)
    out = _natural(tiles, stages)
    if variant == "dual":
        out = out.reshape(programs, 2, 64, LT)
        out = out[:, 0] + out[:, 1]
    return out


def variant_lanes(variant: str) -> tuple:
    """The lane counts a variant is built for: LANES for A and B, C's 32."""
    return LANES if variant in SPLIT else (C_LANES,)


def stage_loop_stages(variant: str, lanes: int) -> int:
    """Stages of one pass of a variant's stage loop: C's 32, else two at
    one lane and a six-stage pass split (common.loop_stages)."""
    return 32 if variant == "lanes" else loop_stages(lanes)


class LayoutKernel(LaneKernel):
    """K12, bound to ``viterbi_k12_launch``."""

    def __init__(self):
        super().__init__("K12", "viterbi_k12_launch", "layout_probe.cu",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int])

    def lanes_of(self, variant: str, programs: int, lanes) -> int:
        """A's and B's ``pick_lanes`` of the threads they run at one lane
        (programs x 128: arrays for A, array pairs for B); C's 32, which it
        also takes as ``lanes``.  Raises on a count the variant is not
        built for."""
        if variant in SPLIT:
            return self.pick_lanes(programs * LT, lanes)
        if lanes is not None:
            check_lanes(lanes, self.name)
            if lanes != C_LANES:
                raise ValueError(f"K12 lanes is one warp an array: it takes "
                                 f"lanes None or {C_LANES}, got {lanes}")
        return C_LANES

    def __call__(self, variant: str, x: torch.Tensor, stages: int,
                 lanes: int = None) -> torch.Tensor:
        """(programs, 64, 128) int32: every program's pm + pp after
        ``stages`` stages.  On a CUDA tensor one launch on the current
        stream, not synchronized, each array over ``lanes`` lanes
        (``lanes_of``); on a CPU tensor its plain version."""
        programs = _check(variant, x, stages)
        lanes = self.lanes_of(variant, programs, lanes)
        if not x.is_contiguous():
            raise ValueError("K12 takes a contiguous tile")
        if not self.check_device(x):
            return layout_torch(variant, x, stages)
        out = torch.empty((programs, 64, LT), dtype=torch.int32,
                          device=x.device)
        self.launch_lanes(x.device, lanes, VARIANTS.index(variant), lanes,
                          x.data_ptr(), out.data_ptr(), int(stages), programs)
        return out


K12 = LayoutKernel()


def probe_input(tiles: int, device, seed: int = 0) -> torch.Tensor:
    """(tiles x 192, 128) int32 values 0..7999 from numpy's generator (the
    JAX probe's jax.random.randint range, :229-230)."""
    x = np.random.default_rng(seed).integers(0, 8000, (tiles * ROWS, LT))
    return torch.from_numpy(x.astype(np.int32)).to(device)


def sass_counts() -> dict:
    """{(variant, lanes): (SASS instructions of its stage loop, {REG, STACK,
    ...}, the loop's opcode mix)} read from the built library."""
    return sass_table("viterbi_layout", {
        (v, n): (KERNEL[v],) if n == 1 or v == "lanes" else
        ("layout_split_kernel", f"ILi{SPLIT.index(v)}ELi{n}EE")
        for v in VARIANTS for n in variant_lanes(v)})


def run(variant: str, lanes: int, x: torch.Tensor, tiles: int,
        sass: dict) -> dict:
    """Time one variant at one lane count at STAGES stages over ``tiles``
    tiles of x."""
    programs = tiles // TILES_A_PROGRAM[variant]
    xv = x[:programs * ROWS * TILES_A_PROGRAM[variant]]
    ms, all_ms, _ = timed(lambda: K12(variant, xv, STAGES, lanes), REPS)
    loop, res, mix = sass[variant, lanes]
    per_stage = loop / stage_loop_stages(variant, lanes)
    lane_instr = per_stage * lanes / ARRAYS_A_THREAD[variant]
    arrays = tiles * LT
    return dict(variant=variant, lanes=lanes, tiles=tiles, arrays=arrays,
                picked=lanes == K12.lanes_of(variant, programs, None),
                ms=ms, all_ms=all_ms,
                ns_per_stage_tile=ms * 1e6 / (STAGES * tiles),
                sass_loop=loop, sass_per_stage=per_stage, mix=mix,
                shfl_per_stage=shfl_count(mix) / stage_loop_stages(variant,
                                                                   lanes),
                lane_instr_per_array_stage=lane_instr,
                lane_instr_per_ns=arrays * STAGES * lane_instr / (ms * 1e6),
                regs=res.get("REG"), stack=res.get("STACK"),
                local=res.get("LOCAL"))


def describe(r: dict) -> str:
    return (f"{r['variant']:5s} {r['arrays']:6d} arrays {r['lanes']:2d} "
            f"lanes: median {r['ms']:.4f} ms of "
            f"{[round(t, 4) for t in r['all_ms']]} = "
            f"{r['ns_per_stage_tile']:.4f} ns/stage/tile; SASS "
            f"{r['sass_per_stage']:g} a stage a thread ({r['sass_loop']} in "
            f"the stage loop: {describe_mix(r['mix'])}), SHFL "
            f"{r['shfl_per_stage']:g} a stage, "
            f"{r['lane_instr_per_array_stage']:g} lane-instructions an "
            f"array-stage = {r['lane_instr_per_ns']:.1f} a ns; registers "
            f"{r['regs']}, stack {r['stack']} B, local {r['local']} B")


def probe(names=VARIANTS, lanes=TURNS) -> list:
    """Time each named variant on the current CUDA device at GRID and
    HEADLINE_TILES tiles, A and B at each lane count of ``lanes`` in turn
    (C at its 32), and print one line each; returns their ``run``
    results."""
    for v in names:
        if v not in VARIANTS:
            raise ValueError(f"unknown variant {v!r}; one of {VARIANTS}")
    for n in lanes:
        check_lanes(n, "K12")
    dev = hardware.resolve_device("cuda")
    x = probe_input(HEADLINE_TILES, dev)
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {STAGES} stages; A and B "
          f"over lanes {list(lanes)} an array in turn, in CUDA blocks of 64 "
          f"threads at one lane and 128 split; C one warp an array, in "
          f"blocks of 4 warps")
    results = []
    for tiles in (GRID, HEADLINE_TILES):
        for v in names:
            for n in (lanes if v in SPLIT else (C_LANES,)):
                results.append(run(v, n, x, tiles, sass))
                print(describe(results[-1]), flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
