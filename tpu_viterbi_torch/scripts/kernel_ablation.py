"""Ablation probe on the card: kernel K13, the counterpart of
``scripts/kernel_ablation.py``, which built K1's time a stage up piece by
piece on the TPU.  Here it says where K1's instructions a stage go.

    python -m tpu_viterbi_torch.scripts.kernel_ablation [variants]

Variants, each adding one piece (JAX :9-19):
  body        the stage body, u and d read raw from rows of packs 0-3
  +unpack     SOFT8 word mode: each pack's 16 words unpacked, MSB first
  +dump       the survivor store: every pack's pp into device memory
  +traceback  the chase from state 0 down the store
  +tb(bisect) the same chase, each pack picked from its 64 loaded words by
              a select tree on the state's bits (JAX :102-108): its loads
              do not wait for the state, +traceback's one load does; the
              output is +traceback's

Each array runs split over ``lanes`` lanes of a warp (``common.LANES``; 1
is one thread an array, K1's layout); ``common.lanes_for`` picks the count
from the arrays, as K25's and K19's wrappers do.  Each variant runs N_PACKS
packs of 32 stages at two array counts, the JAX script's GRID programs of
128 arrays (2048) and HEADLINE_TILES (15,872, K1's occupancy at the
headline), at every lane count in turn with one lane (``common.TURNS``: one
lane first and last): the median of REPS CUDA-event launches after one
untimed launch, printed as ns per stage per 128-array tile, beside the SASS
instructions of its stage loop a stage (its SHFL count the lanes'
exchanges), its registers and stack frame (cuobjdump -res-usage); then the
decomposition line at each count at one lane and at the picked lanes.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import hardware
from .common import (LANES, LT, TURNS, LaneKernel, branch_signs,
                     check_lanes, check_names, describe_stages, lanes_for,
                     loop_stages, sass_table, shfl_count, time_stages)
from .layout_probe import _interleave

N_PACKS = 256
WPP = 16                # SOFT8 words of a 32-stage pack
GRID = 16
HEADLINE_TILES = 124    # K25's: 15,872 arrays
REPS = 5
VARIANTS = ("body", "+unpack", "+dump", "+traceback", "+tb(bisect)")
TRACEBACKS = ("+traceback", "+tb(bisect)")
# lane-operations an array-stage, for the bound: the ACS (hardware.ACS_OPS)
# and, with the unpack, its two field extracts, an add and a subtract
OPS = {"body": 256, "+unpack": 260, "+dump": 260, "+traceback": 260,
       "+tb(bisect)": 260}


def _check(variant: str, words: torch.Tensor) -> int:
    """The number of packs in words; raises on what the kernel refuses."""
    check_names([variant], VARIANTS)
    if words.dim() != 3 or words.shape[1:] != (WPP, LT) or \
            words.dtype != torch.int32:
        raise ValueError(f"K13 takes (programs x n_packs, {WPP}, {LT}) int32 "
                         f"words, got {words.dtype} {tuple(words.shape)}")
    return words.shape[0]


def lane_block(lanes: int) -> int:
    """CUDA threads a block of the kernel at ``lanes`` lanes an array
    (kernel_ablation.cu's: K1's 64 at one lane; else 128, and at least 8
    arrays, so that the dump's rows cover whole 32-byte sectors)."""
    return 64 if lanes == 1 else max(128, 8 * lanes)


def n_emit(variant: str, n_packs: int) -> int:
    """Output rows a program: the traceback's n_packs - 1, else one."""
    return n_packs - 1 if variant in TRACEBACKS else 1


def stage_signs(device):
    """(same, neg): (32, 1) bool masks of the even children 2q whose two
    branch signs agree and whose first is negative."""
    s0, s1 = branch_signs()
    return (torch.from_numpy(s0 == s1).to(device)[:, None],
            torch.from_numpy(s0 < 0).to(device)[:, None])


def natural_stage(pm: torch.Tensor, pp: torch.Tensor, u: torch.Tensor,
                  d: torch.Tensor, signs) -> tuple:
    """One stage of the JAX probes' natural-order ACS (``_one_real_stage``
    in natural order) on (64, arrays) int32 pm and pp, the stage's (arrays,)
    u and d and ``stage_signs``: bm = (same sign ? u : d) * s0, a strict
    '>' (the j=0 branch wins ties), int32 wrapping."""
    same, neg = signs
    bm = torch.where(same, u, d)
    bm = torch.where(neg, -bm, bm)
    lo, hi = pm[:32], pm[32:]
    c0e, c1e = lo + bm, hi - bm
    c0o, c1o = lo - bm, hi + bm
    de, do = c1e > c0e, c1o > c0o
    from_lo, from_hi = pp[:32] + pp[:32], pp[32:] + pp[32:] + 1
    return (_interleave(torch.where(de, c1e, c0e), torch.where(do, c1o, c0o),
                        0),
            _interleave(torch.where(de, from_hi, from_lo),
                        torch.where(do, from_hi, from_lo), 0))


def ablation_torch(variant: str, words: torch.Tensor, programs: int):
    """Plain version of one variant: words (programs x n_packs, 16, 128)
    int32 -> (out (programs, n_emit, 128) int32, the survivor store
    (n_packs, 64, programs x 128) int32 or None without the dump).  pm and
    pp start at zero; the ACS is the natural-order one of the JAX probe's
    rotating layout (back in natural order after every pack), wrapping."""
    rows = _check(variant, words)
    if programs <= 0 or rows % programs or rows // programs < 4:
        raise ValueError(f"{rows} packs do not make {programs} programs of "
                         f"at least 4")
    n_packs = rows // programs
    arrays = programs * LT
    w = words.reshape(programs, n_packs, WPP, LT).permute(1, 2, 0, 3) \
        .reshape(n_packs, WPP, arrays)                   # [pack][row][array]
    dev = words.device
    signs = stage_signs(dev)
    pm = torch.zeros((64, arrays), dtype=torch.int32, device=dev)
    pp = torch.zeros_like(pm)
    dump = variant in ("+dump",) + TRACEBACKS
    store = torch.empty((n_packs, 64, arrays), dtype=torch.int32,
                        device=dev) if dump else None
    if variant == "body":
        u_all = torch.cat([w[0], w[1]])
        d_all = torch.cat([w[2], w[3]])
    for p in range(n_packs):
        if variant != "body":
            fields = [((w[p] >> sh) & 255 ^ 128) - 128
                      for sh in (24, 16, 8, 0)]      # MSB first, sign-extended
            u_js = (fields[0] + fields[1], fields[2] + fields[3])
            d_js = (fields[0] - fields[1], fields[2] - fields[3])
        for s in range(32):
            if variant == "body":
                u, d = u_all[s], d_all[s]
            else:
                u, d = u_js[s % 2][s // 2], d_js[s % 2][s // 2]
            pm, pp = natural_stage(pm, pp, u, d, signs)
        if dump:
            store[p] = pp
    if variant not in TRACEBACKS:
        return (pm[0] + pp[0]).reshape(programs, 1, LT), store
    out = torch.zeros((n_packs - 1, arrays), dtype=torch.int32, device=dev)
    state = torch.zeros((1, arrays), dtype=torch.int64, device=dev)
    for k in range(n_packs - 1):
        kp = n_packs - 1 - k
        if variant == "+traceback":
            pack = store[kp].gather(0, state)
        else:                               # halve the 64 rows 6 times
            pack = store[kp]
            for b in (5, 4, 3, 2, 1, 0):
                h = 1 << b
                pack = torch.where((state >> b) & 1 == 1, pack[h:2 * h],
                                   pack[:h])
        if k >= 1:
            out[kp - 1] = pack[0]
        state = ((pack >> 26) & 63).to(torch.int64)
    return out.reshape(n_packs - 1, programs, LT).permute(1, 0, 2) \
        .contiguous(), store


class AblationKernel(LaneKernel):
    """K13, bound to ``viterbi_k13_launch``."""

    def __init__(self):
        super().__init__("K13", "viterbi_k13_launch", "kernel_ablation.cu",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int])

    def __call__(self, variant: str, words: torch.Tensor, programs: int,
                 lanes: int = None):
        """(out (programs, n_emit, 128) int32, the survivor store
        (n_packs, 64, programs x 128) int32, or None without the dump).  On
        a CUDA tensor one launch on the current stream, not synchronized,
        each array over ``lanes`` lanes (``lanes_for`` the arrays when
        None); on a CPU tensor its plain version."""
        rows = _check(variant, words)
        if programs <= 0 or rows % programs or rows // programs < 4 \
                or not words.is_contiguous():
            raise ValueError(f"K13 takes contiguous words of at least 4 "
                             f"packs a program: {rows} packs, {programs} "
                             f"programs")
        lanes = self.pick_lanes(programs * LT, lanes)
        if not self.check_device(words):
            return ablation_torch(variant, words, programs)
        n_packs = rows // programs
        dev = words.device
        out = torch.empty((programs, n_emit(variant, n_packs), LT),
                          dtype=torch.int32, device=dev)
        store = torch.empty((n_packs, 64, programs * LT), dtype=torch.int32,
                            device=dev) \
            if variant in ("+dump",) + TRACEBACKS else None
        self.launch_lanes(dev, lanes, VARIANTS.index(variant), lanes,
                          words.data_ptr(),
                          None if store is None else store.data_ptr(),
                          out.data_ptr(), programs, n_packs)
        return out, store


K13 = AblationKernel()


def probe_input(programs: int, n_packs: int, device,
                seed: int = 0) -> torch.Tensor:
    """(programs x n_packs, 16, 128) full-range int32 words from numpy's
    generator (the JAX probe's randint range, :176-178)."""
    x = np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31 - 1, (programs * n_packs, WPP, LT), dtype=np.int64)
    return torch.from_numpy(x.astype(np.int32)).to(device)


def sass_counts() -> dict:
    """{(variant, lanes): (SASS instructions of its stage loop, {REG,
    STACK, ...}, the loop's opcode mix)} read from the built library."""
    return sass_table("viterbi_ablation", {
        (v, n): ("ablation_kernel", f"ILi{i}E") if n == 1 else
        ("ablation_lanes_kernel", f"ILi{i}ELi{n}EE")
        for i, v in enumerate(VARIANTS) for n in LANES})


def run(variant: str, words: torch.Tensor, programs: int, lanes: int,
        sass: dict) -> dict:
    """Time one variant over ``programs`` programs of N_PACKS packs at
    ``lanes`` lanes an array."""
    mix = sass[variant, lanes][2]
    return time_stages(lambda: K13(variant, words, programs, lanes), REPS,
                       N_PACKS * 32, programs * LT, sass[variant, lanes],
                       loop_stages(lanes), variant=variant,
                       programs=programs, lanes=lanes,
                       picked=lanes == lanes_for(programs * LT),
                       shfl_per_stage=shfl_count(mix) / loop_stages(lanes))


def describe(r: dict) -> str:
    return (describe_stages(r, f"{r['variant']:11s} {r['arrays']:6d} arrays "
                               f"{r['lanes']:2d} lanes")
            + f"; SHFL a stage {r['shfl_per_stage']:g}")


def decomposition(results: list) -> str:
    """Each piece against the variant it adds to, in ns/stage/tile; the
    bisect, like the JAX line's, against +dump."""
    by = {r["variant"]: r["ns_per_stage_tile"] for r in results}
    base = dict(zip(VARIANTS[1:], VARIANTS), **{"+tb(bisect)": "+dump"})
    return " | ".join(f"{v} {by[v] - by[base[v]]:+.4f}" for v in by
                      if base.get(v) in by)


def probe(names=VARIANTS, lanes=TURNS) -> list:
    """Time each named variant on the current CUDA device at GRID and
    HEADLINE_TILES programs at each lane count of ``lanes`` in turn and
    print one line each, and at each count the decomposition at one lane
    (its first run) and at the lanes ``lanes_for`` picks; returns the
    ``run`` results."""
    check_names(names, VARIANTS)
    for n in lanes:
        check_lanes(n, "K13")
    dev = hardware.resolve_device("cuda")
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {N_PACKS} packs of 32 stages, "
          f"lanes {list(lanes)} an array in turn; CUDA blocks of " +
          ", ".join(f"{lane_block(n)}" for n in LANES) + " threads",
          flush=True)
    results = []
    for programs in (GRID, HEADLINE_TILES):
        words = probe_input(programs, N_PACKS, dev)
        mine = []
        for v in names:
            for n in lanes:
                mine.append(run(v, words, programs, n, sass))
                print(describe(mine[-1]), flush=True)
        del words
        results += mine
        picked = lanes_for(programs * LT)
        for n in dict.fromkeys((1, picked)):
            first = {}
            for r in mine:
                if r["lanes"] == n:
                    first.setdefault(r["variant"], r)
            print(f"{programs * LT} arrays, {n} lanes: decomposition: "
                  f"{decomposition(list(first.values()))}", flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
