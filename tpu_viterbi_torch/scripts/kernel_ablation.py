"""Ablation probe on the card: kernel K13, the counterpart of
``scripts/kernel_ablation.py``, which built K1's time a stage up piece by
piece on the TPU.  Here it says where K1's instructions a stage go.

    python -m tpu_viterbi_torch.scripts.kernel_ablation [variants]

Variants, each adding one piece (JAX :9-19):
  body        the stage body, u and d read raw from rows of packs 0-3
  +unpack     SOFT8 word mode: each pack's 16 words unpacked, MSB first
  +dump       the survivor store: every pack's pp into device memory
  +traceback  the chase from state 0 down the store

The JAX probe's +tb(bisect) variant reads the same store as +traceback
through a TPU relayout and gives the same output; on the card both reads
are one indexed load, so it is not a variant here.

Each variant runs GRID programs of 128 arrays over N_PACKS packs of 32
stages: the median of REPS CUDA-event launches after one untimed launch,
printed as ns per stage per 128-array tile, beside the SASS instructions
of its stage loop a stage, its registers and stack frame (cuobjdump
-res-usage).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import hardware
from .common import (LT, ProbeKernel, branch_signs, cubin_listings, pick,
                     stage_loop_instructions, timed)
from .layout_probe import _interleave

N_PACKS = 256
WPP = 16                # SOFT8 words of a 32-stage pack
GRID = 16
REPS = 5
VARIANTS = ("body", "+unpack", "+dump", "+traceback")
LOOP_STAGES = 2         # stages of one pass of the stage loop
# lane-operations an array-stage, for the bound: the ACS (chip_smoke.ACS_OPS)
# and, with the unpack, its two field extracts, an add and a subtract
OPS = {"body": 256, "+unpack": 260, "+dump": 260, "+traceback": 260}


def _check(variant: str, words: torch.Tensor) -> int:
    """The number of packs in words; raises on what the kernel refuses."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if words.dim() != 3 or words.shape[1:] != (WPP, LT) or \
            words.dtype != torch.int32:
        raise ValueError(f"K13 takes (programs x n_packs, {WPP}, {LT}) int32 "
                         f"words, got {words.dtype} {tuple(words.shape)}")
    return words.shape[0]


def n_emit(variant: str, n_packs: int) -> int:
    """Output rows a program: the traceback's n_packs - 1, else one."""
    return n_packs - 1 if variant == "+traceback" else 1


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
    s0, s1 = branch_signs()
    dev = words.device
    same = torch.from_numpy(s0 == s1).to(dev)[:, None]
    neg = torch.from_numpy(s0 < 0).to(dev)[:, None]
    pm = torch.zeros((64, arrays), dtype=torch.int32, device=dev)
    pp = torch.zeros_like(pm)
    dump = variant in ("+dump", "+traceback")
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
            bm = torch.where(same, u, d)
            bm = torch.where(neg, -bm, bm)
            lo, hi = pm[:32], pm[32:]
            c0e, c1e = lo + bm, hi - bm
            c0o, c1o = lo - bm, hi + bm
            de, do = c1e > c0e, c1o > c0o
            from_lo, from_hi = pp[:32] + pp[:32], pp[32:] + pp[32:] + 1
            pm = _interleave(torch.where(de, c1e, c0e),
                             torch.where(do, c1o, c0o), 0)
            pp = _interleave(torch.where(de, from_hi, from_lo),
                             torch.where(do, from_hi, from_lo), 0)
        if dump:
            store[p] = pp
    if variant != "+traceback":
        return (pm[0] + pp[0]).reshape(programs, 1, LT), store
    out = torch.zeros((n_packs - 1, arrays), dtype=torch.int32, device=dev)
    state = torch.zeros((1, arrays), dtype=torch.int64, device=dev)
    for k in range(n_packs - 1):
        kp = n_packs - 1 - k
        pack = store[kp].gather(0, state)
        if k >= 1:
            out[kp - 1] = pack[0]
        state = ((pack >> 26) & 63).to(torch.int64)
    return out.reshape(n_packs - 1, programs, LT).permute(1, 0, 2) \
        .contiguous(), store


class AblationKernel(ProbeKernel):
    """K13, bound to ``viterbi_k13_launch``."""

    def __init__(self):
        super().__init__("K13", "viterbi_k13_launch", "kernel_ablation.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int])

    def __call__(self, variant: str, words: torch.Tensor, programs: int):
        """(out (programs, n_emit, 128) int32, the survivor store
        (n_packs, 64, programs x 128) int32, or None without the dump).  On
        a CUDA tensor one launch on the current stream, not synchronized;
        on a CPU tensor its plain version."""
        rows = _check(variant, words)
        if programs <= 0 or rows % programs or rows // programs < 4 \
                or not words.is_contiguous():
            raise ValueError(f"K13 takes contiguous words of at least 4 "
                             f"packs a program: {rows} packs, {programs} "
                             f"programs")
        if not self.check_device(words):
            return ablation_torch(variant, words, programs)
        n_packs = rows // programs
        dev = words.device
        out = torch.empty((programs, n_emit(variant, n_packs), LT),
                          dtype=torch.int32, device=dev)
        store = torch.empty((n_packs, 64, programs * LT), dtype=torch.int32,
                            device=dev) \
            if variant in ("+dump", "+traceback") else None
        self.launch(dev, VARIANTS.index(variant), words.data_ptr(),
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
    """{variant: (SASS instructions of its stage loop, {REG, STACK, ...})}
    read from the built library."""
    sass, res = cubin_listings("viterbi_ablation")
    loops = stage_loop_instructions(sass)
    return {v: (pick(loops, "ablation_kernel", f"ILi{i}E"),
                pick(res, "ablation_kernel", f"ILi{i}E"))
            for i, v in enumerate(VARIANTS)}


def run(variant: str, words: torch.Tensor, sass: tuple) -> dict:
    """Time one variant over GRID programs of N_PACKS packs."""
    ms, all_ms, _ = timed(lambda: K13(variant, words, GRID), REPS)
    loop, res = sass
    return dict(variant=variant, ms=ms, all_ms=all_ms,
                ns_per_stage_tile=ms * 1e6 / (N_PACKS * 32 * GRID),
                sass_loop=loop, sass_per_stage=loop / LOOP_STAGES,
                regs=res.get("REG"), stack=res.get("STACK"),
                local=res.get("LOCAL"))


def describe(r: dict) -> str:
    return (f"{r['variant']:10s}: median {r['ms']:.4f} ms of "
            f"{[round(t, 4) for t in r['all_ms']]} = "
            f"{r['ns_per_stage_tile']:.4f} ns/stage/tile; SASS "
            f"{r['sass_per_stage']:g} a stage ({r['sass_loop']} in the stage "
            f"loop); registers {r['regs']}, stack {r['stack']} B, local "
            f"{r['local']} B")


def probe(names=VARIANTS) -> list:
    """Time each named variant on the current CUDA device and print one
    line each; returns their ``run`` results."""
    for v in names:
        if v not in VARIANTS:
            raise ValueError(f"unknown variant {v!r}; one of {VARIANTS}")
    dev = hardware.resolve_device("cuda")
    words = probe_input(GRID, N_PACKS, dev)
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {GRID * LT} arrays x "
          f"{N_PACKS} packs of 32 stages, CUDA blocks of 64 threads")
    results = []
    for v in names:
        results.append(run(v, words, sass[v]))
        print(describe(results[-1]), flush=True)
    if len(results) > 1:
        steps = [(b["variant"],
                  b["ns_per_stage_tile"] - a["ns_per_stage_tile"])
                 for a, b in zip(results, results[1:])]
        print("decomposition: " + " | ".join(f"{v} {d:+.4f}"
                                              for v, d in steps))
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
