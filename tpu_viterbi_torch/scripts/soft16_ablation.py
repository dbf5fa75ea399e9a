"""SOFT16's input traffic apart from its unpack on the card: kernel K25, the
counterpart of ``scripts/soft16_ablation.py``, which decomposed SOFT16's
time a stage over SOFT8's on K13's harness on the TPU.

    python -m tpu_viterbi_torch.scripts.soft16_ablation [variants]

Variants (the JAX script's, :9-17), on K13's harness (``csrc/acs.cuh``'s
stage, one thread an array, a pack loop of 32 stages):
  s8/noup     (16, 128) word blocks a pack, u and d rows 0 and 1, raw, for
              every stage: SOFT8's input traffic, no unpack
  s16/noup    (32, 128) blocks: SOFT16's 2x traffic, no unpack
  s8/unpack   SOFT8's unpack (K13's +unpack)
  s16/unpack  SOFT16's unpack ("pack": a0 = w >> 16, a1 = (w << 16) >> 16)
noup reads every word of its block (the ones it does not use with
``ld.volatile``), as the TPU's block DMA did.

Each variant runs N_PACKS packs (8192 stages) at two array counts: the JAX
script's GRID programs of 128 arrays (2048) and HEADLINE_TILES (15,872, K1's
occupancy at the headline, as K12 and K18 run).  A time is the median of
REPS CUDA-event launches after one untimed launch, printed as ns per stage
per 128-array tile beside the SASS of the stage loop (its LDG count shows
the loads); then the JAX script's decomposition line at each count.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from .. import hardware
from .common import (LT, ProbeKernel, check_names, describe_stages,
                     sass_table, time_stages)
from .kernel_ablation import natural_stage, stage_signs

N_PACKS = 256           # 8192 stages a program
GRID = 16
HEADLINE_TILES = 124
REPS = 5
VARIANTS = ("s8/noup", "s16/noup", "s8/unpack", "s16/unpack")
WPP = {"s8/noup": 16, "s16/noup": 32, "s8/unpack": 16, "s16/unpack": 32}
LOOP_STAGES = 2         # stages of one pass of the stage loop
# lane-operations an array-stage, for the bound: the ACS (chip_smoke.ACS_OPS)
# and, with the unpack, its two field extracts, an add and a subtract
OPS = {"s8/noup": 256, "s16/noup": 256, "s8/unpack": 260, "s16/unpack": 260}


def _check(variant: str, words: torch.Tensor, programs: int) -> int:
    """The packs of a program; raises on what the kernel refuses."""
    check_names([variant], VARIANTS)
    wpp = WPP[variant]
    if words.dim() != 3 or words.shape[1:] != (wpp, LT) or \
            words.dtype != torch.int32:
        raise ValueError(f"K25 {variant} takes (programs x n_packs, {wpp}, "
                         f"{LT}) int32 words, got {words.dtype} "
                         f"{tuple(words.shape)}")
    rows = words.shape[0]
    if programs <= 0 or rows == 0 or rows % programs:
        raise ValueError(f"{rows} packs do not make {programs} programs")
    return rows // programs


def _stage_fields(variant: str, wv: torch.Tensor):
    """[(u, d)] of the 32 stages of one pack's (wpp, arrays) words."""
    if variant.endswith("noup"):
        return [(wv[0], wv[1])] * 32
    if variant == "s16/unpack":
        a0, a1 = wv >> 16, (wv << 16) >> 16
        return [(a0[s] + a1[s], a0[s] - a1[s]) for s in range(32)]
    f = [((wv >> sh) & 255 ^ 128) - 128 for sh in (24, 16, 8, 0)]
    u_js, d_js = (f[0] + f[1], f[2] + f[3]), (f[0] - f[1], f[2] - f[3])
    return [(u_js[s % 2][s // 2], d_js[s % 2][s // 2]) for s in range(32)]


def soft16_ablation_torch(variant: str, words: torch.Tensor,
                          programs: int) -> torch.Tensor:
    """Plain version of one variant: words (programs x n_packs, wpp, 128)
    int32 -> (programs, 1, 128) int32, each program's (pm + pp)[0] after
    n_packs x 32 stages of the natural-order ACS from zero, wrapping (JAX
    :61-82)."""
    n_packs = _check(variant, words, programs)
    wpp = WPP[variant]
    w = words.reshape(programs, n_packs, wpp, LT).permute(1, 2, 0, 3) \
        .reshape(n_packs, wpp, programs * LT)            # [pack][row][array]
    signs = stage_signs(words.device)
    pm = torch.zeros((64, programs * LT), dtype=torch.int32,
                     device=words.device)
    pp = torch.zeros_like(pm)
    for p in range(n_packs):
        for u, d in _stage_fields(variant, w[p]):
            pm, pp = natural_stage(pm, pp, u, d, signs)
    return (pm[0] + pp[0]).reshape(programs, 1, LT)


class Soft16AblationKernel(ProbeKernel):
    """K25, bound to ``viterbi_k25_launch``."""

    def __init__(self):
        super().__init__("K25", "viterbi_k25_launch", "soft16_ablation.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int])

    def __call__(self, variant: str, words: torch.Tensor,
                 programs: int) -> torch.Tensor:
        """(programs, 1, 128) int32.  On a CUDA tensor one launch on the
        current stream, not synchronized; on a CPU tensor its plain
        version."""
        n_packs = _check(variant, words, programs)
        if not words.is_contiguous():
            raise ValueError("K25 takes contiguous words")
        if not self.check_device(words):
            return soft16_ablation_torch(variant, words, programs)
        out = torch.empty((programs, 1, LT), dtype=torch.int32,
                          device=words.device)
        self.launch(words.device, VARIANTS.index(variant), words.data_ptr(),
                    out.data_ptr(), programs, n_packs)
        return out


K25 = Soft16AblationKernel()


def probe_input(programs: int, n_packs: int, wpp: int, device,
                seed: int = 0) -> torch.Tensor:
    """(programs x n_packs, wpp, 128) full-range int32 words (the JAX
    script's randint range, :100-103) from a torch.Generator on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (programs * n_packs, wpp, LT),
                         generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def sass_counts() -> dict:
    """{variant: (SASS instructions of its stage loop, {REG, STACK, ...},
    the loop's opcode mix)} read from the built library."""
    return sass_table("viterbi_soft16_ablation",
                      {v: ("soft16_ablation_kernel", f"ILi{i}E")
                       for i, v in enumerate(VARIANTS)})


def decomposition(by: dict) -> str:
    """The JAX script's line (:131-133) from {variant: ns/stage/tile}."""
    a, b, c, d = (by[v] for v in VARIANTS)
    return (f"DMA cost of 2x words: {b - a:+.4f} ns/stage | s8 unpack "
            f"{c - a:+.4f} | s16 unpack {d - b:+.4f} | format gap (unpacked) "
            f"{d - c:+.4f}")


def describe(r: dict) -> str:
    return (describe_stages(r, f"{r['variant']:10s} {r['arrays']:6d} arrays")
            + f"; LDG in the stage loop {r['ldg']}")


def probe(names=VARIANTS) -> list:
    """Time each named variant on the current CUDA device at GRID and
    HEADLINE_TILES programs and print one line each, and the decomposition
    line where all four ran; returns the ``time_stages`` results."""
    check_names(names, VARIANTS)
    dev = hardware.resolve_device("cuda")
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {N_PACKS} packs of 32 stages, "
          f"CUDA blocks of 64 threads")
    results = []
    for programs in (GRID, HEADLINE_TILES):
        by = {}
        for wpp in sorted({WPP[v] for v in names}):
            words = probe_input(programs, N_PACKS, wpp, dev)
            for v in (v for v in names if WPP[v] == wpp):
                r = time_stages(lambda: K25(v, words, programs), REPS,
                                N_PACKS * 32, programs * LT, sass[v],
                                LOOP_STAGES, variant=v, programs=programs,
                                ldg=sum(n for op, n in sass[v][2].items()
                                        if op.startswith("LDG")))
                results.append(r)
                by[v] = r["ns_per_stage_tile"]
                print(describe(r), flush=True)
            del words
        if len(by) == len(VARIANTS):
            print(f"{programs * LT} arrays: {decomposition(by)}", flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
