"""ACS variants on the card: kernel K14, the counterpart of
``scripts/acs_variants_bench.py``, which isolated the costs of the TPU's
ACS formulations.  Here it weighs K1's register exchange against decision
bits and a bit-granular traceback.

    python -m tpu_viterbi_torch.scripts.acs_variants_bench [variants]

Variants (JAX :3-11; some decode wrongly by design, they time arithmetic):
  full       both children from the same predecessor pair and bm, with
             the register exchange
  pp_noshuf  as full, pp shifted in place with no exchange
  eo         the true even/odd children, with the register exchange
  decbits    as eo, pp rows [dec_e; dec_o]: decision bits, no exchange
  bit_tb     the bit-granular traceback chase alone

Each runs N_TILES x 128 arrays over N_PACKS packs of 32 stages (2112
stages, K1's per-thread count at the headline): the median of REPS
CUDA-event launches after one untimed launch, printed as ns per stage per
128-array tile, beside the SASS instructions of its stage loop a stage, its
registers and stack frame (cuobjdump -res-usage).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import hardware
from .common import (LT, ProbeKernel, cubin_listings, pick,
                     stage_loop_instructions, timed)
from .layout_probe import _interleave

N_PACKS = 66
BPP = 32
N_TILES = 16
REPS = 5
VARIANTS = ("full", "pp_noshuf", "eo", "decbits", "bit_tb")
LOOP_STAGES = dict(full=2, pp_noshuf=2, eo=2, decbits=2, bit_tb=1)
# lane-operations an array-stage, for the bound: the forward variants' 2
# adds, max and select a state (chip_smoke.ACS_OPS); the chase's shift, and,
# two shift-ors and the sum's add
OPS = dict(full=256, pp_noshuf=256, eo=256, decbits=256, bit_tb=5)


def _check(variant: str, rs: torch.Tensor) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if rs.dim() != 4 or rs.shape[1:3] != (BPP, 2) or rs.shape[0] == 0 or \
            rs.shape[3] == 0 or rs.dtype != torch.int32:
        raise ValueError(f"K14 takes (n_packs, {BPP}, 2, width) int32, got "
                         f"{rs.dtype} {tuple(rs.shape)}")


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


class AcsVariantsKernel(ProbeKernel):
    """K14, bound to ``viterbi_k14_launch``."""

    def __init__(self):
        super().__init__("K14", "viterbi_k14_launch", "acs_variants.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int])

    def __call__(self, variant: str, rs: torch.Tensor) -> torch.Tensor:
        """(64, width) int32.  On a CUDA tensor one launch on the current
        stream, not synchronized; on a CPU tensor its plain version."""
        _check(variant, rs)
        if not rs.is_contiguous():
            raise ValueError("K14 takes a contiguous input")
        if not self.check_device(rs):
            return acs_variants_torch(variant, rs)
        out = torch.empty((64, rs.shape[3]), dtype=torch.int32,
                          device=rs.device)
        self.launch(rs.device, VARIANTS.index(variant), rs.data_ptr(),
                    out.data_ptr(), rs.shape[0], rs.shape[3])
        return out


K14 = AcsVariantsKernel()


def probe_input(n_packs: int, width: int, device,
                seed: int = 0) -> torch.Tensor:
    """(n_packs, 32, 2, width) int32 values -100..100 from numpy's generator
    (the JAX probe's randint range, :154-155)."""
    x = np.random.default_rng(seed).integers(-100, 101,
                                             (n_packs, BPP, 2, width))
    return torch.from_numpy(x.astype(np.int32)).to(device)


def sass_counts() -> dict:
    """{variant: (SASS instructions of its stage loop, {REG, STACK, ...})}
    read from the built library."""
    sass, res = cubin_listings("viterbi_acs_variants")
    loops = stage_loop_instructions(sass)
    return {v: (pick(loops, "acs_kernel", f"ILi{i}E"),
                pick(res, "acs_kernel", f"ILi{i}E"))
            for i, v in enumerate(VARIANTS)}


def run(variant: str, rs: torch.Tensor, sass: tuple) -> dict:
    """Time one variant on rs."""
    ms, all_ms, _ = timed(lambda: K14(variant, rs), REPS)
    loop, res = sass
    tiles = rs.shape[3] / LT
    return dict(variant=variant, ms=ms, all_ms=all_ms,
                ns_per_stage_tile=ms * 1e6 / (rs.shape[0] * BPP * tiles),
                sass_loop=loop, sass_per_stage=loop / LOOP_STAGES[variant],
                regs=res.get("REG"), stack=res.get("STACK"),
                local=res.get("LOCAL"))


def describe(r: dict) -> str:
    return (f"{r['variant']:9s}: median {r['ms']:.4f} ms of "
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
    rs = probe_input(N_PACKS, N_TILES * LT, dev)
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {N_TILES * LT} arrays x "
          f"{N_PACKS * BPP} stages, CUDA blocks of 64 threads")
    results = []
    for v in names:
        results.append(run(v, rs, sass[v]))
        print(describe(results[-1]), flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
