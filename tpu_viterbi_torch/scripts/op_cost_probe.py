"""Per-construct ALU cost probe on the card: the op-cost part of kernel
K11, the counterpart of ``scripts/op_cost_probe.py``, whose TPU runs gave
the JAX hardware model its VPU rate.  This one gives
``hardware.alu_model`` its rate.

    python -m tpu_viterbi_torch.scripts.op_cost_probe [variants]

Methodology (the JAX probe's, :3-6): a variant runs STEPS_LO and STEPS_HI
steps of UNROLL constructs each, and the slope (t_hi - t_lo) / (STEPS_HI -
STEPS_LO) cancels the fixed cost of a launch.  Each time is the median of
REPS launches between CUDA events.  The grid fills every SM with 8 blocks
of 256 threads (the SM's 2048-thread maximum), a multiple of the SM count,
so the rate is the card's: lane-ops per ns, and per clock per SM at the
peak SM clock (128 is one instruction a clock on each of the SM's four
schedulers).  Beside each rate stands the count of SASS instructions in
the variant's step loop (cuobjdump), which shows what ptxas made of the
8 x N_OPS constructs, and the rate of those instructions: ptxas fuses
some constructs (two adds into one IADD3), so a semantic rate can pass
the issue limit where the instruction rate cannot.  ``hardware.alu_model``
takes add4's instruction rate.

Constructs of the ACS, each thread one element of the tile: add, add4,
mul, cmpsel, selconst, bcast, shiftor.  The JAX probe's relayouts of the
tile's rows (merge, halves, cat8/4/2/1, permgather, rollsub), which timed
TPU sublane relayouts, run a warp to a column, lane r holding row r: a row
permutation is one ``shfl.sync.idx`` a construct, so they time the card's
shuffle against its adds (halves moves no row: its add alone).  The
relayouts count the same ops as the JAX probe (N_OPS); their lines say
how many SASS instructions ptxas made of them.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict

import numpy as np
import torch

from .. import hardware
from ..utils.timing import cuda_ms
from .common import (ProbeKernel, cubin_listings, loop_instructions,
                     loop_opcodes)

ROWS, COLS = 32, 128
UNROLL = 8
STEPS_LO = 5000
STEPS_HI = 45000
REPS = 5
VARIANTS = ("add", "add4", "mul", "cmpsel", "selconst", "bcast", "shiftor",
            "merge", "halves", "cat8", "cat4", "cat2", "cat1", "permgather",
            "rollsub")
RELAYOUTS = VARIANTS[7:]      # a warp a column (csrc/op_cost.cu)
# (32, 128) ops per construct, for the per-op rate (JAX :109-111)
N_OPS = dict(add=1, add4=4, mul=1, cmpsel=3, selconst=3, bcast=1, shiftor=3,
             merge=3, halves=3, cat8=3, cat4=3, cat2=3, cat1=3, permgather=2,
             rollsub=2)
THREADS = 256                 # a CUDA block
BLOCKS_PER_SM = 8             # 8 x 256 = the SM's 2048 threads
TILE_BLOCKS = ROWS * COLS // THREADS


def _relayout(variant: str, a: torch.Tensor, c: torch.Tensor):
    """One relayout construct of the JAX probe (:64-84) on (32, 128)."""
    if variant == "permgather":             # jnp.take(a, [1..31, 0], axis=0)
        return torch.roll(a, -1, 0) + c
    if variant == "rollsub":                # pltpu.roll(a, 1, 0)
        return torch.roll(a, 1, 0) + c
    e, o = a[:16] + c[:16], a[16:] - c[16:]
    g = 1 if variant == "merge" else 16 if variant == "halves" \
        else int(variant[3:])
    return torch.stack([e.reshape(16 // g, g, COLS), o.reshape(16 // g, g,
                                                              COLS)],
                       dim=1).reshape(ROWS, COLS)


def op_cost_torch(variant: str, x: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of one variant on the (32, 128) int32 tile ``x``:
    the value after ``steps`` x UNROLL constructs, int32 arithmetic
    wrapping (JAX :45-105)."""
    if variant not in N_OPS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if x.shape != (ROWS, COLS) or x.dtype != torch.int32:
        raise ValueError(f"the probe's tile is (32, 128) int32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    c = x
    n = steps * UNROLL
    if variant == "add4":
        accs = [x + k for k in range(4)]
        for _ in range(n):
            accs = [a + c for a in accs]
        return accs[0] + accs[1] + accs[2] + accs[3]
    u = x[1:2, :]
    mask = (torch.arange(ROWS, device=x.device) % 3 == 0)[:, None]
    a = x
    if variant in RELAYOUTS:
        for _ in range(n):
            a = _relayout(variant, a, c)
        return a
    for _ in range(n):
        if variant == "add":
            a = a + c
        elif variant == "mul":
            a = a * c
        elif variant == "cmpsel":
            a = torch.where(a > c, c - a, a)
        elif variant == "selconst":
            a = torch.where(mask, a + c, a - c)
        elif variant == "bcast":
            a = a + u
        else:                                   # shiftor
            a = (a << 1) | (c & 1)
    return a


class OpCostKernel(ProbeKernel):
    """K11, bound to ``viterbi_k11_launch``."""

    def __init__(self):
        super().__init__("K11", "viterbi_k11_launch", "op_cost.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int])

    def __call__(self, variant: str, x: torch.Tensor, steps: int,
                 tiles: int) -> torch.Tensor:
        """(tiles, 32, 128) int32: ``tiles`` copies of the variant's value
        after ``steps`` steps on the tile ``x``.  On a CUDA tensor one
        launch of tiles x 16 blocks of 256 threads (a relayout: tiles x 128
        warps, one a column), on the current stream, not synchronized; on a
        CPU tensor its plain version."""
        if variant not in N_OPS:
            raise ValueError(f"unknown variant {variant!r}; one of "
                             f"{VARIANTS}")
        if steps < 0 or tiles <= 0:
            raise ValueError(f"steps must be >= 0 and tiles > 0, got "
                             f"{steps}, {tiles}")
        if x.shape != (ROWS, COLS) or x.dtype != torch.int32 \
                or not x.is_contiguous():
            raise ValueError(f"K11 takes a contiguous (32, 128) int32 tile, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if not self.check_device(x):
            return op_cost_torch(variant, x, steps).expand(tiles, ROWS,
                                                           COLS).clone()
        out = torch.empty((tiles, ROWS, COLS), dtype=torch.int32,
                          device=x.device)
        self.launch(x.device, VARIANTS.index(variant), x.data_ptr(),
                    out.data_ptr(), int(steps), int(tiles))
        return out


K11 = OpCostKernel()


def grid_tiles(device=None) -> int:
    """Tiles whose 16 blocks each put BLOCKS_PER_SM blocks on every SM
    (an odd SM count gets twice that): the block count is a multiple of
    the SM count."""
    dev = hardware.resolve_device("cuda" if device is None else device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    return blocks // TILE_BLOCKS if blocks % TILE_BLOCKS == 0 else sms


def probe_input(device) -> torch.Tensor:
    """The probe's tile: int32 values 0..6 from numpy's generator seeded 0
    (the JAX probe's first input, :126-127)."""
    x = np.random.default_rng(0).integers(0, 7, (ROWS, COLS))
    return torch.from_numpy(x.astype(np.int32)).to(device)


def sass_loop_counts() -> Dict[str, int]:
    """{variant: SASS instructions in its step loop}, read with cuobjdump
    from the built library's cubin that holds the op-cost kernels."""
    loops = loop_instructions(cubin_listings("op_cost_kernel")[0])
    counts = {}
    for i, v in enumerate(VARIANTS):
        hits = [n for name, n in loops.items()
                if "op_cost_kernel" in name and f"ILi{i}E" in name]
        if len(hits) != 1:
            raise RuntimeError(f"no single step loop for {v} in the SASS "
                               f"listing ({hits})")
        counts[v] = hits[0]
    return counts


def sass_loop_mixes() -> Dict[str, Dict[str, int]]:
    """{variant: the opcode mix of its step loop} (the loop that
    ``sass_loop_counts`` counts), read from the built library."""
    mixes = loop_opcodes(cubin_listings("op_cost_kernel")[0])
    out = {}
    for i, v in enumerate(VARIANTS):
        hits = [m for name, m in mixes.items()
                if "op_cost_kernel" in name and f"ILi{i}E" in name]
        if len(hits) != 1:
            raise RuntimeError(f"no single step loop for {v} in the SASS "
                               f"listing")
        out[v] = hits[0]
    return out


def run(variant: str, x: torch.Tensor, tiles: int, clock_hz: float,
        sass: int) -> dict:
    """Time one variant at STEPS_LO and STEPS_HI (REPS CUDA-event launches
    each, after one warm-up) -> its slope and rates."""
    ms = {}
    for steps in (STEPS_LO, STEPS_HI):
        K11(variant, x, steps, tiles)                      # warm-up
        ms[steps], _, _ = cuda_ms(lambda: K11(variant, x, steps, tiles),
                                  REPS)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lanes = tiles * ROWS * COLS
    dt_ns = (ms[STEPS_HI] - ms[STEPS_LO]) * 1e6
    loops = lanes * (STEPS_HI - STEPS_LO)
    rate = loops * UNROLL * N_OPS[variant] / dt_ns
    sass_rate = loops * sass / dt_ns
    per_sm_clock = sms * clock_hz * 1e-9
    return dict(variant=variant, ms_lo=ms[STEPS_LO], ms_hi=ms[STEPS_HI],
                ns_per_construct=dt_ns / ((STEPS_HI - STEPS_LO) * UNROLL),
                lane_ops_per_ns=rate,
                ops_per_clock_per_sm=rate / per_sm_clock, sass_loop=sass,
                sass_per_ns=sass_rate,
                sass_per_clock_per_sm=sass_rate / per_sm_clock)


def describe(r: dict) -> str:
    return (f"{r['variant']:9s}: lo={r['ms_lo']:8.4f} hi={r['ms_hi']:8.4f} "
            f"ms  {r['ns_per_construct'] * 1e3:8.4f} ps/construct over the "
            f"grid ({N_OPS[r['variant']]} ops) = "
            f"{r['lane_ops_per_ns']:9.1f} lane-ops/ns = "
            f"{r['ops_per_clock_per_sm']:6.2f} per clock per SM; SASS "
            f"{r['sass_loop']} instructions a step loop of {UNROLL} x "
            f"{N_OPS[r['variant']]} ops = {r['sass_per_ns']:9.1f} lane-"
            f"instructions/ns = {r['sass_per_clock_per_sm']:6.2f} per clock "
            f"per SM")


def probe(names=VARIANTS) -> list:
    """Time each named variant on the current CUDA device and print one
    line each; returns their ``run`` results."""
    for v in names:
        if v not in N_OPS:
            raise ValueError(f"unknown variant {v!r}; one of {VARIANTS}")
    dev = hardware.resolve_device("cuda")
    x = probe_input(dev)
    tiles = grid_tiles(dev)
    clock = hardware.sm_clock_hz(dev)
    sass = sass_loop_counts()
    print(f"{torch.cuda.get_device_name(dev)}: {tiles * TILE_BLOCKS} blocks "
          f"of {THREADS} threads, peak SM clock {clock / 1e9:.3f} GHz")
    results = []
    for v in names:
        results.append(run(v, x, tiles, clock, sass[v]))
        print(describe(results[-1]), flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
