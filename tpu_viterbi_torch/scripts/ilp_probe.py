"""ILP probe on the card: kernel K15, the counterpart of
``scripts/ilp_probe.py``, which asked whether the TPU's vector unit issues
faster with independent chains.  Here it asks what ILP buys at K1's one
warp a scheduler, and how fast the ACS' add/max mix issues.

    python -m tpu_viterbi_torch.scripts.ilp_probe [chains ...]

Each of 1, 2 and 4 independent chains a thread runs steps of UNROLL x
chains (a = a + c, a = max(a, c - a)) pairs at two occupancies:
  sched  one warp a scheduler on every SM, K1's at the headline: a block
         of 128 threads an SM
  full   the SM's 2048 threads, K11's grid (op_cost_probe.grid_tiles)
The time of a step is the slope between STEPS_LO and STEPS_HI steps (the
method of op_cost_probe.run, which cancels the launch), each the median of
REPS CUDA-event launches after one untimed launch; printed as ns a pair
and as lane-instructions a clock per SM, with the SASS instructions of the
step loop (cuobjdump) and the kernel's registers.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import hardware
from .common import (ProbeKernel, cubin_listings, pick,
                     stage_loop_instructions, timed)
from .op_cost_probe import grid_tiles, TILE_BLOCKS, THREADS as FULL_THREADS

ROWS, COLS = 32, 128
TILE = ROWS * COLS
UNROLL = 8
STEPS = 60000
STEPS_LO = 10000
STEPS_HI = STEPS
REPS = 5
CHAINS = (1, 2, 4)
OCCUPANCIES = ("sched", "full")
SCHED_THREADS = 128         # four warps an SM: one a scheduler
# lane-operations a pair, the JAX probe's count (its :64) and the bound's:
# the add and the max; c - (a + c) is -a, which ptxas folds into the max
OPS_A_PAIR = 2


def _check(chains: int, x: torch.Tensor, steps: int) -> None:
    if chains not in CHAINS:
        raise ValueError(f"unknown chain count {chains!r}; one of {CHAINS}")
    if x.shape != (ROWS, COLS) or x.dtype != torch.int32:
        raise ValueError(f"the probe's tile is (32, 128) int32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def ilp_torch(chains: int, x: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version: the (32, 128) sum of ``chains`` chains from x + k
    after ``steps`` x UNROLL (a = a + c, a = max(a, c - a)) with c = row 1
    of x, int32 wrapping (JAX :23-42)."""
    _check(chains, x, steps)
    c = x[1:2]
    accs = [x + k for k in range(chains)]
    for _ in range(steps * UNROLL):
        for k in range(chains):
            a = accs[k] + c
            accs[k] = torch.maximum(a, c - a)
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def grid(occupancy: str, device=None):
    """(blocks, threads a block) of an occupancy on the card."""
    if occupancy not in OCCUPANCIES:
        raise ValueError(f"unknown occupancy {occupancy!r}; one of "
                         f"{OCCUPANCIES}")
    dev = hardware.resolve_device("cuda" if device is None else device)
    if occupancy == "sched":
        return torch.cuda.get_device_properties(dev).multi_processor_count, \
            SCHED_THREADS
    return grid_tiles(dev) * TILE_BLOCKS, FULL_THREADS


class IlpKernel(ProbeKernel):
    """K15, bound to ``viterbi_k15_launch``."""

    def __init__(self):
        super().__init__("K15", "viterbi_k15_launch", "ilp_probe.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int])

    def __call__(self, chains: int, x: torch.Tensor, steps: int,
                 blocks: int, threads: int) -> torch.Tensor:
        """(blocks x threads,) int32: element i is the plain value at tile
        position i mod 4096.  On a CUDA tensor one launch on the current
        stream, not synchronized; on a CPU tensor its plain version."""
        _check(chains, x, steps)
        if blocks <= 0 or threads <= 0 or threads % 32 or threads > 256 \
                or not x.is_contiguous():
            raise ValueError(f"K15 takes a contiguous tile and blocks > 0 of "
                             f"a multiple of 32 threads up to 256, got "
                             f"{blocks} x {threads}")
        n = blocks * threads
        if not self.check_device(x):
            flat = ilp_torch(chains, x, steps).reshape(-1)
            return flat.repeat(-(-n // TILE))[:n]
        out = torch.empty(n, dtype=torch.int32, device=x.device)
        self.launch(x.device, chains, x.data_ptr(), out.data_ptr(),
                    int(steps), blocks, threads)
        return out


K15 = IlpKernel()


def probe_input(device) -> torch.Tensor:
    """The probe's tile: int32 values 0..6 from numpy's generator seeded 0
    (the JAX probe's first input, :46-47)."""
    x = np.random.default_rng(0).integers(0, 7, (ROWS, COLS))
    return torch.from_numpy(x.astype(np.int32)).to(device)


def sass_counts() -> dict:
    """{chains: (SASS instructions of the step loop, {REG, STACK, ...})}
    read from the built library."""
    sass, res = cubin_listings("viterbi_ilp")
    loops = stage_loop_instructions(sass)
    return {n: (pick(loops, "ilp_kernel", f"ILi{n}E"),
                pick(res, "ilp_kernel", f"ILi{n}E")) for n in CHAINS}


def run(chains: int, occupancy: str, x: torch.Tensor, clock_hz: float,
        sass: tuple) -> dict:
    """Time one chain count at one occupancy: the slope between STEPS_LO
    and STEPS_HI."""
    blocks, threads = grid(occupancy, x.device)
    ms = {}
    for steps in (STEPS_LO, STEPS_HI):
        ms[steps], _, _ = timed(
            lambda: K15(chains, x, steps, blocks, threads), REPS)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    dt_ns = (ms[STEPS_HI] - ms[STEPS_LO]) * 1e6
    lanes = blocks * threads
    pairs = (STEPS_HI - STEPS_LO) * UNROLL * chains
    loop, res = sass
    per_clock = lanes * (STEPS_HI - STEPS_LO) * loop / dt_ns / \
        (sms * clock_hz * 1e-9)
    return dict(chains=chains, occupancy=occupancy, blocks=blocks,
                threads=threads, ms_lo=ms[STEPS_LO], ms_hi=ms[STEPS_HI],
                ns_per_pair=dt_ns / pairs,
                pair_ops_per_ns=lanes * pairs * OPS_A_PAIR / dt_ns,
                sass_loop=loop, sass_per_clock_per_sm=per_clock,
                regs=res.get("REG"), stack=res.get("STACK"))


def describe(r: dict) -> str:
    return (f"chains={r['chains']} {r['occupancy']:5s} ({r['blocks']} x "
            f"{r['threads']}): lo={r['ms_lo']:.4f} hi={r['ms_hi']:.4f} ms, "
            f"{r['ns_per_pair']:.4f} ns a dependent pair a thread, "
            f"{r['pair_ops_per_ns']:.1f} lane-ops/ns ({OPS_A_PAIR} a pair); "
            f"SASS {r['sass_loop']} a step loop of {UNROLL} x {r['chains']} "
            f"pairs = {r['sass_per_clock_per_sm']:.2f} lane-instructions a "
            f"clock per SM; registers {r['regs']}, stack {r['stack']} B")


def probe(chains=CHAINS) -> list:
    """Time each chain count at both occupancies on the current CUDA device
    and print one line each; returns their ``run`` results."""
    chains = [int(n) for n in chains]
    for n in chains:
        if n not in CHAINS:
            raise ValueError(f"unknown chain count {n!r}; one of {CHAINS}")
    dev = hardware.resolve_device("cuda")
    x = probe_input(dev)
    clock = hardware.sm_clock_hz(dev)
    sass = sass_counts()
    print(f"{torch.cuda.get_device_name(dev)}: peak SM clock "
          f"{clock / 1e9:.3f} GHz; steps {STEPS_LO} and {STEPS_HI}")
    results = []
    for occupancy in OCCUPANCIES:
        for n in chains:
            results.append(run(n, occupancy, x, clock, sass[n]))
            print(describe(results[-1]), flush=True)
    return results


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or CHAINS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
