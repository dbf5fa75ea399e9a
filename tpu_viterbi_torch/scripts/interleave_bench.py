"""The ACS' perfect shuffle on the card: kernel K28, the counterpart of
``scripts/interleave_bench.py``, which checked and timed lowerings of the
sublane interleave I[2q] = E[q], I[2q+1] = O[q] of two (32, 128) arrays on
the TPU.

    python -m tpu_viterbi_torch.scripts.interleave_bench [variants]

Variants (``csrc/interleave.cu``), the GPU forms of the JAX ones:
  regs    (bcast) the shuffle register renaming (the rep loop unrolled by
          the shuffle's order, 6, each rep adding its own register so that
          ptxas cannot fold the reps)
  shfl    (new) a warp a column, lane q rows q and 32 + q, __shfl_sync
  smem    (scratch) stores to a shared column's even and odd rows, then a
          read, every rep
  concat  I = [E; O]: the wrong-result floor, regs' loop without the
          renaming
regs, smem and concat split each column's 64 rows over ``lanes`` threads
(``common.LANES``; one lane is a thread a column, the first design):
regs and concat rename in place across lanes (nothing moves; the
write-out maps each position to its row), smem's lanes share a warp and
swap through shared memory.  shfl is one warp a column, 32 lanes, its
only count.  ``common.lanes_for`` picks the count from the columns.
First the JAX script's check (:99-127): one bare merge of arange(64 x 128)
against numpy's, each variant (concat must fail it).  Then each variant
runs REPS reps (merge, then + 1) on (64, 8 x 128) int32 values -100..100:
the JAX shape, 1,024 columns, regs, smem and concat at every lane count in
turn with one lane (``common.TURNS``), shfl at its 32; and on a grid that
fills every SM a thread a column (16 CUDA blocks of 128 an SM), each
variant at its pick (one lane; shfl 32).  A time is the median of RUNS
CUDA-event launches after one untimed launch, printed as ns per interleave
per 128-column tile (the JAX unit) and values a ns (64 a column-rep),
beside the SASS and SHFL of the rep loop a rep (a thread's), its registers
and stack.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import hardware
from .common import (LANES, LT, TURNS, LaneKernel, check_lanes, check_names,
                     sass_table, shfl_count, timed)

ROWS = 64
REPS = 16384            # interleaves a column (JAX :21)
N_TILES = 8             # the JAX grid, 128 columns a tile (:22)
RUNS = 5
BLOCKS_PER_SM = 16      # 16 x 128 threads = the SM's 2048
VARIANTS = ("regs", "shfl", "smem", "concat")
SPLIT = ("regs", "smem", "concat")      # over 1-32 lanes a column
SHFL_LANES = 32                         # shfl: one warp a column
JAX_NAME = {"regs": "bcast", "shfl": None, "smem": "scratch",
            "concat": "concat"}
# lane-operations a column-rep, for the bound: 64 adds, 32 IADD3 each
# adding two; shfl 4 shuffles, 2 selects and 2 adds on each of 32 lanes;
# smem 64 stores, 64 loads and 64 adds
OPS = {"regs": 32, "shfl": 256, "smem": 192, "concat": 32}


def loop_reps(variant: str, lanes: int) -> int:
    """Reps of one pass of a variant's rep loop, for its SASS a rep: regs'
    and concat's 6 (the shuffle's order) at up to 4 lanes, split from 8
    lanes on lanes / 4 passes of 6 an iteration (interleave.cu's
    kPassesPerIter: 96 adds a thread or more); shfl's 1, smem's 1 at one
    lane and 2 split (its two scratch buffers)."""
    if variant in ("regs", "concat"):
        return 6 * (lanes // 4 if lanes >= 8 else 1)
    return 2 if variant == "smem" and lanes > 1 else 1


def variant_lanes(variant: str) -> tuple:
    """The lane counts a variant is built for: LANES, shfl's 32."""
    return LANES if variant in SPLIT else (SHFL_LANES,)


def _merge(e: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    return torch.stack([e, o], dim=1).reshape(2 * e.shape[0], *e.shape[1:])


def interleave_torch(variant: str, x: torch.Tensor, reps: int,
                     one: int = 1) -> torch.Tensor:
    """Plain version of one variant on (64, cols) int32: ``reps`` times E,
    O = I[:32] + one, I[32:] + one with I the merge of E = x[:32] and O =
    x[32:] (concat: I = x), int32 wrapping (JAX :51-72)."""
    _check(variant, x, reps)
    e, o = x[:32], x[32:]
    for _ in range(reps):
        m = torch.cat([e, o]) if variant == "concat" else _merge(e, o)
        e, o = m[:32] + one, m[32:] + one
    return torch.cat([e, o])


def _check(variant: str, x: torch.Tensor, reps: int) -> None:
    check_names([variant], VARIANTS)
    if x.dim() != 2 or x.shape[0] != ROWS or x.shape[1] == 0 or \
            x.dtype != torch.int32:
        raise ValueError(f"K28 takes (64, cols) int32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")


class InterleaveKernel(LaneKernel):
    """K28, bound to ``viterbi_k28_launch``."""

    def __init__(self):
        super().__init__("K28", "viterbi_k28_launch", "interleave.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int])

    def lanes_of(self, variant: str, cols: int, lanes) -> int:
        """regs', smem's and concat's ``pick_lanes`` of ``cols`` columns;
        shfl's 32, which it also takes as ``lanes``.  Raises on a count the
        variant is not built for."""
        if variant in SPLIT:
            return self.pick_lanes(cols, lanes)
        if lanes is not None:
            check_lanes(lanes, self.name)
            if lanes != SHFL_LANES:
                raise ValueError(f"K28 shfl is one warp a column: it takes "
                                 f"lanes None or {SHFL_LANES}, got {lanes}")
        return SHFL_LANES

    def __call__(self, variant: str, x: torch.Tensor, reps: int,
                 one: int = 1, lanes: int = None) -> torch.Tensor:
        """(64, cols) int32 after ``reps`` reps.  On a CUDA tensor one
        launch on the current stream, not synchronized, each column over
        ``lanes`` lanes (``lanes_of``); on a CPU tensor its plain
        version."""
        _check(variant, x, reps)
        if not x.is_contiguous():
            raise ValueError("K28 takes a contiguous array")
        lanes = self.lanes_of(variant, x.shape[1], lanes)
        if not self.check_device(x):
            return interleave_torch(variant, x, reps, one)
        out = torch.empty_like(x)
        self.launch_lanes(x.device, lanes, VARIANTS.index(variant),
                          x.data_ptr(), out.data_ptr(), x.shape[1],
                          int(reps), int(one), lanes)
        return out


K28 = InterleaveKernel()


def probe_input(tiles: int, device, seed: int = 0) -> torch.Tensor:
    """(64, tiles x 128) int32 values -100..100 (the JAX script's randint
    range, :131-132) from numpy's generator."""
    x = np.random.default_rng(seed).integers(-100, 101, (ROWS, tiles * LT))
    return torch.from_numpy(x.astype(np.int32)).to(device)


def check_input(device) -> torch.Tensor:
    """The check's arange(64 x 128) as (64, 128) (JAX :112)."""
    return torch.arange(ROWS * LT, dtype=torch.int32,
                        device=device).reshape(ROWS, LT)


def check_correct(variant: str, device) -> bool:
    """One bare merge (reps 1, one 0) of ``check_input`` against numpy's
    interleave (JAX :120-126): True for every variant but concat."""
    x = check_input(device)
    got = K28(variant, x, 1, 0).cpu().numpy()
    xn = x.cpu().numpy()
    want = np.empty_like(xn)
    want[0::2] = xn[:32]
    want[1::2] = xn[32:]
    return bool(np.array_equal(got, want))


def full_tiles(device) -> int:
    """Tiles of 128 columns whose thread-a-column CUDA blocks put
    BLOCKS_PER_SM blocks on every SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count \
        * BLOCKS_PER_SM


def sass_counts() -> dict:
    """{(variant, lanes): (SASS instructions of its rep loop, {REG, STACK,
    ...}, the loop's opcode mix)} read from the built library."""
    return sass_table("viterbi_interleave", {
        (v, n): ("interleave_kernel", f"ILi{i}E") if n == 1 or v == "shfl"
        else ("interleave_lanes_kernel", f"ILi{i}ELi{n}EE")
        for i, v in enumerate(VARIANTS) for n in variant_lanes(v)})


def run(variant: str, lanes: int, x: torch.Tensor, sass: dict) -> dict:
    """Time one variant at ``lanes`` lanes a column, REPS reps on x."""
    ms, all_ms, _ = timed(lambda: K28(variant, x, REPS, lanes=lanes), RUNS)
    tiles = x.shape[1] // LT
    loop, res, mix = sass[variant, lanes]
    per = loop_reps(variant, lanes)
    return dict(variant=variant, lanes=lanes, tiles=tiles,
                columns=x.shape[1], ms=ms, all_ms=all_ms,
                picked=lanes == K28.lanes_of(variant, x.shape[1], None),
                ns_per_interleave_tile=ms * 1e6 / (REPS * tiles),
                values_per_ns=ROWS * x.shape[1] * REPS / (ms * 1e6),
                sass_loop=loop, sass_per_rep=loop / per,
                shfl_per_rep=shfl_count(mix) / per, mix=mix,
                regs=res.get("REG"), stack=res.get("STACK"))


def describe(r: dict) -> str:
    name = JAX_NAME[r["variant"]]
    return (f"{r['variant']:6s} ({name or 'new'}) {r['columns']:6d} columns "
            f"{r['lanes']:2d} lanes: median {r['ms']:.4f} ms of "
            f"{[round(t, 4) for t in r['all_ms']]} ~"
            f"{r['ns_per_interleave_tile']:.4f} ns/interleave/tile = "
            f"{r['values_per_ns']:.1f} values moved and added a ns; SASS "
            f"{r['sass_per_rep']:g} and SHFL {r['shfl_per_rep']:g} a rep a "
            f"thread ({r['sass_loop']} in the loop: "
            f"{', '.join(f'{k} {n}' for k, n in list(r['mix'].items())[:5])});"
            f" registers {r['regs']}, stack {r['stack']} B")


def probe(names=VARIANTS) -> dict:
    """The check of every named variant, then each one's time at the JAX
    shape (regs, smem and concat at each lane count in turn with one lane,
    ``common.TURNS``, shfl at its 32) and at the full grid (each at its
    pick) on the current CUDA device, one line each; returns {"correct":
    {variant: bool}, "runs": [``run`` results]}."""
    check_names(names, VARIANTS)
    dev = hardware.resolve_device("cuda")
    correct = {}
    for v in names:
        correct[v] = check_correct(v, dev)
        print(f"{v:10s}: correct={correct[v]}", flush=True)
    sass = sass_counts()
    full = full_tiles(dev)
    print(f"{torch.cuda.get_device_name(dev)}: {REPS} reps at {N_TILES} "
          f"tiles of 128 columns, lanes {list(TURNS)} a column in turn, and "
          f"{full} tiles at the pick", flush=True)
    runs = []
    for tiles in (N_TILES, full):
        x = probe_input(tiles, dev)
        for v in names:
            counts = TURNS if tiles == N_TILES and v in SPLIT else \
                (K28.lanes_of(v, x.shape[1], None),)
            for n in counts:
                runs.append(run(v, n, x, sass))
                print(describe(runs[-1]), flush=True)
        del x
    return {"correct": correct, "runs": runs}


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
