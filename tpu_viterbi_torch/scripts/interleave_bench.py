"""The ACS' perfect shuffle on the card: kernel K28, the counterpart of
``scripts/interleave_bench.py``, which checked and timed lowerings of the
sublane interleave I[2q] = E[q], I[2q+1] = O[q] of two (32, 128) arrays on
the TPU.

    python -m tpu_viterbi_torch.scripts.interleave_bench [variants]

Variants (``csrc/interleave.cu``), the GPU forms of the JAX ones:
  regs    (bcast) a thread a column, the shuffle register renaming (the
          rep loop unrolled by the shuffle's order, 6, each rep adding its
          own register so that ptxas cannot fold the reps)
  shfl    (new) a warp a column, lane q rows q and 32 + q, __shfl_sync
  smem    (scratch) strided stores to a shared column, then a read
  concat  I = [E; O]: the wrong-result floor, regs' loop without the
          renaming
First the JAX script's check (:99-127): one bare merge of arange(64 x 128)
against numpy's, each variant (concat must fail it).  Then each variant
runs REPS reps (merge, then + 1) on (64, 8 x 128) int32 values -100..100:
the JAX shape, 1,024 columns, which fills 8 SMs a thread a column; and on
a grid that fills every SM (16 CUDA blocks of 128 an SM).  A time is the
median of RUNS CUDA-event launches after one untimed launch, printed as ns
per interleave per 128-column tile (the JAX unit) and values a ns (64 a
column-rep), beside the SASS of the rep loop.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from .. import hardware
from .common import (LT, ProbeKernel, check_names, sass_table, timed)

ROWS = 64
REPS = 16384            # interleaves a column (JAX :21)
N_TILES = 8             # the JAX grid, 128 columns a tile (:22)
RUNS = 5
BLOCKS_PER_SM = 16      # 16 x 128 threads = the SM's 2048
VARIANTS = ("regs", "shfl", "smem", "concat")
JAX_NAME = {"regs": "bcast", "shfl": None, "smem": "scratch",
            "concat": "concat"}
# lane-operations a column-rep, for the bound: 64 adds, 32 IADD3 each
# adding two; shfl 4 shuffles, 2 selects and 2 adds on each of 32 lanes;
# smem 64 stores, 64 loads and 64 adds
OPS = {"regs": 32, "shfl": 256, "smem": 192, "concat": 32}
# reps of the rep loop a pass, for its SASS count a rep
LOOP_REPS = {"regs": 6, "shfl": 1, "smem": 1, "concat": 6}


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


class InterleaveKernel(ProbeKernel):
    """K28, bound to ``viterbi_k28_launch``."""

    def __init__(self):
        super().__init__("K28", "viterbi_k28_launch", "interleave.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int])

    def __call__(self, variant: str, x: torch.Tensor, reps: int,
                 one: int = 1) -> torch.Tensor:
        """(64, cols) int32 after ``reps`` reps.  On a CUDA tensor one
        launch on the current stream, not synchronized; on a CPU tensor its
        plain version."""
        _check(variant, x, reps)
        if not x.is_contiguous():
            raise ValueError("K28 takes a contiguous array")
        if not self.check_device(x):
            return interleave_torch(variant, x, reps, one)
        out = torch.empty_like(x)
        self.launch(x.device, VARIANTS.index(variant), x.data_ptr(),
                    out.data_ptr(), x.shape[1], int(reps), int(one))
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
    """{variant: (SASS instructions of its rep loop, {REG, STACK, ...}, the
    loop's opcode mix)} read from the built library."""
    return sass_table("viterbi_interleave",
                      {v: ("interleave_kernel", f"ILi{i}E")
                       for i, v in enumerate(VARIANTS)})


def run(variant: str, x: torch.Tensor, sass: tuple) -> dict:
    """Time one variant at REPS reps on x."""
    ms, all_ms, _ = timed(lambda: K28(variant, x, REPS), RUNS)
    tiles = x.shape[1] // LT
    loop, res, mix = sass
    return dict(variant=variant, tiles=tiles, columns=x.shape[1], ms=ms,
                all_ms=all_ms, ns_per_interleave_tile=ms * 1e6 /
                (REPS * tiles),
                values_per_ns=ROWS * x.shape[1] * REPS / (ms * 1e6),
                sass_loop=loop, sass_per_rep=loop / LOOP_REPS[variant],
                mix=mix, regs=res.get("REG"), stack=res.get("STACK"))


def describe(r: dict) -> str:
    name = JAX_NAME[r["variant"]]
    return (f"{r['variant']:6s} ({name or 'new'}) {r['columns']:6d} columns: "
            f"median {r['ms']:.4f} ms of {[round(t, 4) for t in r['all_ms']]}"
            f" ~{r['ns_per_interleave_tile']:.4f} ns/interleave/tile = "
            f"{r['values_per_ns']:.1f} values moved and added a ns; SASS "
            f"{r['sass_per_rep']:g} a rep ({r['sass_loop']} in the loop: "
            f"{', '.join(f'{k} {n}' for k, n in list(r['mix'].items())[:5])});"
            f" registers {r['regs']}, stack {r['stack']} B")


def probe(names=VARIANTS) -> dict:
    """The check of every named variant, then each one's time at the JAX
    shape and at the full grid on the current CUDA device, one line each;
    returns {"correct": {variant: bool}, "runs": [``run`` results]}."""
    check_names(names, VARIANTS)
    dev = hardware.resolve_device("cuda")
    correct = {}
    for v in names:
        correct[v] = check_correct(v, dev)
        print(f"{v:10s}: correct={correct[v]}", flush=True)
    sass = sass_counts()
    full = full_tiles(dev)
    print(f"{torch.cuda.get_device_name(dev)}: {REPS} reps at {N_TILES} and "
          f"{full} tiles of 128 columns", flush=True)
    runs = []
    for tiles in (N_TILES, full):
        x = probe_input(tiles, dev)
        for v in names:
            runs.append(run(v, x, sass[v]))
            print(describe(runs[-1]), flush=True)
    return {"correct": correct, "runs": runs}


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
