"""The staging-transpose experiment on the card: kernel K26, the counterpart
of ``scripts/transpose_bench.py``, which timed XLA's transpose and a Pallas
tile transpose of the 32M-bit staging shape on the TPU: (B, Lw) = (15744,
1056) block-major int32 words (66.5 MB) -> (Lw, B) word-major.

    python -m tpu_viterbi_torch.scripts.transpose_bench [tilings]
    python -m tpu_viterbi_torch.scripts.transpose_bench --against \
        OTHER_CHECKOUT [--rounds R]

Lines (the JAX script's, :80-102):
  torch transpose   ``x.t().contiguous()``, PyTorch's own copy kernel (the
                    JAX script's XLA line), alone and with the consumer
  copy_             ``y.copy_(x)`` of the same bytes: the card's copy rate
                    at this shape, a practical ceiling beside the bound
  cuda <tiling>     K26's transpose; the JAX tiles do not fit 227 KB of
                    shared memory (512 x 512 int32 is 1 MB), so they map to
                    32x32 (for 256 x 256), 64x64 (for 512 x 512) and slab
                    (32 whole rows, for 128 x 1056), each on the route
                    ``K26.route`` picks: "bulk" (bulk copies of tile rows
                    into mbarrier-completed slots, 16-byte stores; the JAX
                    shape) or "element" (4-byte loads and stores, where a
                    pitch or the base is not a multiple of 16 bytes)
  consume           K26's consumer alone, one launch: the wrapping int32
                    sums of the first 128 columns of every row of the
                    transposed array (``_sum_kernel``), beside
                    ``x[:, :128].sum(0)``
The transposes and ``copy_`` are timed two ways: one call at a time, the
median of REPS CUDA-event calls after one untimed call (the host's wrapper,
allocation and ``ctypes`` launch fall inside the events), and replayed from
a CUDA graph of GRAPH_CALLS calls (``utils.timing.graph_ms``: the card's
own clock); the consumer and torch's sum one call at a time.  GB/s counts
the transpose's 2 x B x Lw x 4 bytes.  ``--against`` times each tiling and
``copy_`` in this checkout and another, a process a turn (other, this,
this, other), both ways.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from .. import hardware
from ..utils.bits import to_int32_bits
from .common import ProbeKernel, check_names, timed

B, LW = 15744, 1056
REPS = 5
GRAPH_CALLS = 20        # calls a CUDA graph replays (``both_ways``)
TILINGS = ("32x32", "64x64", "slab")
# the JAX tile each stands for (tb, tw), :92
JAX_TILE = {"32x32": (256, 256), "64x64": (512, 512), "slab": (128, 1056)}
SUM_COLS = 128
SLAB_ROWS = 32
ROUTES = ("element", "bulk")     # viterbi_k26_launch's route 0, 1
# the bulk route's geometry (csrc/transpose_bench.cu): a CTA's warps and a
# warp's ring slots (32x32, 64x64), a slab chunk's words, the barriers'
# space before the slots
TILE_WARPS, TILE_SLOTS = 4, 3
CHUNK_WORDS = 32
BAR_BYTES = 128
TILE = {"32x32": 32, "64x64": 64, "slab": CHUNK_WORDS}


def transpose_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K26's transposes: (rows, cols) -> (cols, rows)."""
    return x.t().contiguous()


def consume_torch(t: torch.Tensor) -> torch.Tensor:
    """Plain version of K26's consumer: the (128,) int32 column sums of t's
    first 128 columns, wrapping as int32 adds do (``_sum_kernel``)."""
    return to_int32_bits(t[:, :SUM_COLS].to(torch.int64).sum(0) & 0xFFFFFFFF)


def _check(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2 or x.dtype != torch.int32 or x.numel() == 0 \
            or not x.is_contiguous():
        raise ValueError(f"K26 {what} takes a contiguous 2-D int32 array, "
                         f"got {x.dtype} {tuple(x.shape)}")


def slab_bytes(route: str, cols: int) -> int:
    """Shared memory of the slab tiling on ``route`` at ``cols`` columns:
    the element route's 32 x (cols | 1) padded words; the bulk route's
    ceil(cols / 32) chunk slots of ``slot_bytes(32)`` and their 8-byte
    barriers, rounded up to BAR_BYTES (``csrc/transpose_bench.cu``)."""
    if route == "element":
        return SLAB_ROWS * (cols | 1) * 4
    chunks = -(-cols // CHUNK_WORDS)
    return -(-8 * chunks // BAR_BYTES) * BAR_BYTES + chunks * slot_bytes(
        CHUNK_WORDS)


def slot_bytes(t: int) -> int:
    """Bytes of a t x t bulk-route slot: row i at ``slot_row(t, i)``."""
    return t * t * 4 + 16 * (t // 4)


def slot_row(t: int, i: int) -> int:
    """Byte offset of row i in a t x t bulk-route slot: 16 bytes more every
    4 rows, so chunk j of row i lies in bank group ((i >> 2) + j) % 8."""
    return i * t * 4 + 16 * (i >> 2)


class TransposeBenchKernel(ProbeKernel):
    """K26, bound to ``viterbi_k26_launch``: ``transpose`` and ``consume``,
    each one launch on a CUDA tensor (on the current stream, not
    synchronized) and its plain version on a CPU tensor.  ``transpose``
    takes the route ``route`` picks; ``route_launches`` counts its launches
    by route."""

    def __init__(self):
        super().__init__("K26", "viterbi_k26_launch", "transpose_bench.cu",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int])
        self.route_launches = Counter()

    def route(self, tiling: str, x: torch.Tensor) -> str:
        """The route (``ROUTES``) ``transpose(tiling, x)`` launches: "bulk"
        (bulk copies of whole tile rows, 16-byte stores) where rows and cols
        are multiples of 4 words and the base is 16-byte aligned, else
        "element" (the first design's 4-byte loads and stores).  Raises
        where the tiling does not fit shared memory on its route."""
        check_names([tiling], TILINGS, "tiling")
        _check(x, "transpose")
        rows, cols = x.shape
        route = "bulk" if rows % 4 == 0 and cols % 4 == 0 and \
            x.data_ptr() % 16 == 0 else "element"
        budget = hardware.smem_budget_bytes()
        if tiling == "slab" and slab_bytes(route, cols) > budget:
            raise ValueError(f"the slab of {SLAB_ROWS} rows of {cols} words "
                             f"({route} route) does not fit {budget} bytes "
                             f"of shared memory")
        return route

    def transpose(self, tiling: str, x: torch.Tensor) -> torch.Tensor:
        """(rows, cols) int32 -> (cols, rows)."""
        route = self.route(tiling, x)
        if not self.check_device(x):
            return transpose_torch(x)
        rows, cols = x.shape
        out = torch.empty((cols, rows), dtype=torch.int32, device=x.device)
        self.launch(x.device, TILINGS.index(tiling), ROUTES.index(route),
                    x.data_ptr(), out.data_ptr(), rows, cols)
        self.route_launches[route] += 1
        return out

    def consume(self, t: torch.Tensor) -> torch.Tensor:
        """(rows, cols >= 128) int32 -> (128,) int32 column sums."""
        _check(t, "consume")
        if t.shape[1] < SUM_COLS:
            raise ValueError(f"K26 consume sums {SUM_COLS} columns, got "
                             f"{t.shape[1]}")
        if not self.check_device(t):
            return consume_torch(t)
        out = torch.empty(SUM_COLS, dtype=torch.int32, device=t.device)
        self.launch(t.device, len(TILINGS), 0, t.data_ptr(), out.data_ptr(),
                    t.shape[0], t.shape[1])
        return out


K26 = TransposeBenchKernel()


def probe_input(device, rows: int = B, cols: int = LW,
                seed: int = 0) -> torch.Tensor:
    """(rows, cols) full-range int32 words (the JAX script's randint range,
    :81-82) from a torch.Generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, (rows, cols), generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)


def _line(label: str, ms: float, all_ms, g_ms: float, g_all,
          nbytes: int) -> str:
    return (f"{label:22s}: {ms:8.4f} ms ({nbytes / ms / 1e6:6.0f} GB/s) of "
            f"{[round(t, 4) for t in all_ms]}; replayed {g_ms:8.4f} ms "
            f"({nbytes / g_ms / 1e6:6.0f} GB/s) of "
            f"{[round(t, 4) for t in g_all]}")


def both_ways(fn):
    """fn timed one call at a time (``timed``, REPS) and replayed from a
    CUDA graph of GRAPH_CALLS calls (``graph_ms``, REPS replays): (ms, all
    ms, graph ms a call, all graph ms, the graph's last result)."""
    from ..utils.timing import graph_ms
    ms, all_ms, _ = timed(fn, REPS)
    g_ms, g_all, out = graph_ms(fn, GRAPH_CALLS, REPS)
    return ms, all_ms, g_ms, g_all, out


def probe(names=TILINGS) -> dict:
    """Time torch's transpose (alone and with K26's consumer), a
    ``copy_`` of the same bytes, each named tiling and the consumer on the
    current CUDA device and print one line each; the transposes and the
    copy both one call at a time and replayed from a CUDA graph
    (``both_ways``).  Returns {line: median ms}, the graph readings under
    "<line> graph"."""
    check_names(names, TILINGS, "tiling")
    dev = hardware.resolve_device("cuda")
    x = probe_input(dev)
    nbytes = 2 * x.numel() * 4
    want = transpose_torch(x)
    print(f"{torch.cuda.get_device_name(dev)}: ({B}, {LW}) int32 -> ({LW}, "
          f"{B}), {nbytes / 1e6:.1f} MB moved", flush=True)
    res = {}
    y = torch.empty_like(x)
    for label, key, fn in (("torch transpose", "torch",
                            lambda: transpose_torch(x)),
                           ("copy_", "copy", lambda: y.copy_(x))):
        ms, all_ms, g_ms, g_all, _ = both_ways(fn)
        res[key], res[f"{key} graph"] = ms, g_ms
        print(_line(label, ms, all_ms, g_ms, g_all, nbytes), flush=True)
    if not torch.equal(y, x):
        raise AssertionError("copy_ differs from its source")
    res["torch+consume"], all_ms, _ = timed(
        lambda: K26.consume(transpose_torch(x)), REPS)
    print(f"{'torch transpose+consume':22s}: {res['torch+consume']:8.4f} ms "
          f"of {[round(t, 4) for t in all_ms]}", flush=True)
    for tiling in names:
        ms, all_ms, g_ms, g_all, got = both_ways(
            lambda: K26.transpose(tiling, x))
        if not torch.equal(got, want):
            raise AssertionError(f"K26 {tiling} differs from x.t()")
        res[tiling], res[f"{tiling} graph"] = ms, g_ms
        tb, tw = JAX_TILE[tiling]
        print(_line(f"cuda {tiling} (JAX {tb}x{tw})", ms, all_ms, g_ms,
                    g_all, nbytes), flush=True)
    res["consume"], all_ms, got = timed(lambda: K26.consume(want), REPS)
    res["torch consume"], lib_ms, lib = timed(
        lambda: want[:, :SUM_COLS].sum(0, dtype=torch.int32), REPS)
    if not (torch.equal(got, consume_torch(want)) and torch.equal(got, lib)):
        raise AssertionError("K26 consume differs from its plain version")
    print(f"{'consume':22s}: {res['consume']:8.4f} ms of "
          f"{[round(t, 4) for t in all_ms]}; torch .sum(0) "
          f"{res['torch consume']:.4f} ms of {[round(t, 4) for t in lib_ms]}",
          flush=True)
    return res


# one turn, run in a checkout's root: only the entry points both sides have
TURN_CHILD = """
import json, sys, torch
from tpu_viterbi_torch.scripts import transpose_bench as tb
from tpu_viterbi_torch.scripts.common import timed
from tpu_viterbi_torch.utils.timing import graph_ms
x = tb.probe_input("cuda")
want = x.t().contiguous()
y = torch.empty_like(x)
res = {}
for name in (*tb.TILINGS, "copy_"):
    fn = ((lambda: y.copy_(x)) if name == "copy_" else
          (lambda: tb.K26.transpose(name, x)))
    ms, _, got = timed(fn, tb.REPS)
    g_ms, _, g_got = graph_ms(fn, int(sys.argv[1]), tb.REPS)
    ok = torch.equal(y, x) if name == "copy_" else (
        torch.equal(got, want) and torch.equal(g_got, want))
    res[name] = [ms, g_ms, bool(ok)]
print(json.dumps(res))
"""


def turn(checkout: str) -> dict:
    """One process in ``checkout`` (its own package and build): {tiling or
    "copy_": [single ms, graph ms a call, equal to x.t()]}."""
    env = {**os.environ, "PYTHONPATH": checkout}
    out = subprocess.run([sys.executable, "-c", TURN_CHILD,
                          str(GRAPH_CALLS)], cwd=checkout, env=env,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {checkout} exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.splitlines()[-1])


def turns(other: str, rounds: int = 1) -> int:
    """Each tiling and ``copy_`` timed in this checkout and ``other``, a
    process a turn (other, this, this, other, ``rounds`` times over), one
    call at a time and replayed from a graph; prints each turn and each
    side's median of its turns.  Returns 1 where a transpose differs from
    x.t(), else 0."""
    here = str(Path(__file__).resolve().parents[2])
    sides = {"other": os.path.abspath(other), "this": here}
    got = {side: [] for side in sides}
    ok = True
    for _ in range(rounds):
        for side in ("other", "this", "this", "other"):
            r = turn(sides[side])
            got[side].append(r)
            ok = ok and all(v[2] for v in r.values())
            print(f"{side:5s} {sides[side]}: " + "; ".join(
                f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in r.items()) +
                " ms (single / graph)", flush=True)
    for side, rs in got.items():
        print(f"{side}: median of turns " + "; ".join(
            f"{k} {statistics.median(r[k][0] for r in rs):.4f} / "
            f"{statistics.median(r[k][1] for r in rs):.4f}"
            for k in rs[0]) + " ms (single / graph)", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args[:1] == ["--against"]:
        rounds = int(args[3]) if args[2:3] == ["--rounds"] else 1
        return turns(args[1], rounds)
    probe(args or TILINGS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
