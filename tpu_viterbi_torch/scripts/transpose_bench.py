"""The staging-transpose experiment on the card: kernel K26, the counterpart
of ``scripts/transpose_bench.py``, which timed XLA's transpose and a Pallas
tile transpose of the 32M-bit staging shape on the TPU: (B, Lw) = (15744,
1056) block-major int32 words (66.5 MB) -> (Lw, B) word-major.

    python -m tpu_viterbi_torch.scripts.transpose_bench [tilings]

Lines (the JAX script's, :80-102):
  torch transpose   ``x.t().contiguous()``, PyTorch's own copy kernel (the
                    JAX script's XLA line), alone and with the consumer
  cuda <tiling>     K26's transpose; the JAX tiles do not fit 227 KB of
                    shared memory (512 x 512 int32 is 1 MB), so they map to
                    32x32 (K6's 32 x 33 tile, for 256 x 256), 64x64 (a 64 x
                    65 tile, for 512 x 512) and slab (32 whole rows, for 128
                    x 1056)
  consume           K26's consumer alone, one launch: the wrapping int32
                    sums of the first 128 columns of every row of the
                    transposed array (``_sum_kernel``), beside
                    ``x[:, :128].sum(0)``
A time is the median of REPS CUDA-event launches after one untimed launch;
GB/s counts the transpose's 2 x B x Lw x 4 bytes.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from .. import hardware
from ..utils.bits import to_int32_bits
from .common import ProbeKernel, check_names, timed

B, LW = 15744, 1056
REPS = 5
TILINGS = ("32x32", "64x64", "slab")
# the JAX tile each stands for (tb, tw), :92
JAX_TILE = {"32x32": (256, 256), "64x64": (512, 512), "slab": (128, 1056)}
SUM_COLS = 128
SLAB_ROWS = 32


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


class TransposeBenchKernel(ProbeKernel):
    """K26, bound to ``viterbi_k26_launch``: ``transpose`` and ``consume``,
    each one launch on a CUDA tensor (on the current stream, not
    synchronized) and its plain version on a CPU tensor."""

    def __init__(self):
        super().__init__("K26", "viterbi_k26_launch", "transpose_bench.cu",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int])

    def transpose(self, tiling: str, x: torch.Tensor) -> torch.Tensor:
        """(rows, cols) int32 -> (cols, rows)."""
        check_names([tiling], TILINGS, "tiling")
        _check(x, "transpose")
        rows, cols = x.shape
        budget = hardware.smem_budget_bytes()
        if tiling == "slab" and SLAB_ROWS * (cols | 1) * 4 > budget:
            raise ValueError(f"the slab of {SLAB_ROWS} rows of {cols} words "
                             f"does not fit {budget} bytes of shared memory")
        if not self.check_device(x):
            return transpose_torch(x)
        out = torch.empty((cols, rows), dtype=torch.int32, device=x.device)
        self.launch(x.device, TILINGS.index(tiling), x.data_ptr(),
                    out.data_ptr(), rows, cols)
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
        self.launch(t.device, len(TILINGS), t.data_ptr(), out.data_ptr(),
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


def _line(label: str, ms: float, all_ms, nbytes: int) -> str:
    return (f"{label:22s}: {ms:8.4f} ms ({nbytes / ms / 1e6:6.0f} GB/s) of "
            f"{[round(t, 4) for t in all_ms]}")


def probe(names=TILINGS) -> dict:
    """Time torch's transpose (alone and with K26's consumer), each named
    tiling and the consumer on the current CUDA device and print one line
    each; returns {line: median ms}."""
    check_names(names, TILINGS, "tiling")
    dev = hardware.resolve_device("cuda")
    x = probe_input(dev)
    nbytes = 2 * x.numel() * 4
    want = transpose_torch(x)
    print(f"{torch.cuda.get_device_name(dev)}: ({B}, {LW}) int32 -> ({LW}, "
          f"{B}), {nbytes / 1e6:.1f} MB moved", flush=True)
    res = {}
    res["torch"], all_ms, _ = timed(lambda: transpose_torch(x), REPS)
    print(_line("torch transpose", res["torch"], all_ms, nbytes), flush=True)
    res["torch+consume"], all_ms, _ = timed(
        lambda: K26.consume(transpose_torch(x)), REPS)
    print(_line("torch transpose+consume", res["torch+consume"], all_ms,
                nbytes), flush=True)
    for tiling in names:
        ms, all_ms, got = timed(lambda: K26.transpose(tiling, x), REPS)
        if not torch.equal(got, want):
            raise AssertionError(f"K26 {tiling} differs from x.t()")
        res[tiling] = ms
        tb, tw = JAX_TILE[tiling]
        print(_line(f"cuda {tiling} (JAX {tb}x{tw})", ms, all_ms, nbytes),
              flush=True)
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


def main(argv=None) -> int:
    probe(list(sys.argv[1:] if argv is None else argv) or TILINGS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
