"""The values-in decode split on the card: the counterpart of
``scripts/bench_split.py``, which timed the TPU's staging, kernel and full
decode from (S, 2) soft values at 32M bits, dec_len 2048, each on its own.
K22 is no kernel of its own: its pieces are launches of K6 and K4.

    python -m tpu_viterbi_torch.scripts.bench_split [message_len] [dec_len]

Pieces, on (m + 64, 2) random int32 values in [-100, 100] (inside the SOFT8
field range that ``decode_blocks_cuda``'s contract asks), each timed with
CUDA events, one warmed launch a sample:
  staging  K6 on the flat values into the (2 * block_len, B) layout, as
           ``decode_blocks_cuda`` stages them
  kernel   K4 in value mode on those staged values
  full     ``decode_blocks_cuda``: K6, K4 and the assemble
The plan is ``plan_blocks(m, 32, dec_len)`` on m itself (JAX :36).  Gb/s
is m over the event time: the card has no relay, so the JAX script's
"floor-corrected" 33 ms term is not carried over.
"""

from __future__ import annotations

import sys

import torch

from .. import hardware
from ..config import ChannelIn, DecoderConfig
from ..decoder import core_cuda
from ..decoder.core_torch import BlockPlan, plan_blocks
from .common import print_attribution, stage_tiles, time_piece

N_BITS = 32_000_000
DEC_LEN = 2048
CFG = DecoderConfig(ChannelIn.SOFT8)
PIECES = ("staging", "kernel", "full")


def make_plan(m: int, dec_len: int = DEC_LEN) -> BlockPlan:
    return plan_blocks(m, 32, dec_len)


def make_values(m: int, device, seed: int = 0) -> torch.Tensor:
    """(m + 64, 2) int32 values in [-100, 100] from a torch.Generator
    (JAX :42-43)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-100, 101, (m + 64, 2), generator=gen,
                         device=device, dtype=torch.int32)


def stage_values(r: torch.Tensor, plan: BlockPlan) -> torch.Tensor:
    """K6 on the flat values: the (2 * block_len, B) staged layout."""
    return core_cuda.K6(r.reshape(-1), 2 * plan.dec_len, 2 * plan.block_len,
                        plan.num_blocks)


def pieces(r: torch.Tensor, plan: BlockPlan, cfg: DecoderConfig = CFG):
    """{piece: a call of it on the values r}, and the staged values the
    kernel piece decodes (made once, outside the timing)."""
    staged = stage_values(r, plan)
    return {"staging": lambda: stage_values(r, plan),
            "kernel": lambda: core_cuda.K4(staged, cfg, plan),
            "full": lambda: core_cuda.decode_blocks_cuda(r, cfg, plan)}


def probe(m: int = N_BITS, dec_len: int = DEC_LEN, device="cuda") -> dict:
    """Time the three pieces on the card and print the JAX script's lines;
    returns {piece: median ms}."""
    dev = hardware.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the values-in split times kernels on the card")
    plan = make_plan(m, dec_len)
    b = plan.num_blocks
    print(f"{torch.cuda.get_device_name(dev)}: m={m} dec_len={plan.dec_len} "
          f"blocks={b} tiles={-(-b // 128)}", flush=True)
    fns = pieces(make_values(m, dev), plan)
    stages = stage_tiles(plan)
    t = {p: time_piece(p, fns[p], 0 if p == "staging" else stages)
         for p in PIECES}
    print(f"staging:  {t['staging']:8.4f} ms", flush=True)
    for p in ("kernel", "full"):
        print(f"{p + ':':9s} {t[p]:8.4f} ms -> {m / t[p] / 1e6:6.2f} Gb/s",
              flush=True)
    print_attribution([
        ("staging (K6)", t["staging"], ""),
        ("kernel (K4 values)", t["kernel"], ""),
        ("assemble (full-staging-kernel)",
         t["full"] - t["staging"] - t["kernel"], "")])
    return t


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    probe(int(argv[0]) if argv else N_BITS,
          int(argv[1]) if len(argv) > 1 else DEC_LEN)
    return 0


if __name__ == "__main__":
    sys.exit(main())
