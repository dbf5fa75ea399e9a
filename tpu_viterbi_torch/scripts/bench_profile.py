"""Where a decode's time goes at the bench's shape on the card: the
counterpart of ``scripts/bench_profile.py``, which split the TPU bench's
slope (SOFT8, 32M bits, dec_len 8192, decode + BER check) into staging,
kernel, assembly and check.  K21 is no kernel of its own: its pieces are
launches of the port's kernels.

    python -m tpu_viterbi_torch.scripts.bench_profile [message_len] [dec_len ...]

Pieces, on random full-range SOFT8 words, each timed with CUDA events, one
warmed launch a sample (``common.time_piece``; no k-multi slope: a CUDA
event reads the device's clock, utils/timing.py):
  stage   K6 staging the words word-major (``stage_words_cuda``), the
          staged A/B path's staging.  K1 needs none: it reads its words
          straight from the flat stream, so on the main path this piece
          does no work
  kraw    K1 alone (no ``assemble_output``)
  decode  ``decode_packed_cuda``: K1 and the assemble
  check   ``sharding.simulate.count_errors`` on pre-made random (2, n_out)
          words: the XOR and popcount the in-graph simulation runs, torch
          ops of a few launches
  d+c     decode, then the count (what ``simulate`` runs after generating)
The default runs dec_len 8192 (the JAX script's: 3,907 time-blocks, so
3,907 threads on the card) and 2048 (``ViterbiGPU``'s: 15,625).
"""

from __future__ import annotations

import sys

import torch

from .. import hardware
from ..config import ChannelIn, DecoderConfig
from ..decoder import core_cuda
from ..decoder.core_torch import BlockPlan, plan_blocks
from ..sharding.simulate import count_errors
from .common import print_attribution, stage_tiles, time_piece

N_BITS = 32_000_000
DEC_LENS = (8192, 2048)
CFG = DecoderConfig(ChannelIn.SOFT8)
PIECES = ("stage", "kraw", "decode", "check", "d+c")


def make_plan(m: int, dec_len: int, cfg: DecoderConfig = CFG) -> BlockPlan:
    """The bench's plan for an m-bit transmission (JAX :70)."""
    return plan_blocks(cfg.get_message_len(2 * m), cfg.bits_per_pack,
                       dec_len)


def make_inputs(m: int, plan: BlockPlan, device, cfg: DecoderConfig = CFG,
                seed: int = 0) -> dict:
    """x: the m-bit transmission's random words; y: random (2, n_out) int32
    words for the check; ref: y[1] as the count's int64 reference packs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             device=device, dtype=torch.int64
                             ).to(torch.int32)

    y = words(2, plan.message_len // 32)
    return dict(x=words(cfg.get_input_words(2 * m)), y=y,
                ref=y[1].to(torch.int64) & 0xFFFFFFFF)


def pieces(inp: dict, plan: BlockPlan, cfg: DecoderConfig = CFG) -> dict:
    """{piece: a call of it on ``inp``}; on CPU tensors every kernel runs
    its plain version."""
    x, y, ref = inp["x"], inp["y"], inp["ref"]
    m = plan.message_len

    def dc():
        out = core_cuda.decode_packed_cuda(x, cfg, plan)
        return count_errors(out, ref, plan.bits_per_pack, m)

    return {
        "stage": lambda: core_cuda.stage_words_cuda(x, cfg, plan),
        "kraw": lambda: core_cuda.K1(x, cfg, plan),
        "decode": lambda: core_cuda.decode_packed_cuda(x, cfg, plan),
        "check": lambda: count_errors(y[0], ref, plan.bits_per_pack, m),
        "d+c": dc,
    }


def profile(m: int, dec_len: int, dev: torch.device) -> dict:
    """Time every piece at one dec_len and print the JAX script's
    attribution block; returns {piece: median ms}."""
    plan = make_plan(m, dec_len)
    b = plan.num_blocks
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"m={m} dec_len={plan.dec_len} blocks={b} tiles={-(-b // 128)} "
          f"n_packs={plan.n_packs}: K1 runs {b} threads in "
          f"{-(-b // core_cuda.K_THREADS)} CUDA blocks of "
          f"{core_cuda.K_THREADS} on {sms} SMs", flush=True)
    fns = pieces(make_inputs(m, plan, dev), plan)
    stages = stage_tiles(plan)
    t = {p: time_piece(p, fns[p], stages if p in ("stage", "kraw",
                                                  "decode") else 0)
         for p in PIECES}
    print_attribution([
        ("staging (K6, A/B only)", t["stage"],
         "   (the main path stages nothing: K1 reads the flat stream)"),
        ("kernel (K1 raw)", t["kraw"], ""),
        ("assemble (dec-raw)", t["decode"] - t["kraw"], ""),
        ("check", t["check"], ""),
        ("decode total", t["decode"],
         f" ({plan.message_len / t['decode'] / 1e6:.2f} Gb/s)"),
        ("decode+check", t["d+c"],
         f" ({plan.message_len / t['d+c'] / 1e6:.2f} Gb/s)"),
        ("count in d+c (d+c-decode)", t["d+c"] - t["decode"], "")])
    print(f"ns/stage (kernel)            {t['kraw'] * 1e6 / stages:.3f}",
          flush=True)
    return t


def probe(m: int = N_BITS, dec_lens=DEC_LENS, device="cuda") -> dict:
    """``profile`` at each dec_len on the card: {dec_len: {piece: ms}}."""
    dev = hardware.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the bench profile times kernels on the card")
    print(f"{torch.cuda.get_device_name(dev)}: SOFT8 b32, {m} bits",
          flush=True)
    return {dl: profile(m, dl, dev) for dl in dec_lens}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    m = int(argv[0]) if argv else N_BITS
    probe(m, tuple(int(a) for a in argv[1:]) or DEC_LENS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
