"""The kernel's share of a full SOFT16 (and SOFT8) decode on the card: the
counterpart of ``scripts/soft16_pieces.py``, which timed the TPU's
production kernel on pre-staged input against its full decode with the
reference check.  K24 is no kernel of its own: its pieces are launches of
K1 and K3.

    python -m tpu_viterbi_torch.scripts.soft16_pieces [message_bits]

Configurations (the JAX script's): SOFT8 / dec_len 8192, SOFT16 / 4096 and
SOFT16 / 8192 with the windowed survivor.  Words are coded words at 5.5 dB
from K7 (``packed_workload_cuda``) at ``DEFAULT_SCALES``, with their
reference packs.  Pieces, each timed with CUDA events, one warmed launch a
sample:
  kernel-only  K1 (K3 for the window) alone: it reads the flat stream, so
               there is nothing to pre-stage on the card
  full         ``decode_packed_cuda`` and the XOR/popcount against the
               reference packs (``sharding.simulate.count_errors``); the
               BEN it counts is printed and must be 0
The JAX script passed survivor "auto", which took the window at SOFT16 /
8192 on the TPU's VMEM; the card's "auto" keeps the full store at 32M bits
(hardware.survivor_store_budget_bytes), so the third configuration passes
"window" to keep the script's ``w`` row.
"""

from __future__ import annotations

import sys

import torch

from .. import hardware
from ..chain.genkernel import packed_workload_cuda, ref_words_from_packs
from ..config import ChannelIn, DecoderConfig
from ..decoder import core_cuda
from ..decoder.core_torch import plan_blocks
from ..sharding.simulate import DEFAULT_SCALES, count_errors
from .common import stage_tiles, time_piece

N_BITS = 32_000_000
SNR_DB = 5.5
SEED = 51                           # the JAX script's first key
CONFIGS = ((ChannelIn.SOFT8, 8192, "auto"), (ChannelIn.SOFT16, 4096, "auto"),
           (ChannelIn.SOFT16, 8192, "window"))
PIECES = ("kernel-only", "full")


def make_case(ch: ChannelIn, dec_len: int, survivor: str, n: int, device,
              seed: int = SEED) -> dict:
    """One configuration's inputs: its cfg and plan, the window flag, K7's
    words (their plain version on the CPU) and the reference packs."""
    cfg = DecoderConfig(ch)
    m = cfg.get_message_len(2 * n)
    plan = plan_blocks(m, cfg.bits_per_pack, dec_len)
    window = core_cuda.resolve_window(survivor, cfg, plan, device)
    packs, words = packed_workload_cuda(seed, n, ch, SNR_DB,
                                        DEFAULT_SCALES[ch], device)
    ref = ref_words_from_packs(packs, cfg.extra_l, -(-m // 32) * 32)
    return dict(cfg=cfg, plan=plan, window=window, words=words, ref=ref,
                label=f"{ch.name.lower()}/{dec_len}{'w' if window else ''}")


def pieces(case: dict) -> dict:
    """{piece: a call of it on ``case``}: kernel-only -> (B, n_emit) packs,
    full -> the bit errors (0-dim int64)."""
    cfg, plan, window = case["cfg"], case["plan"], case["window"]
    words, ref = case["words"], case["ref"]
    kernel = core_cuda.kernel_for(cfg, window)

    def full():
        out = core_cuda.decode_packed_cuda(words, cfg, plan, window=window)
        return count_errors(out, ref, plan.bits_per_pack, plan.message_len)

    return {"kernel-only": lambda: kernel(words, cfg, plan), "full": full}


def probe(n: int = N_BITS, device="cuda") -> dict:
    """Time both pieces of every configuration on the card; returns {label:
    {"kernel-only": ms, "full": ms, "ben": int}}."""
    dev = hardware.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the SOFT16 pieces probe times kernels on the card")
    print(f"{torch.cuda.get_device_name(dev)}: {n} bits at {SNR_DB} dB; the "
          f"third configuration passes survivor 'window' (the card's 'auto' "
          f"keeps the full store at this size)", flush=True)
    res = {}
    for ch, dec_len, survivor in CONFIGS:
        case = make_case(ch, dec_len, survivor, n, dev)
        fns = pieces(case)
        stages = stage_tiles(case["plan"])
        kernel = core_cuda.kernel_for(case["cfg"], case["window"]).name
        row = {p: time_piece(f"{case['label']} {p} ({kernel})"
                             if p == "kernel-only" else
                             f"{case['label']} {p}", fns[p], stages)
               for p in PIECES}
        row["ben"] = int(fns["full"]())
        print(f"{case['label']} full: BEN {row['ben']} over "
              f"{case['plan'].message_len} bits; kernel share "
              f"{row['kernel-only'] / row['full']:.1%}", flush=True)
        res[case["label"]] = row
        del case, fns
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    probe(int(argv[0]) if argv else N_BITS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
