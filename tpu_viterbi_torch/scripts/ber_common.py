"""What the BER and fuzz scripts (``ber_deep``, ``ber_deep_tail``,
``check_gen_ber``, ``fuzz_gpu``, ``ber_sharded``, ``ber_curve``) share: the
``+Ns`` log line, a row's configuration, the survivor JAX's one-device run
resolved on the TPU, the kernels a row launched, the BEN and digest of
host output words, and the JSON rows, written only to ``--out``.

The scripts keep the JAX scripts' seeds, scales and ``dec_len``: at the
same seed K7/K8 draw the JAX generator's message bits, and its noise up to
an ulp of f32 log/sin/cos, so a point's BEN is comparable to the JAX
run's count for count (``chain/genkernel.py``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch

from .. import hardware
from ..chain import genkernel
from ..config import NUM_STATES, ChannelIn, DecodeOut, DecoderConfig
from ..decoder import core_cuda
from ..decoder.core_torch import (WARMUP, plan_blocks,
                                  survivor_window_slots)
from ..utils.bits import count_bit_errors

CALL_BITS = 32_000_000           # message bits a simulate() call (the JAX N)
# the TPU's scoped-VMEM budget that resolved JAX's survivor plan
# (tpu_viterbi/hardware.py:37-41: 16.00M on "TPU v5 lite", the default
# too) and its kernel's blocks a program (core_pallas.LANE_TILE)
TPU_VMEM_BUDGET = 16 * 10 ** 6
TPU_LANE_TILE = 128


class Log:
    """Prints ``+  12.3s message`` lines, seconds since it was made."""

    def __init__(self):
        self.t0 = time.time()

    def __call__(self, msg: str) -> None:
        print(f"+{time.time() - self.t0:6.1f}s {msg}", flush=True)


def config(channel: str, out: str) -> DecoderConfig:
    """The row's configuration: a ChannelIn name and "b16" or "b32"."""
    return DecoderConfig(ChannelIn[channel],
                         decode_out=DecodeOut.O_B16 if out == "b16"
                         else DecodeOut.O_B32)


def tpu_footprint(cfg: DecoderConfig, dec_len: int, window: bool) -> int:
    """VMEM bytes of one program of JAX's fused word-mode kernel
    (``core_pallas.vmem_footprint_bytes``, fused, FP32 on u/d words): the
    survivor store or ring, the double-buffered output, the word scratch
    and the double-buffered packed input."""
    plan = plan_blocks(dec_len, cfg.bits_per_pack, dec_len)
    lt = TPU_LANE_TILE
    slots = survivor_window_slots(cfg) if window else plan.n_packs
    surv = slots * NUM_STATES * lt * 4
    out = 2 * (plan.dec_len // plan.bits_per_pack) * lt * 4
    dpp = 4 if cfg.channel_in == ChannelIn.FP32 else cfg.enc_data_per_pack
    wpb = (2 * plan.dec_len + 2 * WARMUP) // dpp
    words = plan.n_packs * (wpb // plan.n_packs) * lt * 4
    return surv + out + words + 2 * wpb * lt * 4


def jax_survivor(cfg: DecoderConfig, dec_len: int) -> str:
    """The survivor mode JAX's one-device simulation ran on the TPU with
    ``survivor='auto'`` (``core_pallas.resolve_window``): 'window' where
    the full store overflows the VMEM budget and the ring fits, else
    'full'.  The port's own 'auto' keys on half of the card's memory and
    would keep the full store everywhere here, so the scripts pass this
    explicitly."""
    full = tpu_footprint(cfg, dec_len, window=False)
    ring = tpu_footprint(cfg, dec_len, window=True)
    return "window" if full > TPU_VMEM_BUDGET >= ring else "full"


KERNELS = genkernel.KERNELS + core_cuda.KERNELS + (hardware.K9,)


class Launches:
    """Counts the launches of K1-K9 from when it is made (or ``reset``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.start = {k.name: k.launches for k in KERNELS}

    def counts(self) -> dict:
        return {k.name: k.launches - self.start[k.name] for k in KERNELS
                if k.launches > self.start[k.name]}

    def describe(self, cfg: DecoderConfig = None) -> str:
        """"K7 x4 + K1 x4", K3 on the FP32 channel named with its reader;
        "plain versions" when nothing launched (a CPU run)."""
        c = self.counts()
        if not c:
            return "plain versions"
        wire = " (f32 wire)" if cfg is not None and \
            cfg.channel_in == ChannelIn.FP32 else ""
        return " + ".join(f"{k}{wire if k == 'K3' else ''} x{n}"
                          for k, n in c.items())


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the scripts' --device and --out."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the run goes: the GPU (kernels K1-K8), or "
                        "the CPU (their plain versions)")
    p.add_argument("--out", metavar="PATH", default=None,
                   help="write the rows there as JSON; without it the "
                        "script only prints")
    return p


def sha(words: np.ndarray) -> str:
    """A short digest of decoded words (the rows compare words by it)."""
    return hashlib.sha256(np.ascontiguousarray(words).tobytes()
                          ).hexdigest()[:16]


def errors(words: np.ndarray, cfg: DecoderConfig, bits: np.ndarray) -> int:
    """BEN of host output words (uint32 or uint16) against the message."""
    return count_bit_errors(torch.from_numpy(words.astype(np.int64)),
                            cfg.bits_per_pack,
                            torch.from_numpy(bits[cfg.extra_l:]), 0)


def write_rows(rows: list, out, log: Log, only=None) -> None:
    """Write ``rows`` to ``out`` as JSON (nothing without ``out``); with
    ``only`` (the configurations this run ran), the rows of other
    configurations already in ``out`` stay in front of them."""
    if out is None:
        return
    old = []
    if only is not None and os.path.exists(out):
        with open(out) as f:
            old = [r for r in json.load(f) if r["config"] not in only]
    with open(out, "w") as f:
        json.dump(old + rows, f, indent=1)
        f.write("\n")
    log(f"wrote {out}")



def rows_main(argv, description: str, run, first: str, default: int,
              header) -> int:
    """main() of a script whose rows are keyed by configuration
    (``ber_deep``, ``ber_deep_tail``): an optional positional ``first``
    (an int, ``default``) and an optional comma-separated list of the
    script's configurations; logs ``header(first)``, then
    run(first, only, device, log=log)'s rows, which go to --out."""
    p = parser(description)
    p.add_argument(first, nargs="?", type=int, default=default)
    p.add_argument("configs", nargs="?", default=None,
                   help="comma-separated configurations of the script's "
                        "CASES")
    args = p.parse_args(argv)
    only = args.configs.split(",") if args.configs else None
    log = Log()
    n = getattr(args, first)
    log(f"device: {args.device}; {header(n)}")
    write_rows(run(n, only, args.device, log=log), args.out, log, only)
    return 0
