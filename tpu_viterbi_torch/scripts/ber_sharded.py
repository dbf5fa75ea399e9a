"""BER of the split against the one-device decode at 8 ranks (the
counterpart of ``scripts/ber_sharded.py`` and ``scripts/ber_sharded_mp.py``
in one script): the same noisy workloads through ``ViterbiGPU.run`` and
through ``decode_sharded`` over ``--ranks`` ranks, one JSON row a point.

The workloads are the JAX scripts': one ``np.random.default_rng(99)``
stream, SOFT8 at scale 32.0 then HARD at scale 1.0, for each channel the
SNRs in order, for each point the message bits, then the f32 noise, then
``quantize_and_pack``; ``dec_len`` 2048.  The JAX package's numpy words
are the port's, so both decodes count JAX's BEN exactly.  The split's block
framing depends only on the number of ranks, not on how ranks map to
processes: 8 rank processes at 200,000 bits and SNRs 0.5, 1.0 give the JAX
rows of 8 devices over 4 processes.

Three ways to hold the ranks:

  - by default ``--ranks`` processes are started (``sharding.launch``):
    gloo on the CPU or when they share a card, nccl when each has a card;
  - ``--in-process`` holds them in this process
    (``blocks.decode_all_ranks``), with no collective;
  - under ``torchrun`` (WORLD_SIZE set) each process is one rank.

Every rank decodes the one-device reference too, and a point fails (exit
code 1) unless the split's BER lies within 2 % of it (``ber_sharded_mp.py``'s
check).  Rank 0 prints a line a point and writes the rows to ``--out``.

    python -m tpu_viterbi_torch.scripts.ber_sharded --device cpu --in-process
    python -m tpu_viterbi_torch.scripts.ber_sharded --device cpu --ranks 2 \\
        -n 40000
    python -m tpu_viterbi_torch.scripts.ber_sharded -n 200000 --snrs 0.5,1.0
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..chain.channel import snr_to_sigma
from ..chain.encode import conv_encode_np
from ..chain.quantize import quantize_and_pack
from ..config import ChannelIn, DecoderConfig
from ..decoder.api import ViterbiGPU
from ..hardware import resolve_device
from ..sharding import launch
from ..sharding.blocks import decode_all_ranks, decode_sharded
from ..sharding.mesh import initialize_distributed, make_block_mesh
from .ber_common import Launches, Log, errors, parser, sha, write_rows

SEED = 99
DEC_LEN = 2048
CHANNELS = ((ChannelIn.SOFT8, 32.0), (ChannelIn.HARD, 1.0))
SNRS = (0.0, 0.5, 1.0, 1.5)
MP_SNRS = (0.5, 1.0)              # ber_sharded_mp.py's points, 200,000 bits
RANKS = 8                         # the JAX rows' devices
WAIT_S = 1200                     # the rank processes' time limit


def workloads(n: int, snrs=SNRS):
    """(channel, scale, snr, message bits, packed words) of every point,
    drawn from one default_rng(SEED) stream in the JAX scripts' order."""
    rng = np.random.default_rng(SEED)
    for ch, scale in CHANNELS:
        for snr in snrs:
            bits = rng.integers(0, 2, n).astype(np.uint8)
            sym = 2 * conv_encode_np(bits).astype(np.float32) - 1
            sym = sym + rng.normal(0, snr_to_sigma(snr),
                                   sym.shape).astype(np.float32)
            packed = quantize_and_pack(torch.from_numpy(sym), ch, scale)
            yield ch, scale, snr, bits, packed.numpy()


def within(ber_split: float, ber_one: float) -> bool:
    """ber_sharded_mp.py's check: the split's BER within 2 % of the
    one-device BER (of 1e-3 below it)."""
    return abs(ber_split - ber_one) < 0.02 * max(ber_one, 1e-3)


def run(n: int, snrs, ranks: int, device, in_process: bool,
        log=None) -> list:
    """Every point's row.  ``in_process``: the ranks held in this process;
    else this process is one rank of the initialised group (or the only
    one)."""
    dev = resolve_device(device)
    mesh = None
    if in_process:
        processes, coll = 1, None
    else:
        coll = initialize_distributed(device=dev)
        mesh = make_block_mesh(dev)
        dev, ranks, processes = mesh.device, mesh.size, mesh.size
    rows = []
    for ch, _, snr, bits, packed in workloads(n, snrs):
        cfg = DecoderConfig(channel_in=ch)
        launches = Launches()
        out1, _ = ViterbiGPU(cfg, dec_len=DEC_LEN, device=dev).run(
            packed, 2 * n)
        m1 = cfg.get_message_len(2 * n)
        if in_process:
            outs, ms = decode_all_ranks(packed, 2 * n, cfg, ranks, dev,
                                        DEC_LEN)
        else:
            outs, ms = decode_sharded(packed, 2 * n, cfg, mesh, DEC_LEN)
        ben1, bens = errors(out1, cfg, bits), errors(outs, cfg, bits)
        rows.append({
            "channel": ch.name, "snr_db": snr, "devices": ranks,
            "processes": processes, "bits": int(m1),
            "ber_single": ben1 / m1, "ber_sharded": bens / ms,
            "sharded_bits": int(ms), "ben_single": ben1, "ben_sharded": bens,
            "backend": coll, "device": str(dev),
            "words_single": sha(out1), "words_sharded": sha(outs),
            "launches_rank0": launches.counts(),
            "within_2pct": within(bens / ms, ben1 / m1)})
        if log is not None and (mesh is None or mesh.rank == 0):
            log(f"{ch.name:6s} snr={snr:3.1f} single={ben1 / m1:.3e} "
                f"({ben1})  sharded({ranks} ranks/{processes} proc)="
                f"{bens / ms:.3e} ({bens}) "
                f"[{launches.describe(cfg)}]")
    return rows


def main(argv=None) -> int:
    p = parser(__doc__.splitlines()[0])
    p.add_argument("-n", "--num", type=int, default=400_000,
                   help="message bits a point (400,000; ber_sharded_mp.py's "
                        "rows: 200,000 with --snrs 0.5,1.0)")
    p.add_argument("--snrs", default=",".join(map(str, SNRS)),
                   help="comma-separated SNRs (dB) of each channel")
    p.add_argument("--ranks", type=int, default=RANKS)
    p.add_argument("--in-process", action="store_true",
                   help="hold the ranks in this process (no collective)")
    args = p.parse_args(argv)
    snrs = [float(s) for s in args.snrs.split(",")]
    if not args.in_process and not os.environ.get("WORLD_SIZE"):
        # the launcher: one process a rank, each with torchrun's variables
        results = launch.spawn_ranks(
            lambda r: [sys.executable, "-m", __spec__.name,
                       *(argv if argv is not None else sys.argv[1:])],
            args.ranks, args.device, WAIT_S)
        return launch.report(results)
    log = Log()
    rows = run(args.num, snrs, args.ranks, args.device, args.in_process,
               log)
    if args.in_process or torch.distributed.get_rank() == 0:
        write_rows(rows, args.out, log)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    bad = [r for r in rows if not r["within_2pct"]]
    for r in bad:
        log(f"FAIL {r['channel']} {r['snr_db']} dB: the split's BER "
            f"{r['ber_sharded']:.3e} is not within 2 % of "
            f"{r['ber_single']:.3e}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
