"""Multi-rank decode example (the counterpart of
``scripts/pod_decode_example.py``): the whole chain over the ranks of the
split, on the card unless given ``--device cpu``.

By default the chain runs in-graph (``cli.e2e_simulation``, the path of
``python -m tpu_viterbi_torch --e2e-device``): each rank draws its slab of
the shared-seed stream with K7 (K8 on FP32), decodes it with its right
neighbour's halo (K1 reading it as its tail halo), counts its errors, and
only the scalar error count crosses ranks.  ``--host-data`` instead builds
the workload on the host with numpy (``sharding.certify.coded_workload``)
and decodes it through ``decode_sharded``.  Rank 0 prints the ranks, the
bits decoded, the time of the call (the first, kernel build included) and
BEN/BER, and writes them to ``--out``; the exit code is 1 when BEN > 0 at
3 dB or more.

    # one rank on the card
    python -m tpu_viterbi_torch.scripts.pod_decode_example -n 32000000 -s 5.5
    # ranks on this host (one a card: nccl; sharing a card or the CPU: gloo)
    torchrun --nproc-per-node 2 -m \\
        tpu_viterbi_torch.scripts.pod_decode_example -n 400000 --device cpu

The channel scales are the JAX script's (``-i s8``: 32.0), where the CLI
uses 40000.0; on HARD the scale does not change the decisions, so
``-i h`` counts the CLI's BEN for the same seed and message.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import cli
from ..chain.channel import snr_to_sigma
from ..config import ChannelIn, DecoderConfig
from ..hardware import resolve_device
from ..sharding.blocks import decode_sharded
from ..sharding.certify import coded_workload
from ..sharding.mesh import initialize_distributed, make_block_mesh
from ..utils.bits import count_bit_errors
from .ber_common import Launches

CHANNELS = {"h": ChannelIn.HARD, "s4": ChannelIn.SOFT4,
            "s8": ChannelIn.SOFT8, "s16": ChannelIn.SOFT16}
# the JAX script's scales (pod_decode_example.py:69)
SCALES = {"h": 1.0, "s4": 4.0, "s8": 32.0, "s16": 8192.0}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-n", "--num", type=int, default=8_000_000)
    p.add_argument("-s", "--snr", type=float, default=5.5)
    p.add_argument("-i", "--input", default="s8", choices=sorted(CHANNELS))
    p.add_argument("--dec-len", type=int, default=2048)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--coordinator", default=None, help="host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--host-data", action="store_true",
                   help="build the workload on the host and decode it "
                        "through decode_sharded (default: in-graph)")
    p.add_argument("--out", metavar="PATH", default=None,
                   help="rank 0 writes its result there as JSON")
    return p.parse_args(argv)


def host_data(args, cfg: DecoderConfig):
    """--host-data: the numpy workload at this SNR, decoded over the
    ranks -> (BEN, m, the mesh, seconds of the decode)."""
    device = resolve_device(args.device)
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, device=device)
    mesh = make_block_mesh(device)
    bits, packed = coded_workload(args.num, snr_to_sigma(args.snr),
                                  args.seed, cfg.channel_in,
                                  SCALES[args.input])
    t0 = time.perf_counter()
    out, m = decode_sharded(packed, 2 * args.num, cfg, mesh,
                            dec_len=args.dec_len)
    seconds = time.perf_counter() - t0
    ben = count_bit_errors(torch.from_numpy(out.view(np.int32)),
                           cfg.bits_per_pack,
                           torch.from_numpy(bits[cfg.extra_l:]), 0)
    return ben, m, mesh, seconds


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = DecoderConfig(channel_in=CHANNELS[args.input])
    launches = Launches()
    if args.host_data:
        ben, m, mesh, seconds = host_data(args, cfg)
    else:
        ben, _, m, mesh, _, seconds = cli.e2e_simulation(
            cfg, args.num, args.snr, SCALES[args.input], args.seed,
            args.dec_len, device=args.device, coordinator=args.coordinator,
            num_processes=args.num_processes, process_id=args.process_id)
    ranks = 1 if mesh is None else mesh.size
    if mesh is None or mesh.rank == 0:
        backend = None if mesh is None else mesh.backend
        print(f"ranks: {ranks} ({backend or 'no process group'}), "
              f"channel={cfg.channel_in.name}", flush=True)
        print(f"decoded {m} bits on {ranks} rank(s) in {seconds * 1e3:.1f} "
              f"ms (first call, kernel build included)")
        print(f"BEN: {ben}   BER: {ben / m:.3e}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"ranks": ranks, "backend": backend,
                           "channel": cfg.channel_in.name, "snr_db": args.snr,
                           "seed": args.seed, "host_data": args.host_data,
                           "bits": m, "seconds": seconds, "ben": ben,
                           "launches_rank0": launches.counts()}, f, indent=1)
                f.write("\n")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0 if ben == 0 or args.snr < 3 else 1


if __name__ == "__main__":
    sys.exit(main())
