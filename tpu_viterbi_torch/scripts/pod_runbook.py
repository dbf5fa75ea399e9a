"""Multi-card runbook (the counterpart of ``scripts/pod_runbook.py``): one
command that takes the split from bring-up to a certified multi-rank
decode, on cards (one rank a card: nccl; ranks sharing a card: gloo) or on
the CPU (``--device cpu``: gloo ranks, the plain versions), so the
procedure itself runs without several cards.

Steps, each printed PASS or FAIL; rank 0 writes the report to ``--out``:

  1 bringup            the ranks, processes, backend and each rank's
                       device; on the card its name and power limit
                       (nvidia-smi), the hardware model
                       (``smem_budget_bytes``, ``survivor_store_budget_bytes``,
                       ``alu_model``) and with ``--probe-smem`` K9's probe
  2 aligned_decode     the split of SOFT8 coded input (``coded_workload``,
                       sigma 0.4, seed 17) at a shard aligned by
                       ``zero_copy_align_stages`` (32,000,000 bits a rank
                       at dec_len 2048 on the card, 8,192 at 64 on the
                       CPU): the halo read in place (``info['aligned']``),
                       the output bit-equal to the plain path at the same
                       framing (on the CPU: to ``decode_all_ranks``), and
                       BEN <= m / 10,000
  3 collective_census  the decoder's census exactly the one halo exchange,
                       the simulation's the halo, the one-word realignment
                       and one scalar all-reduce (``audit.expected_census``);
                       skipped at one rank
  4 linearity          where each rank has a card of its own: the split's
                       decode and the one-rank decode of the same shard,
                       CUDA events (median of LINEARITY_RUNS after one
                       untimed call), aggregate and per-rank Gb/s, their
                       ratio, the cards for 100 Gb/s and the canary K10
                       beside them; PASS at a ratio of 0.6 or more.  Ranks
                       that share a card or run on the CPU are time-sliced:
                       the step is 'modeled', with no time.

The exit code is 0 only if every step passes.

    # dry run on the CPU, 8 gloo rank processes
    python -m tpu_viterbi_torch.scripts.pod_runbook --device cpu --ranks 8
    # one rank on the card (nccl), with K9's probe
    python -m tpu_viterbi_torch.scripts.pod_runbook --coordinator \\
        localhost:29500 --num-processes 1 --process-id 0 --probe-smem
    # one rank a card on this host
    torchrun --nproc-per-node 4 -m tpu_viterbi_torch.scripts.pod_runbook
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import hardware
from ..config import ChannelIn, DecoderConfig
from ..decoder.api import DEFAULT_DEC_LEN
from ..hardware import resolve_device
from ..sharding import audit, launch
from ..sharding.blocks import (decode_all_ranks, run_sharded,
                               zero_copy_align_stages)
from ..sharding.certify import coded_workload
from ..sharding.mesh import initialize_distributed, make_block_mesh
from ..utils import timing
from ..utils.bits import count_bit_errors
from .ber_common import Launches

CARD_BITS = 32_000_000       # message bits a rank on the card
CPU_BITS = 8192              # ... on the CPU (JAX's virtual run)
CPU_DEC_LEN = 64
SIGMA, SEED = 0.4, 17        # the certification workload (JAX's)
LINEARITY_RUNS = 10
MIN_RATIO = 0.6              # per-rank Gb/s against the one-rank decode's
TARGET_GBPS = 100.0          # SURVEY.md §6
WAIT_S = 1200                # the rank processes' time limit


class Runbook:
    """The report and the log of one rank's run."""

    def __init__(self, rank: int):
        self.rank, self.t0 = rank, time.time()
        self.report = {"steps": {}, "ok": True}

    def log(self, msg: str) -> None:
        if self.rank == 0:
            print(f"[runbook +{time.time() - self.t0:6.1f}s] {msg}",
                  flush=True)

    def step(self, name: str, ok: bool, **details) -> None:
        self.report["steps"][name] = {"ok": bool(ok), **details}
        self.report["ok"] = self.report["ok"] and bool(ok)
        self.log(f"step {name}: {'PASS' if ok else 'FAIL'} " + " ".join(
            f"{k}={v}" for k, v in details.items() if not isinstance(v, dict)))


def gathered(mesh, obj) -> list:
    """Every rank's ``obj`` in rank order (one rank: [obj]); outside the
    split's collectives, so it is not in the census."""
    if mesh.group is None:
        return [obj]
    objs = [None] * mesh.size
    dist.all_gather_object(objs, obj, group=mesh.group)
    return objs


def bringup(book: Runbook, mesh, backend, probe_smem: bool) -> None:
    on_card = mesh.device.type == "cuda"
    devices = gathered(mesh, str(mesh.device))
    details = dict(n_ranks=mesh.size,
                   n_processes=dist.get_world_size()
                   if dist.is_initialized() else 1,
                   backend=backend or "none", devices=devices,
                   device_kind=hardware.device_kind() or "cpu",
                   smem_budget_bytes=hardware.smem_budget_bytes(),
                   survivor_store_budget_bytes=(
                       hardware.survivor_store_budget_bytes(mesh.device)
                       if on_card else None),
                   alu_model=hardware.alu_model())
    if on_card:
        details["cards"] = hardware.smi_cards()
        book.log(f"cards: {details['cards']}")
    if probe_smem and on_card:
        details["probed_smem_bytes"] = hardware.probe_smem_budget()
    book.step("bringup", len(devices) == mesh.size >= 1, **details)


def aligned_decode(book: Runbook, mesh, args):
    """Step 2 -> (cfg, the decoder, this rank's words, sd, dec_len,
    total message bits)."""
    on_card = mesh.device.type == "cuda"
    n = mesh.size
    cfg = DecoderConfig(channel_in=ChannelIn.SOFT8)
    dec_len = args.dec_len or (DEFAULT_DEC_LEN if on_card else CPU_DEC_LEN)
    align = zero_copy_align_stages(cfg, dec_len)
    per_rank = CARD_BITS if on_card else CPU_BITS
    sd = align * max(1, (args.num or per_rank * n) // (align * n))
    n_bits = sd * n
    book.log(f"aligned decode: {n_bits} bits over {n} ranks (sd={sd}, "
             f"dec_len={dec_len}, device {mesh.device})")
    bits, packed = coded_workload(n_bits, sigma=SIGMA, seed=SEED)
    out, info, dec, x = run_sharded(cfg, sd, mesh, dec_len, packed)
    m = cfg.get_message_len(2 * n_bits)
    mw = m // cfg.bits_per_pack
    got = mesh.all_gather(out).cpu()[:mw]
    if on_card:
        plain_path = "the plain path (backend torch) on the card"
        plain = mesh.all_gather(run_sharded(cfg, sd, mesh, dec_len, packed,
                                            backend="torch")[0]).cpu()[:mw]
    else:
        plain_path = "decode_all_ranks"
        words, _ = decode_all_ranks(packed, 2 * n_bits, cfg, n, mesh.device,
                                    dec_len)
        plain = torch.from_numpy(words.view(np.int32))
    bit_equal = bool(torch.equal(got, plain))
    ben = count_bit_errors(got, cfg.bits_per_pack,
                           torch.from_numpy(bits[cfg.extra_l:]), 0)
    book.step("aligned_decode", info["aligned"] and bit_equal
              and ben <= m // 10_000, aligned=info["aligned"],
              backend=info["backend"], bit_equal=bit_equal,
              against=plain_path, ben=ben, message_bits=m, sd=sd,
              dec_len=dec_len)
    return cfg, dec, x, sd, dec_len, n_bits


def collective_census(book: Runbook, mesh, cfg, dec, x, dec_len,
                      n_bits) -> None:
    if mesh.size == 1:
        book.step("collective_census", True, skipped=True,
                  note="one rank issues no collective; the census at 2 "
                       "and 4 ranks is tests/test_torch_distributed.py's")
        return
    decoder = audit.collective_census(mesh, dec, x)
    sim = audit.audit_simulation(cfg, n_bits, mesh, dec_len)
    ok = decoder == audit.expected_census(cfg, simulate=False) and \
        sim == audit.expected_census(cfg, simulate=True)
    book.step("collective_census", ok, decoder=decoder, simulation=sim)


def linearity(book: Runbook, mesh, dec, x, sd, n_bits) -> None:
    if mesh.device.type != "cuda" or mesh.backend not in (None, "nccl"):
        book.step("linearity", True, modeled=True,
                  note=f"{mesh.size} rank(s) on {mesh.device.type} "
                       f"({mesh.backend or 'no process group'}): ranks "
                       f"that share a device are time-sliced and give no "
                       f"scaling number; the census is the structural "
                       f"proof")
        return
    one = lambda: dec.local(x, x[: dec.halo_words])      # noqa: E731
    dec(x)
    split_ms, _, _ = timing.cuda_ms(lambda: dec(x), LINEARITY_RUNS)
    one()
    one_ms, _, _ = timing.cuda_ms(one, LINEARITY_RUNS)
    ms = gathered(mesh, (split_ms, one_ms))
    split_ms = max(s for s, _ in ms)          # the slowest rank ends it
    one_ms = float(np.median([o for _, o in ms]))
    gbps = n_bits / (split_ms * 1e-3) / 1e9
    per_rank = gbps / mesh.size
    one_gbps = sd / (one_ms * 1e-3) / 1e9
    ratio = per_rank / one_gbps
    book.step("linearity", ratio >= MIN_RATIO, split_ms=round(split_ms, 4),
              one_rank_ms=round(one_ms, 4), aggregate_gbps=round(gbps, 3),
              per_rank_gbps=round(per_rank, 3),
              one_rank_gbps=round(one_gbps, 3), ratio=round(ratio, 4),
              cards_for_100gbps=math.ceil(TARGET_GBPS / per_rank),
              canary_ns=round(timing.canary_ns(), 4), runs=LINEARITY_RUNS)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-n", "--num", type=int, default=None,
                   help=f"message bits in all (default {CARD_BITS} a rank "
                        f"on the card, {CPU_BITS} on the CPU)")
    p.add_argument("--dec-len", type=int, default=None,
                   help=f"default {DEFAULT_DEC_LEN} on the card, "
                        f"{CPU_DEC_LEN} on the CPU")
    p.add_argument("--ranks", type=int, default=None, metavar="N",
                   help="start N rank processes on this host "
                        "(sharding/launch.py)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--coordinator", default=None, help="host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--probe-smem", action="store_true",
                   help="also search the shared-memory budget with K9 "
                        "(the card only)")
    p.add_argument("--out", metavar="PATH", default=None,
                   help="rank 0 writes the report there as JSON")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.ranks and not os.environ.get("WORLD_SIZE"):
        results = launch.spawn_ranks(
            lambda r: [sys.executable, "-m", __spec__.name,
                       *(argv if argv is not None else sys.argv[1:])],
            args.ranks, args.device, WAIT_S)
        return launch.report(results)
    device = resolve_device(args.device)
    backend = initialize_distributed(args.coordinator, args.num_processes,
                                     args.process_id, device=device)
    try:
        mesh = make_block_mesh(device)
        book = Runbook(mesh.rank)
        launches = Launches()
        bringup(book, mesh, backend, args.probe_smem)
        cfg, dec, x, sd, dec_len, n_bits = aligned_decode(book, mesh, args)
        collective_census(book, mesh, cfg, dec, x, dec_len, n_bits)
        linearity(book, mesh, dec, x, sd, n_bits)
        book.report["launches_rank0"] = launches.counts()
        if mesh.rank == 0 and args.out:
            with open(args.out, "w") as f:
                json.dump(book.report, f, indent=1)
                f.write("\n")
            book.log(f"wrote {args.out}")
        book.log(f"RUNBOOK {'PASS' if book.report['ok'] else 'FAIL'}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0 if book.report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
