"""One rank of a multi-process run of the split, over ``torch.distributed``
(the counterpart of ``scripts/distributed_worker.py``).

Each rank joins the process group (``sharding.mesh.initialize_distributed``:
gloo on the CPU or on a card the ranks share, nccl where each has its
own), then runs, on a seeded coded workload (``sharding.certify``):

  - ``decode_sharded``: the gathered output must equal the in-process
    decode of every rank (``blocks.decode_all_ranks``) and, on the valid
    prefix, the one-rank split's; the decoder's collective census must be
    the one halo exchange (``audit``);
  - the sharded simulation (K7/K8 at this rank's base offset, the decode,
    the all-reduce): the count must equal the in-process one
    (``ShardedSimulation.all_ranks``), this rank's decoded words equal its
    part of it, the census the expected one, and the noiseless count 0;
  - the generator: this rank's slab equals its slice of the one-rank
    stream.

It prints one line a check, ``DIST_OK <check> ...``, and with ``--out-dir``
writes ``rank<r>.json`` (the results) and ``rank<r>_decode.npy`` (the
gathered decode) there.  Run it as one process per rank, started with
``subprocess`` (never forked after CUDA is initialised; without
``--coordinator`` it reads torchrun's variables, as
``sharding.launch.spawn_ranks`` sets them):

    python -m tpu_viterbi_torch.scripts.distributed_worker \\
        --coordinator localhost:PORT --num-processes 2 --process-id {0,1} \\
        --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import ChannelIn, DecodeOut, DecoderConfig
from ..chain.genkernel import packed_workload_cuda
from ..sharding import audit
from ..sharding.blocks import decode_all_ranks, decode_sharded, shard_stages
from ..sharding.certify import coded_workload
from ..sharding.mesh import BlockMesh, initialize_distributed, make_block_mesh
from ..sharding.simulate import DEFAULT_SCALES, build_sharded_simulation

CHANNELS = {"h": ChannelIn.HARD, "s4": ChannelIn.SOFT4, "s8": ChannelIn.SOFT8,
            "s16": ChannelIn.SOFT16, "f": ChannelIn.FP32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # without them, torchrun's variables (sharding/launch.py sets them)
    p.add_argument("--coordinator", default=None, help="host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("-n", "--num", type=int, default=8 * 2048 + 16)
    p.add_argument("-i", "--input", choices=sorted(CHANNELS), default="s8")
    p.add_argument("-o", "--output", choices=["b32", "b16"], default="b32")
    p.add_argument("--dec-len", type=lambda s: s if s == "auto" else int(s),
                   default=256)
    p.add_argument("--sigma", type=float, default=0.6,
                   help="noise of the decode's coded workload")
    p.add_argument("--snr", type=float, default=0.5,
                   help="SNR (dB) of the noisy simulation")
    p.add_argument("--seed", type=int, default=17)
    p.add_argument("--out-dir", type=Path, default=None)
    return p.parse_args(argv)


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> int:
    args = parse_args(argv)
    backend = initialize_distributed(args.coordinator, args.num_processes,
                                     args.process_id, device=args.device)
    mesh = make_block_mesh(args.device)
    n_ranks, rank = mesh.size, mesh.rank
    check(n_ranks == (args.num_processes or n_ranks), f"{n_ranks} ranks")
    cfg = DecoderConfig(CHANNELS[args.input], decode_out=(
        DecodeOut.O_B16 if args.output == "b16" else DecodeOut.O_B32))
    scale = DEFAULT_SCALES[cfg.channel_in]
    res = {"rank": rank, "ranks": n_ranks, "backend": backend,
           "device": str(mesh.device)}

    # decode_sharded against every rank decoded in this process
    _, packed = coded_workload(args.num, args.sigma, args.seed,
                               cfg.channel_in, scale)
    n_in = 2 * args.num
    mesh.census.clear()
    got, m = decode_sharded(packed, n_in, cfg, mesh, args.dec_len)
    census = list(mesh.census)
    want, m2 = decode_all_ranks(packed, n_in, cfg, n_ranks, mesh.device,
                                args.dec_len)
    one, _ = decode_all_ranks(packed, n_in, cfg, 1, mesh.device,
                              args.dec_len)
    check(m == m2 and np.array_equal(got, want),
          "decode_sharded differs from the in-process ranks")
    check(np.array_equal(got, one[: got.shape[0]]),
          "decode_sharded differs from the one-rank split")
    sd = shard_stages(cfg, n_in, n_ranks, args.dec_len)[0]
    want_census = audit.expected_census(cfg, False) + [
        ("all_gather", "int32", sd // cfg.bits_per_pack)]
    check(census == (want_census if n_ranks > 1 else []),
          f"decode census {census}")
    res.update(decode_m=m, decode_sha=sha(got))
    print(f"DIST_OK decode m={m} sha={res['decode_sha']} census={census}",
          flush=True)

    # the sharded simulation: noisy, then noiseless
    sims, refs = {}, {}
    for tag, snr in (("noisy", args.snr), ("noiseless", math.inf)):
        fn, m = build_sharded_simulation(
            cfg, args.num, snr_db=snr, dec_len=args.dec_len,
            generator="cuda", mesh=mesh, return_output=True)
        mesh.census.clear()
        ben, out = fn(args.seed)
        census = list(mesh.census)
        refs[tag], _ = build_sharded_simulation(
            cfg, args.num, snr_db=snr, dec_len=args.dec_len,
            generator="cuda", mesh=BlockMesh(0, n_ranks, mesh.device))
        ben_all, outs = refs[tag].all_ranks(args.seed)
        lo = rank * out.shape[0]
        check(int(ben) == int(ben_all), f"{tag} BEN {int(ben)} against "
              f"{int(ben_all)} in process")
        check(torch.equal(out.cpu(), outs[lo: lo + out.shape[0]].cpu()),
              f"{tag}: this rank's decoded words differ")
        check(census == (audit.expected_census(cfg, True) if n_ranks > 1
                         else [("all_reduce", "int64", 1)]),
              f"{tag} census {census}")
        sims[tag] = int(ben)
    check(sims["noiseless"] == 0, f"noiseless BEN {sims['noiseless']}")
    res.update(ben=sims["noisy"], noiseless_ben=0, m=m, census=census)
    print(f"DIST_OK simulate ben={sims['noisy']} noiseless=0 m={m} "
          f"census={census}", flush=True)

    # this rank's generated slab against the one-rank stream
    slab = refs["noisy"].generate(args.seed, rank)
    full = packed_workload_cuda(args.seed, args.num, cfg.channel_in,
                                args.snr, scale, mesh.device)
    for what, part, whole in (("packs", slab[0], full[0]),
                              ("words", slab[1], full[1])):
        lo = rank * part.shape[0]
        have = whole[lo: lo + part.shape[0]]
        check(torch.equal(part[: have.shape[0]].cpu(), have.cpu())
              and not part[have.shape[0]:].any(),
              f"generated {what} differ from the one-rank stream")
    print("DIST_OK generator slab equals the one-rank stream", flush=True)

    if args.out_dir is not None:
        args.out_dir.mkdir(parents=True, exist_ok=True)
        np.save(args.out_dir / f"rank{rank}_decode.npy", got)
        (args.out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
