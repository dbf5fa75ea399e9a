"""The in-graph simulation's call timed in this checkout and another, in
turns on one card.

    python -m tpu_viterbi_torch.scripts.ingraph_turns OTHER_CHECKOUT
        [--rounds R]

Each turn is a process of its own, started in a checkout's root so that it
imports that checkout's package: it builds ``build_sharded_simulation``
at the CLI's headline (SOFT8, 32M bits, 5.5 dB, its channel scale 40000,
``dec_len`` 2048, the default generator and survivor), makes one call
(the kernels' build), then times CALLS calls at seed SEED with CUDA
events (``utils/timing.cuda_ms``) and prints their median.  The turns go
other, this, this, other, R times over, so that a drift of the card's
clock falls on both alike.  Prints each turn's median and each checkout's
median of its turns.  Exits 1 when the two checkouts count a different
BEN at the same seed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

BITS, SNR_DB, CALLS, SEED = 32_000_000, 5.5, 20, 7

# run in a checkout's root: only the entry points both sides have
CHILD = """
import json, sys
from tpu_viterbi_torch.config import ChannelIn, DecoderConfig
from tpu_viterbi_torch.sharding.simulate import build_sharded_simulation
from tpu_viterbi_torch.utils.timing import cuda_ms
n, snr, calls, seed = (int(sys.argv[1]), float(sys.argv[2]),
                       int(sys.argv[3]), int(sys.argv[4]))
fn, m = build_sharded_simulation(DecoderConfig(ChannelIn.SOFT8), n,
                                 snr_db=snr, scale=40000.0, dec_len=2048)
ben = int(fn(seed))
ms, all_ms, _ = cuda_ms(lambda: fn(seed), calls)
print(json.dumps({"ms": ms, "all_ms": all_ms, "ben": ben}))
"""


def turn(checkout: str, n: int, snr: float, calls: int, seed: int) -> dict:
    """One process in ``checkout``: {ms, all_ms, ben}."""
    env = {**os.environ, "PYTHONPATH": checkout}
    out = subprocess.run(
        [sys.executable, "-c", CHILD, str(n), str(snr), str(calls),
         str(seed)], cwd=checkout, env=env, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {checkout} exited {out.returncode}: "
                           f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The in-graph call in this "
                                "checkout and another, in turns")
    p.add_argument("other", metavar="OTHER_CHECKOUT")
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sides = {"other": os.path.abspath(args.other), "this": here}
    ms = {k: [] for k in sides}
    bens = set()
    for _ in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            r = turn(sides[side], BITS, SNR_DB, CALLS, SEED)
            ms[side].append(r["ms"])
            bens.add(r["ben"])
            print(f"{side:5s} {sides[side]}: median {r['ms']:.4f} ms of "
                  f"{CALLS} calls (min {min(r['all_ms']):.4f}), BEN "
                  f"{r['ben']}", flush=True)
    for side, t in ms.items():
        print(f"{side}: median of turns {statistics.median(t):.4f} ms "
              f"({', '.join(f'{x:.4f}' for x in t)})")
    if len(bens) != 1:
        print(f"BEN differs between turns: {sorted(bens)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
