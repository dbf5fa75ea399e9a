"""Deep BER at the waterfall's knee on the card; the counterpart of
``scripts/ber_deep.py``.

The in-graph simulation (``sharding/simulate.build_sharded_simulation``:
K7/K8 generate, K1/K2/K3 decode, the count stays on the device) runs
``bits_per_point`` bits a point as calls of 32M bits with the JAX script's
seeds 9000 + 97 c, the counts summed on the device, for the JAX script's
configurations and SNRs (project convention sigma = 10^(-SNR/5)) at
``dec_len`` 8192.  Each configuration decodes with the survivor mode JAX's
run resolved on the TPU (``ber_common.jax_survivor``), and each row names
the kernels it launched.  The counts are comparable to the JAX run's
(``bench/ber_deep.json``) count for count.

    python -m tpu_viterbi_torch.scripts.ber_deep [bits_per_point] [cfg,cfg..]
        [--device cuda|cpu] [--out PATH]

With a configuration list and --out, the rows of other configurations
already in PATH are kept.
"""

from __future__ import annotations

import sys

import torch

from ..sharding.simulate import build_sharded_simulation
from .ber_common import (CALL_BITS, Launches, Log, config, jax_survivor,
                         rows_main)

DEC_LEN = 8192
SEED0, SEED_STEP = 9000, 97

# the JAX script's configurations and knee SNRs (ber_deep.py:40-48)
CASES = {
    "h/b32": ("HARD", "b32", (1.25, 1.5, 1.75, 2.0)),
    "s4/b32": ("SOFT4", "b32", (0.875, 1.0, 1.125, 1.25)),
    "s8/b32": ("SOFT8", "b32", (0.875, 1.0, 1.125, 1.25)),
    "s16/b32": ("SOFT16", "b32", (0.875, 1.0, 1.125, 1.25)),
    "f/b32": ("FP32", "b32", (0.875, 1.0, 1.125, 1.25)),
    "s8/b16": ("SOFT8", "b16", (1.0, 1.125)),
}


def run(bits_per_point: int = 128_000_000, only=None, device="cuda",
        call_bits: int = None, log=None) -> list:
    """The rows {config, snr_db, ben, bits, ber, survivor, kernels}: each
    point ceil(bits_per_point / call_bits) calls of ``call_bits`` message
    bits (default CALL_BITS).  ``only``: the configurations to run."""
    log = log or Log()
    call_bits = call_bits or CALL_BITS
    calls = -(-bits_per_point // call_bits)
    rows = []
    for name, (ch, out, snrs) in CASES.items():
        if only is not None and name not in only:
            continue
        cfg = config(ch, out)
        survivor = jax_survivor(cfg, DEC_LEN)
        for snr in snrs:
            fn, m = build_sharded_simulation(
                cfg, call_bits, snr_db=snr, dec_len=DEC_LEN,
                generator="cuda", survivor=survivor, device=device)
            launches = Launches()
            ben = torch.zeros((), dtype=torch.int64, device=device)
            for c in range(calls):
                ben = ben + fn(SEED0 + SEED_STEP * c)
            ben, bits = int(ben), m * calls
            rows.append({"config": name, "snr_db": snr, "ben": ben,
                         "bits": bits, "ber": ben / bits,
                         "survivor": survivor,
                         "kernels": launches.describe(cfg)})
            log(f"{name:7s} snr={snr:5.3f}: BEN {ben:8d} / {bits} -> BER "
                f"{ben / bits:.3e}  [{survivor}: {rows[-1]['kernels']}]")
    return rows


def main(argv=None) -> int:
    return rows_main(
        argv, "Deep BER at the waterfall's knee (the JAX script's "
        "configurations, seeds and dec_len)", run, "bits_per_point",
        128_000_000,
        lambda n: f"{-(-n // CALL_BITS)} x {CALL_BITS} bits per point")


if __name__ == "__main__":
    sys.exit(main())
