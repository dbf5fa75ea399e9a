"""The fused generator's BER against the element chain's on the card; the
counterpart of ``scripts/check_gen_ber.py``.

The tests hold K7/K8's draws to their plain version and the noise's
distribution; this holds what matters to the product, the BER the decoder
measures.  SOFT8 at 32M bits a point, SNRs 0.0 / 0.5 / 1.0, ``dec_len``
8192, seed 17, through the in-graph simulation with generator ``cuda``
(K7) and ``torch`` (the element chain: a torch.Generator's stream, not
JAX's).  The two draw different noise of the same law, so their counts
must agree within counting error: where both BERs exceed 1e-4, within 25 %
of the larger, the JAX script's rule.  Viterbi errors come in bursts, so a
count's variance is several times binomial; the rule is not tightened.

    python -m tpu_viterbi_torch.scripts.check_gen_ber [--device cuda|cpu]
        [--out PATH]

Exits 1 when a point disagrees.
"""

from __future__ import annotations

import sys

from ..sharding.simulate import build_sharded_simulation
from .ber_common import (CALL_BITS, Launches, Log, config, jax_survivor,
                         parser, write_rows)

SNRS = (0.0, 0.5, 1.0)
SEED = 17
DEC_LEN = 8192
GENERATORS = ("cuda", "torch")     # the JAX script's "pallas" and "xla"
MIN_BER = 1e-4
MAX_REL_DIFF = 0.25


def agree(ber_a: float, ber_b: float):
    """(whether the rule holds, the relative difference or None where a
    BER is at or below MIN_BER)."""
    if ber_a > MIN_BER and ber_b > MIN_BER:
        rel = abs(ber_a - ber_b) / max(ber_a, ber_b)
        return rel <= MAX_REL_DIFF, rel
    return True, None


def run(device="cuda", call_bits: int = CALL_BITS, log=None):
    """-> (rows {snr_db, generator, ben, bits, ber, kernels}, whether every
    point agrees)."""
    log = log or Log()
    cfg = config("SOFT8", "b32")
    survivor = jax_survivor(cfg, DEC_LEN)
    rows, ok = [], True
    for snr in SNRS:
        bers = {}
        for gen in GENERATORS:
            fn, m = build_sharded_simulation(
                cfg, call_bits, snr_db=snr, dec_len=DEC_LEN, generator=gen,
                survivor=survivor, device=device)
            launches = Launches()
            ben = int(fn(SEED))
            bers[gen] = ben / m
            rows.append({"snr_db": snr, "generator": gen, "ben": ben,
                         "bits": m, "ber": ben / m,
                         "kernels": launches.describe(cfg)})
            log(f"snr={snr:4.1f} {gen:6s}: BEN {ben:9d}  BER {ben / m:.3e}"
                f"  [{rows[-1]['kernels']}]")
        good, rel = agree(*(bers[g] for g in GENERATORS))
        if not good:
            log(f"  DISAGREE at snr={snr}: rel diff {rel:.1%}")
            ok = False
        elif rel is not None:
            log(f"  agree: rel diff {rel:.2%}")
    return rows, ok


def main(argv=None) -> int:
    args = parser("The fused generator's BER against the element "
                  "chain's").parse_args(argv)
    log = Log()
    rows, ok = run(args.device, log=log)
    write_rows(rows, args.out, log)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
