"""Decode time against message size on the card; the counterpart of
``scripts/scaling_curve.py``.

The JAX table: SOFT8, b32 packs, at 99,968 to 128,000,000 message bits
(``SIZES``), full-range random int32 words from a torch.Generator seeded
17 + i (JAX's ``PRNGKey(17 + i)``), the word count the decode reads.  Each
size runs twice: at ``auto_dec_len(m, 32)``, JAX's rule (``dec_len_policy``
"jax_auto"), and at ``decoder.api.DEFAULT_DEC_LEN`` 2048 ("default").

Up to 32M bits each row's first call must equal the plain decode
(``core_torch.decode_packed_torch``) on the same words on the card, word
for word; at 64M and 128M the row also decodes a K7 SOFT8 workload of the
same size at 5.5 dB (seed 17, the channel sweep's scale), and its BEN must
be 0.  A miss exits 1 and names the row.  ``decode_seconds`` is the slope
of K decodes queued between two CUDA events (``utils.timing.queued_s``,
JAX's ``amplified_slope``), ``graph_seconds`` the same K decodes replayed
from a CUDA graph, a call's share (4M bits or fewer).  ``fastest`` marks
each size's faster policy (``sweep_common.mark_fastest``).

    python -m tpu_viterbi_torch.scripts.scaling_curve [size]
        [--device cuda|cpu] [--out PATH]

``size``: the JAX sizes up to it, or ``size`` alone where none is.  With
``--device cpu`` the rows' plans and checks run through the plain versions
and every time field is None: the CPU has no device clock.
"""

from __future__ import annotations

import sys

from ..chain.genkernel import packed_workload_cuda, ref_words_from_packs
from ..decoder.api import DEFAULT_DEC_LEN
from ..decoder.core_torch import WARMUP, auto_dec_len, plan_blocks
from ..sharding.simulate import count_errors
from .ber_common import Log
from .channel_throughput import SCALES, SNR_DB
from .sweep_common import (REPS, SOFT8, Decodes, RowMiss, amplify_k,
                           check_plain, mark_fastest, queued_times,
                           random_words, rates, sweep_main, tiles_stages,
                           times_text)

# the JAX table (scaling_curve.py:41, :71-73)
SIZES = (99_968, 249_984, 1_000_000, 4_000_000, 16_000_000, 32_000_000,
         64_000_000, 128_000_000)
SEED0 = 17                          # PRNGKey(17 + i)
POLICIES = ("jax_auto", "default")
PLAIN_MAX_BITS = 32_000_000         # above: the BEN check on K7's workload


def policy_dec_len(policy: str, m: int) -> int:
    """The dec_len a policy gives an m-bit message."""
    return auto_dec_len(m, SOFT8.bits_per_pack) if policy == "jax_auto" \
        else DEFAULT_DEC_LEN


def row_table(sizes=SIZES) -> list:
    """[(m, policy, dec_len)] in the sweep's order."""
    return [(m, p, policy_dec_len(p, m)) for m in sizes for p in POLICIES]


def describe(r: dict) -> str:
    """One row on one line."""
    check = f"BEN {r['ben_at_5p5dB']} at 5.5 dB (K7's words)" \
        if "ben_at_5p5dB" in r else "first call == plain decode"
    return (f"m={r['message_len']:>11,d} {r['dec_len_policy']:8s} dec_len "
            f"{r['dec_len']:5d}: {r['blocks']} blocks, K={r['K']}: "
            f"{times_text(r)}; {check}")


def ben_at_5p5db(decode: Decodes, m: int, plan, device) -> int:
    """BEN of the decode of a K7 SOFT8 workload of m message bits at 5.5
    dB; RowMiss unless 0."""
    packs, words = packed_workload_cuda(SEED0, m + WARMUP, SOFT8.channel_in,
                                        SNR_DB, SCALES["SOFT8"], device)
    ref = ref_words_from_packs(packs, SOFT8.extra_l, m)
    ben = int(count_errors(decode(words, SOFT8, plan), ref,
                           plan.bits_per_pack, m))
    if ben:
        raise RowMiss(f"m={m} dec_len {plan.dec_len}: BEN {ben} at "
                      f"{SNR_DB} dB, want 0")
    return ben


def point(m: int, policy: str, device) -> dict:
    """One row: the check, then the times."""
    plan = plan_blocks(m, SOFT8.bits_per_pack, policy_dec_len(policy, m))
    k = amplify_k(m)
    xs = [random_words(m, SEED0 + i, device) for i in range(REPS + 1)]
    decode = Decodes()
    first = decode(xs[0], SOFT8, plan)
    check = {}
    if m <= PLAIN_MAX_BITS:
        check_plain(f"m={m} dec_len {plan.dec_len}", first, xs[0], SOFT8,
                    plan)
    else:
        check["ben_at_5p5dB"] = ben_at_5p5db(decode, m, plan, device)
    del first
    t = queued_times(decode, xs, SOFT8, plan, k, device)
    _, stages = tiles_stages(plan)
    return {"message_len": m, "dec_len": plan.dec_len, **t,
            **rates(m, t["decode_seconds"], stages),
            "blocks": plan.num_blocks, "dec_len_policy": policy, "K": k,
            **check, "fastest": False, "kernel": "K1", "calls": decode.calls}


def run(size: int = SIZES[-1], device="cuda", log=None) -> list:
    """The rows of ``row_table`` up to ``size``; raises RowMiss on a
    miss."""
    log = log or Log()
    rows = []
    for m, policy, _ in row_table([m for m in SIZES if m <= size] or
                                  [size]):
        rows.append(point(m, policy, device))
        log(describe(rows[-1]))
    mark_fastest(rows, log)
    return rows


def main(argv=None) -> int:
    return sweep_main(argv, "Decode time against message size (the JAX "
                      "sizes, at JAX's auto_dec_len and at 2048)", run,
                      SIZES[-1])


if __name__ == "__main__":
    sys.exit(main())
