"""Decode time against ``dec_len`` at small message sizes on the card; the
counterpart of ``scripts/small_msg_sweep.py``.

The JAX table: SOFT8, b32 packs, at 99,968, 249,984, 1,000,000 and
3,999,872 message bits, each at dec_len 8192, 4096, 2048, 1024, 512 and
``auto_dec_len(m, 32)``, a dec_len dropped where it clamps to an earlier
one's (``dl_eff``), and the 32M-bit anchor at 8192.  The card adds rows at
256, 128 and 64 (``card_only``): a small message fills the H100's 132 SMs
only with short blocks, and JAX's table stops at 512.  The words are
full-range random int32 from a torch.Generator seeded 100 dl + i (JAX's
``PRNGKey(100 * dl + i)``), the word count the decode reads.

Each row's first call must equal the plain decode
(``core_torch.decode_packed_torch``) on the same words on the card, word
for word; a miss exits 1 and names the row.  ``decode_seconds`` is the
slope of K decodes queued between two CUDA events (``utils.timing.
queued_s``, JAX's ``amplified_slope``; K sized as JAX sizes it), and
``graph_seconds`` the same K decodes replayed from a CUDA graph, a call's
share (rows of 4M bits or fewer): the gap between the two is the host's
launch where it paces the card.  ``fastest`` marks each size's fastest
row by ``graph_seconds`` where the size has them, else by
``decode_seconds`` (``sweep_common.mark_fastest``).

    python -m tpu_viterbi_torch.scripts.small_msg_sweep [size]
        [--device cuda|cpu] [--out PATH]

``size``: the JAX sizes up to it (the anchor from 32M on), or ``size``
alone where none is.  With ``--device cpu`` the rows' plans and checks run
through the plain versions and every time field is None: the CPU has no
device clock.
"""

from __future__ import annotations

import sys

from ..decoder.core_torch import auto_dec_len, plan_blocks
from .ber_common import Log
from .sweep_common import (REPS, SOFT8, TARGET_S, Decodes, amplify_k,
                           check_plain, mark_fastest, queued_times,
                           random_words, rates, sweep_main, tiles_stages,
                           times_text)

# the JAX table (small_msg_sweep.py:91-106)
SIZES = (99_968, 249_984, 1_000_000, 3_999_872)
CANDIDATES = (8192, 4096, 2048, 1024, 512)      # and auto_dec_len(m, 32)
ANCHOR, ANCHOR_DEC_LEN, ANCHOR_TARGET_S = 32_000_000, 8192, 0.06
SEED_STEP = 100                                 # PRNGKey(100 * dl + i)
CARD_ONLY = (256, 128, 64)


def dl_eff(dl: int, m: int) -> int:
    """The dec_len a candidate gives at m bits (JAX's dedup key)."""
    return max(32, min(dl, m) - min(dl, m) % 32)


def row_table(sizes=SIZES, anchor: bool = True) -> list:
    """[(m, candidate dec_len, card_only)] in the sweep's order."""
    rows = []
    for m in sizes:
        seen = set()
        for dl, card_only in [(d, False) for d in
                              (*CANDIDATES, auto_dec_len(m, 32))] + \
                [(d, True) for d in CARD_ONLY]:
            if dl_eff(dl, m) not in seen:
                seen.add(dl_eff(dl, m))
                rows.append((m, dl, card_only))
    if anchor:
        rows.append((ANCHOR, ANCHOR_DEC_LEN, False))
    return rows


def describe(r: dict) -> str:
    """One row on one line."""
    flags = " [card_only]" if r["card_only"] else ""
    return (f"m={r['message_len']:>10,d} dec_len {r['dec_len']:5d}: "
            f"{r['blocks']} blocks, {r['tiles']} tiles, K={r['K']}: "
            f"{times_text(r)}{flags}; first call == plain decode")


def point(m: int, dl: int, card_only: bool, device,
          target_s: float = TARGET_S) -> dict:
    """One row: the check, then the times."""
    plan = plan_blocks(m, SOFT8.bits_per_pack, dl)
    k = amplify_k(m, target_s)
    xs = [random_words(m, SEED_STEP * dl + i, device)
          for i in range(REPS + 1)]
    decode = Decodes()
    check_plain(f"m={m} dec_len {plan.dec_len}",
                decode(xs[0], SOFT8, plan), xs[0], SOFT8, plan)
    t = queued_times(decode, xs, SOFT8, plan, k, device)
    tiles, stages = tiles_stages(plan)
    return {"message_len": m, "dec_len": plan.dec_len, "K": k, **t,
            **rates(m, t["decode_seconds"], stages),
            "blocks": plan.num_blocks, "tiles": tiles,
            "card_only": card_only, "fastest": False, "kernel": "K1",
            "calls": decode.calls}


def run(size: int = ANCHOR, device="cuda", log=None) -> list:
    """The rows of ``row_table`` up to ``size``; raises RowMiss on a
    miss."""
    log = log or Log()
    sizes = [m for m in SIZES if m <= size] or [size]
    rows = []
    for m, dl, card_only in row_table(sizes, anchor=size >= ANCHOR):
        rows.append(point(m, dl, card_only, device,
                          ANCHOR_TARGET_S if m == ANCHOR else TARGET_S))
        log(describe(rows[-1]))
    mark_fastest(rows, log)
    return rows


def main(argv=None) -> int:
    return sweep_main(argv, "Decode time against dec_len at small message "
                      "sizes (the JAX table and the card's short blocks)",
                      run, ANCHOR)


if __name__ == "__main__":
    sys.exit(main())
