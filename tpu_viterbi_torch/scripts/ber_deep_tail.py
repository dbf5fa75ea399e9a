"""Deep-BER tail on the card: the deepest SNR of each format driven to at
least TARGET_EVENTS error events, over at least 512M bits and at most
``max_bits``; the counterpart of ``scripts/ber_deep_tail.py``, which bounds
the windowed survivor's error floor.

Each call is one 32M-bit call of the in-graph simulation (K7/K8, the
decode, the count on the device) with the JAX script's seeds
77000 + 131 c.  Each row decodes with the survivor mode JAX's run resolved
on the TPU with ``survivor='auto'`` (``ber_common.jax_survivor``: the
window, K3, where the full store overflowed the TPU's VMEM), passed
explicitly because the port's own 'auto' would keep the full store, and
names the kernels it launched.  The s16 row at ``dec_len`` 4096 is the
full-store twin of the one at 8192; f/b32/value2048 decodes at the API's
default ``dec_len``.

    python -m tpu_viterbi_torch.scripts.ber_deep_tail [max_bits] [cfg,cfg..]
        [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import sys

from types import SimpleNamespace

from ..chain.genkernel import packed_workload_cuda, ref_words_from_packs
from ..decoder.core_torch import decode_packed_torch, plan_blocks
from ..sharding.simulate import (DEFAULT_SCALES, build_sharded_simulation,
                                 count_errors)
from .ber_common import (CALL_BITS, Launches, Log, config, jax_survivor,
                         rows_main)

TARGET_EVENTS = 30
MIN_BITS = 512_000_000
SEED0, SEED_STEP = 77_000, 131

# the JAX script's rows (ber_deep_tail.py:38-50): channel, output pack,
# SNR, dec_len
CASES = {
    "h/b32": ("HARD", "b32", 2.0, 8192),
    "s4/b32": ("SOFT4", "b32", 1.25, 8192),
    "s8/b32": ("SOFT8", "b32", 1.25, 8192),
    "s16/b32": ("SOFT16", "b32", 1.25, 8192),
    "s16/b32/full4096": ("SOFT16", "b32", 1.25, 4096),
    "f/b32": ("FP32", "b32", 1.25, 8192),
    "f/b32/value2048": ("FP32", "b32", 1.25, 2048),
    "s8/b16": ("SOFT8", "b16", 1.125, 8192),
    "s8/b16/deep": ("SOFT8", "b16", 1.25, 8192),
}


def row_survivor(name: str) -> str:
    """The survivor mode row ``name`` passes: JAX's plan."""
    ch, out, _, dec_len = CASES[name]
    return jax_survivor(config(ch, out), dec_len)


def row_against_plain(name: str, device="cuda",
                      call_bits: int = CALL_BITS) -> SimpleNamespace:
    """One call of row ``name`` at its first seed through the in-graph
    simulation, and the plain decode of the same generated words on
    ``device``.  -> cfg, plan, window (the row's survivor mode), words
    (the packed input), ref32 (the message words), ben and got (the
    simulation's BEN and decoded words), launches (the kernels that call
    launched, {name: count}), plain_ben and want (the plain decode's)."""
    ch, out, snr, dec_len = CASES[name]
    cfg = config(ch, out)
    window = row_survivor(name) == "window"
    fn, m = build_sharded_simulation(
        cfg, call_bits, snr_db=snr, dec_len=dec_len, generator="cuda",
        survivor="window" if window else "full", device=device,
        return_output=True)
    launches = Launches()
    ben, got = fn(SEED0)
    launched = launches.counts()
    packs, words = packed_workload_cuda(SEED0, call_bits, cfg.channel_in,
                                        snr, DEFAULT_SCALES[cfg.channel_in],
                                        device)
    plan = plan_blocks(m, cfg.bits_per_pack, dec_len)
    want = decode_packed_torch(words, cfg, plan, window)
    ref32 = ref_words_from_packs(packs, cfg.extra_l, -(-m // 32) * 32)
    return SimpleNamespace(
        cfg=cfg, plan=plan, window=window, words=words, ref32=ref32,
        ben=int(ben), got=got, launches=launched, want=want,
        plain_ben=int(count_errors(want, ref32, cfg.bits_per_pack, m)))


def run(max_bits: int = 1_024_000_000, only=None, device="cuda",
        call_bits: int = None, log=None) -> list:
    """The rows {config, snr_db, dec_len, ben, bits, ber, survivor,
    kernels[, upper_bound_95]}: calls of ``call_bits`` bits (default
    CALL_BITS) until the row has TARGET_EVENTS events and MIN_BITS bits,
    or ``max_bits``."""
    log = log or Log()
    call_bits = call_bits or CALL_BITS
    rows = []
    for name, (ch, out, snr, dec_len) in CASES.items():
        if only is not None and name not in only:
            continue
        cfg = config(ch, out)
        survivor = row_survivor(name)
        fn, m = build_sharded_simulation(
            cfg, call_bits, snr_db=snr, dec_len=dec_len, generator="cuda",
            survivor=survivor, device=device)
        launches = Launches()
        ben, bits, c = 0, 0, 0
        while bits < max_bits and (ben < TARGET_EVENTS or bits < MIN_BITS):
            ben += int(fn(SEED0 + SEED_STEP * c))
            c += 1
            bits = m * c
            if c % 8 == 0:
                log(f"  {name}: {ben} events / {bits // 1_000_000}M bits")
        row = {"config": name, "snr_db": snr, "dec_len": dec_len,
               "ben": ben, "bits": bits, "ber": ben / bits,
               "survivor": survivor, "kernels": launches.describe(cfg)}
        if ben == 0:
            row["upper_bound_95"] = f"<{3.0 / bits:.2e} (0 events)"
        rows.append(row)
        log(f"{name:16s} snr={snr:5.3f}: BEN {ben:6d} / {bits} -> BER "
            f"{ben / bits:.3e}  [{survivor}: {row['kernels']}]")
    return rows


def main(argv=None) -> int:
    return rows_main(
        argv, "Deep-BER tail: the deepest SNR of each format to "
        f"{TARGET_EVENTS} error events", run, "max_bits", 1_024_000_000,
        lambda n: f"target {TARGET_EVENTS} events or {n} bits per point")


if __name__ == "__main__":
    sys.exit(main())
