"""Decode throughput of every channel format on the card; the counterpart
of ``scripts/channel_throughput.py``.

The JAX script's workload: 32,000,000 message bits a format (HARD, SOFT4,
SOFT8, SOFT16, FP32) at 5.5 dB with its channel scales (``SCALES``), six
workloads from seeds 7-12 drawn by K7 (K8 on FP32) through
``chain.genkernel.packed_workload_cuda``.  Each format is decoded through
``core_cuda.decode_packed_cuda`` (K1 on the integer formats, int16x2 path
metrics but on SOFT16's int32; K2 on the FP32 wire) at every ``dec_len``
the JAX script tried (``candidates``), not only at the first that fits:
``jax_pick`` marks that one, the first whose VMEM footprint fits the TPU's
budget (``ber_common.tpu_footprint``, JAX's ``pallas_supported``).

Each row's first call (seed 7) must equal the plain decode
(``core_torch.decode_packed_torch``) on the same words on the card, word
for word, and its BER must be at most 1e-2 (the JAX script's rule); a miss
exits 1 and names the row.  Times (CUDA events, the reference's method):
``kernel_seconds``, the decode alone, and ``decode_check_seconds``, the
decode and the error count on the card (the JAX script's timed
quantity), each the median of RUNS calls over the six workloads after one
untimed call; ``bound_ms`` is ``core_cuda.decode_bound_ms`` of the row.
``ns_per_stage`` keeps JAX's 128-block-tile definition.

    python -m tpu_viterbi_torch.scripts.channel_throughput [message_len]
        [--device cuda|cpu] [--out PATH]

With ``--device cpu`` the rows' plans and checks run through the plain
versions and every time field is None: the CPU has no device clock.
"""

from __future__ import annotations

import itertools
import sys

from ..chain.genkernel import packed_workload_cuda, ref_words_from_packs
from ..config import ChannelIn, DecoderConfig
from ..decoder import core_cuda
from ..decoder.core_torch import BlockPlan, plan_blocks
from ..sharding.simulate import count_errors
from ..utils.timing import cuda_ms
from .ber_common import TPU_VMEM_BUDGET, Log, tpu_footprint
from .sweep_common import (Decodes, RowMiss, check_plain, is_card, ms, rates,
                           sweep_main, tiles_stages)

# the JAX script's table (channel_throughput.py:35-36, :108, :148-149)
SCALES = {"HARD": 40000.0, "SOFT4": 4.0, "SOFT8": 32.0, "SOFT16": 8192.0,
          "FP32": 4.0}
CHANNELS = ("HARD", "SOFT4", "SOFT8", "SOFT16", "FP32")
MESSAGE_LEN = 32_000_000
SNR_DB = 5.5
SEED0 = 7                   # PRNGKey(7 + i)
N_INPUTS = 6
MAX_BER = 1e-2
RUNS = 10                   # timed calls a median


def median_s(fn, n: int) -> float:
    """Median seconds of RUNS CUDA-event timed calls fn(i), the inputs
    i = 1, 2, ... taken in turn mod n, after one untimed fn(0)."""
    fn(0)
    i = itertools.count(1)
    med, _, _ = cuda_ms(lambda: fn(next(i) % n), RUNS)
    return med / 1e3


def candidates(cfg: DecoderConfig) -> tuple:
    """The JAX script's dec_lens in its order (:61-62): FP32 tries 2048
    first."""
    return (2048, 8192, 4096, 1024) if cfg.channel_in == ChannelIn.FP32 \
        else (8192, 4096, 2048, 1024)


def jax_pick(cfg: DecoderConfig, m: int) -> int:
    """The dec_len the JAX script ran on an m-bit message: that of its
    first candidate plan whose fused kernel fits the TPU's VMEM budget
    (``pallas_supported``)."""
    for dl in candidates(cfg):
        dl = plan_blocks(m, cfg.bits_per_pack, dl).dec_len
        if tpu_footprint(cfg, dl, window=False) <= TPU_VMEM_BUDGET:
            return dl
    raise ValueError(f"{cfg.channel_in.name}: no dec_len fits VMEM")


def row_plans(cfg: DecoderConfig, m: int) -> list:
    """The plans of a format's rows: a candidate each, in the JAX order,
    those that clamp to an earlier one's dec_len dropped (at 32M bits
    none)."""
    plans, seen = [], set()
    for dl in candidates(cfg):
        plan = plan_blocks(m, cfg.bits_per_pack, dl)
        if plan.dec_len not in seen:
            seen.add(plan.dec_len)
            plans.append(plan)
    return plans


def describe(r: dict) -> str:
    """One row on one line."""
    share = "" if r["share_of_bound"] is None else \
        f" ({r['share_of_bound']:.0%} of bound {r['bound_ms']:.4f} ms)"
    gbps = "" if r["gbps"] is None else \
        f" = {r['gbps']:.3f} Gb/s, {r['ns_per_stage']:.3f} ns/stage"
    return (f"{r['channel']:6s} dec_len {r['dec_len']:5d}"
            f"{' (jax pick)' if r['jax_pick'] else ''}: {r['kernel']} "
            f"{r['metrics']}, kernel {ms(r['kernel_seconds'])}{gbps}{share}"
            f"; decode+count {ms(r['decode_check_seconds'])}; BEN "
            f"{r['ben_at_5p5dB']} of {r['message_bits']}; first call == "
            f"plain decode; {r['calls']} calls")


def row(name: str, cfg: DecoderConfig, plan: BlockPlan, words: list,
        refs: list, message_len: int, pick: int, device) -> dict:
    """One format at one dec_len: the checks, then the times."""
    m, bpp = plan.message_len, plan.bits_per_pack
    tag = f"{name} dec_len {plan.dec_len}"
    decode = Decodes()
    first = decode(words[0], cfg, plan)
    check_plain(tag, first, words[0], cfg, plan)
    ben = int(count_errors(first, refs[0], bpp, m))
    del first
    if ben / m > MAX_BER:
        raise RowMiss(f"{tag}: BER {ben / m:.3g} above {MAX_BER} "
                      f"(BEN {ben} of {m})")
    kernel = core_cuda.kernel_for(cfg, False)
    pm16 = core_cuda.runs_pm16(kernel, cfg)
    k_s = dc_s = bnd = None
    if is_card(device):
        k_s = median_s(lambda i: decode(words[i], cfg, plan), len(words))
        dc_s = median_s(lambda i: count_errors(decode(words[i], cfg, plan),
                                               refs[i], bpp, m), len(words))
        bnd = core_cuda.decode_bound_ms(words[0].numel() * 4, cfg, plan,
                                       pm16)[0]
    _, stages = tiles_stages(plan)
    return {"channel": name, "dec_len": plan.dec_len,
            "message_len": message_len, "ben_at_5p5dB": ben,
            "kernel_seconds": k_s, **rates(m, k_s, stages),
            "message_bits": m, "kernel": kernel.name,
            "metrics": "int16x2" if pm16 else "int32",
            "decode_check_seconds": dc_s, "bound_ms": bnd,
            "share_of_bound": None if k_s is None else bnd / (k_s * 1e3),
            "jax_pick": plan.dec_len == pick, "calls": decode.calls}


def measure(name: str, message_len: int, device, log) -> list:
    """A format's rows: its six workloads drawn once, then a row at each
    candidate dec_len."""
    cfg = DecoderConfig(ChannelIn[name])
    m = cfg.get_message_len(2 * message_len)
    words, refs = [], []
    for i in range(N_INPUTS):
        packs, w = packed_workload_cuda(SEED0 + i, message_len,
                                        cfg.channel_in, SNR_DB, SCALES[name],
                                        device)
        words.append(w)
        refs.append(ref_words_from_packs(packs, cfg.extra_l,
                                         -(-m // 32) * 32))
    pick = jax_pick(cfg, m)
    rows = []
    for plan in row_plans(cfg, m):
        rows.append(row(name, cfg, plan, words, refs, message_len, pick,
                        device))
        log(describe(rows[-1]))
    return rows


def run(message_len: int = MESSAGE_LEN, device="cuda", log=None) -> list:
    """Every format's rows (``measure``); raises RowMiss on a miss."""
    log = log or Log()
    return [r for name in CHANNELS
            for r in measure(name, message_len, device, log)]


def document(rows: list, message_len: int, device: str) -> dict:
    """The JSON the JAX script wrote (message_len, device, channels)."""
    return {"message_len": message_len, "device": device, "channels": rows}


def main(argv=None) -> int:
    return sweep_main(argv, "Decode throughput of every channel format "
                      "(the JAX script's workload, every candidate dec_len)",
                      run, MESSAGE_LEN, document)


if __name__ == "__main__":
    sys.exit(main())
