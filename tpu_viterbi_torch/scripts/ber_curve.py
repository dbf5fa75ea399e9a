"""BER against SNR for a set of decoder configurations (BASELINE.json's
configurations 2-3); the counterpart of ``bench/ber_curve.py``.

Each point draws its message bits and noise on the decoding device, from
``torch.Generator``s seeded with ``--seed`` and ``--seed + 1`` as the CLI's
chain seeds its source and its noise, encodes, quantizes at the curve's
informative scales (``default_scale``) and decodes through
``ViterbiGPU.run`` (K1 on the integer channels, K2 on the FP32 wire; their
plain versions with ``--device cpu``).  The draws are not JAX's threefry
draws, and the CPU's and the card's generators differ too, so a point's
BEN is comparable to the JAX run's (``bench/ber_curve_tpu.json``) only
statistically: by ``agree``, at the spread ``event_bits`` measures over
other draws of the point.  The metric width does not change a decode, so
``s8/b16`` counts ``s8/b32``'s BEN exactly.  ``--golden`` adds the plain
numpy decoder's BER at up to 200,000 bits (the reference validates only
through this curve, src/main.cpp:151-171).

    python -m tpu_viterbi_torch.scripts.ber_curve [--num 2000000]
        [--snrs -1,-0.5,0,0.5,1,1.5,2] [--configs h/b32,...] [--seed 123]
        [--golden] [--device cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import math
import statistics
import sys

import numpy as np
import torch

from ..chain.channel import add_awgn, snr_to_sigma
from ..chain.encode import conv_encode
from ..chain.quantize import quantize_and_pack, unpack_to_soft
from ..chain.source import random_bits
from ..config import ChannelIn, DecoderConfig, Metric
from ..decoder.api import ViterbiGPU
from ..decoder.golden import golden_decode_full
from ..hardware import resolve_device
from .ber_common import Launches, Log, errors, parser, sha, write_rows

# Quantizer scale a channel width, so a unit BPSK symbol takes about a
# quarter of the quantizer's range (bench/ber_curve.py:31-33): the CLI's
# 40000 saturates every soft format, which would make the soft curves the
# hard one.  HARD compares with 0, so its scale is only the reference's.
SCALES = {ChannelIn.HARD: 40000.0, ChannelIn.SOFT4: 4.0,
          ChannelIn.SOFT8: 32.0, ChannelIn.SOFT16: 8192.0,
          ChannelIn.FP32: 4.0}
# a configuration's spec, "s8/b16": channel / path-metric width (:106-108)
CHANNELS = {"h": ChannelIn.HARD, "s4": ChannelIn.SOFT4,
            "s8": ChannelIn.SOFT8, "s16": ChannelIn.SOFT16,
            "f": ChannelIn.FP32}
METRICS = {"b32": Metric.M_B32, "b16": Metric.M_B16, "f16": Metric.M_FP16}
# the JAX harness's defaults: configurations, SNRs, bits a point, seed
CONFIGS = "h/b32,s4/b32,s8/b32,s16/b32,f/b32,s4/b16,s8/b16"
SNRS = "-1,-0.5,0,0.5,1,1.5,2"
NUM = 2_000_000
SEED = 123
DEC_LEN = 2048                    # ViterbiTPU's and ViterbiGPU's default
GOLDEN_MAX_BITS = 200_000         # golden is a Python loop a stage
# agree(): the largest z, and the counts too small for a statistic; its L
# (EVENT_BITS by default) is the variance of a point's BEN over its mean,
# the bits a count's error event carries.  4 is too few on the waterfall,
# where an event flips tens of bits: ``event_bits`` measures L a point
# over the draws of SPREAD_SEEDS
EVENT_BITS = 4
MAX_Z = 4.0
FEW = 5
SPREAD_SEEDS = tuple(range(10_000, 10_064, 2))   # 32 draws; seed + 1 noise


def default_scale(channel_in: ChannelIn) -> float:
    """The curve's quantizer scale for ``channel_in`` (JAX's
    ``_default_scale``; not ``sharding.simulate.DEFAULT_SCALES``)."""
    return SCALES[channel_in]


def spec_config(spec: str) -> DecoderConfig:
    """The configuration of a spec such as "s8/b16"."""
    c, metric = spec.split("/")
    return DecoderConfig(channel_in=CHANNELS[c], metric=METRICS[metric])


def draw(message_len: int, snr_db: float, seed: int, device):
    """(message bits, noisy +-1 values) of a point on ``device``: the bits
    from a generator seeded with ``seed``, the noise (sigma =
    10^(-SNR/5)) from one seeded with ``seed + 1``."""
    dev = resolve_device(device)
    src, noise = torch.Generator(device=dev), torch.Generator(device=dev)
    src.manual_seed(seed)
    noise.manual_seed(seed + 1)
    bits = random_bits(src, message_len)
    return bits, add_awgn(noise, conv_encode(bits), snr_to_sigma(snr_db))


def decode_values(cfg: DecoderConfig, noisy: torch.Tensor, dec: ViterbiGPU):
    """(packed words, decoded host words, seconds of the decode): the
    noisy values quantized at the curve's scale and decoded by ``dec``."""
    packed = quantize_and_pack(noisy, cfg.channel_in,
                               default_scale(cfg.channel_in))
    out, seconds = dec.run(packed, noisy.shape[0])
    return packed, out, seconds


def values_point(cfg: DecoderConfig, bits: torch.Tensor,
                 noisy: torch.Tensor, dec: ViterbiGPU):
    """(BEN, message bits decoded) of a point after its noise: quantize,
    decode, count against ``bits`` from ``cfg.extra_l``."""
    _, out, _ = decode_values(cfg, noisy, dec)
    return (errors(out, cfg, bits.cpu().numpy()),
            cfg.get_message_len(noisy.shape[0]))


def run_point(cfg: DecoderConfig, message_len: int, snr_db: float,
              seed: int, device="cuda", dec: ViterbiGPU = None):
    """(BEN, message bits decoded) of one point; ``dec`` defaults to a new
    ``ViterbiGPU(cfg, dec_len=DEC_LEN)`` on ``device``.  The draws are the
    port's (``draw``), not JAX's: compare counts with ``agree``."""
    if dec is None:
        dec = ViterbiGPU(cfg, dec_len=DEC_LEN, device=device)
    return values_point(cfg, *draw(message_len, snr_db, seed, device), dec)


def golden_point(cfg: DecoderConfig, message_len: int, snr_db: float,
                 seed: int, device="cuda"):
    """(BEN, message bits decoded) of the plain numpy decoder on a point
    drawn at min(message_len, GOLDEN_MAX_BITS) bits: the words unpacked to
    soft values, one block over the whole message, the bits compared from
    ``cfg.extra_l``."""
    n = min(message_len, GOLDEN_MAX_BITS)
    bits, noisy = draw(n, snr_db, seed, device)
    packed = quantize_and_pack(noisy, cfg.channel_in,
                               default_scale(cfg.channel_in))
    r = unpack_to_soft(packed, cfg.channel_in)[: 2 * n].reshape(-1, 2)
    m = cfg.get_message_len(2 * n)
    got = golden_decode_full(r.cpu().numpy().astype(np.int64), m)
    want = bits.cpu().numpy()[cfg.extra_l: cfg.extra_l + m]
    return int(np.count_nonzero(got != want)), m


def event_bits(cfg: DecoderConfig, message_len: int, snr_db: float,
               seeds=SPREAD_SEEDS, device="cuda",
               dec: ViterbiGPU = None) -> float:
    """L of a point: the variance of its BEN over the draws of ``seeds``
    over their mean (0.0 when no draw has an error).  Independent errors
    give 1; an error event of k bits, about k."""
    bens = [run_point(cfg, message_len, snr_db, s, device, dec)[0]
            for s in seeds]
    mean = statistics.fmean(bens)
    return statistics.variance(bens) / mean if mean else 0.0


def z_score(ben_a: int, bits_a: int, ben_b: int, bits_b: int,
            events: float = EVENT_BITS) -> float:
    """|r_a - r_b| / sqrt(L (B_a / n_a^2 + B_b / n_b^2)), r = B / n, L =
    ``events``: the gap of two BERs in standard deviations of their
    counts (0 when both are 0; infinite for a gap where L is 0)."""
    var = events * (ben_a / bits_a ** 2 + ben_b / bits_b ** 2)
    gap = abs(ben_a / bits_a - ben_b / bits_b)
    if not var:
        return math.inf if gap else 0.0
    return gap / math.sqrt(var)


def agree(ben_a: int, bits_a: int, ben_b: int, bits_b: int,
          events: float = EVENT_BITS) -> bool:
    """Two points of a curve agree: both counts <= FEW, or z <= MAX_Z at L
    = ``events``."""
    return max(ben_a, ben_b) <= FEW or \
        z_score(ben_a, bits_a, ben_b, bits_b, events) <= MAX_Z


def main(argv=None) -> int:
    p = parser("BER against SNR for a set of decoder configurations (the "
               "JAX harness's flags, seed and scales)")
    p.add_argument("--num", type=int, default=NUM)
    # this project's SNR convention is sigma = 10^(-SNR/5) (main.cpp:135):
    # the waterfall sits around -1..+2 "dB"
    p.add_argument("--snrs", type=str, default=SNRS)
    p.add_argument("--configs", type=str, default=CONFIGS)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--golden", action="store_true",
                   help="add the plain numpy decoder's BER (slow: at most "
                        f"{GOLDEN_MAX_BITS} bits)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    snrs = [float(s) for s in args.snrs.split(",")]
    log = Log()
    log(f"device: {dev}; {args.num} bits a point, seed {args.seed}, "
        f"dec_len {DEC_LEN}")
    rows = []
    for spec in args.configs.split(","):
        cfg = spec_config(spec)
        dec = ViterbiGPU(cfg, dec_len=DEC_LEN, device=dev)
        for snr in snrs:
            bits, noisy = draw(args.num, snr, args.seed, dev)
            launches = Launches()
            _, out, seconds = decode_values(cfg, noisy, dec)
            kernels = launches.describe(cfg)
            m = cfg.get_message_len(2 * args.num)
            ben = errors(out, cfg, bits.cpu().numpy())
            row = {"config": spec, "snr_db": snr, "ben": ben, "bits": m,
                   "ber": ben / m, "kernels": kernels, "words": sha(out)}
            if dev.type == "cuda":
                row["ms"] = seconds * 1e3
            if args.golden:
                gben, gm = golden_point(cfg, args.num, snr, args.seed, dev)
                row.update(golden_ber=gben / gm, golden_ben=gben,
                           golden_bits=gm)
            rows.append(row)
            print(f"{spec:8s} snr={snr:4.1f}  BEN={ben:9d}  "
                  f"BER={ben/m:.3e}"
                  + (f"  golden={row['golden_ber']:.3e}"
                     if args.golden else ""), flush=True)
    write_rows(rows, args.out, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
