"""Randomized fuzz of the decode kernels on the card; the counterpart of
``scripts/fuzz_tpu.py``, with its trials and seeds.

``trial``: a random ``ALL_VALID_CONFIGS`` entry with ``CompMode.REG``,
message length and ``dec_len``, on full-range random words (FP32: values
in [-8, 8)); ``core_cuda.decode_packed_cuda`` (K1, K2 on FP32) must be
bit-equal to ``core_torch.decode_packed_torch`` on the same device.

``wtrial``: coded input (random message -> ``conv_encode_np`` -> AWGN ->
``quantize_and_pack`` at ``DEFAULT_SCALES``), ``dec_len`` of at least 64
stages; the window (K3) must be bit-equal to the full store (K1/K2).  On
random words that are no code the two may differ (unmerged paths), so
this family decodes coded streams only.

The draws are the JAX script's (numpy's generator at the same seeds), so
each trial decodes the words the JAX script's trial decodes.  On
``--device cpu`` the wrappers run their plain versions.

    python -m tpu_viterbi_torch.scripts.fuzz_gpu [n_trials] [seed0]
        [n_window_trials] [--device cuda|cpu]

Exits 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..chain.encode import conv_encode_np
from ..chain.quantize import quantize_and_pack
from ..config import (ALL_VALID_CONFIGS, ChannelIn, CompMode, DecodeOut,
                      DecoderConfig)
from ..decoder.core_cuda import decode_packed_cuda
from ..decoder.core_torch import decode_packed_torch, plan_blocks
from ..hardware import resolve_device
from ..sharding.simulate import DEFAULT_SCALES
from .ber_common import Launches, Log

N_TRIALS, SEED0 = 24, 5000       # the JAX script's defaults
WINDOW_SEED_OFFSET = 10_000      # window trials draw from seed0 + this


def seeds(n: int = N_TRIALS, seed0: int = SEED0, n_win: int = None):
    """-> (the trials' seeds, the window trials' seeds): n from seed0, and
    n_win (default max(8, n // 2)) from seed0 + WINDOW_SEED_OFFSET."""
    n_win = max(8, n // 2) if n_win is None else n_win
    w0 = seed0 + WINDOW_SEED_OFFSET
    return range(seed0, seed0 + n), range(w0, w0 + n_win)


WINDOW_CHANNELS = (ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT8,
                   ChannelIn.SOFT16, ChannelIn.FP32)


def trial_case(seed: int):
    """(cfg, plan, words) of ``fuzz_tpu.trial`` at ``seed``: numpy int32
    words, or float32 values on FP32."""
    rng = np.random.default_rng(seed)
    cfgs = [c for c in ALL_VALID_CONFIGS if c.comp_mode == CompMode.REG]
    cfg = cfgs[rng.integers(len(cfgs))]
    bpp = cfg.bits_per_pack
    message_len = int(rng.integers(4, 200)) * bpp
    dec_len = int(rng.integers(1, 12)) * bpp
    plan = plan_blocks(message_len, bpp, dec_len)
    n_vals = 2 * (message_len + 64)
    if cfg.channel_in == ChannelIn.FP32:
        words = rng.integers(-8, 8, size=(n_vals,)).astype(np.float32)
    else:
        words = rng.integers(-2 ** 31, 2 ** 31, size=(
            n_vals // cfg.enc_data_per_pack,)).astype(np.int32)
    return cfg, plan, words


def wtrial_case(seed: int):
    """(cfg, plan, packed words as a CPU tensor, sigma) of
    ``fuzz_tpu.wtrial`` at ``seed``."""
    rng = np.random.default_rng(seed)
    ch = WINDOW_CHANNELS[rng.integers(len(WINDOW_CHANNELS))]
    out = DecodeOut.O_B16 if rng.integers(2) else DecodeOut.O_B32
    cfg = DecoderConfig(channel_in=ch, decode_out=out)
    bpp = cfg.bits_per_pack
    n = int(rng.integers(40, 400)) * bpp
    sigma = float(rng.uniform(0.0, 0.6))
    bits = rng.integers(0, 2, n).astype(np.uint8)
    sym = 2 * conv_encode_np(bits).astype(np.float32) - 1
    if sigma:
        sym = sym + rng.normal(0, sigma, sym.shape).astype(np.float32)
    packed = quantize_and_pack(torch.from_numpy(sym), ch, DEFAULT_SCALES[ch])
    m = cfg.get_message_len(2 * n)
    # dec_len >= 64 stages keeps the roll-halo fused path of the JAX
    # kernel in play
    plan = plan_blocks(m, bpp, int(rng.integers(max(2, 64 // bpp + 1), 12))
                       * bpp)
    return cfg, plan, packed, sigma


def trial(i: int, seed: int, device, log) -> bool:
    cfg, plan, words = trial_case(seed)
    x = torch.from_numpy(words).to(device)
    want = decode_packed_torch(x, cfg, plan)
    launches = Launches()
    got = decode_packed_cuda(x, cfg, plan)
    ok = torch.equal(got, want)
    log(f"trial {i:3d}: {cfg.channel_in.name:6s}/{cfg.metric.name:6s}/"
        f"{cfg.decode_out.name} m={plan.message_len:5d} dec_len="
        f"{plan.dec_len:4d} blocks={plan.num_blocks:3d} "
        f"[{launches.describe(cfg)}] -> {'OK' if ok else 'MISMATCH'}")
    return ok


def wtrial(i: int, seed: int, device, log) -> bool:
    cfg, plan, packed, sigma = wtrial_case(seed)
    x = packed.to(device)
    launches = Launches()
    full = decode_packed_cuda(x, cfg, plan, window=False)
    win = decode_packed_cuda(x, cfg, plan, window=True)
    ok = torch.equal(full, win)
    log(f"wtrial {i:3d}: {cfg.channel_in.name:6s}/{cfg.decode_out.name} "
        f"m={plan.message_len:5d} dec_len={plan.dec_len:4d} sigma="
        f"{sigma:.2f} blocks={plan.num_blocks:3d} "
        f"[{launches.describe(cfg)}] -> {'OK' if ok else 'MISMATCH'}")
    return ok


def run(n: int = N_TRIALS, seed0: int = SEED0, n_win: int = None,
        device="cuda", log=None):
    """-> (trials that held, trials run): the trials and window trials of
    ``seeds(n, seed0, n_win)``."""
    log = log or Log()
    device = resolve_device(device)
    plain, window = seeds(n, seed0, n_win)
    good = sum(trial(i, s, device, log) for i, s in enumerate(plain))
    good += sum(wtrial(i, s, device, log) for i, s in enumerate(window))
    return good, len(plain) + len(window)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Randomized fuzz of the decode "
                                "kernels against the plain core")
    p.add_argument("n_trials", nargs="?", type=int, default=N_TRIALS)
    p.add_argument("seed0", nargs="?", type=int, default=SEED0)
    p.add_argument("n_window_trials", nargs="?", type=int, default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    good, total = run(args.n_trials, args.seed0, args.n_window_trials,
                      args.device)
    print(f"{good}/{total} trials OK")
    return 0 if good == total else 1


if __name__ == "__main__":
    sys.exit(main())
