"""The in-graph simulation's element-chain workload: message bits -> packed
channel words with flat streams end to end, the counterpart of
``tpu_viterbi/chain/workload.py`` (the JAX package's generator ``xla``;
the port's generator ``torch``).

The chain's own functions do the work: ``conv_encode`` gives the coded
stream already interleaved [out0, out1] per stage, which is the word
format's field order, so ``quantize_and_pack`` packs it by shifts and ORs.
The TPU's (n, 2)-pair workarounds (banded-matrix packing, one-hot
interleave) have nothing to avoid here.

Draws come from the ``torch.Generator`` the caller passes (message bits,
then noise), so the streams equal the JAX package's only at sigma = 0 for
the same bits, and statistically under noise.
"""

from __future__ import annotations

import math

import torch

from ..config import ChannelIn
from .channel import add_awgn, snr_to_sigma
from .encode import conv_encode
from .quantize import quantize_and_pack
from .source import random_bits


def packed_workload(generator: torch.Generator, n: int,
                    channel_in: ChannelIn, snr_db: float, scale: float):
    """-> (message bits (n,) uint8, packed channel words (ceil(2n/vpw),)
    int32; for FP32 the (2n,) interleaved scaled f32 values), on the
    generator's device.  snr_db = inf is the noiseless channel."""
    bits = random_bits(generator, n)
    sigma = 0.0 if math.isinf(snr_db) else snr_to_sigma(snr_db)
    symbols = add_awgn(generator, conv_encode(bits), sigma)
    return bits, quantize_and_pack(symbols, channel_in, scale)
