"""Bit packing/unpacking and BER accounting helpers.

Conventions follow the reference main program exactly: decoded output
packs hold the earliest bit in the MSB (reference: main.cpp:160 unpacks
bit i as word[i/bpp] >> (bpp-1 - i%bpp)), and decoded bit i corresponds to
original message bit i + extra_l (main.cpp:161).

The numpy helpers are copies of ``tpu_viterbi/utils/bits.py``;
``count_bit_errors`` is plain torch and runs where its tensors live, so a
32M-bit BER never leaves the device.
"""

from __future__ import annotations

import numpy as np
import torch


def extreme_field_words(rng: np.random.Generator, n: int,
                        width: int) -> np.ndarray:
    """n int32 channel words whose ``width``-bit fields all sit at their
    extremes, the worst case of a decoder's path metrics: a quarter all
    minimum (0x80808080 for 8-bit fields), a quarter all maximum
    (0x7F7F7F7F), half with each field at its minimum or maximum at random.
    HARD's 1-bit fields are extreme whatever they are: random words."""
    if width == 1:
        return rng.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int32)
    lo, hi = 1 << (width - 1), (1 << (width - 1)) - 1
    per = 32 // width
    fields = np.where(rng.random((n, per)) < 0.5, lo, hi).astype(np.int64)
    kind = rng.integers(0, 4, size=n)
    fields[kind == 0] = lo
    fields[kind == 1] = hi
    words = np.zeros(n, dtype=np.int64)
    for j in range(per):                      # MSB = earliest field
        words = (words << width) | fields[:, j]
    return (words - ((words >> 31) << 32)).astype(np.int32)


def extreme_wire(rng: np.random.Generator, n: int) -> np.ndarray:
    """n f32 values of the FP32 channel's wire at and past the decoders'
    [-8, 7] clamp: noise around -100, 100, 7 and -8, with 10 % NaN and 5 %
    each of +inf and -inf."""
    x = (rng.choice([-100.0, 100.0, 7.0, -8.0], size=n) +
         rng.standard_normal(n)).astype(np.float32)
    u = rng.random(n)
    x[u < 0.1] = np.nan
    x[(u >= 0.1) & (u < 0.15)] = np.inf
    x[(u >= 0.15) & (u < 0.2)] = -np.inf
    return x


def unpack_msb_first(words: np.ndarray, bits_per_pack: int) -> np.ndarray:
    """Packed words -> (n*bpp,) bits, earliest (MSB) first."""
    w = np.asarray(words).astype(np.int64) & ((1 << bits_per_pack) - 1)
    shifts = np.arange(bits_per_pack - 1, -1, -1)
    return ((w[:, None] >> shifts[None, :]) & 1).astype(np.uint8).reshape(-1)


def pack_msb_first(bits: np.ndarray, bits_per_pack: int) -> np.ndarray:
    """(n,) bits -> packed words, earliest bit in MSB."""
    bits = np.asarray(bits, dtype=np.int64).reshape(-1, bits_per_pack)
    shifts = np.arange(bits_per_pack - 1, -1, -1)
    words = (bits << shifts[None, :]).sum(axis=1)
    dtype = np.uint16 if bits_per_pack == 16 else np.uint32
    return words.astype(dtype)


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns
    (the uint32 words, as torch holds them)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 element holding a value below 2^32 (SWAR:
    2-, 4- and 8-bit partial sums, then the bytes folded by shifts — no
    multiply, so nothing can overflow int64)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def count_bit_errors(decoded_words: torch.Tensor, bits_per_pack: int,
                     message_bits: torch.Tensor, offset: int) -> int:
    """BEN: errors of the decoded stream vs message_bits[offset:...]
    (reference BER loop: main.cpp:151-171).

    decoded_words holds the pack bit patterns in any integer dtype (int32
    for b32 packs); message_bits is the (n,) {0,1} source stream.  The
    reference bits are packed MSB-first on their own device, XORed with the
    decoded words and popcounted there; only the count reaches the host."""
    bpp = bits_per_pack
    ref = message_bits[offset:]
    n_bits = min(decoded_words.shape[0] * bpp, ref.shape[0])
    n_words = -(-n_bits // bpp)
    dec = decoded_words[:n_words].to(torch.int64) & ((1 << bpp) - 1)
    ref = ref[:n_bits].to(torch.int64)
    tail = n_words * bpp - n_bits
    if tail:
        ref = torch.cat([ref, ref.new_zeros(tail)])
    cols = ref.view(n_words, bpp)
    packed = torch.zeros_like(dec)
    for j in range(bpp):                  # MSB = earliest bit
        packed = (packed << 1) | cols[:, j]
    diff = dec ^ packed
    if tail:                              # bits past the message: not counted
        diff[-1] &= ((1 << bpp) - 1) ^ ((1 << tail) - 1)
    return int(_popcount32(diff).sum())
