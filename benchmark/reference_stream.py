"""A frozen copy of the definition of the channel streams, in plain PyTorch:
message bits -> K=7 rate-1/2 encode (0o171, 0o133) -> BPSK -> AWGN ->
quantize -> packed words.  The benchmark makes every rx cell's inputs with
it, and the reference re-draws the in-graph simulation's inputs with it.

The streams are defined by counters, so every value is a function of the
key and its position:

- threefry2x32 at 13 rounds (rotations 13, 15, 26, 6, 17, 29, 16, 24; a
  key injection after every fourth round and after the last);
- message-bit pack p (32 bits, MSB = earliest): word p & 1 of the call on
  counter (p >> 1, 1); bits past the message are 0;
- the noise of stage t: the call on counter (t // s, 2 + t % s), s the
  stages a channel word holds (1 on the FP32 wire), through Box-Muller over
  24-bit uniforms: u1 = (x0 & 0xFFFFFF) + 1) * 2^-24, u2 = (x1 & 0xFFFFFF) *
  2^-24, r = sqrt(-2 log u1), z0 = r cos(2 pi u2) for the first coded value
  and z1 = r sin(2 pi u2) for the second;
- a coded value is sym * scale + (scale * sigma) * z in float32, each
  operation rounded once, sym = +1 for a coded 1 and -1 for a 0, sigma =
  10^(-SNR/5) (the reference's ``main.cpp:135``);
- HARD keeps v > 0; SOFT4/8/16 round half to even and saturate to their
  signed field; fields are packed MSB = earliest into 32-bit words; the
  FP32 wire carries the values themselves, [r0, r1] a stage.

Imports torch and numpy only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .framing import OFFSET

M32 = 0xFFFFFFFF
ROUNDS = 13
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
BITS_TAG = 1
NOISE_TAG = 2
POLY = (0o171, 0o133)          # newest bit at the polynomial's bit 6
CONST_LEN = 7
TWO_PI_F32 = float(np.float32(2.0 * math.pi))
CHUNK_STAGES = 1 << 22         # stages made at once: bounds the temporaries


@dataclass(frozen=True)
class Channel:
    """A channel format: ``width`` bits a field (0: the f32 wire), its
    saturation range, and values a 32-bit word."""

    name: str
    width: int
    lo: int = 0
    hi: int = 0

    @property
    def values_per_word(self) -> int:
        return 32 // self.width if self.width else 1

    @property
    def stages_per_word(self) -> int:
        return max(1, self.values_per_word // 2)


CHANNELS = {c.name: c for c in (
    Channel("HARD", 1), Channel("SOFT4", 4, -8, 7),
    Channel("SOFT8", 8, -128, 127), Channel("SOFT16", 16, -32768, 32767),
    Channel("FP32", 0))}


def sigma_of(snr_db: float) -> float:
    """Noise deviation of the reference's SNR convention; 0 when noiseless."""
    return 0.0 if math.isinf(snr_db) else float(10.0 ** (-snr_db / 5.0))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, c0, c1, rounds: int = ROUNDS):
    """threefry2x32 on counters (c0, c1), uint32 values held in int64
    tensors (or ints for c1): -> (x0, x1) int64 tensors of uint32 values."""
    k0, k1 = int(k0) & M32, int(k1) & M32
    ks = (k0, k1, 0x1BD11BDA ^ k0 ^ k1)
    x0 = (torch.as_tensor(c0, dtype=torch.int64) + k0) & M32
    x1 = (torch.as_tensor(c1, dtype=torch.int64, device=x0.device)
          + k1) & M32
    x1 = x1.expand_as(x0)
    done = group = 0
    while done < rounds:
        step = min(4, rounds - done)
        for i in range(step):
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, ROTATIONS[4 * (group % 2) + i]) ^ x0
        done += step
        group += 1
        x0 = (x0 + ks[group % 3]) & M32
        x1 = (x1 + ks[(group + 1) % 3] + group) & M32
    return x0, x1


def message_packs(key, n: int, device) -> torch.Tensor:
    """The ceil(n / 32) message-bit packs, int64 tensor of uint32 values,
    bits past n zeroed."""
    p = torch.arange(-(-n // 32), device=device, dtype=torch.int64)
    x0, x1 = threefry2x32(key[0], key[1], p >> 1, BITS_TAG)
    packs = torch.where((p & 1) == 1, x1, x0)
    keep = torch.clamp(n - 32 * p, 0, 32)
    return packs & ((M32 << (32 - keep)) & M32)


def _bits_at(packs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Message bits at stages ``t`` (0 before the first), int64."""
    tc = t.clamp(min=0)
    bit = (packs[tc >> 5] >> (31 - (tc & 31))) & 1
    return torch.where(t < 0, 0, bit)


def coded_bits(packs: torch.Tensor, t: torch.Tensor):
    """The encoder's two coded bits at stages ``t``: parity of the register
    whose bit 6 - d holds message bit t - d, masked by each polynomial."""
    out = []
    for poly in POLY:
        acc = torch.zeros_like(t)
        for b in range(CONST_LEN):
            if (poly >> b) & 1:
                acc = acc ^ _bits_at(packs, t - (CONST_LEN - 1 - b))
        out.append(acc)
    return out


def normal_pair(x0: torch.Tensor, x1: torch.Tensor):
    """Box-Muller over 24-bit uniforms, each float32 operation rounded
    once."""
    two24 = 2.0 ** -24
    u1 = ((x0 & 0xFFFFFF).to(torch.float32) + 1.0) * two24
    u2 = (x1 & 0xFFFFFF).to(torch.float32) * two24
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = TWO_PI_F32 * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _values(key, packs, t, channel: Channel, scale: float, sigma: float):
    """The two coded values of stages ``t`` as float32 (r0, r1)."""
    f_scale = float(np.float32(scale))
    f_nscale = float(np.float32(scale * sigma))
    spw = channel.stages_per_word
    zs = (None, None)
    if sigma:
        zs = normal_pair(*threefry2x32(key[0], key[1], t // spw,
                                       NOISE_TAG + t % spw))
    out = []
    for bit, z in zip(coded_bits(packs, t), zs):
        v = (bit.to(torch.float32) * 2.0 - 1.0) * f_scale
        out.append(v if z is None else v + f_nscale * z)
    return out


def _fields(v: torch.Tensor, channel: Channel) -> torch.Tensor:
    if channel.width == 1:
        return (v > 0.0).to(torch.int64)
    q = torch.clamp(torch.round(v), channel.lo, channel.hi).to(torch.int64)
    return q & ((1 << channel.width) - 1)


def stream(key, n: int, channel: Channel, snr_db: float, scale: float,
           device):
    """-> (message packs, the channel stream): ceil(2n / vpw) int32 words,
    or 2n float32 values on the FP32 wire, made a chunk of stages at a
    time."""
    sigma = sigma_of(snr_db)
    packs = message_packs(key, n, device)
    spw = channel.stages_per_word
    if channel.width == 0:
        size, dtype = 2 * n, torch.float32
    else:
        size, dtype = -(-2 * n // channel.values_per_word), torch.int32
    out = torch.empty(size, dtype=dtype, device=device)
    stages = size // 2 if channel.width == 0 else size * spw
    step = CHUNK_STAGES - CHUNK_STAGES % spw
    for a in range(0, stages, step):
        t = torch.arange(a, min(stages, a + step), device=device,
                         dtype=torch.int64)
        r0, r1 = _values(key, packs, t, channel, scale, sigma)
        if channel.width == 0:
            out[2 * a: 2 * a + 2 * t.shape[0]] = torch.stack(
                [r0, r1], 1).reshape(-1)
            continue
        ok = t < n
        f = torch.stack([torch.where(ok, _fields(r, channel), 0)
                         for r in (r0, r1)], 1).reshape(-1, 2 * spw)
        word = torch.zeros(f.shape[0], dtype=torch.int64, device=device)
        for k in range(2 * spw):
            word = word | (f[:, k] << (32 - (k + 1) * channel.width))
        out[a // spw: a // spw + f.shape[0]] = to_int32(word)
    return packs, out


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in an int64 tensor -> the same bit patterns as int32."""
    x = x & M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def reference_words(packs: torch.Tensor, message_len: int,
                    bits_per_pack: int = 32) -> torch.Tensor:
    """The words an error-free decode gives: decoded bit i is message bit i
    + ``OFFSET``, packed MSB = earliest into ``bits_per_pack``-bit words, as
    an int64 tensor of unsigned values."""
    i = torch.arange(message_len, device=packs.device, dtype=torch.int64)
    bits = _bits_at(packs, i + OFFSET).view(-1, bits_per_pack)
    weights = torch.arange(bits_per_pack - 1, -1, -1, device=packs.device)
    return (bits << weights).sum(1)
