"""Quantizer / packer and the matching unpacker.

Reference semantics (src/viterbiDF.h:98-167, SoftDecisionPacker):
  - every float is scaled by ``scale`` (40000.0 in the reference main
    program, main.cpp:137);
  - HARD:   v > 0 -> 1 else 0 (strict greater-than);
  - SOFT4:  round-to-nearest(-even) then saturate to [-8, 7], keep 4 bits;
  - SOFT8:  saturate to [-128, 127], keep 8 bits;
  - SOFT16: saturate to [-32768, 32767], keep 16 bits;
  - FP32:   scaled floats pass through unpacked;
  - packing is MSB = earliest-in-time into int32 words (viterbiDF.h:157-163).

Rounding: ``torch.round`` rounds half to even, like the reference's lrintf
in the default FP environment and the JAX package's ``jnp.rint``.  Packing
is shifts and ORs (the JAX package packs with banded MXU matmuls instead,
a TPU layout workaround).  Field values are held in int64, so the uint32
word arithmetic never meets a sign bit.
"""

from __future__ import annotations

import torch

from ..config import FP_PRECISION, ChannelIn
from ..utils.bits import to_int32_bits
from .pipeline import ComputeElement

_QUANT_PARAMS = {
    ChannelIn.SOFT4: (4, -8, 7),
    ChannelIn.SOFT8: (8, -128, 127),
    ChannelIn.SOFT16: (16, -32768, 32767),
}


def quantize_fields(values: torch.Tensor, channel_in: ChannelIn,
                    scale: float = 1.0):
    """(n,) float soft values -> ((n,) int64 masked field values, width).
    The scale/round/saturate/mask stage of the packer without the packing
    (reference: quantFuncs, viterbiDF.h:105-125)."""
    v = values.to(torch.float32) * scale
    if channel_in == ChannelIn.HARD:
        return (v > 0.0).to(torch.int64), 1
    width, lo, hi = _QUANT_PARAMS[channel_in]
    q = torch.clamp(torch.round(v), lo, hi).to(torch.int64)
    return q & ((1 << width) - 1), width


def quantize_and_pack(values: torch.Tensor, channel_in: ChannelIn,
                      scale: float = 1.0) -> torch.Tensor:
    """(n,) float soft values -> packed int32 words (or scaled float32 for
    FP32).  n is zero-padded up to a whole number of words."""
    if channel_in == ChannelIn.FP32:
        return values.to(torch.float32) * scale
    q, width = quantize_fields(values, channel_in, scale)
    per_word = 32 // width
    n_pad = (-q.shape[0]) % per_word
    if n_pad:
        q = torch.cat([q, q.new_zeros(n_pad)])
    fields = q.view(-1, per_word)
    words = torch.zeros_like(fields[:, 0])
    for j in range(per_word):               # MSB = earliest field
        words = (words << width) | fields[:, j]
    return to_int32_bits(words)


def unpack_to_soft(packed: torch.Tensor, channel_in: ChannelIn) -> torch.Tensor:
    """Packed words -> per-value soft tensor.

    HARD   -> int32 in {-1, +1} (BPSK re-map of the hard bits)
    SOFT4  -> int32 in [-8, 7]      (sign-extended nibbles)
    SOFT8  -> int32 in [-128, 127]
    SOFT16 -> int32 in [-32768, 32767]
    FP32   -> float32 clamped to [-2^(FPprecision-1), 2^(FPprecision-1)-1]
              (clamp semantics of the reference kernel, viterbiBM.cuh:139-151)
    """
    if channel_in == ChannelIn.FP32:
        lo = -(1 << (FP_PRECISION - 1))
        hi = (1 << (FP_PRECISION - 1)) - 1
        return packed.to(torch.float32).clamp(lo, hi)
    words = packed.to(torch.int64) & 0xFFFFFFFF
    width = 1 if channel_in == ChannelIn.HARD else _QUANT_PARAMS[channel_in][0]
    per_word = 32 // width
    shifts = torch.arange(per_word - 1, -1, -1, device=words.device) * width
    vals = ((words[:, None] >> shifts) & ((1 << width) - 1)).reshape(-1)
    if channel_in == ChannelIn.HARD:
        return (vals * 2 - 1).to(torch.int32)
    half = 1 << (width - 1)
    return (((vals + half) & ((1 << width) - 1)) - half).to(torch.int32)


class SoftDecisionPacker(ComputeElement):
    def __init__(self, channel_in: ChannelIn, scale: float = 1.0):
        super().__init__()
        self.channel_in = ChannelIn(channel_in)
        self.scale = float(scale)

    def process(self, soft_values):
        return quantize_and_pack(soft_values, self.channel_in, self.scale)
