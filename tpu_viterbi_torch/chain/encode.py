"""Convolutional encoder, vectorized (no Python loop over bits).

Reference semantics (src/viterbiDF.h:36-63): a K-bit shift register where the
newest bit enters at bit K-1 (`buffer >>= 1; buffer |= bit << (K-1)`), two
parity outputs per input bit from XOR-popcount of `buffer & poly{1,2}`, coded
output interleaved [out0, out1] per stage with poly 0o171 first, and the
register starting at zero (bits before t=0 are 0).

As in ``tpu_viterbi/chain/encode.py``: out_k[t] = XOR over tap offsets d of
bit[t-d], computed with shifted views of the zero-padded bit tensor — one
XOR per polynomial tap for the whole message.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CONST_LEN, POLY1, POLY2
from .pipeline import ComputeElement


def _tap_offsets(poly: int) -> list:
    """Delay d of each tap: reference buffer bit (K-1-d) holds input bit t-d."""
    return [CONST_LEN - 1 - b for b in range(CONST_LEN) if (poly >> b) & 1]


_TAPS0 = _tap_offsets(POLY1)
_TAPS1 = _tap_offsets(POLY2)


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """Encode (n,) {0,1} bits -> (2n,) uint8 coded bits, interleaved
    [out0, out1]."""
    bits = bits.to(torch.uint8)
    n = bits.shape[0]
    padded = torch.cat([bits.new_zeros(CONST_LEN - 1), bits])

    def parity(taps):
        acc = torch.zeros_like(bits)
        for d in taps:
            acc ^= padded[CONST_LEN - 1 - d: CONST_LEN - 1 - d + n]
        return acc

    return torch.stack([parity(_TAPS0), parity(_TAPS1)], dim=1).reshape(2 * n)


def conv_encode_np(bits: np.ndarray) -> np.ndarray:
    """NumPy twin of conv_encode for golden-model tests."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[0]
    padded = np.pad(bits, (CONST_LEN - 1, 0))

    def parity(taps):
        acc = np.zeros((n,), dtype=np.uint8)
        for d in taps:
            acc ^= padded[CONST_LEN - 1 - d: CONST_LEN - 1 - d + n]
        return acc

    out = np.empty(2 * n, dtype=np.uint8)
    out[0::2] = parity(_TAPS0)
    out[1::2] = parity(_TAPS1)
    return out


class ConvolutionalEncoder(ComputeElement):
    def __init__(self, const_len: int = CONST_LEN, poly1: int = POLY1,
                 poly2: int = POLY2):
        super().__init__()
        if (const_len, poly1, poly2) != (CONST_LEN, POLY1, POLY2):
            raise NotImplementedError(
                "framework is specialized for K=7, polys 0o171/0o133 "
                "(matching the reference build)")

    def process(self, bits):
        return conv_encode(bits)
