"""Trellis tables for the K=7, rate-1/2 convolutional code (0o171 / 0o133).

A numpy-only copy of ``tpu_viterbi/trellis.py``: both stacks must agree on
these tables bit for bit.  The reference derives per-lane branch-metric
index streams with warp bit tricks at kernel start (reference:
src/viterbi/viterbiBM.cuh:189-207, `bmIndCalc`); here they are plain numpy
tables, and the CUDA kernel folds the same signs into constants at compile
time.

State convention (differs from the reference's internal shift-register
layout but produces the identical code / identical decoded bits):

  state sigma_t = sum_{i=0..5} b_{t-i} << i        (newest input bit at LSB)

With this convention the two trellis predecessors of state ``s`` are
``(s >> 1)`` and ``(s >> 1) + 32`` — i.e. the gathered predecessor-metric
vectors are simple pairwise row repeats of the lower/upper half of the state
axis.  In the one-thread-per-block CUDA kernel every state lives in its own
register, so the reference's `__shfl_xor_sync` butterfly network and its
6-cycle shuffle-exchange layout (viterbiACS.cuh:418-448, 461-480) become
plain register renaming.
"""

from __future__ import annotations

import numpy as np

from .config import CONST_LEN, NUM_STATES, POLY1, POLY2


def _reverse_bits(x: int, width: int) -> int:
    r = 0
    for i in range(width):
        if x & (1 << i):
            r |= 1 << (width - 1 - i)
    return r


# Polynomials with taps re-indexed for the newest-bit-at-LSB window layout.
# The reference applies polys to a buffer with the newest bit at bit K-1
# (viterbiDF.h:50-51); our 7-bit window w = (b_{t-6} << 6) | sigma_t holds the
# newest bit at bit 0, so the tap masks are the bit-reversed polynomials.
POLY1_REV = _reverse_bits(POLY1, CONST_LEN)  # 0o117
POLY2_REV = _reverse_bits(POLY2, CONST_LEN)  # 0o155


def _parity(x: np.ndarray) -> np.ndarray:
    r = np.zeros_like(x)
    for i in range(CONST_LEN):
        r ^= (x >> i) & 1
    return r


def branch_code_table() -> np.ndarray:
    """(64, 2) int32 table: c[state, j] = 2*out0 + out1 for the transition
    into ``state`` whose dropped oldest bit is ``j`` (= b_{t-6}).

    ``c`` indexes the 4 branch-metric hypotheses exactly as the reference's
    bmInd = (out0 << 1) | out1 (viterbiBM.cuh:195-206).
    """
    s = np.arange(NUM_STATES, dtype=np.int64)[:, None]          # (64, 1)
    j = np.arange(2, dtype=np.int64)[None, :]                   # (1, 2)
    window = (j << (CONST_LEN - 1)) | s                         # 7-bit window
    out0 = _parity(window & POLY1_REV)
    out1 = _parity(window & POLY2_REV)
    return ((out0 << 1) | out1).astype(np.int32)


def branch_sign_table() -> np.ndarray:
    """(64, 2, 2) int32 table of BPSK signs: sign[state, j, k] = +1 if the
    expected coded bit k for the transition (state, j) is 1 else -1.

    Used to form branch metrics as correlations sign0*r0 + sign1*r1, which is
    what the reference's dp2a/dp4a coefficient tricks compute
    (viterbiBM.cuh:45-124).
    """
    c = branch_code_table()
    out0 = (c >> 1) & 1
    out1 = c & 1
    return np.stack([2 * out0 - 1, 2 * out1 - 1], axis=-1).astype(np.int32)


def encode_output_table() -> np.ndarray:
    """(128,) int32: for a 7-bit encoder register in *reference* layout
    (newest bit at bit 6, viterbiDF.h:50-51), the coded pair (out0<<1)|out1."""
    buf = np.arange(1 << CONST_LEN, dtype=np.int64)
    out0 = _parity(buf & POLY1)
    out1 = _parity(buf & POLY2)
    return ((out0 << 1) | out1).astype(np.int32)


# Static constants used by the decoder cores.
BRANCH_CODE = branch_code_table()          # (64, 2)  values in {0,1,2,3}
BRANCH_CODE_J0 = BRANCH_CODE[:, 0]         # (64,)
BRANCH_CODE_J1 = BRANCH_CODE[:, 1]         # (64,)
