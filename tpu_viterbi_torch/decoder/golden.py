"""Golden (oracle) Viterbi decoders in plain NumPy.

The reference project has no unit-level oracle (its only check is end-to-end
BER, src/main.cpp:151-171).  This module provides one: a straightforward
stage-by-stage Viterbi with an explicit decision matrix and a bit-level
path-following traceback.  It shares only the *contract* with the production
cores (state convention, branch codes, tie-breaking), not the implementation
(no register exchange, no survivor packs, no batching), so agreement is a
meaningful check.

Conventions (see trellis.py):
  - state sigma_t = last 6 input bits, newest at LSB;
  - predecessors of s are (s >> 1) and (s >> 1) + 32 (dropped bit j = 0 / 1);
  - branch metric = correlation: bm[c] for c = 2*out0 + out1 is
    [-r0-r1, -r0+r1, r0-r1, r0+r1];
  - tie-break: the j = 1 branch wins only on strict '>' (matches cores);
  - decision bit stored at stage t is j = b_{t-6} (the dropped oldest bit);
  - output bit o = decision at stage o + 32 along the traced path, which is
    message bit o + extra_l (reference framing, main.cpp:161).
"""

from __future__ import annotations

import numpy as np

from ..config import NUM_STATES
from ..trellis import BRANCH_CODE_J0, BRANCH_CODE_J1

_PRED0 = np.arange(NUM_STATES) >> 1          # low-half predecessor index
_PRED1 = (np.arange(NUM_STATES) >> 1) + 32   # high-half predecessor index
_EMIT_DELAY = 32  # output bit o <- decision at stage o + 32 (see module doc)


def branch_metrics(r0, r1, integer_metric: bool):
    """(4,) branch metrics for one stage, hypothesis order c = 2*out0+out1."""
    s, d = r0 + r1, r0 - r1
    bm = np.array([-s, -d, d, s])
    if integer_metric and bm.dtype.kind == "f":
        bm = np.trunc(bm)  # reference FP32 path casts float->int (C trunc)
    return bm.astype(np.int64) if integer_metric else bm


def golden_forward(r: np.ndarray, integer_metric: bool = True):
    """Run ACS over r (L, 2) soft pairs.  Returns (pm, decisions) with
    decisions (L, 64) uint8."""
    L = r.shape[0]
    pm = np.zeros(NUM_STATES, dtype=np.int64 if integer_metric else np.float64)
    dec = np.zeros((L, NUM_STATES), dtype=np.uint8)
    j0 = BRANCH_CODE_J0
    j1 = BRANCH_CODE_J1
    for t in range(L):
        bm = branch_metrics(r[t, 0], r[t, 1], integer_metric)
        cand0 = pm[_PRED0] + bm[j0]
        cand1 = pm[_PRED1] + bm[j1]
        d = cand1 > cand0
        pm = np.where(d, cand1, cand0)
        dec[t] = d
    return pm, dec


def golden_traceback(dec: np.ndarray, out_len: int, start_state: int = 0):
    """Bit-level path-following traceback from `start_state` at the last
    stage.  Emits out_len bits (output bit o = decision at stage o + 32)."""
    L = dec.shape[0]
    out = np.zeros(out_len, dtype=np.uint8)
    state = start_state
    for t in range(L - 1, _EMIT_DELAY - 1, -1):
        d = int(dec[t, state])
        o = t - _EMIT_DELAY
        if o < out_len:
            out[o] = d
        state = (state >> 1) | (d << 5)
    return out


def golden_decode_block(r: np.ndarray, dec_len: int,
                        integer_metric: bool = True) -> np.ndarray:
    """Decode one overlap-save block: r is (dec_len + 64, 2) soft pairs,
    returns (dec_len,) bits (= message bits [extra_l, extra_l + dec_len) of
    the block's input span)."""
    assert r.shape[0] == dec_len + 64
    _, dec = golden_forward(r, integer_metric)
    return golden_traceback(dec, dec_len)


def golden_decode_full(r: np.ndarray, message_len: int,
                       integer_metric: bool = True) -> np.ndarray:
    """Decode the whole message as a single block (no chunking): r is (S, 2)
    with S >= message_len + 64; returns (message_len,) bits."""
    _, dec = golden_forward(r, integer_metric)
    return golden_traceback(dec, message_len)
