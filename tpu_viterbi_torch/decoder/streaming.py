"""Streaming decode: feed the channel stream in chunks, get decoded bits out
(the port of ``tpu_viterbi/decoder/streaming.py``).

A StreamingViterbi instance keeps the undecodable tail of each chunk (the
extra_l + extra_r = 64-stage overlap-save boundary) and prepends it to the
next chunk, so an arbitrarily long stream decodes in fixed-size pieces with
the one-shot decoder's per-block framing.

Output alignment matches the one-shot contract: across all emitted chunks,
output bit i is the estimate of stream message bit i + extra_l, and the
total emitted length equals ``get_message_len`` of the whole stream — the
final extra_r-and-rounding stages are consumed as right halo only, as the
reference's framing discards them (viterbi.cu:86-88).  After ``flush`` the
instance is empty and serves the next stream with the same decoder.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import DecoderConfig
from .api import DEFAULT_DEC_LEN, ViterbiGPU


class StreamingViterbi:
    """Chunked decoding with carry-over of the overlap-save boundary."""

    def __init__(self, config: DecoderConfig = DecoderConfig(),
                 dec_len: int = DEFAULT_DEC_LEN, backend: str = "auto",
                 survivor: str = "auto", device=None):
        """backend / survivor / device are forwarded to the underlying
        ViterbiGPU (api.py); survivor='window' streams through kernel K3."""
        self.config = config
        self._dec = ViterbiGPU(config, dec_len=dec_len, backend=backend,
                               survivor=survivor, device=device)
        self._carry: Optional[np.ndarray] = None  # packed words carried over

    def _empty(self) -> np.ndarray:
        return np.zeros(0, dtype=np.uint16 if self.config.bits_per_pack == 16
                        else np.uint32)

    def push(self, packed_chunk: np.ndarray) -> np.ndarray:
        """Feed packed channel words; returns packed decoded words for every
        output bit that became decodable (possibly empty).

        Chunks must be whole packed words; for bit alignment across chunks
        the chunk word count must keep stages a multiple of bits_per_pack
        (any equal-sized chunks >= 1024 words satisfy this)."""
        cfg = self.config
        chunk = np.asarray(packed_chunk)
        if self._carry is not None:
            chunk = np.concatenate([self._carry, chunk])
        input_num = chunk.shape[0] * cfg.enc_data_per_pack
        message_len = cfg.get_message_len(input_num)
        if message_len <= 0:
            self._carry = chunk
            return self._empty()
        out, _ = self._dec.run(chunk, input_num)
        # carry everything from the first un-decoded message bit onward:
        # decoded bits cover stream stages [0, message_len); the next call
        # must re-see stages from message_len on (they were only the right
        # halo here).  message_len is a bits_per_pack multiple, so the
        # carry starts on a word boundary.
        self._carry = chunk[2 * message_len // cfg.enc_data_per_pack:]
        return out

    def flush(self) -> np.ndarray:
        """Decode whatever remains of the carried tail under the one-shot
        contract: only bits whose extra_r right halo is real input are
        emitted (``get_message_len`` of the carry), with no synthetic
        padding — so across push() + flush() the output covers exactly the
        bits a one-shot decode of the concatenated stream would
        (getMessageLen, reference viterbi.cu:86-88)."""
        cfg = self.config
        carry, self._carry = self._carry, None
        if carry is None or carry.shape[0] == 0:
            return self._empty()
        input_num = carry.shape[0] * cfg.enc_data_per_pack
        if cfg.get_message_len(input_num) <= 0:
            return self._empty()    # too short to decode under the halo
        out, _ = self._dec.run(carry, input_num)
        return out
