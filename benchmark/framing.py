"""The decode's framing, worked out from the message length and ``dec_len``
alone, as the reference CUDA project frames it (``viterbi.h:67-76``,
``viterbi.cu:86-88``).  The benchmark's reference and its rooflines read
these numbers; nothing here comes from the program under test.

- A message of ``n`` source bits is ``n`` trellis stages, two coded values
  a stage.
- ``extra_l`` + ``extra_r`` = 64 stages frame the decode: the decoded
  stream is ``message_len`` bits, the largest multiple of the pack width
  under ``n`` - 64, and decoded bit i is message bit i + 26.
- Overlap-save: block k runs the trellis over stages [k * dec_len, k *
  dec_len + dec_len + 64), every path metric starting at 0; it traces back
  from state 0 at its last stage and keeps the decisions of its stages 32
  .. dec_len + 31, which are decoded bits [k * dec_len, (k + 1) * dec_len).
  Stages past the stream read zero words.
"""

from __future__ import annotations

from dataclasses import dataclass

EXTRA = 64         # extra_l + extra_r: stages a block runs past its dec_len
LEAD = 32          # a block's stages before its first kept decision
OFFSET = 26        # decoded bit i is message bit i + OFFSET (extra_l)


@dataclass(frozen=True)
class Plan:
    """The framing of one message: ``stages`` trellis stages (its source
    bits), ``message_len`` decoded bits, ``num_blocks`` blocks of
    ``dec_len`` decoded bits over ``block_len`` stages each."""

    stages: int
    message_len: int
    dec_len: int
    num_blocks: int
    bits_per_pack: int

    @property
    def block_len(self) -> int:
        return self.dec_len + EXTRA


def plan(source_bits: int, dec_len: int, bits_per_pack: int) -> Plan:
    """The framing of a message of ``source_bits`` bits (``input_num`` =
    2 x ``source_bits`` coded values) decoded at ``dec_len``."""
    m = (source_bits - EXTRA) // bits_per_pack * bits_per_pack
    if m <= 0:
        raise ValueError(f"{source_bits} source bits decode to nothing")
    dl = max(bits_per_pack, min(dec_len, m))
    dl -= dl % bits_per_pack
    return Plan(source_bits, m, dl, -(-m // dl), bits_per_pack)
