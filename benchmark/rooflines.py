"""The benchmark's own bounds on the card's time, from a cell's shapes alone.
Frozen: a later PR adds counts beside these and changes none, so that no
kernel PR moves its own yardstick.  Nothing here reads the program: the
counts follow from the trellis, from the definition of the streams
(``reference_stream.py``) and from the framing (``framing.py``).

A bound is the larger of its terms: bytes over the memory's peak, and
each kind of operation over the rate of the units that can issue it.

Peaks, NVIDIA H100 SXM5 as published (700 W), with the clock stated:
- issue: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz = 33.45e12
  lane-instructions a second (one instruction a scheduler a clock);
- special functions (log, sqrt, sine, cosine): 132 SMs x 16 lanes x 1.98
  GHz = 4.18e12 a second;
- HBM3: 3.35e12 bytes a second.
"""

from __future__ import annotations

from . import framing
from .reference_stream import Channel

SMS = 132
CLOCK_HZ = 1.98e9
ISSUE_PER_S = SMS * 4 * 32 * CLOCK_HZ
SFU_PER_S = SMS * 16 * CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12

# The ACS of one block-stage: 64 states, each the larger of two candidate
# sums (predecessor metric + branch metric), 128 sums a stage.  A lane's
# 32-bit register holds two 16-bit metrics, so a two-wide add or max takes
# one lane-instruction; DPX's fused add-max (max(a + b, c), counted as one
# instruction) folds one candidate's sum into each maximum.  So 32 fused
# add-max (two states each) and 32 adds for the other candidates: 64.  The
# branch metrics take 4 values a stage shared by every state (not counted);
# neither are the decisions, the survivor store or the traceback, so no
# implementation of the same decode can issue fewer.
ACS_PER_BLOCK_STAGE = 64

# threefry2x32 at 13 rounds: a round is an add, a funnel-shift rotate and a
# xor (3); after rounds 4, 8, 12 and 13 the key is injected: x1's 4 adds
# count, x0's fold into the next round's add (a three-input add) but after
# the last round (1).  The counter's own key add is not counted.
THREEFRY_PER_CALL = 13 * 3 + 4 + 1
# Box-Muller a pair: the special functions log, sqrt, sine, cosine (4, on
# the SFU and issued like any instruction), and at least one instruction
# to make each uniform a float and one for each product r * cos, r * sin.
BOX_MULLER_SFU = 4
BOX_MULLER_ISSUE = BOX_MULLER_SFU + 2 + 2


def stream_bytes(channel: Channel, source_bits: int) -> int:
    """Bytes of a message's channel stream: ceil(2n / vpw) words, or 2n
    float32 values on the FP32 wire."""
    if channel.width == 0:
        return 4 * 2 * source_bits
    return 4 * -(-2 * source_bits // channel.values_per_word)


def decode_terms(channel: Channel, plan: framing.Plan) -> dict:
    """The decode's terms in seconds: ``bytes`` (the stream read once, the
    packed output written once; the survivor store is an intermediate)
    and ``issue`` (the ACS of every stage of every block)."""
    out_bytes = plan.message_len // 8
    ops = ACS_PER_BLOCK_STAGE * plan.block_len * plan.num_blocks
    return {"bytes": (stream_bytes(channel, plan.stages) + out_bytes)
            / HBM_BYTES_PER_S,
            "issue": ops / ISSUE_PER_S}


def generate_terms(channel: Channel, source_bits: int,
                   noisy: bool = True) -> dict:
    """The generator's terms in seconds for one message: ``bytes`` (the
    stream and the ceil(n / 32) message packs written once), ``issue`` (a
    threefry call a stage for its noise and one a pair of message packs,
    a Box-Muller a stage) and ``sfu`` (its special functions)."""
    packs = -(-source_bits // 32)
    stages = source_bits if noisy else 0
    calls = stages + -(-packs // 2)
    issue = calls * THREEFRY_PER_CALL + stages * BOX_MULLER_ISSUE
    return {"bytes": (stream_bytes(channel, source_bits) + 4 * packs)
            / HBM_BYTES_PER_S,
            "issue": issue / ISSUE_PER_S,
            "sfu": stages * BOX_MULLER_SFU / SFU_PER_S}


def bound_s(terms: dict) -> float:
    """The least time: the largest term."""
    return max(terms.values())
