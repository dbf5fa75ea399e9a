"""The plain reference decoder, in PyTorch: the decode that the benchmark
holds every cell's decoded words to, written from the code's definition
and the framing of ``framing.py``, independent of the program.

- Trellis: state s holds message bits t, t-1, ..., t-5 at bits 0..5; its
  predecessors are s >> 1 | j << 5 for the dropped bit j, and the branch's
  coded bits are the parities of the reference encoder's register (newest
  bit at bit 6) masked by 0o171 and 0o133.
- Branch metric: the correlation of the stage's two values with the
  branch's BPSK symbols, (+-r0) + (+-r1); on the FP32 wire the values are
  first clamped to [-8, 7] and the float32 sum is truncated toward zero.
- Add-compare-select keeps the larger metric; a tie keeps j = 0.  Path
  metrics are exact (int32, renormalised once a pack, which changes no
  comparison), or, for the control, int8 (``metrics="int8"``): each
  candidate wrapped to 8 bits as a packed int8 lane would wrap it, and
  state 0's metric subtracted every stage.
- Traceback from state 0 at a block's last stage (``framing.py``).

The control (``CONTROLS``) is this decode a step below a configuration's
stated precision: int8 path metrics where the wire is already integer
(``int8_metrics``), the f32 wire rounded to bfloat16 (``bf16_wire``).

Imports torch and numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

from . import framing
from .reference_stream import CONST_LEN, POLY, Channel, M32, to_int32

STATES = 1 << (CONST_LEN - 1)
FP_LO, FP_HI = -8.0, 7.0           # the FP32 wire's clamp (viterbiBM.cuh)
METRICS = ("exact", "int8")
CONTROLS = ("int8_metrics", "bf16_wire")


def _parity(x: np.ndarray) -> np.ndarray:
    return np.array([bin(int(v)).count("1") & 1 for v in x])


def branch_codes() -> np.ndarray:
    """(2, 64): the coded pair 2 * out0 + out1 of the branch into state s
    from the predecessor whose dropped bit is j."""
    s = np.arange(STATES)
    codes = []
    for j in (0, 1):
        # register: bit 6 - i holds message bit t - i
        reg = sum(((s >> i) & 1) << (CONST_LEN - 1 - i)
                  for i in range(CONST_LEN - 1)) | j
        codes.append(2 * _parity(reg & POLY[0]) + _parity(reg & POLY[1]))
    return np.stack(codes)


def stage_pairs(stream: torch.Tensor, channel: Channel,
                stages: int) -> torch.Tensor:
    """A flat channel stream -> (stages, 2) int32 (u, d) = the branch
    metrics of the coded pairs (1, 1) and (1, 0): r0 + r1 and r0 - r1, on
    the FP32 wire clamped and truncated toward zero.  Stages past the
    stream read zero words (a HARD zero field is -1, a soft one 0)."""
    if channel.width == 0:
        v = stream.to(torch.float32).clamp(FP_LO, FP_HI)
        need = 2 * stages
        if v.shape[0] < need:
            v = torch.cat([v, v.new_zeros(need - v.shape[0])])
        r0, r1 = v[:need:2], v[1:need:2]
        return torch.stack([torch.trunc(r0 + r1), torch.trunc(r0 - r1)],
                           1).to(torch.int32)
    vpw, w = channel.values_per_word, channel.width
    words = stream.to(torch.int64) & M32
    need = -(-2 * stages // vpw)
    if words.shape[0] < need:
        words = torch.cat([words, words.new_zeros(need - words.shape[0])])
    shifts = torch.arange(vpw - 1, -1, -1, device=words.device) * w
    f = (words[:need, None] >> shifts) & ((1 << w) - 1)
    if w == 1:
        v = f * 2 - 1
    else:
        v = f - ((f >> (w - 1)) << w)          # sign-extend
    v = v.reshape(-1)[: 2 * stages].view(stages, 2)
    return torch.stack([v[:, 0] + v[:, 1], v[:, 0] - v[:, 1]],
                       1).to(torch.int32)


def block_pairs(pairs: torch.Tensor, plan: framing.Plan) -> torch.Tensor:
    """(stages, 2) -> (num_blocks, block_len, 2): block k's stages from k *
    dec_len, zero-filled past the message's end."""
    need = (plan.num_blocks - 1) * plan.dec_len + plan.block_len
    if pairs.shape[0] < need:
        pairs = torch.cat([pairs, pairs.new_zeros(need - pairs.shape[0], 2)])
    return pairs[:need].unfold(0, plan.block_len,
                               plan.dec_len).transpose(1, 2)


def _wrap8(x: torch.Tensor) -> torch.Tensor:
    return ((x + 128) & 255) - 128


def decode_blocks(ud: torch.Tensor, plan: framing.Plan,
                  metrics: str = "exact") -> torch.Tensor:
    """(B, block_len, 2) int32 (u, d) pairs of B blocks -> (B, dec_len)
    uint8 decoded bits: the decisions at stages LEAD .. LEAD + dec_len - 1
    on the path traced back from state 0 at the last stage."""
    if metrics not in METRICS:
        raise ValueError(f"metrics must be one of {METRICS}")
    dev = ud.device
    b, length = ud.shape[0], ud.shape[1]
    codes = torch.as_tensor(branch_codes(), device=dev)
    s = torch.arange(STATES, device=dev)
    prev = (s >> 1, (s >> 1) | (1 << (CONST_LEN - 2)))
    weights = torch.ones(STATES, dtype=torch.int64, device=dev) << s
    pm = torch.zeros((b, STATES), dtype=torch.int32, device=dev)
    decisions = torch.empty((length, b), dtype=torch.int64, device=dev)
    for t in range(length):
        u, d = ud[:, t, 0], ud[:, t, 1]
        # metrics of the coded pairs 0 = (0, 0), 1 = (0, 1), 2, 3 = (1, 1)
        bm = torch.stack([-u, -d, d, u], 1)
        c0 = pm[:, prev[0]] + bm[:, codes[0]]
        c1 = pm[:, prev[1]] + bm[:, codes[1]]
        if metrics == "int8":
            c0, c1 = _wrap8(c0), _wrap8(c1)
        take1 = c1 > c0
        pm = torch.where(take1, c1, c0)
        if metrics == "int8":
            pm = _wrap8(pm - pm[:, :1])
        elif t % 32 == 31:
            pm = pm - pm.amin(1, keepdim=True)
        decisions[t] = (take1.to(torch.int64) * weights).sum(1)
    state = torch.zeros(b, dtype=torch.int64, device=dev)
    bits = torch.empty((b, plan.dec_len), dtype=torch.uint8, device=dev)
    for t in range(length - 1, -1, -1):
        j = (decisions[t] >> state) & 1
        if framing.LEAD <= t < framing.LEAD + plan.dec_len:
            bits[:, t - framing.LEAD] = j.to(torch.uint8)
        state = (state >> 1) | (j << (CONST_LEN - 2))
    return bits


def pack_bits(bits: torch.Tensor, bits_per_pack: int) -> torch.Tensor:
    """(m,) decoded bits -> (m / bits_per_pack,) int32 words, MSB =
    earliest (the output packs' bit patterns)."""
    w = torch.arange(bits_per_pack - 1, -1, -1, device=bits.device)
    return to_int32((bits.view(-1, bits_per_pack).to(torch.int64)
                     << w).sum(1))


def decode(streams, channel: Channel, plan: framing.Plan,
           metrics: str = "exact") -> list:
    """Decode each of ``streams`` (channel streams of ``plan.stages``
    stages) in one batch of their blocks -> a list of int32 output words,
    ``plan.message_len / bits_per_pack`` each."""
    ud = torch.cat([block_pairs(stage_pairs(x, channel, plan.stages), plan)
                    for x in streams])
    bits = decode_blocks(ud, plan, metrics)
    bits = bits.view(len(streams), -1)[:, : plan.message_len]
    return [pack_bits(row, plan.bits_per_pack) for row in bits]


def control_decode(streams, channel: Channel, plan: framing.Plan,
                   control: str) -> list:
    """``decode`` a step below the configuration's precision."""
    if control == "int8_metrics":
        return decode(streams, channel, plan, "int8")
    if control == "bf16_wire" and channel.width == 0:
        return decode([x.to(torch.bfloat16).to(torch.float32)
                       for x in streams], channel, plan)
    raise ValueError(f"no control {control!r} for the {channel.name} "
                     f"channel (controls: {', '.join(CONTROLS)})")


def differing_bits(a: torch.Tensor, b: torch.Tensor) -> int:
    """Bits that differ between two equally long int32 word tensors (each
    word read as unsigned), or every bit of the longer where the lengths
    differ."""
    if a.shape != b.shape:
        return 32 * max(a.numel(), b.numel())
    x = (a.to(torch.int64) ^ b.to(torch.int64)) & M32
    count = torch.zeros_like(x)
    for _ in range(32):
        count += x & 1
        x = x >> 1
    return int(count.sum())
