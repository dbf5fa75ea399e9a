"""The lane-split layout of ``tpu_viterbi_torch/csrc/lanes.cuh`` in numpy,
for the CPU tests of the kernels that use it: K25
(tests/test_torch_k6_k25.py), K13 and K19 (tests/test_torch_k13_k19.py).

An array's 64 states are split over ``lanes`` lanes, S = 64 / lanes
positions a lane (position P = lane * S + register).  After t stages
position P holds logical state rol6(P, t % 6); stage t pairs P with
P ^ (1 << b), b = 5 - t % 6, and P keeps the child whose x bit is P's bit
b.  The model works on (64, arrays) arrays indexed by position, and asserts
where each operand comes from: the lane's own registers, or the same
register of another lane (a shuffle)."""

import itertools

import numpy as np

from tpu_viterbi_torch.trellis import branch_sign_table


def rol6(p, f):
    """The logical state position p holds f stages into a pass."""
    return ((p << f) | (p >> (6 - f))) & 63 if f else p


def wrap32(v):
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def wrap16(v):
    return (v + 2 ** 15) % 2 ** 16 - 2 ** 15


def bm_bits_table():
    """[f][p]: lanes.cuh's bm_bits from the port's trellis: bit 0 bm's sign
    is +, bit 1 bm is +-d, for the pair q position p holds in phase f
    (state 2q's j=0 branch signs)."""
    t = branch_sign_table()
    out = np.zeros((6, 64), np.int64)
    for f, p in itertools.product(range(6), range(64)):
        s = t[2 * (rol6(p, f) & 31), 0]
        out[f, p] = int(s[0] > 0) | (int(s[0] != s[1]) << 1)
    return out


_BM_BITS = bm_bits_table()


def pairs(lanes: int, f: int):
    """(partner, h): each position's partner in phase f and its x bit (the
    pair bit b = 5 - f of P); asserts that a pair lies in one lane when b
    is a register bit and in one register of two lanes when it is a lane
    bit."""
    S = 64 // lanes
    reg_bits = 6 - int(np.log2(lanes))
    b = 5 - f
    p = np.arange(64)
    part = p ^ (1 << b)
    if b < reg_bits:                 # the pair within a lane
        assert (part // S == p // S).all()
    else:                            # a shuffle: the same register
        assert (part % S == p % S).all()
    return part, (p >> b) & 1


def trellis_bm(f: int, lanes: int, u, d):
    """(64, arrays) bm of each position in phase f from the stage's
    (arrays,) u and d: bm_bits taken apart as the kernel takes it (the
    lane's flips XOR the register's bits), then +-u or +-d, wrapping."""
    S = 64 // lanes
    p = np.arange(64)
    bits = _BM_BITS[f, (p // S) * S] ^ _BM_BITS[f, p % S]
    assert (bits == _BM_BITS[f]).all()
    bm = np.where((bits & 2)[:, None] > 0, d, u)
    return wrap32(np.where((bits & 1)[:, None] > 0, bm, -bm))


def lane_acs_stage(pm, pp, f: int, lanes: int, bm):
    """lanes.cuh's int32 stage (lane_acs) in phase f: c_self = pm + bm,
    c_part = pm[partner] - bm, the partner taken on c_part > c_self or on a
    tie where h = 1; the survivor gets the winner's x bit."""
    part, h = pairs(lanes, f)
    h = (h == 1)[:, None]
    cs, cp = wrap32(pm + bm), wrap32(pm[part] - bm)
    dec = (cp > cs) | ((cp == cs) & h)
    return (np.where(dec, cp, cs),
            (np.where(dec, pp[part], pp) << 1 | (dec != h)) & 0xFFFFFFFF)


def run_trellis(packs, lanes: int, arrays: int, at_pack_end=None):
    """(pm, pp) by position after the stages of ``packs`` (each pack a list
    of 32 (u, d) stage fields, (arrays,) int32 tensors or arrays), from
    zero; ``at_pack_end(p, f, pp)`` after each pack p, f the phase of the
    stage after it."""
    pm = np.zeros((64, arrays), np.int64)
    pp = np.zeros_like(pm)
    t = 0
    for p, fields in enumerate(packs):
        for u, d in fields:
            u = wrap32(np.asarray(u, dtype=np.int64))
            d = wrap32(np.asarray(d, dtype=np.int64))
            pm, pp = lane_acs_stage(pm, pp, t % 6, lanes,
                                    trellis_bm(t % 6, lanes, u, d))
            t += 1
        if at_pack_end is not None:
            at_pack_end(p, t % 6, pp)
    return pm, pp
