"""The lane-split layout of ``tpu_viterbi_torch/csrc/lanes.cuh`` in numpy,
for the CPU tests of the kernels that use it: K25
(tests/test_torch_k6_k25.py), K13 and K19 (tests/test_torch_k13_k19.py),
K12's layouts A and B (tests/test_torch_k12_k18.py), K14's forward
variants and K16's bcast and no_pp (tests/test_torch_k14_k16.py, with the
survivors keyed by fixed rows that K14's pp_noshuf and decbits put back
together); K18's split of its 32 predecessor pairs or pm words over lanes,
with the sources of its repack (csrc/swar_probe.cu), for the same K12/K18
tests; K16's fixed-partner layout (no_acs, concat, pltpu_repeat) and K14's
chase over spans of stages (csrc/kernel_microbench.cu,
csrc/acs_variants.cu).

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


def run_trellis(packs, lanes: int, arrays: int, at_pack_end=None,
                start=None):
    """(pm, pp) by position after the stages of ``packs`` (each pack a list
    of (u, d) stage fields, (arrays,) int32 tensors or arrays, 32 a pack
    but K12's one), from zero or from ``start`` = (pm, pp) by position at
    stage 0, where position P holds state P; ``at_pack_end(p, f, pp)``
    after each pack p, f the phase of the stage after it."""
    if start is None:
        pm = np.zeros((64, arrays), np.int64)
        pp = np.zeros_like(pm)
    else:
        pm, pp = (np.asarray(v, np.int64) for v in start)
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


# --- K12: layouts A and B on this layout ---

def k12_split(x, stages: int, lanes: int, dual: bool):
    """K12's A (``dual`` False) or B split over ``lanes`` lanes, as
    csrc/layout_probe.cu's layout_split_kernel computes it: x (tiles x
    192, 128) int32 -> (programs, 64, 128) int32.  Each column's pm and pp
    start in natural order, position P as state P; stage t reads row t % 32
    of u and d; B's program g is tiles 2g and 2g + 1, its two arrays
    summed position by position; position P's sum goes to row rol6(P,
    stages % 6)."""
    t = np.asarray(x, np.int64).reshape(-1, 192, 128)
    arrays = t.shape[0] * 128
    cols = t.transpose(1, 0, 2).reshape(192, arrays)    # a = g * 128 + l
    fields = [(cols[128 + s % 32], cols[160 + s % 32]) for s in range(stages)]
    pm, pp = run_trellis([fields], lanes, arrays,
                         start=(cols[:64], cols[64:128]))
    by_pos = (pm + pp).reshape(64, -1, 128)             # (P, tile, column)
    if dual:
        by_pos = by_pos[:, 0::2] + by_pos[:, 1::2]
    out = np.zeros_like(by_pos)
    out[[rol6(p, stages % 6) for p in range(64)]] = by_pos
    return wrap32(out).transpose(1, 0, 2)


# --- K18: 32 pairs or words over lanes ---

def swar_owner(lanes: int):
    """(lane, slot) of predecessor pair or pm word q = 0..31 (its survivors
    pp[q], pp[q + 32] and bm[q] beside it): lane q mod L, slot q div L."""
    q = np.arange(32)
    return q % lanes, q // lanes


def swar_repack_sources(lanes: int):
    """For destination (lane l, slot r) of a repack, as the kernel computes
    them: ((lane, slot) of word k, (lane, slot) of word k + 16, the half b
    the lane's selector takes), new word w = r L + l = 2k + b.  At one lane
    the sources are the thread's own registers (b the slot's bit 0); split,
    both slots are functions of r alone (compile-time indices) and b of
    the lane alone (a selector fixed for it)."""
    S = 32 // lanes
    out = {}
    for l in range(lanes):
        for r in range(S):
            if lanes == 1:
                out[l, r] = ((0, r >> 1), (0, (r >> 1) + 16), r & 1)
                continue
            src = (l >> 1) + (r & 1) * (lanes // 2)
            if lanes == 32:
                out[l, r] = ((src, 0), (src + 16, 0), l & 1)
            else:
                out[l, r] = ((src, r >> 1), (src, (r >> 1) + 16 // lanes),
                             l & 1)
    return out


def byte_perm(x, y, sel: int):
    """__byte_perm: byte i of the result is byte (sel >> 4 i) & 7 of y:x."""
    v = (np.asarray(y, np.int64) << 32) | np.asarray(x, np.int64)
    return sum(((v >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def vadd2(a, b):
    """__vadd2: two 16-bit adds, no carry across."""
    return ((a + b) & 0xFFFF) | ((((a >> 16) + (b >> 16)) & 0xFFFF) << 16)


def vibmax_s16x2(a, b):
    """__vibmax_s16x2: (the larger signed half of each, a >= b of the high
    half, of the low half)."""
    def half(w, h):
        return wrap16((w >> (16 * h)) & 0xFFFF)
    ge_lo, ge_hi = half(a, 0) >= half(b, 0), half(a, 1) >= half(b, 1)
    lo = np.where(ge_lo, half(a, 0), half(b, 0)) & 0xFFFF
    hi = np.where(ge_hi, half(a, 1), half(b, 1)) & 0xFFFF
    return lo | (hi << 16), ge_hi, ge_lo


def k18_split(variant: str, x, stages: int, lanes: int, repack: int):
    """K18 split over ``lanes`` lanes, as csrc/swar_probe.cu computes it:
    x (programs x rows, 128) int32 -> (programs, 64, 128) int32.  Every
    register is a (lane, slot) of swar_owner; a stage reads only its own
    slot; a repack builds each (lane, slot) from the swar_repack_sources
    of the stage's maxima, asserting that they hold words k and k + 16."""
    rows = 160 if variant == "baseline" else 128
    t = np.asarray(x, np.int64).reshape(-1, rows, 128)
    lane_of, slot_of = swar_owner(lanes)

    def regs(first):            # rows first + q -> [lane, slot] of q
        r = np.zeros((lanes, 32 // lanes) + t[:, 0].shape, np.int64)
        r[lane_of, slot_of] = t[:, first:first + 32].transpose(1, 0, 2)
        return r

    def rows_of(v):             # [lane, slot] of q -> rows q
        return v[lane_of, slot_of].transpose(1, 0, 2)

    m32 = 0xFFFFFFFF
    if variant == "baseline":
        lo, hi, pl, ph, bm = (regs(f) & m32 for f in (0, 32, 64, 96, 128))
        for _ in range(stages):
            c0e, c1e = wrap32(lo + bm), wrap32(hi - bm)
            c0o, c1o = wrap32(lo - bm), wrap32(hi + bm)
            de, do = c1e > c0e, c1o > c0o
            fl, fh = (pl << 1) & m32, ((ph << 1) | 1) & m32
            lo = np.where(de, c1e, c0e) & m32
            hi = np.where(do, c1o, c0o) & m32
            pl, ph = np.where(de, fh, fl), np.where(do, fh, fl)
        out = np.concatenate([rows_of(lo + pl), rows_of(hi + ph)], 1)
        return wrap32(out)
    pmw, pl, ph, bm = (regs(f) & m32 for f in (0, 32, 64, 96))
    nm = -bm & m32
    bme, bmo = byte_perm(bm, nm, 0x5410), byte_perm(nm, bm, 0x5410)
    sources = swar_repack_sources(lanes)
    for s in range(stages):
        ce, co = vadd2(pmw, bme), vadd2(pmw, bmo)
        m, ge_o, ge_e = vibmax_s16x2(byte_perm(ce, co, 0x5410),
                                     byte_perm(ce, co, 0x7632))
        fl, fh = (pl << 1) & m32, ((ph << 1) | 1) & m32
        pl, ph = np.where(ge_e, fl, fh), np.where(ge_o, fl, fh)
        if s % repack != repack - 1:
            pmw = m
            continue
        new = np.zeros_like(m)
        for (l, r), ((la, sa), (lb, sb), b) in sources.items():
            k = (r * lanes + l) >> 1
            assert (lane_of[k], slot_of[k]) == (la, sa)
            assert (lane_of[k + 16], slot_of[k + 16]) == (lb, sb)
            assert b == (r * lanes + l) & 1
            new[l, r] = byte_perm(m[la, sa], m[lb, sb],
                                  0x7632 if b else 0x5410)
        pmw = new
    return wrap32(np.concatenate([rows_of(pmw + pl), rows_of(pmw + ph)], 1))


# --- K14 and K16 ---

M32 = 0xFFFFFFFF


def probe_stage(pm, pp, f: int, lanes: int, bm, same: bool, mode: str):
    """lanes.cuh's lane_probe_stage in phase f, bm the stage's one (arrays,)
    bm: ``same`` (both children of a pair take max(lo + bm, hi - bm)) makes
    the position holding hi (h = 1) add -bm to itself and +bm to its
    partner, else every position adds +bm (the even/odd butterfly); the
    survivor is exchanged (``mode`` "exchange", lane_acs_stage), shifts the
    stage's bit in place ("shift") or counts ("count")."""
    part, h = pairs(lanes, f)
    h = (h == 1)[:, None]
    b = wrap32(np.where(h & same, -bm, bm))
    if mode == "exchange":
        return lane_acs_stage(pm, pp, f, lanes, b)
    cs, cp = wrap32(pm + b), wrap32(pm[part] - b)
    dec = (cp > cs) | ((cp == cs) & h)
    pm_o = np.where(dec, cp, cs)
    if mode == "count":
        return pm_o, (pp + 1) & M32
    return pm_o, ((pp << 1) | (dec != h)) & M32


def stage_bms(rs):
    """Each stage's (arrays,) bm = r0 + r1 of the stage-pair input, wrapping
    (rs (n_packs, 32, 2, arrays))."""
    x = np.asarray(rs, np.int64)
    return [wrap32(x[t // 32, t % 32, 0] + x[t // 32, t % 32, 1])
            for t in range(x.shape[0] * 32)]


def ror6(p, f):
    """The position that holds logical state p f stages into a pass."""
    return rol6(p, (6 - f) % 6)


def probe_split(rs, lanes: int, same: bool, mode: str, key=None):
    """(64, arrays) output of a trellis variant on the in-place layout from
    zero after the input's stages: row rol6(P, T % 6) gets position P's
    pm + pp.  With ``key`` (mode "shift": survivors keyed by fixed rows),
    row s's word is put back together bit by bit: bit j from stage T - 1 -
    j, phase f, whose bit the position that then held logical state key(s)
    shifted in."""
    bms = stage_bms(rs)
    arrays = bms[0].shape[0]
    pm = np.zeros((64, arrays), np.int64)
    pp = np.zeros_like(pm)
    for t, bm in enumerate(bms):
        pm, pp = probe_stage(pm, pp, t % 6, lanes, bm[None, :], same, mode)
    T = len(bms)
    out = np.zeros_like(pm)
    for P in range(64):
        s = rol6(P, T % 6)
        if key is None:
            word = pp[P]
        else:
            word = np.zeros(arrays, np.int64)
            for j in range(min(32, T)):
                f = (T - 1 - j) % 6
                src = ror6(key(s), f)
                assert rol6(src, f) == key(s)
                word |= pp[src] & (1 << j)
        out[s] = wrap32(pm[P] + word)
    return out


def fixed_split(rs, lanes: int, variant: str):
    """K16's no_acs, concat or pltpu_repeat in the fixed-partner layout:
    pair q = slot * L + lane (swar_owner) holds rows q and q + 32 in its
    lane, and a stage reads only that lane's registers."""
    bms = stage_bms(rs)
    arrays = bms[0].shape[0]
    S = 32 // lanes
    pm = np.zeros((lanes, S, 2, arrays), np.int64)   # [lane, slot, x]
    pp = np.zeros_like(pm)
    for bm in bms:
        if variant == "no_acs":
            pm, pp = wrap32(pm + bm), (pp + 1) & M32
            continue
        c0, c1 = wrap32(pm[:, :, 0] + bm), wrap32(pm[:, :, 1] - bm)
        dec = c1 > c0
        m = np.where(dec, c1, c0)
        p = ((np.where(dec, pp[:, :, 1], pp[:, :, 0]) << 1) | dec) & M32
        pm, pp = np.stack([m, m], 2), np.stack([p, p], 2)
    lane_of, slot_of = swar_owner(lanes)
    v = wrap32(pm + pp)[lane_of, slot_of]            # [q, x, arrays]
    return np.concatenate([v[:, 0], v[:, 1]])


def chase_split(rs, lanes: int, shift: bool = True):
    """K14's bit_tb with its T stages split into spans of n = T / L over the
    lanes: each lane chases and sums its span from state 0; round k joins
    lanes l and l ^ k (spans of n k stages), the sums added, the earlier
    span's state shifted right by the later one's stages (``shift`` False:
    a control that only ORs them).  Returns (64, arrays), every row acc +
    state."""
    x = np.asarray(rs, np.int64)
    n_packs, arrays = x.shape[0], x.shape[3]
    T = n_packs * 32
    n = T // lanes
    state = np.zeros((lanes, arrays), np.int64)
    acc = np.zeros_like(state)
    for lane in range(lanes):
        for t in range(lane * n, (lane + 1) * n):
            pack = x[t % n_packs, t % 32, 0]
            d = (pack >> (31 - t % 32)) & 1
            state[lane] = (state[lane] >> 1) | (d << 5)
            acc[lane] = wrap32(acc[lane] + pack)
    k = 1
    while k < lanes:
        partner = np.arange(lanes) ^ k
        later = (np.arange(lanes) & k)[:, None] > 0
        first = np.where(later, state[partner], state)
        second = np.where(later, state, state[partner])
        gap = n * k if shift else 0
        state = (first >> gap if gap < 6 else 0) | second
        acc = wrap32(acc + acc[partner])
        k *= 2
    assert (state == state[0]).all() and (acc == acc[0]).all()
    return np.broadcast_to(wrap32(acc[0] + state[0]), (64, arrays)).copy()


# --- K28: the interleave's columns over lanes ---

def k28_src_row(r: int) -> int:
    """Row r of the merge comes from row src(r) of [E; O]: ror6(r, 1)."""
    return (r % 2) * 32 + r // 2


def k28_one_lane(variant: str, x, reps: int, one: int = 1):
    """csrc/interleave.cu's thread-a-column kernel in numpy: regs' passes
    of 6 reps add in place and its last reps % 6 move by src_row; concat
    only adds; smem stores E and O to the even and odd rows and reads all
    64 back."""
    v = np.asarray(x, np.int64)
    k = 0
    if variant == "smem":
        for _ in range(reps):
            col = np.zeros_like(v)
            col[0::2], col[1::2] = v[:32], v[32:]
            v = wrap32(col + one)
        return v
    while k + 6 <= reps:
        v = wrap32(v + 6 * one)
        k += 6
    for _ in range(k, reps):
        src = [k28_src_row(r) if variant == "regs" else r for r in range(64)]
        v = wrap32(v[src] + one)
    return v


def k28_thread_columns(cols: int, lanes: int):
    """regs' and concat's split threads: [(column, lane)] of every thread
    that holds a live column, warp w holding lane w % L of columns
    32 (w / L) + t."""
    warps = -(-cols // 32) * lanes
    g = np.arange(warps * 32)
    w, t = g // 32, g % 32
    c, lane = w // lanes * 32 + t, w % lanes
    live = c < cols
    return c[live], lane[live]


def k28_split_regs(variant: str, x, reps: int, lanes: int, one: int = 1):
    """regs or concat at ``lanes`` >= 2 lanes a column: thread (c, lane)
    loads rows lane S .. lane S + S - 1 of column c, adds one a rep in
    place (nothing moves between threads), and writes position P = lane S
    + r to row rol6(P, reps % 6) (regs) or P (concat).  Asserts every
    element is loaded once and written once."""
    v = np.asarray(x, np.int64)
    S = 64 // lanes
    cols = v.shape[1]
    c, lane = k28_thread_columns(cols, lanes)
    out = np.full_like(v, -1)
    written = np.zeros(v.shape, np.int64)
    loaded = np.zeros(v.shape, np.int64)
    f = reps % 6 if variant == "regs" else 0
    for r in range(S):
        P = lane * S + r
        loaded[P, c] += 1
        val = wrap32(v[P, c] + reps * one)
        rows = np.array([rol6(p, f) for p in P])
        out[rows, c] = val
        written[rows, c] += 1
    assert (loaded == 1).all() and (written == 1).all()
    return out


def k28_smem_word(C: int, cw, m):
    """csrc/interleave.cu's smem_word: the scratch word of merged row m of
    the warp's column cw, C columns a warp."""
    return ((m >> 1) * C + cw) * 2 + (m & 1)


def k28_smem_accesses(lanes: int):
    """smem's shared accesses at ``lanes`` >= 2 lanes, as the kernel makes
    them, per thread t of a warp (lane t / C, column t % C): [the 64-bit
    word of store j], [the words of load j of row q, of row q + 32], each
    an array over t; asserts that they address rows (2q, 2q + 1), q and
    q + 32 of the thread's column (q = j L + lane)."""
    C, H = 32 // lanes, 32 // lanes
    t = np.arange(32)
    lane, cw = t // C, t % C
    w = k28_smem_word(C, cw, lane)
    stores, loads = [], []
    for j in range(H):
        q = j * lanes + lane
        st = 32 * j + t
        assert (2 * st == k28_smem_word(C, cw, 2 * q)).all()
        assert (2 * st + 1 == k28_smem_word(C, cw, 2 * q + 1)).all()
        lo, hi = w + 32 * j, w + 32 * j + 32 * C
        assert (lo == k28_smem_word(C, cw, q)).all()
        assert (hi == k28_smem_word(C, cw, q + 32)).all()
        stores.append(st)
        loads.append((lo, hi))
    return stores, loads


def k28_split_smem(x, reps: int, lanes: int, one: int = 1):
    """smem at ``lanes`` >= 2 lanes a column through the accesses of
    ``k28_smem_accesses``, a warp's scratch a (64 C) word array, the two
    buffers alternating: thread (lane, cw) holds pairs (E[q], O[q]), q =
    j L + lane; a rep stores them as 64-bit words and loads rows q and
    q + 32, plus one.  Columns past the array run with zeros and write
    nothing."""
    v = np.asarray(x, np.int64)
    cols = v.shape[1]
    C, H = 32 // lanes, 32 // lanes
    stores, loads = k28_smem_accesses(lanes)
    t = np.arange(32)
    lane, cw = t // C, t % C
    out = np.full_like(v, -1)
    for c0 in range(0, cols, C):
        c = c0 + cw
        live = c < cols
        cc = np.where(live, c, 0)
        e = np.stack([np.where(live, v[j * lanes + lane, cc], 0)
                      for j in range(H)])
        o = np.stack([np.where(live, v[32 + j * lanes + lane, cc], 0)
                      for j in range(H)])
        bufs = [np.full(64 * C, -1, np.int64) for _ in range(2)]
        for k in range(reps):
            buf = bufs[k % 2]
            for j in range(H):
                buf[2 * stores[j]], buf[2 * stores[j] + 1] = e[j], o[j]
            for j in range(H):
                lo, hi = loads[j]
                e[j], o[j] = wrap32(buf[lo] + one), wrap32(buf[hi] + one)
        for j in range(H):
            q = j * lanes + lane
            out[q[live], c[live]] = e[j][live]
            out[32 + q[live], c[live]] = o[j][live]
    return out


# --- K23: the roll-halo decode's time-blocks over lanes ---

def k23_neighbour(rank: int, slot: int, cluster: int, slots: int):
    """(rank, slot) of the time-block whose heads time-block (rank, slot)
    of a tile's cluster takes as its halo: the next slot of its CUDA
    block, the last slot the first of the next rank (the tile wraps)."""
    if slot < slots - 1:
        return rank, slot + 1
    return (rank + 1) % cluster, 0


def k23_split(xp, wpb: int, wph: int, b_pad: int, n_packs: int,
              n_conv: int, n_emit: int, lanes: int, cluster: int = 8,
              slots: int = 16):
    """K23's lane-split kernel in numpy: (out (b_pad, n_emit) int64, the
    store (n_packs, 64, b_pad), the phases of the pack ends).  Each CUDA
    block (a cluster rank of a tile) holds ``slots`` time-blocks; a
    time-block's heads are its first wph stream words (zero past the end),
    its halo the heads of ``k23_neighbour``; stage t reads word t / 2, SOFT8
    fields MSB first; the lanes run ``run_trellis``; each pack's survivors
    go to rows rol6(P, f); every lane chases from state 0, lane 0 writes."""
    x = np.asarray(xp, np.int64) & 0xFFFFFFFF
    n = x.shape[0]

    def word(i):
        return np.where(i < n, x[np.minimum(i, n - 1)], 0)

    blk = np.arange(b_pad)
    heads = word(blk[:, None] * wpb + np.arange(wph)[None, :])
    tile, rank, slot = blk // 128, blk % 128 // slots, blk % slots
    nbr = np.array([tile[b] * 128 + np.dot(
        k23_neighbour(rank[b], slot[b], cluster, slots), (slots, 1))
        for b in blk])
    words = np.concatenate(
        [word(blk[:, None] * wpb + np.arange(wpb)[None, :]), heads[nbr]], 1)
    assert words.shape[1] == n_packs * 16
    signed = words - ((words >> 31) << 32)
    fields = [((signed >> sh) & 255 ^ 128) - 128 for sh in (24, 16, 8, 0)]
    packs = []
    for p in range(n_packs):
        stages = []
        for s in range(32):
            wi = 16 * p + s // 2
            a0, a1 = (fields[0], fields[1]) if s % 2 == 0 else \
                (fields[2], fields[3])
            stages.append((a0[:, wi] + a1[:, wi], a0[:, wi] - a1[:, wi]))
        packs.append(stages)
    store = np.full((n_packs, 64, b_pad), -1, np.int64)
    phases = []

    def at_pack_end(p, f, pp):
        phases.append(f)
        rows = np.array([rol6(q, f) for q in range(64)])
        assert sorted(rows) == list(range(64))
        store[p, rows] = pp

    run_trellis(packs, lanes, b_pad, at_pack_end)
    out = np.zeros((b_pad, n_emit), np.int64)
    state = np.zeros(b_pad, np.int64)
    emit_lo = n_packs - n_conv - n_emit
    for k in range(n_conv + n_emit):
        kp = n_packs - 1 - k
        pack = store[kp, state, blk]
        if k >= n_conv:
            out[:, kp - emit_lo] = pack
        state = (pack >> 26) & 63
    return out, store, phases, nbr
