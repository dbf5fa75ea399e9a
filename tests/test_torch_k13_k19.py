"""K13 (the ablation probe) and K19 (the 16-bit ACS probe) as redesigned for
the H100, on the CPU: each array split over ``lanes`` lanes of a warp in
the in-place layout of ``csrc/lanes.cuh`` (shared with K25), modelled in
numpy (tests/lane_model.py) as the kernels compute it, against the plain
versions, which tests/test_torch_ablation.py and
tests/test_torch_acs_probes.py hold against the JAX scripts' kernels.

- K19: every variant at every lane count, the int16x2 variants' positions
  (P, P ^ 1) a word: the pair of the phase whose pair bit is 0 is the
  word's other half, and each half's tie rule is __vibmax_s16x2's a >= b on
  operands ordered by the half's x bit; i16's survivors shift per half;
  the output rows mapped back from the last phase (32, 64 and 96 stages).
- K13: every variant at every lane count: the dump's rows rol6(P, f) at the
  pack ends (f = 2, 4, 0 in turn), the block's rows of at least 8 adjacent
  arrays, the chase, and the bisect over lanes (the low bits inside a lane,
  the high bits a shuffle), output and store, over 4, 5 and 6 packs.
- Both wrappers: the plain version on a CPU tensor at every lane count, the
  pick of ``common.lanes_for``, and the refusal of a lane count that is not
  built, before any launch.

The kernels themselves run only on a card (tests/test_torch_cuda.py)."""

import re

import numpy as np
import pytest
import torch

from tpu_viterbi_torch import library
from tpu_viterbi_torch.scripts import kernel_ablation as ka
from tpu_viterbi_torch.scripts import opt_bench as ob
from tpu_viterbi_torch.scripts import soft16_ablation as sa
from tpu_viterbi_torch.scripts.common import LANES, lanes_for

import lane_model
from lane_model import rol6, wrap16, wrap32

K13, K19 = ka.K13, ob.K19


# --- K19 ---

def _k19_lanes(variant, rs, lanes, strict=False):
    """K19's lane-split kernel in numpy: (64, width) int32.  ``strict``: a
    control that decides every int16 half on c_part > c_self, without the
    tie rule."""
    n_packs, width = rs.shape[0], rs.shape[3]
    x = rs.numpy().astype(np.int64)
    p = np.arange(64)
    pm = np.zeros((64, width), np.int64)
    pp = np.zeros_like(pm)
    for t in range(n_packs * 32):
        f = t % 6
        bm = x[t // 32, t % 32, 0] + x[t // 32, t % 32, 1]
        if variant == "i32_split":
            pm, pp = lane_model.lane_acs_stage(pm, pp, f, lanes,
                                               wrap32(bm)[None, :])
            continue
        part, h = lane_model.pairs(lanes, f)
        if f == 5:                   # pair bit 0: the word's other half
            assert (part // 2 == p // 2).all()
        else:                        # the same half of another word or lane
            assert (part % 2 == p % 2).all()
        h = (h == 1)[:, None]
        b16 = wrap16(bm)[None, :]
        cs, cp = wrap16(pm + b16), wrap16(pm[part] - b16)
        # __vibmax_s16x2(a, c) a half: (cp, cs) where h = 1, else (cs, cp);
        # the partner wins where a >= c equals h
        a, c = np.where(h, cp, cs), np.where(h, cs, cp)
        ge = a >= c
        dec = (cp > cs) if strict else ge == h
        pm = np.where(ge, a, c)
        if variant == "i16":         # int16 survivors: shifted, masked
            from_self = ((pp << 1) & 0xFFFF) | h
            from_part = ((pp[part] << 1) & 0xFFFF) | ~h
            pp = np.where(dec, from_part, from_self)
        else:
            pp = (np.where(dec, pp[part], pp) << 1 | (dec != h)) & 0xFFFFFFFF
    out = np.zeros((64, width), np.int64)
    rows = [rol6(q, n_packs * 32 % 6) for q in range(64)]
    out[rows] = wrap32(pm + pp) if variant == "i32_split" else \
        wrap16(pm + pp)
    return torch.from_numpy(out.astype(np.int32))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", ob.VARIANTS)
def test_k19_lane_layout_equals_the_plain_version(variant, lanes):
    """The lane layout over 32, 64 and 96 stages (the output rows mapped
    back from phases 2, 4 and 0) computes opt_bench_torch bit for bit."""
    for n_packs in (1, 2, 3):
        rs = ob.probe_input(n_packs, 40, "cpu", seed=3 * n_packs + lanes)
        assert torch.equal(_k19_lanes(variant, rs, lanes),
                           ob.opt_bench_torch(variant, rs))


@pytest.mark.parametrize("variant", ["i16", "i16_pm"])
def test_k19_model_sees_the_tie_rule(variant):
    """A control: the int16x2 model deciding every half on a strict '>'
    (the partner never taking a tie) differs from the plain version, so
    the test above holds the per-half tie rule on inputs with ties."""
    rs = ob.probe_input(2, 40, "cpu", seed=5)
    assert not torch.equal(_k19_lanes(variant, rs, 4, strict=True),
                           ob.opt_bench_torch(variant, rs))


# --- K13 ---

def _k13_packs(variant, w):
    """Each pack's 32 (u, d) stage fields as the kernel reads them: the
    body's raw rows of packs 0-3, else SOFT8's unpack (K25's s8/unpack,
    the same reader)."""
    if variant == "body":
        u_all, d_all = torch.cat([w[0], w[1]]), torch.cat([w[2], w[3]])
        return [[(u_all[s], d_all[s]) for s in range(32)]] * w.shape[0]
    return [sa._stage_fields("s8/unpack", w[p]) for p in range(w.shape[0])]


def _k13_lanes(variant, words, programs, lanes):
    """K13's lane-split kernel in numpy: (out, store or None, the phases of
    the pack ends)."""
    n_packs = words.shape[0] // programs
    arrays = programs * 128
    w = words.reshape(programs, n_packs, 16, 128).permute(1, 2, 0, 3) \
        .reshape(n_packs, 16, arrays)
    S = 64 // lanes
    dump = variant in ("+dump",) + ka.TRACEBACKS
    store = np.full((n_packs, 64, arrays), -1, np.int64) if dump else None
    phases = []

    def at_pack_end(p, f, pp):
        # position P's survivor goes to row rol6(P, f): the lane's part
        # (rol6(lane * S, f), a register a phase) OR the register's
        phases.append(f)
        rows = np.array([rol6(q, f) for q in range(64)])
        lane_part = np.array([rol6(q // S * S, f) for q in range(64)])
        reg_part = np.array([rol6(q % S, f) for q in range(64)])
        assert (rows == lane_part | reg_part).all()
        assert not (lane_part & reg_part).any()
        assert sorted(rows) == list(range(64))      # each row once
        store[p, rows] = pp

    pm, pp = lane_model.run_trellis(_k13_packs(variant, w), lanes, arrays,
                                    at_pack_end if dump else None)
    if variant not in ka.TRACEBACKS:
        out = wrap32(pm[0] + pp[0]).reshape(programs, 1, 128)
    else:
        out = np.zeros((n_packs - 1, arrays), np.int64)
        state = np.zeros(arrays, np.int64)
        cols = np.arange(arrays)
        for k in range(n_packs - 1):
            kp = n_packs - 1 - k
            if variant == "+traceback":
                pack = store[kp, state, cols]
            else:
                # lane l loads rows l * S .. l * S + S - 1; the select tree
                # halves them on the state's low bits, then one shuffle
                # takes the lane its high bits name
                x = store[kp].reshape(lanes, S, arrays)
                h = S // 2
                while h >= 1:
                    x = np.where((state // h & 1)[None, None] == 1,
                                 x[:, h:2 * h], x[:, :h])
                    h //= 2
                pack = x[state // S, 0, cols]
            if k >= 1:
                out[kp - 1] = pack
            state = (pack >> 26) & 63
        out = out.reshape(n_packs - 1, programs, 128).transpose(1, 0, 2)
        out = wrap32(out)
    out = torch.from_numpy(np.ascontiguousarray(out).astype(np.int32))
    if dump:
        store = torch.from_numpy(wrap32(store).astype(np.int32))
    return out, store, phases


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", ka.VARIANTS)
def test_k13_lane_layout_equals_the_plain_version(variant, lanes):
    """The lane layout over 4, 5 and 6 packs (tails of 2, 4 and 0 stages;
    pack ends in phases 2, 4 and 0) computes ablation_torch's output and
    survivor store bit for bit, full-range words included."""
    for n_packs in (4, 5, 6):
        words = ka.probe_input(1, n_packs, "cpu", seed=7 * n_packs + lanes)
        out, store, phases = _k13_lanes(variant, words, 1, lanes)
        want, want_store = ka.ablation_torch(variant, words, 1)
        assert torch.equal(out, want)
        assert (store is None) == (want_store is None)
        if store is not None:
            assert torch.equal(store, want_store)
            assert phases[:3] == [2, 4, 0]


def test_k13_lane_layout_over_programs():
    """Two programs at 32 lanes: the chase and the bisect stay in their
    program's columns."""
    words = ka.probe_input(2, 4, "cpu", seed=11)
    for v in ka.TRACEBACKS:
        out, store, _ = _k13_lanes(v, words, 2, 32)
        want, want_store = ka.ablation_torch(v, words, 2)
        assert torch.equal(out, want) and torch.equal(store, want_store)


@pytest.mark.parametrize("lanes", LANES[1:])
def test_k13_dump_rows_cover_whole_sectors(lanes):
    """The dump's block write: thread t writes element e = k x block + t of
    the block's 64 x A tile (A = block / lanes arrays), so a warp's 32
    stores fall on whole rows of at least 8 adjacent arrays: whole 32-byte
    sectors, every element once."""
    block = ka.lane_block(lanes)
    n_arrays = block // lanes
    assert block % 32 == 0 and n_arrays >= 8 and 128 % n_arrays == 0
    seen = []
    for k in range(64 // lanes):
        for warp in range(block // 32):
            e = k * block + warp * 32 + np.arange(32)
            row, col = e // n_arrays, e % n_arrays
            for r in set(row.tolist()):
                c = np.sort(col[row == r])
                assert len(c) >= 8 and len(c) % 8 == 0 and c[0] % 8 == 0
                assert (np.diff(c) == 1).all()
            seen += list(zip(row.tolist(), col.tolist()))
    assert sorted(seen) == [(r, c) for r in range(64)
                            for c in range(n_arrays)]


# --- the wrappers ---

@pytest.mark.parametrize("lanes", (None,) + LANES)
def test_k13_k19_lanes_on_cpu_are_the_plain_version(lanes):
    words = ka.probe_input(2, 4, "cpu", seed=3)
    for v in ("+unpack", "+tb(bisect)"):
        out, store = K13(v, words, 2, lanes)
        want, want_store = ka.ablation_torch(v, words, 2)
        assert torch.equal(out, want)
        assert (store is None) == (want_store is None)
        if store is not None:
            assert torch.equal(store, want_store)
    rs = ob.probe_input(1, 50, "cpu", seed=3)
    for lt in ob.LTS:
        assert torch.equal(K19("i16_pm", rs, lt, lanes),
                           ob.opt_bench_torch("i16_pm", rs))


@pytest.mark.parametrize("lanes", [0, 3, 64, 2.0])
def test_k13_k19_refuse_bad_lanes(lanes):
    """A lane count that is not built raises before any launch."""
    words = ka.probe_input(1, 4, "cpu")
    rs = ob.probe_input(1, 40, "cpu")
    before = [(k.launches, sum(k.lane_launches.values())) for k in (K13, K19)]
    with pytest.raises(ValueError, match="lanes"):
        K13("+dump", words, 1, lanes)
    with pytest.raises(ValueError, match="lanes"):
        K19("i16", rs, 128, lanes)
    assert [(k.launches, sum(k.lane_launches.values()))
            for k in (K13, K19)] == before


@pytest.mark.parametrize("arrays,want", [(2048, 32), (4096, 16),
                                         (15872, 1)])
def test_k13_k19_pick_the_shared_rule(arrays, want):
    """The default lanes are common.lanes_for's, K25's: 32 at K13's JAX
    shape (2,048 arrays), 16 at K19's (4,096), 1 at the headline's
    15,872."""
    assert lanes_for(arrays) == want
    for k in (K13, K19, sa.K25):
        assert k.pick_lanes(arrays, None) == want
        assert k.pick_lanes(arrays, 8) == 8


def test_lane_sources_share_one_header():
    """K13's, K19's, K14's, K16's, K23's and K28's entries take the lane
    counts of ``LANES``, through lanes.cuh's dispatch_lanes; K13's
    lane-split block is ``lane_block``'s; the layout (rol6, bm_bits,
    lane_acs, the exchange, the x bit, K14's and K16's trellis stage and
    stage-pair passes) is defined once, in lanes.cuh, which K13, K19, K25,
    K14, K16, K23 and K28 include."""
    srcs = {p.name: p.read_text() for p in library.CSRC.glob("*.cu*")}
    cases = re.search(r"cudaError_t dispatch_lanes\(int lanes.*?switch "
                      r"\(lanes\) \{(.*?)default", srcs["lanes.cuh"],
                      re.S).group(1)
    assert tuple(int(c) for c in re.findall(r"case (\d+):", cases)) == LANES
    assert [n for n, s in srcs.items() if "switch (lanes)" in s] == \
        ["lanes.cuh"]
    for name in ("kernel_ablation.cu", "opt_bench.cu", "acs_variants.cu",
                 "kernel_microbench.cu", "staging_cost.cu", "interleave.cu"):
        assert "viterbi::dispatch_lanes(lanes, " in srcs[name]
    for name in ("kernel_ablation.cu", "opt_bench.cu", "soft16_ablation.cu",
                 "acs_variants.cu", "kernel_microbench.cu", "staging_cost.cu",
                 "interleave.cu"):
        assert '#include "lanes.cuh"' in srcs[name]
    for name in ("acs_variants.cu", "kernel_microbench.cu"):
        assert "viterbi::ProbeLane<" in srcs[name]
        assert "viterbi::pair_stages(a, in);" in srcs[name]
    for fn in (r"int rol6\(", r"int bm_bits\(", r"void lane_acs\(",
               r"T lane_partner\(", r"bool lane_x\(",
               r"void lane_probe_stage\(", r"struct ProbeLane ",
               r"struct PairPass ", r"void pair_stages\("):
        assert [n for n, s in srcs.items() if re.search(fn, s)] == \
            ["lanes.cuh"], fn
    block = re.search(r"constexpr int lane_block\(\) \{\s*return (.*?);",
                      srcs["kernel_ablation.cu"], re.S).group(1)
    assert block == "8 * L > 128 ? 8 * L : 128"
    assert all(ka.lane_block(n) == max(128, 8 * n) for n in LANES[1:])
