"""K12 (the layout probe) and K18 (the int16x2 SWAR ACS probe) as
redesigned for the H100, on the CPU: each array split over ``lanes`` lanes
of a warp, modelled in numpy (tests/lane_model.py) as the kernels compute
it, against the plain versions, which tests/test_torch_probes.py and
tests/test_torch_acs_probes.py hold against the JAX scripts' kernels in
interpret mode.

- K12 A and B on the in-place layout of ``csrc/lanes.cuh``: pm and pp
  placed in natural order at t = 0, each stage's u and d from row t % 32,
  B's two arrays summed position by position, the output rows rol6(P,
  stages % 6) (32, 64 and 96 stages: tails of 2, 4 and 0); a warp's row
  load one request of 32 / L neighbouring words.
- K18: pair or word q in lane q mod L, slot q div L; the baseline reads
  only its own slots, the swar variants' repack takes words k and k + 16
  from compile-time slots of the lanes the kernel names.
- The wrappers: the plain version on a CPU tensor at every lane count,
  ``common.lanes_for``'s pick (B's from its array pairs, C always 32), and
  the refusal of a lane count that is not built, before any launch.

The kernels themselves run only on a card (tests/test_torch_cuda.py)."""

import re

import numpy as np
import pytest
import torch

from tpu_viterbi_torch import hardware, library
from tpu_viterbi_torch.scripts import layout_probe as lp
from tpu_viterbi_torch.scripts import swar_probe as sp
from tpu_viterbi_torch.scripts.common import LANES, lanes_for

import lane_model

K12, K18 = lp.K12, sp.K18
STAGES_PROGRAMS = ((32, 1), (64, 2), (96, 3))   # tails 2, 4, 0


# --- K12 ---

@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", lp.SPLIT)
def test_k12_lane_layout_equals_the_plain_version(variant, lanes):
    """A and B over 32, 64 and 96 stages on 1-3 programs compute
    layout_torch bit for bit on the lane layout."""
    for stages, programs in STAGES_PROGRAMS:
        x = lp.probe_input(programs * lp.TILES_A_PROGRAM[variant], "cpu",
                           seed=stages + lanes)
        got = lane_model.k12_split(x, stages, lanes, variant == "dual")
        assert torch.equal(torch.from_numpy(got.astype(np.int32)),
                           lp.layout_torch(variant, x, stages))


def test_k12_lane_model_sees_the_rotation():
    """A control: the positions' sums stored in natural order, without the
    rotation rol6(P, stages % 6), differ from the plain version at tails 2
    and 4 (so the test above holds the output rows)."""
    for stages in (32, 64):
        x = lp.probe_input(1, "cpu", seed=stages)
        got = lane_model.k12_split(x, stages, 4, False)
        rows = [lane_model.rol6(p, stages % 6) for p in range(64)]
        assert not np.array_equal(got[:, rows],
                                  lp.layout_torch("real", x, stages).numpy())


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", lp.SPLIT)
def test_k12_rows_are_one_request_a_warp(variant, lanes):
    """Thread i = a L + lane reads row t % 32 of u and d of its array a's
    tile: a warp's 32 loads fall on 32 / L neighbouring words of one row,
    aligned to their span, the L lanes of an array on one address."""
    n = lp.TILES_A_PROGRAM[variant]
    programs = 2
    for warp in range(programs * lp.LT * lanes // 32):
        i = warp * 32 + np.arange(32)
        a = i // lanes
        g, col = a // lp.LT, a % lp.LT
        addr = (n * g * lp.ROWS + 128) * lp.LT + col     # u row 0
        words = np.unique(addr)
        assert len(words) == 32 // lanes and len(np.unique(g)) == 1
        assert (np.diff(words) == 1).all() and words[0] % len(words) == 0
        for k in range(len(words)):
            assert (addr[k * lanes:(k + 1) * lanes] == words[k]).all()


# --- K18 ---

@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", sp.VARIANTS)
def test_k18_lane_layout_equals_the_plain_version(variant, lanes):
    """Every variant over 32, 64 and 96 stages on 1-3 programs computes
    swar_torch bit for bit with its pairs or words over the lanes."""
    for stages, programs in STAGES_PROGRAMS:
        x = sp.probe_input(variant, programs, "cpu", seed=stages + lanes)
        got = lane_model.k18_split(variant, x, stages, lanes,
                                   sp.REPACK[variant])
        assert torch.equal(torch.from_numpy(got.astype(np.int32)),
                           sp.swar_torch(variant, x, stages))


@pytest.mark.parametrize("lanes", LANES)
def test_k18_repack_sources(lanes):
    """The repack's operands: every destination (lane, slot) reads words k
    and k + 16 from one slot each, a function of the slot alone, of the
    lane the kernel names, and takes the half its lane (or, at one lane,
    its slot) fixes; each (lane, slot) of m is read twice, two shuffles a
    word (64 an array) where the array is split, none at one lane."""
    S = 32 // lanes
    lane_of, slot_of = lane_model.swar_owner(lanes)
    src = lane_model.swar_repack_sources(lanes)
    assert sorted(src) == [(l, r) for l in range(lanes) for r in range(S)]
    reads = []
    for (l, r), ((la, sa), (lb, sb), b) in src.items():
        w = r * lanes + l
        k = w >> 1
        assert (lane_of[k], slot_of[k], lane_of[k + 16], slot_of[k + 16]) \
            == (la, sa, lb, sb)
        assert b == w & 1
        assert (sa, sb) == (src[0, r][0][1], src[0, r][1][1])
        if lanes > 1:
            assert b == l & 1
        reads += [(la, sa), (lb, sb)]
    assert sorted(reads) == sorted([(l, s) for l in range(lanes)
                                    for s in range(S)] * 2)
    remote = sum(la != l for (l, _), ((la, _), _, _) in src.items())
    assert (remote == 0) == (lanes == 1)


def test_k18_model_sees_the_repack():
    """A control: the model refuses sources that do not hold words k and k
    + 16 (here swapped), so the test above runs the repack from the
    sources the kernel names."""
    x = sp.probe_input("swar/stage", 1, "cpu", seed=4)
    real = lane_model.swar_repack_sources
    try:
        lane_model.swar_repack_sources = lambda n: {
            key: (b, a, h) for key, (a, b, h) in real(n).items()}
        with pytest.raises(AssertionError):
            lane_model.k18_split("swar/stage", x, 32, 4, 1)
    finally:
        lane_model.swar_repack_sources = real


def test_k18_baseline_bound_counts_the_stage():
    """OPS counts a pair's stage as ACS_OPS counts a state's (an add a
    candidate, a max that also gives its decision, a select a survivor):
    baseline 10 (4 adds, 2 maxima, 2 selects, a shift, a shift-or), 320 an
    array-stage, below the 387 SASS of the compiled one-lane stage; swar 7
    packed (2 adds, 1 max, the same 4 for the survivors), 224."""
    assert sp.OPS["baseline"] == 32 * (4 + 2 + 2 + 2) <= 387
    assert sp.OPS["swar/stage"] == sp.OPS["swar/4stages"] == \
        32 * (2 + 1 + 4)
    acs_ops = hardware.ACS_OPS
    assert 2 * acs_ops // 64 == 4 + 2 + 2      # two states of K1's stage


# --- the wrappers ---

@pytest.mark.parametrize("lanes", (None,) + LANES)
def test_k12_k18_lanes_on_cpu_are_the_plain_version(lanes):
    """On a CPU tensor each wrapper gives its plain version at every lane
    count and launches nothing."""
    before = (K12.launches, K18.launches)
    for v in lp.VARIANTS:
        x = lp.probe_input(2, "cpu", seed=5)
        n = lanes if v in lp.SPLIT or lanes is None else lp.C_LANES
        assert torch.equal(K12(v, x, 32, n), lp.layout_torch(v, x, 32))
    for v in sp.VARIANTS:
        x = sp.probe_input(v, 2, "cpu", seed=5)
        assert torch.equal(K18(v, x, 8, lanes), sp.swar_torch(v, x, 8))
    assert (K12.launches, K18.launches) == before


@pytest.mark.parametrize("lanes", [0, 3, 64, 2.0])
def test_k12_k18_refuse_bad_lanes(lanes):
    """A lane count that is not built raises before any launch."""
    x12 = lp.probe_input(2, "cpu")
    before = [(k.launches, sum(k.lane_launches.values())) for k in (K12, K18)]
    for v in lp.VARIANTS:
        with pytest.raises(ValueError, match="lanes"):
            K12(v, x12, 32, lanes)
    for v in sp.VARIANTS:
        with pytest.raises(ValueError, match="lanes"):
            K18(v, sp.probe_input(v, 1, "cpu"), 8, lanes)
    assert [(k.launches, sum(k.lane_launches.values()))
            for k in (K12, K18)] == before


def test_k12_c_runs_one_warp_an_array():
    """C is built at 32 lanes only: it takes None or 32 and refuses the
    other counts; A and B take every count of LANES."""
    x = lp.probe_input(1, "cpu")
    assert lp.variant_lanes("lanes") == (lp.C_LANES,) == (32,)
    assert lp.variant_lanes("real") == lp.variant_lanes("dual") == LANES
    for n in LANES[:-1]:
        with pytest.raises(ValueError, match="one warp an array"):
            K12("lanes", x, 32, n)
    assert K12.lanes_of("lanes", 16, 32) == 32


@pytest.mark.parametrize("tiles,want", [(16, (32, 32, 32, 32)),
                                        (124, (1, 16, 32, 1)),
                                        (2, (32, 32, 32, 32))])
def test_k12_k18_pick_the_shared_rule(tiles, want):
    """The default lanes are common.lanes_for's, K13's, K19's and K25's,
    of the threads a variant runs at one lane: A's arrays, B's array pairs
    (7,936 at 15,872 arrays: 16 lanes), K18's arrays; C is 32."""
    arrays = tiles * lp.LT
    a, b, c, k18 = want
    assert K12.lanes_of("real", tiles, None) == a == lanes_for(arrays)
    assert K12.lanes_of("dual", tiles // 2 or 1, None) == b
    assert b == lanes_for(max(tiles // 2, 1) * lp.LT)
    assert K12.lanes_of("lanes", tiles, None) == c
    assert K18.pick_lanes(arrays, None) == k18 == lanes_for(arrays)
    assert K18.pick_lanes(arrays, 8) == 8


def test_k12_k18_sources_launch_every_lane_count():
    """Each entry takes the lane count after the variant; one lane launches
    the one-thread-an-array kernels (layout_real_kernel,
    layout_dual_kernel, swar_kernel), the split lanes.cuh's dispatch_lanes
    from two lanes, every other count of LANES; K12's split runs
    lanes.cuh's stage; only the swar variants' repack shuffles in K18's
    split, whose stage loop is the probe's SPLIT_LOOP_STAGES; the split
    kernels build in parts of their own."""
    src = {n: (library.CSRC / n).read_text()
           for n in ("layout_probe.cu", "swar_probe.cu", "lanes.cuh")}
    cases = re.search(r"dispatch_lanes\(int lanes.*?switch \(lanes\) \{(.*?)"
                      r"default", src["lanes.cuh"], re.S).group(1)
    assert tuple(int(c) for c in re.findall(r"case (\d+):", cases)) == LANES
    assert "if constexpr (FIRST == 1)" in cases.split("case 2:")[0]
    for name, entry in (("layout_probe.cu", "viterbi_k12_launch"),
                        ("swar_probe.cu", "viterbi_k18_launch")):
        s = src[name]
        assert re.search(rf"int {entry}\(int variant, int lanes,", s)
        assert re.search(r"launch_split\(int lanes.*?return viterbi::"
                         r"dispatch_lanes<2>\(lanes, ", s, re.S)
        assert '#include "lanes.cuh"' in s
        assert "switch (lanes)" not in s
        assert library.build_parts(library.CSRC / name) >= 2
    assert '#include "lanes.cuh"' in src["layout_probe.cu"]
    assert "lane_stage<L, J>" in src["layout_probe.cu"]
    assert int(re.search(r"kLoopStages = (\d+);", src["swar_probe.cu"])
               .group(1)) == sp.SPLIT_LOOP_STAGES
    body = src["swar_probe.cu"]
    body = body[body.index("swar_lanes_kernel("):]
    base, swar = body.split("} else {", 1)
    assert "__shfl" not in base and swar.count("__shfl_sync") == 4
