"""K14 (the ACS variants) and K16 (the construct microbenchmark) as
redesigned for the H100, on the CPU: each array split over ``lanes`` lanes
of a warp, modelled in numpy (tests/lane_model.py) as the kernels compute
it, against the plain versions, which tests/test_torch_probes.py and
tests/test_torch_acs_probes.py hold against the JAX scripts' kernels in
interpret mode.

- The trellis variants (K14's full, pp_noshuf, eo, decbits; K16's bcast
  and no_pp) on the in-place layout of ``csrc/lanes.cuh``: the position
  holding hi adds -bm where both children take the same candidates, the
  tie rule turns with the position's x bit, the output rows are mapped
  back from the last phase (32, 64 and 96 stages: tails of 2, 4 and 0);
  pp_noshuf's and decbits' survivors, keyed by fixed rows, shift in place
  and are put back together bit by bit from the positions that held each
  row's key.
- K16's no_acs, concat and pltpu_repeat in the fixed-partner layout: rows
  q and q + 32 in one lane, no exchange.
- K14's bit_tb over spans of stages, joined as one shift register, also
  where a span is shorter than the 6-bit state.
- The wrappers: the plain version on a CPU tensor at every lane count,
  ``common.lanes_for``'s pick, the refusal of a lane count that is not
  built, before any launch; the sources' entries and build parts; the
  construct's operation count beside the function's.
- ``scripts/sass_compare.py``, which holds the one-lane kernels (and every
  other) to another checkout's build: what it counts the same.

The kernels themselves run only on a card (tests/test_torch_cuda.py)."""

import re

import numpy as np
import pytest
import torch

from tpu_viterbi_torch import hardware, library
from tpu_viterbi_torch.scripts import acs_variants_bench as av
from tpu_viterbi_torch.scripts import kernel_microbench as km
from tpu_viterbi_torch.scripts import sass_compare
from tpu_viterbi_torch.scripts.common import LANES, lanes_for

import lane_model

K14, K16 = av.K14, km.K16
N_PACKS = (1, 2, 3)             # 32, 64 and 96 stages: tails 2, 4, 0
WIDTH = 24

# the in-place variants: (SAME, survivor mode, the row key of a shift-in)
K14_TRELLIS = {"full": (True, "exchange", None),
               "pp_noshuf": (True, "shift", lambda s: s >> 1),
               "eo": (False, "exchange", None),
               "decbits": (False, "shift", lambda s: s)}
K16_TRELLIS = {"bcast": (True, "exchange", None),
               "no_pp": (True, "count", None)}


def _k14_lanes(variant, rs, lanes):
    if variant == "bit_tb":
        got = lane_model.chase_split(rs, lanes)
    else:
        got = lane_model.probe_split(rs, lanes, *K14_TRELLIS[variant])
    return torch.from_numpy(got.astype(np.int32))


def _k16_lanes(variant, rs, lanes):
    if variant in K16_TRELLIS:
        got = lane_model.probe_split(rs, lanes, *K16_TRELLIS[variant])
    else:
        got = lane_model.fixed_split(rs, lanes, variant)
    return torch.from_numpy(got.astype(np.int32))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", av.VARIANTS)
def test_k14_lane_layout_equals_the_plain_version(variant, lanes):
    """Every variant over 32, 64 and 96 stages computes acs_variants_torch
    bit for bit on its lane layout."""
    for n_packs in N_PACKS:
        rs = av.probe_input(n_packs, WIDTH, "cpu", seed=5 * n_packs + lanes)
        assert torch.equal(_k14_lanes(variant, rs, lanes),
                           av.acs_variants_torch(variant, rs))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", km.VARIANTS)
def test_k16_lane_layout_equals_the_plain_version(variant, lanes):
    """Every variant over 32, 64 and 96 stages computes microbench_torch
    bit for bit on its lane layout."""
    for n_packs in N_PACKS:
        rs = km.probe_input(n_packs, WIDTH, "cpu", seed=3 * n_packs + lanes)
        assert torch.equal(_k16_lanes(variant, rs, lanes),
                           km.microbench_torch(variant, rs))


@pytest.mark.parametrize("n_packs,lanes", [(1, 8), (1, 16), (1, 32),
                                           (2, 16), (2, 32), (3, 32)])
def test_k14_chase_join_spans_under_six(n_packs, lanes):
    """Spans of 4, 2, 1, 4, 2 and 3 stages, shorter than the 6-bit state:
    the join keeps the bits of earlier spans that the later ones do not
    shift out, bit-equal to the one-lane chase; a join that only ORs the
    spans' states (a control) differs."""
    rs = av.probe_input(n_packs, 64, "cpu", seed=lanes + n_packs)
    assert n_packs * 32 // lanes < 6
    want = av.acs_variants_torch("bit_tb", rs)
    assert torch.equal(_k14_lanes("bit_tb", rs, lanes), want)
    control = lane_model.chase_split(rs, lanes, shift=False)
    assert not np.array_equal(control, want.numpy())


def test_k14_shift_in_rows_are_put_back_together():
    """A control for decbits: its words read by position, as if the
    survivors rode the rotation (no key), or keyed by the partner's row,
    differ from the plain version (and the right key agrees).  pp_noshuf's
    rows are all one word on this input (every pair takes the same
    decision: the metrics stay equal), so no key can be told apart there;
    its rows are put back together as decbits' are, keyed by the pair."""
    for n_packs in (1, 2, 3):
        rs = av.probe_input(n_packs, WIDTH, "cpu", seed=n_packs)
        same, mode, key = K14_TRELLIS["decbits"]
        want = av.acs_variants_torch("decbits", rs).numpy()
        assert np.array_equal(
            lane_model.probe_split(rs, 4, same, mode, key), want)
        for wrong in (None, lambda s: s ^ 32):
            assert not np.array_equal(
                lane_model.probe_split(rs, 4, same, mode, wrong), want)
        pp = av.acs_variants_torch("pp_noshuf", rs)
        assert torch.equal(pp, pp[:1].expand_as(pp))


@pytest.mark.parametrize("variant", ["full", "eo", "decbits", "bcast"])
def test_k14_k16_model_sees_the_tie_rule(variant):
    """A control: deciding every position on a strict '>' (the partner never
    taking a tie) differs from the plain version, so the tests above hold
    the x-bit tie rule on inputs with ties (bm = 0 in about 1 stage in
    200)."""
    rs = av.probe_input(2, 64, "cpu", seed=7)
    same, mode, key = {**K14_TRELLIS, **K16_TRELLIS}[variant]
    plain = (km.microbench_torch if variant == "bcast"
             else av.acs_variants_torch)(variant, rs).numpy()
    real = lane_model.probe_stage
    try:
        def strict(pm, pp, f, lanes, bm, same, mode):
            part, h = lane_model.pairs(lanes, f)
            h = (h == 1)[:, None]
            b = lane_model.wrap32(np.where(h & same, -bm, bm))
            cs = lane_model.wrap32(pm + b)
            cp = lane_model.wrap32(pm[part] - b)
            dec = cp > cs
            src = np.where(dec, pp[part], pp) if mode == "exchange" else pp
            return (np.where(dec, cp, cs),
                    ((src << 1) | (dec != h)) & lane_model.M32)
        lane_model.probe_stage = strict
        assert not np.array_equal(
            lane_model.probe_split(rs, 4, same, mode, key), plain)
    finally:
        lane_model.probe_stage = real


# --- the wrappers ---

@pytest.mark.parametrize("lanes", (None,) + LANES)
def test_k14_k16_lanes_on_cpu_are_the_plain_version(lanes):
    """On a CPU tensor each wrapper gives its plain version at every lane
    count and launches nothing."""
    rs = av.probe_input(1, 40, "cpu", seed=11)
    before = [(k.launches, sum(k.lane_launches.values())) for k in (K14, K16)]
    for v in av.VARIANTS:
        assert torch.equal(K14(v, rs, lanes), av.acs_variants_torch(v, rs))
    for v in km.VARIANTS:
        assert torch.equal(K16(v, rs, lanes), km.microbench_torch(v, rs))
    assert [(k.launches, sum(k.lane_launches.values()))
            for k in (K14, K16)] == before


@pytest.mark.parametrize("lanes", [0, 3, 64, 2.0])
def test_k14_k16_refuse_bad_lanes(lanes):
    """A lane count that is not built raises before any launch."""
    rs = av.probe_input(1, 40, "cpu")
    before = [(k.launches, sum(k.lane_launches.values())) for k in (K14, K16)]
    for k, mod in ((K14, av), (K16, km)):
        for v in mod.VARIANTS:
            with pytest.raises(ValueError, match="lanes"):
                k(v, rs, lanes)
    assert [(k.launches, sum(k.lane_launches.values()))
            for k in (K14, K16)] == before


@pytest.mark.parametrize("arrays,want", [(2048, 32), (4096, 16),
                                         (9727, 8), (9728, 1), (15872, 1)])
def test_k14_k16_pick_the_shared_rule(arrays, want):
    """The default lanes are common.lanes_for's: 32 at the JAX shape (2,048
    arrays), 1 at the headline's 15,872 and from ONE_LANE_ARRAYS."""
    assert lanes_for(arrays) == want
    for k in (K14, K16):
        assert k.pick_lanes(arrays, None) == want
        assert k.pick_lanes(arrays, 4) == 4


def test_k14_k16_sources_launch_every_lane_count():
    """Each entry takes the lane count after the width (the stream last);
    each variant's launch goes through lanes.cuh's dispatch_lanes, one
    lane the one-thread-an-array kernel (its code the same as before the
    split), the rest the lane-split kernel; the entry sends each variant
    to the build part that compiles it, three parts a source; K16's
    fixed-partner stage never shuffles; K14's shift-in variants put their
    rows back together through shared memory and bit_tb joins by
    shuffles."""
    for name, entry, ns, parts in (
            ("acs_variants.cu", "viterbi_k14_launch", "acs",
             {0: (0, 4), 1: (1, 3), 2: (2,)}),
            ("kernel_microbench.cu", "viterbi_k16_launch", "microbench",
             {0: (0, 2), 1: (1, 4), 2: (3,)})):
        s = (library.CSRC / name).read_text()
        assert re.search(rf"int {entry}\(int variant, const void\* rs, "
                         r"void\* out,\s+int n_packs, int width, int lanes,"
                         r"\s+void\* stream\)", s)
        assert library.build_parts(library.CSRC / name) == 3
        assert "return viterbi::dispatch_lanes(lanes, [&](auto l) {" in s
        assert re.search(rf"if constexpr \(L == 1\) \{{\s+{ns}_kernel<V>", s)
        assert f"{ns}_lanes_kernel<V, L>" in s
        for part, variants in parts.items():
            body = s[s.index(f"#if IN_PART({part})\ncudaError_t "
                             f"launch_part{part}("):]
            body = body[:body.index("#endif")]
            assert sorted(int(v) for v in re.findall(
                r"launch_variant<(\d)>", body)) == list(variants)
            entry_body = s[s.index(f"int {entry}("):]
            for v in variants:
                assert re.search(rf"case {v}:(\s+case \d:)?\s+return "
                                 rf"static_cast<int>\(launch_part{part}\(",
                                 entry_body), (name, v)
    mb = (library.CSRC / "kernel_microbench.cu").read_text()
    fixed = mb[mb.index("void fixed_stage("):mb.index("using MicroLane")]
    assert "__shfl" not in fixed and "lane_partner" not in fixed
    acs = (library.CSRC / "acs_variants.cu").read_text()
    rows = acs[acs.index("void store_rows("):acs.index("void chase_lanes(")]
    assert "__syncwarp();" in rows and rows.count("tile[") == 2
    chase = acs[acs.index("void chase_lanes("):acs.index("acs_lanes_kernel(")]
    assert chase.count("__shfl_xor_sync") == 2
    assert "#pragma unroll 1" in chase       # the chase's loop, a stage


def test_k14_k16_construct_ops_count_64_states():
    """CONSTRUCT_OPS counts each variant's own 64-state stage as
    hardware.ACS_OPS counts K1's (2 candidate adds, a max with its
    decision, a survivor update a state; no_acs 2 adds a state; the chase
    its OPS), at or above the function's OPS (what the row's bound
    counts)."""
    acs_ops = hardware.ACS_OPS
    assert acs_ops == 64 * (2 + 1 + 1)
    for mod in (av, km):
        assert set(mod.CONSTRUCT_OPS) == set(mod.VARIANTS)
        for v in mod.VARIANTS:
            assert mod.CONSTRUCT_OPS[v] >= mod.OPS[v]
    assert {v: av.CONSTRUCT_OPS[v] for v in K14_TRELLIS} == \
        dict.fromkeys(K14_TRELLIS, acs_ops)
    assert av.CONSTRUCT_OPS["bit_tb"] == av.OPS["bit_tb"]
    assert km.CONSTRUCT_OPS == dict(no_acs=64 * 2, concat=acs_ops,
                                    no_pp=acs_ops, bcast=acs_ops,
                                    pltpu_repeat=acs_ops)
    assert [av.loop_stages_of(v, n) for v in ("eo", "bit_tb")
            for n in (1, 32)] == [2, 6, 1, 1]


def test_sass_compare_names_what_differs(capsys):
    """A kernel is the same only where its SASS count, digest, registers
    and stack all agree; one that differs or is gone is named; without
    the other checkout the script prints its usage and builds nothing."""
    theirs = {"a": (10, "00ff", 32, 0), "b": (12, "11ee", 40, 0),
              "c": (8, "22dd", 24, 16), "d": (6, "33cc", 20, 0)}
    mine = {"a": (10, "00ff", 32, 0), "b": (12, "11ee", 41, 0),
            "c": (8, "22dd", 24, 0), "e": (6, "33cc", 20, 0)}
    assert sass_compare.compare(mine, theirs) == (["a"], ["b", "c"], ["d"])
    assert sass_compare.compare(theirs, theirs) == (list(theirs), [], [])
    assert sass_compare.main([]) == 2
    assert "OTHER_CHECKOUT" in capsys.readouterr().err
