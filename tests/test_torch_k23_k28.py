"""K23 (the roll-halo decode) and K28 (the interleave) as redesigned for the
H100, on the CPU: each time-block or column split over ``lanes`` threads,
modelled in numpy (tests/lane_model.py) as the kernels compute it, against
the plain versions, which tests/test_torch_split_probes.py and
tests/test_torch_last_probes.py hold against the JAX package.

- K28's regs and concat on the renaming frame: nothing moves between
  threads, position P = lane S + r holds logical row rol6(P, t % 6) after t
  reps and is written to that row (concat to row P), every element loaded
  and written once, reps 0-13 (two passes of 6 and every tail); smem's
  round trip through a warp's scratch, its 64-bit pair stores and its
  loads each falling in 32 distinct banks; the thread-a-column kernel's
  own model at one lane.
- K23's split decode: the roll words (the body from the stream, the halo
  the next time-block's heads through the cluster's map, the tile
  wrapping), ``run_trellis``'s stage loop, the dump's rows at each pack's
  end, the chase, at dec_len 64, 96 and 128 (tails of 2, 4 and 0 stages
  after the six-stage passes) over one and two tiles; the cluster's head
  map against ``roll_words``' neighbours.
- The wrappers: the plain version on a CPU tensor at every lane count,
  ``common.lanes_for``'s picks, the refusal of a lane count that is not
  built, before any launch; the sources' entries and layout.

The kernels themselves run only on a card (tests/test_torch_cuda.py)."""

import re

import numpy as np
import pytest
import torch

from tpu_viterbi_torch import library
from tpu_viterbi_torch.decoder import core_torch
from tpu_viterbi_torch.scripts import interleave_bench as ib
from tpu_viterbi_torch.scripts import staging_cost as sc
from tpu_viterbi_torch.scripts.common import LANES, lanes_for

import lane_model

torch.set_num_threads(1)

K23, K28 = sc.K23, ib.K28
K28_REPS = range(14)
K28_COLS = 200             # six warps of 32 columns and a ragged 8


def _k28_input(seed: int, cols: int = K28_COLS) -> torch.Tensor:
    return ib.probe_input(2, "cpu", seed=seed)[:, :cols].contiguous()


def _k28_lanes(variant, x, reps, lanes):
    if lanes == 1:
        got = lane_model.k28_one_lane(variant, x, reps)
    elif variant == "smem":
        got = lane_model.k28_split_smem(x, reps, lanes)
    else:
        got = lane_model.k28_split_regs(variant, x, reps, lanes)
    return torch.from_numpy(got.astype(np.int32))


# --- K28 ---

@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("variant", ib.SPLIT)
def test_k28_lane_frame_equals_the_plain_version(variant, lanes):
    """regs, smem and concat at every lane count over reps 0-13 compute
    interleave_torch bit for bit on 200 columns (a ragged warp)."""
    x = _k28_input(lanes)
    for reps in K28_REPS:
        assert torch.equal(_k28_lanes(variant, x, reps, lanes),
                           ib.interleave_torch(variant, x, reps)), reps


def test_k28_frame_write_out_is_needed():
    """A control: regs' positions written to row P (no rotation back) equal
    the plain version only where reps % 6 == 0; concat's equal it
    always."""
    x = _k28_input(3)
    for reps in K28_REPS:
        frame = lane_model.k28_split_regs("concat", x, reps, 4)
        frame = torch.from_numpy(frame.astype(np.int32))
        plain = ib.interleave_torch("regs", x, reps)
        assert torch.equal(frame, plain) == (reps % 6 == 0), reps
        assert torch.equal(frame, ib.interleave_torch("concat", x, reps))


@pytest.mark.parametrize("lanes", LANES[1:])
def test_k28_smem_scratch_is_conflict_free(lanes):
    """smem's scratch: each 64-bit store of a warp writes 256 contiguous
    bytes (each half-warp 32 distinct banks), each 32-bit load's 32 words
    fall in 32 distinct banks, and both address the rows the merge names
    (lane_model.k28_smem_accesses asserts that); the warp's two buffers
    hold 64 C words each, within 48 KB a CUDA block of 4 warps."""
    stores, loads = lane_model.k28_smem_accesses(lanes)
    for st in stores:
        assert (np.diff(st) == 1).all()
        for half in (st[:16], st[16:]):
            banks = np.concatenate([2 * half, 2 * half + 1]) % 32
            assert sorted(banks) == list(range(32))
    for lo, hi in loads:
        for words in (lo, hi):
            assert sorted(words % 32) == list(range(32))
    assert 4 * 2 * 64 * (32 // lanes) * 4 <= 48 * 1024


def test_k28_thread_columns_coalesce():
    """regs' and concat's split threads: a warp holds 32 adjacent columns
    at one lane, so each row's loads and stores are one 128-byte line; a
    column's lanes are L warps."""
    for lanes in LANES[1:]:
        c, lane = lane_model.k28_thread_columns(256, lanes)
        warps_c, warps_l = c.reshape(-1, 32), lane.reshape(-1, 32)
        assert (np.diff(warps_c, axis=1) == 1).all()
        assert (warps_c[:, 0] % 32 == 0).all()
        assert (warps_l == warps_l[:, :1]).all()
        for col in (0, 37, 255):
            assert sorted(lane[c == col]) == list(range(lanes))


# --- K23 ---

def _k23_case(dec_len: int, tiles: int, seed: int):
    """A plan of ``tiles`` 128-block tiles at dec_len (its last tile
    padded) and random full-range words pre-padded to ``need``."""
    cfg = sc.CFG
    plan = core_torch.plan_blocks(dec_len * (128 * tiles - 7) - 32, 32,
                                  dec_len)
    assert sc.padded_blocks(plan) == 128 * tiles
    x = np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, sc.need_words(cfg, plan), dtype=np.int64)
    return plan, torch.from_numpy(x.astype(np.int32))


def _k23_lanes(xp, plan, lanes):
    pplan = sc.padded_plan(plan)
    wpb, wph = core_torch.words_per_block(sc.CFG, pplan)
    n_conv, n_emit = core_torch.traceback_shape(sc.CFG, pplan)
    return lane_model.k23_split(xp.numpy(), wpb, wph, pplan.num_blocks,
                                pplan.n_packs, n_conv, n_emit, lanes)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("dec_len,tail", [(64, 2), (96, 4), (128, 0)])
def test_k23_split_decode_equals_the_plain_version(dec_len, tail, lanes):
    """The split decode over one and two tiles (the halo through the
    cluster's head map, the tile wrapping), the dump's rows at pack ends in
    phases 2, 4, 0 in turn, the chase: roll_decode_torch's packs bit for
    bit."""
    for tiles in (1, 2):
        plan, xp = _k23_case(dec_len, tiles, 10 * dec_len + lanes + tiles)
        out, store, phases, _ = _k23_lanes(xp, plan, lanes)
        pplan = sc.padded_plan(plan)
        assert pplan.n_packs * 32 % 6 == tail
        assert phases[:3] == [2, 4, 0][:len(phases[:3])]
        assert (store >= 0).all()
        want = sc.roll_decode_torch(xp, sc.CFG, plan)
        assert np.array_equal(lane_model.wrap32(out), want.numpy())


def test_k23_head_map_is_roll_words_neighbours():
    """(cluster rank, slot) -> the time-block whose heads are its halo:
    the next slot, slot 15 the first slot of the next rank, rank 7's wrapping
    to rank 0 (the tile's last block takes its first's heads): roll_words'
    nbr, block for block, over two tiles; the source's cluster is 8 CUDA
    blocks of 16 time-blocks."""
    src = (library.CSRC / "staging_cost.cu").read_text()
    assert re.search(r"constexpr int kCluster = 8;", src)
    assert re.search(r"constexpr int kSlots = kTile / kCluster;", src)
    plan, xp = _k23_case(64, 2, 1)
    *_, nbr = _k23_lanes(xp, plan, 2)
    lane = np.arange(256)
    assert np.array_equal(nbr, lane - lane % 128 + (lane + 1) % 128)
    assert lane_model.k23_neighbour(7, 15, 8, 16) == (0, 0)
    assert lane_model.k23_neighbour(3, 15, 8, 16) == (4, 0)
    assert lane_model.k23_neighbour(3, 4, 8, 16) == (3, 5)


def test_k23_model_sees_the_wrap_and_the_tie_rule():
    """Controls: a halo of the stream's own next block (no wrap) differs
    from the plain version at each tile's last block only; a strict '>'
    tie rule differs somewhere."""
    plan, xp = _k23_case(64, 1, 2)
    want = sc.roll_decode_torch(xp, sc.CFG, plan).numpy()
    pplan = sc.padded_plan(plan)
    staged = core_torch.decode_staged_torch(
        torch.cat(core_torch.block_major_words(xp, sc.CFG, pplan, 128),
                  1).t().contiguous(), sc.CFG, pplan).numpy()
    differ = (staged != want).any(axis=1)
    assert differ[127] and not differ[:127].any()
    real = lane_model.lane_acs_stage
    try:
        def strict(pm, pp, f, lanes, bm):
            part, h = lane_model.pairs(lanes, f)
            h = (h == 1)[:, None]
            cs = lane_model.wrap32(pm + bm)
            cp = lane_model.wrap32(pm[part] - bm)
            dec = cp > cs
            return (np.where(dec, cp, cs),
                    (np.where(dec, pp[part], pp) << 1 | (dec != h))
                    & 0xFFFFFFFF)
        lane_model.lane_acs_stage = strict
        out, *_ = _k23_lanes(xp, plan, 4)
        assert not np.array_equal(lane_model.wrap32(out), want)
    finally:
        lane_model.lane_acs_stage = real


# --- the wrappers ---

@pytest.mark.parametrize("lanes", (None,) + LANES)
def test_k23_k28_lanes_on_cpu_are_the_plain_version(lanes):
    """On a CPU tensor each wrapper gives its plain version at every lane
    count (shfl at its 32) and launches nothing."""
    x = _k28_input(5, 72)
    plan, xp = _k23_case(64, 1, 3)
    before = [(k.launches, sum(k.lane_launches.values())) for k in (K23, K28)]
    for v in ib.SPLIT:
        assert torch.equal(K28(v, x, 7, lanes=lanes),
                           ib.interleave_torch(v, x, 7))
    assert torch.equal(K28("shfl", x, 7, lanes=None if lanes is None else 32),
                       ib.interleave_torch("shfl", x, 7))
    assert torch.equal(K23(xp, sc.CFG, plan, lanes),
                       sc.roll_decode_torch(xp, sc.CFG, plan))
    assert [(k.launches, sum(k.lane_launches.values()))
            for k in (K23, K28)] == before


@pytest.mark.parametrize("lanes", [0, 3, 64, 2.0])
def test_k23_k28_refuse_bad_lanes(lanes):
    """A lane count that is not built raises before any launch; shfl takes
    only its 32."""
    x = _k28_input(5, 40)
    plan, xp = _k23_case(64, 1, 3)
    before = [(k.launches, sum(k.lane_launches.values())) for k in (K23, K28)]
    for v in ib.VARIANTS:
        with pytest.raises(ValueError, match="lanes"):
            K28(v, x, 3, lanes=lanes)
    with pytest.raises(ValueError, match="lanes"):
        K23(xp, sc.CFG, plan, lanes)
    for n in LANES[:-1]:
        with pytest.raises(ValueError, match="one warp a column"):
            K28("shfl", x, 3, lanes=n)
    assert [(k.launches, sum(k.lane_launches.values()))
            for k in (K23, K28)] == before


@pytest.mark.parametrize("arrays,want", [(1024, 32), (3968, 32),
                                         (270_336, 1)])
def test_k23_k28_pick_the_shared_rule(arrays, want):
    """The default lanes are common.lanes_for's: 32 at K28's JAX shape
    (1,024 columns) and at K23's 3,968 time-blocks (32M bits, dec_len
    8192), 1 at K28's full grid."""
    assert lanes_for(arrays) == want
    assert K23.pick_lanes(arrays, None) == want
    for v in ib.SPLIT:
        assert K28.lanes_of(v, arrays, None) == want
    assert K28.lanes_of("shfl", arrays, None) == ib.SHFL_LANES
    plan, _ = sc.make_plans(sc.N_BITS)
    assert sc.padded_blocks(plan) == 3968


def test_k23_k28_sources_launch_every_lane_count():
    """Each entry takes the lane count last before the stream and sends it
    through lanes.cuh's dispatch_lanes, one lane the first design's kernel
    (roll_kernel, interleave_kernel<V>), the rest the split; K23's split
    is a cluster launch whose halo comes through distributed shared memory
    (no load of a halo word from the stream after the heads), behind two
    cluster barriers; K28's split regs and concat never shuffle, smem
    orders its reps with __syncwarp; the probes' loop reps and SASS keys
    name every built kernel."""
    roll = (library.CSRC / "staging_cost.cu").read_text()
    assert re.search(r"int viterbi_k23_launch\(.*?int n_emit,\s+int lanes, "
                     r"void\* stream\)", roll, re.S)
    assert "viterbi::dispatch_lanes(lanes, " in roll
    assert re.search(r"if constexpr \(L == 1\) \{.*?roll_kernel<<<", roll,
                     re.S)
    split = roll[roll.index("roll_lanes_kernel(const int*"):]
    split = split[:split.index("cudaError_t launch(")]
    assert "__cluster_dims__(kCluster, 1, 1)" in roll
    assert split.count("cluster.sync();") == 2
    assert "cluster.map_shared_rank(" in split
    assert split.count("__ldg(") == 1        # the heads' load
    lanes_cls = roll[roll.index("struct RollLanes"):
                     roll.index("roll_lanes_kernel(const int*")]
    assert "halo[idx - wpb]" in lanes_cls
    inter = (library.CSRC / "interleave.cu").read_text()
    assert re.search(r"int viterbi_k28_launch\(int variant, const void\* x, "
                     r"void\* out,\s+int cols, int reps, int one, int lanes,"
                     r"\s+void\* stream\)", inter)
    assert inter.count("viterbi::dispatch_lanes(lanes, ") == 1
    assert re.search(r"if constexpr \(L == 1\) \{\s+return launch<V>", inter)
    body = inter[inter.index("interleave_lanes_kernel(const int*"):]
    body = body[:body.index("cudaError_t launch_lanes(")]
    assert "__shfl" not in body and "__syncwarp" not in body
    rep = inter[inter.index("void smem_rep("):
                inter.index("interleave_lanes_kernel(const int*")]
    assert rep.count("__syncwarp();") == 1
    assert "return ((m >> 1) * C + cw) * 2 + (m & 1);" in inter
    assert ib.loop_reps("smem", 1) == 1 and ib.loop_reps("smem", 4) == 2
    assert [ib.loop_reps(v, 8) for v in ("regs", "concat", "shfl")] == \
        [12, 12, 1]
    passes = re.search(r"constexpr int kPassesPerIter = (.*?);",
                       inter).group(1)
    assert passes == "L >= 8 ? L / 4 : 1"
    for n in LANES:
        assert ib.loop_reps("regs", n) == 6 * (n // 4 if n >= 8 else 1)
        assert ib.loop_reps("regs", n) * 64 // n >= 96     # adds a thread
    assert {v: ib.variant_lanes(v) for v in ib.VARIANTS} == dict(
        regs=LANES, smem=LANES, concat=LANES, shfl=(ib.SHFL_LANES,))


def test_k23_sass_reads_the_body_pass_loop():
    """K23's SASS a stage is its body's pass loop: the one stage loop at one
    lane; split, the first of the two pass loops (the halo's last passes
    follow in the second), not the longer one nor the chase's or the heads'
    loops (the spans of the 32-lane and one-lane kernels' listings on the
    H100)."""
    split = [(592, 832, 16), (1200, 3072, 118), (5328, 5472, 10),
             (5600, 5840, 16), (8672, 13680, 314), (14528, 19968, 341),
             (26944, 27984, 66), (28336, 28704, 24)]
    one = [(304, 1184, 56), (1408, 1600, 13), (3536, 16448, 808),
           (3472, 18688, 952), (19056, 20128, 68), (20432, 20784, 23)]
    assert sc.body_pass_loop(split) == (8672, 13680, 314)
    assert sc.body_pass_loop(one) == (3536, 16448, 808)
    roll = (library.CSRC / "staging_cost.cu").read_text()
    loops = roll[roll.index("const int stages = n_packs * 32;"):
                 roll.index("__syncthreads();  // every row of the store")]
    assert loops.count("arr.template stages<0, kPass, true, false>") == 1
    assert loops.count("arr.template stages<0, kPass, true, true>") == 1
    assert "t0 / 2 + kPass - 1 < wpb" in loops
