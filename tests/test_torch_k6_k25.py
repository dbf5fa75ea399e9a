"""K6 (the staging transpose) and K25 (SOFT16's ablation) as redesigned for
the H100, on the CPU: what the kernels' wrappers decide in Python and the
arithmetic their designs rest on, against the JAX package.

- K6: ``core_torch.stage_transpose`` (K6's plain version, which its wrapper
  runs on a CPU tensor) against ``core_xla.stage_words`` and
  ``core_xla.overlapped_windows`` at every shape the kernel treats
  differently: each channel at dec_len 32 and 96 (HARD: stride 2, win 6),
  stride % 4 in 0-3, odd num, num below one tile, a stream that ends
  mid-window, a stream sliced 1-3 words off its start; and
  ``core_cuda.transpose_route`` (the load width and tile rows) for each of
  them and over a grid of strides, windows and addresses.
- K25: ``soft16_ablation.lanes_for`` (the lanes an array the wrapper picks)
  and the wrapper's refusals; the in-place lane layout of
  ``csrc/soft16_ablation.cu`` modelled in numpy at every lane count, each
  lane's branch-metric flips taken apart as the kernel takes them, against
  the plain version, which tests/test_torch_last_probes.py holds against
  the JAX script's kernel (the model is tests/lane_model.py, shared with
  K13's and K19's tests).

The kernels themselves run only on a card (tests/test_torch_cuda.py)."""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_viterbi.config import ChannelIn, DecodeOut, DecoderConfig
from tpu_viterbi.decoder import core_xla
from tpu_viterbi_torch import library
from tpu_viterbi_torch.config import from_reference
from tpu_viterbi_torch.decoder import core_cuda, core_torch
from tpu_viterbi_torch.scripts import common
from tpu_viterbi_torch.scripts import soft16_ablation as sa

import lane_model

K6 = core_cuda.K6
K25 = sa.K25


# --- K6 ---

def _route_ok(vec, ti, ptr, stride, win):
    """vec is the widest of K6_VECS that divides the stride and the
    address; ti pads win least, the larger on a tie."""
    ok = [v for v in core_cuda.K6_VECS
          if stride % v == 0 and ptr % (4 * v) == 0]
    pad = {t: -(-win // t) * t for t in core_cuda.K6_TILE_ROWS}
    best = min(pad.values())
    return vec == max(ok) and ti == max(t for t, p in pad.items()
                                        if p == best)


def _stream(rng, n, dtype):
    """n random 32-bit words; float32 ones with NaN payloads and infs."""
    bits = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    if dtype == np.float32:
        bits[::7] = 0x7FC00001 + np.arange(len(bits[::7]), dtype=np.uint32)
        bits[3::11] = 0x7F800000
    return bits.view(dtype)


def _jax_windows(x: np.ndarray, stride: int, win: int, num: int):
    """core_xla's (num, win) overlapping windows, transposed to K6's
    (win, num), as 32-bit words."""
    got = core_xla.overlapped_windows(jnp.asarray(x.view(np.uint32)), stride,
                                      win, num)
    return np.asarray(got).T


@pytest.mark.parametrize("dec_len", [32, 96])
@pytest.mark.parametrize("ch", list(ChannelIn), ids=lambda c: c.name)
def test_k6_stages_every_channel_like_jax(rng, ch, dec_len):
    """Each channel's words staged at dec_len 32 and 96 (HARD at 32:
    stride 2, win 6) equal core_xla.stage_words; the route is the widest
    load and the least-padded tile; a CPU call launches nothing."""
    jcfg = DecoderConfig(ch, decode_out=DecodeOut.O_B32)
    jplan = core_xla.plan_blocks(dec_len * 37 - 32, jcfg.bits_per_pack,
                                 dec_len)
    cfg, plan = from_reference(jcfg), core_torch.plan_from_reference(jplan)
    n = jcfg.get_input_words(2 * (jplan.message_len + 64))
    x = _stream(rng, n, np.float32 if ch == ChannelIn.FP32 else np.int32)
    want = np.asarray(core_xla.stage_words(jnp.asarray(x), jcfg, jplan,
                                           jplan.num_blocks))
    wpb, wph = core_torch.words_per_block(cfg, plan)
    xt = torch.from_numpy(x)
    before = (K6.launches, sum(K6.route_launches.values()))
    got = K6(xt, wpb, wpb + wph, plan.num_blocks)
    assert (K6.launches, sum(K6.route_launches.values())) == before
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    vec, ti = core_cuda.transpose_route(xt.data_ptr(), wpb, wpb + wph)
    assert _route_ok(vec, ti, xt.data_ptr(), wpb, wpb + wph)
    if ch == ChannelIn.HARD and dec_len == 32:
        assert (wpb, wpb + wph, ti) == (2, 6, 8)


@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("num,short", [(333, 0), (5, 0), (333, 17)],
                         ids=["odd-num", "num-below-a-tile",
                              "ends-mid-window"])
@pytest.mark.parametrize("stride", [64, 65, 66, 67],
                         ids=lambda s: f"stride%4={s % 4}")
def test_k6_windows_like_jax(rng, stride, num, short, dtype):
    """win = 3 stride of overlapping windows at every stride % 4, an odd
    num and one below a tile (128 blocks at 32 rows), and a stream that
    ends 17 words into its last window (zeros past it); the route loads
    4 words only where the stride allows it."""
    win = 3 * stride
    n = (num - 1) * stride + win - short
    x = _stream(rng, n, dtype)
    got = K6(torch.from_numpy(x), stride, win, num)
    assert got.shape == (win, num) and got.is_contiguous()
    assert np.array_equal(got.numpy().view(np.uint32),
                          _jax_windows(x, stride, win, num))
    vec, ti = core_cuda.transpose_route(0, stride, win)
    assert _route_ok(vec, ti, 0, stride, win)
    assert vec == {0: 4, 2: 2}.get(stride % 4, 1)


@pytest.mark.parametrize("shape", [(1024, 1056, 129), (2, 6, 600)],
                         ids=["wide", "HARD-32"])
@pytest.mark.parametrize("off", [1, 2, 3])
def test_k6_sliced_stream_like_jax(rng, off, shape):
    """A stream sliced 1-3 words off its start (an address 4, 8 or 12
    bytes past 16) equals JAX on the same words; the route narrows its
    loads to what the address allows."""
    stride, win, num = shape
    x = _stream(rng, (num - 1) * stride + win + off, np.int32)
    xt = torch.from_numpy(x)[off:]
    assert xt.is_contiguous()
    got = K6(xt, stride, win, num)
    assert np.array_equal(got.numpy().view(np.uint32),
                          _jax_windows(x[off:], stride, win, num))
    base = torch.from_numpy(x).data_ptr()
    vec, ti = core_cuda.transpose_route(base + 4 * off, stride, win)
    assert _route_ok(vec, ti, base + 4 * off, stride, win)
    if base % 16 == 0:
        assert vec == (2 if off == 2 else 1)


def test_transpose_route_over_strides_windows_and_addresses():
    for ptr, stride, win in itertools.product(range(0, 64, 4), range(1, 13),
                                              range(1, 70)):
        vec, ti = core_cuda.transpose_route(ptr, stride, win)
        assert _route_ok(vec, ti, ptr, stride, win), (ptr, stride, win)
    assert core_cuda.transpose_route(256, 1024, 1056) == (4, 32)
    assert core_cuda.transpose_route(256, 4096, 4224) == (4, 32)


def test_k6_constants_match_the_source():
    """The tile size and the (vec, ti) instances the wrapper may ask for
    are viterbi.cu's."""
    src = (library.CSRC / "viterbi.cu").read_text()
    assert re.findall(r"constexpr int kTrTileWords = (\d+);", src) == \
        [str(core_cuda.K6_TILE_WORDS)]
    routes = {(int(v), int(t)) for v, t in
              re.findall(r"K6_ROUTE\((\d+), (\d+)\)", src)}
    assert routes == set(itertools.product(core_cuda.K6_VECS,
                                           core_cuda.K6_TILE_ROWS))


# --- K25 ---

@pytest.mark.parametrize("arrays", [1, 128, 2048, 4096, 8000, 8448, 15872,
                                    65536])
def test_lanes_for_fills_the_card(arrays):
    """L divides 64; one lane from ONE_LANE_ARRAYS arrays, else the fewest
    lanes that reach TARGET_THREADS threads, at most 32; 32 at the JAX
    script's 2,048 arrays, 1 at the headline's 15,872 (the rule is
    scripts/common.py's, shared with K13 and K19)."""
    n = sa.lanes_for(arrays)
    assert n in sa.LANES and 64 % n == 0
    if arrays >= common.ONE_LANE_ARRAYS:
        assert n == 1
    else:
        assert arrays * n >= common.TARGET_THREADS or n == sa.LANES[-1]
        assert all(arrays * m < common.TARGET_THREADS
                   for m in sa.LANES[1:] if m < n)
    assert {2048: 32, 15872: 1}.get(arrays, n) == n


def test_lanes_for_is_monotone():
    picks = [sa.lanes_for(a) for a in range(1, 40_000, 37)]
    assert all(a >= b for a, b in zip(picks, picks[1:]))


@pytest.mark.parametrize("lanes", [0, 3, 64, 2.0])
def test_k25_refuses_bad_lanes(lanes):
    words = sa.probe_input(1, 1, 32, "cpu", seed=4)
    before = (K25.launches, sum(K25.lane_launches.values()))
    with pytest.raises(ValueError, match="lanes"):
        K25("s16/unpack", words, 1, lanes)
    assert (K25.launches, sum(K25.lane_launches.values())) == before


@pytest.mark.parametrize("lanes", sa.LANES)
def test_k25_lanes_on_cpu_are_the_plain_version(lanes):
    words = sa.probe_input(2, 1, 16, "cpu", seed=lanes)
    assert torch.equal(K25("s8/unpack", words, 2, lanes),
                       sa.soft16_ablation_torch("s8/unpack", words, 2))


def _lane_layout(variant, words, programs, lanes):
    """The lane-split kernel's arithmetic in numpy (tests/lane_model.py):
    lane l holds positions l * S + r; in phase f = t % 6 position P pairs
    with P ^ (1 << b), b = 5 - f (a shuffle when b is a lane bit), bm's
    choice is the lane's flips XOR the register's bits, and the partner
    wins on c_part > c_self, or on a tie where P's x bit is 1."""
    n_packs = words.shape[0] // programs
    wpp = sa.WPP[variant]
    w = words.reshape(programs, n_packs, wpp, 128).permute(1, 2, 0, 3) \
        .reshape(n_packs, wpp, programs * 128)          # int32, as the kernel
    pm, pp = lane_model.run_trellis(
        [sa._stage_fields(variant, w[p]) for p in range(n_packs)], lanes,
        programs * 128)
    out = lane_model.wrap32(pm[0] + pp[0])
    return torch.from_numpy(out.astype(np.int32)).reshape(programs, 1, 128)


@pytest.mark.parametrize("lanes", sa.LANES[1:])
@pytest.mark.parametrize("variant", sa.VARIANTS)
def test_k25_lane_layout_equals_the_plain_version(variant, lanes):
    """The in-place layout over 1 and 3 packs (32 and 96 stages: a tail
    of 2 stages after the passes of 6, and none) computes the natural-order
    ACS of the plain version bit for bit, full-range words included."""
    for n_packs in (1, 3):
        words = sa.probe_input(1, n_packs, sa.WPP[variant], "cpu",
                               seed=7 * n_packs + lanes)
        assert torch.equal(_lane_layout(variant, words, 1, lanes),
                           sa.soft16_ablation_torch(variant, words, 1))


def test_k25_constants_match_the_source():
    """The lane counts the entry takes are those of lanes.cuh's
    dispatch_lanes, which soft16_ablation.cu calls, and the pass of six
    stages is that of lanes.cuh, which it includes."""
    src = (library.CSRC / "soft16_ablation.cu").read_text()
    header = (library.CSRC / "lanes.cuh").read_text()
    cases = re.search(r"cudaError_t dispatch_lanes\(int lanes.*?switch "
                      r"\(lanes\) \{(.*?)default", header, re.S).group(1)
    assert tuple(int(c) for c in re.findall(r"case (\d+):", cases)) == \
        sa.LANES
    assert "viterbi::dispatch_lanes(lanes, " in src
    assert '#include "lanes.cuh"' in src
    assert re.findall(r"constexpr int kPass = (\d+);", src) == []
    assert re.findall(r"constexpr int kPass = (\d+);", header) == \
        [str(sa.loop_stages(2))]
