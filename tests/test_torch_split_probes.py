"""The port's generator probe (K20) and decode-attribution probes (K21
bench pieces, K22 values-in split, K23 staging cost with the roll halo,
K24 SOFT16 pieces) against the JAX package, on the CPU.  K20's plain
versions are bit-equal to jax's threefry and to the script's tf kernel in
interpret mode, within 1 ulp of its log kernel; the pieces K21, K22 and
K24 drive, run on CPU tensors (so through the plain versions), equal the
XLA core's decodes; K23's plain roll decode equals an XLA twin built the
way ``_kernel_roll`` builds its words.  No decode kernel is compiled in
interpret mode.  The kernels run only on a card
(tests/test_torch_cuda.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_probes import _jax_script
from tpu_viterbi.chain.genkernel import threefry2x32 as jthreefry2x32
from tpu_viterbi.config import ChannelIn as JChannelIn
from tpu_viterbi.config import DecoderConfig as JDecoderConfig
from tpu_viterbi.decoder import core_xla
from tpu_viterbi_torch.config import ChannelIn, DecodeOut, DecoderConfig
from tpu_viterbi_torch.decoder import core_cuda, core_torch
from tpu_viterbi_torch.decoder.core_torch import assemble_output
from tpu_viterbi_torch.scripts import (bench_profile, bench_split,
                                       genkernel_probe, soft16_pieces,
                                       staging_cost)

torch.set_num_threads(1)

N_BITS = 200_000


def _jplan(plan):
    return core_xla.BlockPlan(plan.message_len, plan.dec_len,
                              plan.num_blocks, plan.bits_per_pack)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64) & 0xFFFFFFFF


# --- K20: the generator probe ---

def test_threefry20_plain_matches_jax_and_tf_kernel():
    """The parity input (c0 = 0..1023, c1 = 7, key 0xDEADBEEF / 0x12345678):
    the plain version at 20 rounds, and the wrapper on a CPU tensor, equal
    jax._src.prng.threefry_2x32 and the script's tf_kernel in interpret
    mode, bit for bit."""
    from jax._src.prng import threefry_2x32
    gp = genkernel_probe
    c = gp.tf_input("cpu")
    k0, k1 = gp.KEY
    w = threefry_2x32(jnp.array([k0, k1], dtype=jnp.uint32),
                      jnp.asarray(c.numpy().reshape(2, -1).view(np.uint32)))
    jprobe = _jax_script("genkernel_probe")
    kernel = functools.partial(
        jprobe.tf_kernel, k0=np.int32(np.uint32(k0).view(np.int32)),
        k1=np.int32(np.uint32(k1).view(np.int32)))
    i0, i1 = pl.pallas_call(
        kernel, out_shape=[jax.ShapeDtypeStruct((gp.R, gp.L), jnp.int32)] * 2,
        interpret=True)(jnp.asarray(c.numpy()))
    x0, x1 = gp.tf_torch(c, k0, k1)
    before = gp.K20.launches
    g0, g1 = gp.K20.tf(c, k0, k1)
    assert gp.K20.launches == before
    for got in ((x0, x1), (g0, g1)):
        for j in range(2):
            assert got[j].dtype == torch.int32
            assert np.array_equal(_u32(got[j]).reshape(-1),
                                  np.asarray(w[j]).astype(np.int64))
            assert np.array_equal(got[j].numpy(), np.asarray((i0, i1)[j]))


def test_threefry_known_answers():
    """The Random123 threefry2x32_20 vectors through the wrapper on the CPU,
    and jax's threefry_2x32 on them: the probe's known-answer line."""
    from jax._src.prng import threefry_2x32
    for (k0, k1), (c0, c1), want in genkernel_probe.KNOWN_ANSWERS:
        jw = threefry_2x32(jnp.array([k0, k1], dtype=jnp.uint32),
                           jnp.array([[c0], [c1]], dtype=jnp.uint32))
        assert tuple(int(v) for v in np.asarray(jw).ravel()) == want
        c = torch.tensor([[c0], [c1]], dtype=torch.int64)
        x0, x1 = genkernel_probe.K20.tf(
            torch.where(c >= 2 ** 31, c - 2 ** 32, c).to(torch.int32), k0, k1)
        assert (int(x0[0]) & 0xFFFFFFFF, int(x1[0]) & 0xFFFFFFFF) == want


def test_log_sqrt_plain_within_2ulp_of_jax_interpret():
    """linspace(0.01, 9) on (8, 128) f32: the plain log + sqrt within 2 ulp
    of the larger term of the script's log_kernel in interpret mode (XLA's
    CPU logf is itself up to 2 ulp from numpy's, so 1 cannot hold; off the
    cancellation near x = 0.49 the sums are within 1 ulp); the probe's rel
    err line is small."""
    gp = genkernel_probe
    x = gp.log_input("cpu")
    jprobe = _jax_script("genkernel_probe")
    want = torch.from_numpy(np.array(pl.pallas_call(
        jprobe.log_kernel,
        out_shape=jax.ShapeDtypeStruct((gp.R, gp.L), jnp.float32),
        interpret=True)(jnp.asarray(x.numpy()))))
    got = gp.log_sqrt_torch(x)
    assert gp.term_ulps(got, want, x) <= 2
    far = (x - 0.49).abs() > 0.2
    assert gp.ulp_diff(got[far], want[far]) <= 1
    assert torch.equal(gp.K20.log_sqrt(x), got)
    res = gp.parity("cpu")
    assert res["tf_ok"] and res["known_ok"] and res["rel_err"] < 1e-5


@pytest.mark.parametrize("rounds", [20, 13])
@pytest.mark.parametrize("reps", [4, 8])
def test_many_plain_matches_jax_threefry_xor(reps, rounds):
    """G = 2, RB = 8 of the rate grid: the plain ``many`` equals the XOR of
    the JAX package's threefry2x32 outputs on counters c0 + r (int32 adds
    wrapping), at the JAX probe's 20 rounds and K7's 13."""
    gp = genkernel_probe
    c = gp.many_input("cpu", g=2, rb=8)
    c[0] += 2 ** 31 - 5                  # the int32 add c0 + r wraps
    k0, k1 = gp.MANY_KEY
    jc = jnp.asarray(c.numpy())
    acc = jnp.zeros_like(jc[0])
    for r in range(reps):
        x0, x1 = jthreefry2x32(jnp.int32(k0), jnp.int32(k1),
                               jc[0] + jnp.int32(r), jc[1], rounds=rounds)
        acc = acc ^ x0 ^ x1
    got = gp.many_torch(c, k0, k1, reps, rounds)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(acc))
    assert torch.equal(gp.K20.many(c, k0, k1, reps, rounds), got)


def test_k20_refusals_and_ops():
    gp = genkernel_probe
    c = gp.tf_input("cpu")
    with pytest.raises(ValueError):
        gp.K20.tf(c, 1, 2, rounds=12)
    with pytest.raises(ValueError):
        gp.K20.many(c.to(torch.int64), 1, 2, 4)
    with pytest.raises(ValueError):
        gp.K20.many(c, 1, 2, 0)
    with pytest.raises(ValueError):
        gp.K20.log_sqrt(torch.ones(4, dtype=torch.float64))
    assert gp.threefry_ops(20) == 72 and gp.threefry_ops(13) == 49


# --- K21 / K22: the bench pieces and the values-in split ---

@pytest.mark.parametrize("dec_len", [2048, 8192])
def test_bench_profile_pieces_match_xla(dec_len):
    """About 200,000 bits of random SOFT8 words: K1's raw packs
    assembled, and the decode piece, equal decode_packed_xla; the staging
    piece equals core_xla.stage_words; the check equals the JAX script's
    popcount of y[0] ^ y[1] (:132-134), and d+c the XOR count of the XLA
    decode against the reference packs."""
    cfg = bench_profile.CFG
    plan = bench_profile.make_plan(N_BITS, dec_len)
    inp = bench_profile.make_inputs(N_BITS, plan, "cpu", seed=3)
    f = bench_profile.pieces(inp, plan)
    jcfg, jplan = JDecoderConfig(JChannelIn.SOFT8), _jplan(plan)
    x = jnp.asarray(inp["x"].numpy())
    want = np.asarray(core_xla.decode_packed_xla(x, jcfg, jplan)) \
        .astype(np.int64)
    assert np.array_equal(_u32(assemble_output(f["kraw"](), cfg, plan)), want)
    assert np.array_equal(_u32(f["decode"]()), want)
    assert np.array_equal(
        f["stage"]().numpy(),
        np.asarray(core_xla.stage_words(x, jcfg, jplan, plan.num_blocks)))
    y = jnp.asarray(inp["y"].numpy())
    chk = jnp.sum(jax.lax.population_count(y[0] ^ y[1]).astype(jnp.int32))
    assert int(f["check"]()) == int(chk)
    ref = inp["ref"].numpy()
    n = plan.message_len // 32
    diff = (want[:n] ^ ref[:n]).astype(np.uint32)
    assert int(f["d+c"]()) == int(np.unpackbits(diff.view(np.uint8)).sum())


@pytest.mark.parametrize("dec_len", [2048, 8192])
def test_bench_split_pieces_match_xla(dec_len):
    """(m + 64, 2) values in [-100, 100] at about 200,000 bits: the staged
    values are the (2 * block_len, B) layout of the plan's blocks, the
    kernel piece's packs assembled and the full piece equal
    core_xla.decode_blocks."""
    m = N_BITS
    plan = bench_split.make_plan(m, dec_len)
    r = bench_split.make_values(m, "cpu", seed=4)
    assert int(r.min()) >= -100 and int(r.max()) <= 100
    f = bench_split.pieces(r, plan)
    jplan = _jplan(plan)
    jcfg = JDecoderConfig(JChannelIn.SOFT8)
    blocks = core_xla.gather_blocks(jnp.asarray(r.numpy()), jplan)
    want = np.asarray(core_xla.decode_blocks(blocks, jcfg, jplan)) \
        .astype(np.int64)
    staged = f["staging"]()
    assert np.array_equal(
        staged.numpy(),
        np.asarray(blocks).reshape(plan.num_blocks, -1).T)
    assert np.array_equal(
        _u32(assemble_output(f["kernel"](), bench_split.CFG, plan)), want)
    assert np.array_equal(_u32(f["full"]()), want)


# --- K23: the staging-cost probe and its roll-halo kernel ---

def _roll_twin(xp: np.ndarray, plan, b_pad: int) -> np.ndarray:
    """The XLA twin of K23: _kernel_roll's words built in numpy (body rows,
    the halo packs the first wph words of the next block of the 128-block
    tile, rolled), unpacked as stage_layout_packed unpacks, then
    forward_scan_staged + traceback_scan -> (b_pad, n_emit) uint32."""
    jcfg = JDecoderConfig(JChannelIn.SOFT8)
    dpp, width = jcfg.enc_data_per_pack, jcfg.enc_data_width
    wpb, wph = 2 * plan.dec_len // dpp, 2 * 64 // dpp
    body = xp[: b_pad * wpb].reshape(b_pad, wpb)
    tiles = body.reshape(b_pad // 128, 128, wpb)
    halo = np.roll(tiles[:, :, :wph], -1, axis=1).reshape(b_pad, wph)
    wt = jnp.asarray(np.concatenate([body, halo], axis=1).T)    # (Lw, b)
    u = wt.view(jnp.uint32)
    shifts = jnp.arange(dpp - 1, -1, -1, dtype=jnp.uint32)[None, :, None]
    vals = ((u[:, None, :] >> (shifts * width))
            & jnp.uint32((1 << width) - 1)).astype(jnp.int32)
    half = 1 << (width - 1)
    vals = ((vals + half) & ((1 << width) - 1)) - half
    jplan = core_xla.BlockPlan(b_pad * plan.dec_len, plan.dec_len, b_pad, 32)
    rs = vals.reshape(jplan.n_packs, 32, 2, b_pad)
    surv = core_xla.forward_scan_staged(rs, jcfg, jplan)
    return np.asarray(core_xla.traceback_scan(surv, jcfg, jplan))


def test_roll_plain_matches_xla_twin():
    """Two tiles (249 blocks padded to 256) at dec_len 64 on random SOFT8
    words pre-padded to ``need``: the plain roll decode, and K23's wrapper
    on a CPU tensor, equal the XLA twin, tile wrap included."""
    inp = staging_cost.make_inputs(16_000, "cpu", dec_len=64, seed=5)
    plan, xp = inp["plan"], inp["xp"]
    b_pad = staging_cost.padded_blocks(plan)
    assert (plan.num_blocks, b_pad) == (249, 256)
    assert xp.numel() == staging_cost.need_words(staging_cost.CFG, plan)
    want = _roll_twin(xp.numpy(), plan, b_pad).astype(np.int64)
    got = staging_cost.roll_decode_torch(xp, staging_cost.CFG, plan)
    assert got.shape == (b_pad, plan.dec_len // 32)
    assert np.array_equal(_u32(got), want)
    before = staging_cost.K23.launches
    assert torch.equal(staging_cost.K23(xp, staging_cost.CFG, plan), got)
    assert staging_cost.K23.launches == before


def test_roll_words_are_the_stream_but_at_tile_edges():
    """Off the tile's last lane the roll words are block_major_words' body
    and halo; lane 127 of a tile takes the head of the tile's first block;
    so the roll decode equals the staged decode of the stream's own words
    on every block whose halo is not rolled."""
    cfg = staging_cost.CFG
    inp = staging_cost.make_inputs(16_000, "cpu", dec_len=96, seed=6)
    plan, xp = inp["plan"], inp["xp"]
    b_pad = staging_cost.padded_blocks(plan)
    wpb, wph = core_torch.words_per_block(cfg, plan)
    w = staging_cost.roll_words(xp, cfg, plan)
    body, halo = core_torch.block_major_words(xp, cfg, plan, b_pad)
    lane = torch.arange(b_pad)
    inner = lane % 128 != 127
    assert torch.equal(w[:, inner], torch.cat([body, halo], 1).t()[:, inner])
    for q in range(b_pad // 128):
        assert torch.equal(w[wpb:, 128 * q + 127], body[128 * q, :wph])
    got = staging_cost.roll_decode_torch(xp, cfg, plan)
    want = core_torch.decode_staged_torch(
        torch.cat([body, halo], 1).t().contiguous(), cfg,
        staging_cost.padded_plan(plan))
    assert torch.equal(got[inner], want[inner])
    assert not torch.equal(got, want)


def test_staging_cost_plans_and_refusals():
    """plan0 of the script's shape has overlap 0 (the JAX assert, :58-60)
    and one block fewer; K23 refuses FP32, SOFT16, b16 packs, dec_len <
    64 and a block long enough to need int32 renormalisation."""
    plan, plan0 = staging_cost.make_plans(staging_cost.N_BITS)
    assert plan0.overlap_bits == 0 and plan.overlap_bits > 0
    assert plan0.num_blocks == plan.num_blocks - 1
    assert staging_cost.padded_blocks(plan) == 3968
    x = torch.zeros(4096, dtype=torch.int32)
    with pytest.raises(Exception):
        staging_cost.K23(x.float(), DecoderConfig(ChannelIn.FP32),
                         core_torch.plan_blocks(4096, 32, 256))
    with pytest.raises(Exception):
        staging_cost.K23(x, DecoderConfig(ChannelIn.SOFT8,
                                          decode_out=DecodeOut.O_B16),
                         core_torch.plan_blocks(4096, 16, 256))
    with pytest.raises(Exception):
        staging_cost.K23(x, DecoderConfig(ChannelIn.SOFT16),
                         core_torch.plan_blocks(4096, 32, 256))
    with pytest.raises(ValueError):
        staging_cost.K23(x, staging_cost.CFG,
                         core_torch.plan_blocks(4096, 32, 32))
    with pytest.raises(ValueError, match="renormalise"):
        staging_cost.K23(x, staging_cost.CFG,
                         core_torch.plan_blocks(2 ** 23, 32, 2 ** 23))


def test_constants_match_the_cuda_sources():
    """What Python assumes of K20 and K23 is the sources' own: the roll
    kernel's tile is the 128 blocks the plain version rolls within, K20
    takes the rounds the wrapper allows, and the shared threefry's
    rotations are the plain version's."""
    import re
    from tpu_viterbi_torch import library
    from tpu_viterbi_torch.chain import genkernel
    roll = (library.CSRC / "staging_cost.cu").read_text()
    assert re.findall(r"constexpr int kTile = (\d+);", roll) == \
        [str(staging_cost.LT)]
    probe = (library.CSRC / "genkernel_probe.cu").read_text()
    assert sorted(int(r) for r in re.findall(r"rounds == (\d+)", probe)) == \
        sorted(genkernel_probe.ROUNDS_LIST)
    rots = re.search(r"kRots\[8\] = \{([^}]*)\}",
                     (library.CSRC / "threefry.cuh").read_text()).group(1)
    assert tuple(int(r) for r in rots.split(",")) == genkernel._ROTS
    assert "threefry.cuh" in (library.CSRC / "genkernel.cu").read_text()


# --- K24: the SOFT16 pieces ---

def test_soft16_kernel_only_matches_xla_and_ben0():
    """SOFT16 / 4096 on about 200,000 coded bits at 5.5 dB (K7's plain
    version): the kernel-only packs assembled equal decode_packed_xla, and
    the full piece counts 0 errors."""
    case = soft16_pieces.make_case(ChannelIn.SOFT16, 4096, "auto", N_BITS,
                                   "cpu")
    assert not case["window"] and case["label"] == "soft16/4096"
    f = soft16_pieces.pieces(case)
    cfg, plan = case["cfg"], case["plan"]
    want = np.asarray(core_xla.decode_packed_xla(
        jnp.asarray(case["words"].numpy()), JDecoderConfig(JChannelIn.SOFT16),
        _jplan(plan))).astype(np.int64)
    assert np.array_equal(_u32(assemble_output(f["kernel-only"](), cfg,
                                               plan)), want)
    assert int(f["full"]()) == 0


def test_soft16_window_config_matches_plain_window():
    """SOFT16 / 8192 with survivor 'window' (the script's third
    configuration), at half the bits: kernel-only is K3, on the CPU the
    plain windowed core (held to JAX by test_torch_window.py), equal to
    the full store on this coded input, and BEN 0."""
    case = soft16_pieces.make_case(ChannelIn.SOFT16, 8192, "window",
                                   N_BITS // 2, "cpu")
    assert case["window"] and case["label"] == "soft16/8192w"
    f = soft16_pieces.pieces(case)
    cfg, plan, words = case["cfg"], case["plan"], case["words"]
    before = core_cuda.K3.launches
    got = f["kernel-only"]()
    assert core_cuda.K3.launches == before
    assert torch.equal(got, core_torch.decode_blocks_torch(words, cfg, plan))
    assert int(f["full"]()) == 0
