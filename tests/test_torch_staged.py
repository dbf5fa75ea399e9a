"""The staged-input decode paths of the port against the JAX package, bit
for bit: the values-in entry (``decode_blocks`` / ``decode_blocks_cuda``
against ``core_xla.decode_blocks``, the golden oracle of both packages and
``decode_blocks_pallas`` in interpret mode), ``decode_packed_cuda`` with
``fused=False`` (K6 -> K4 word mode) and ``fp32_words=False`` (K6 -> clamp
and split -> K5) against ``decode_packed_xla``, and the staging functions
against their JAX namesakes.  Inputs are made from a seed with numpy.

On the CPU the wrappers K4, K5 and K6 run their plain versions
(``core_torch.decode_staged_torch``, ``decode_planes_torch``,
``stage_transpose``); the kernels themselves are held against those on the
card by test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_viterbi.config import ChannelIn, DecodeOut, DecoderConfig
from tpu_viterbi.decoder import core_xla
from tpu_viterbi.decoder import golden as jgolden
from tpu_viterbi_torch.config import ConfigResolutionError, from_reference
from tpu_viterbi_torch.decoder import core_cuda, core_torch
from tpu_viterbi_torch.decoder import golden as tgolden

torch.set_num_threads(1)

B32, B16 = DecodeOut.O_B32, DecodeOut.O_B16
CHANNELS = list(ChannelIn)


def _pair(ch, out, m, dec_len):
    """(jax cfg, jax plan, port cfg, port plan) for one decode."""
    jcfg = DecoderConfig(ch, decode_out=out)
    jplan = core_xla.plan_blocks(m, jcfg.bits_per_pack, dec_len)
    return jcfg, jplan, from_reference(jcfg), \
        core_torch.plan_from_reference(jplan)


def _values(rng, ch, n_stages):
    """(n_stages, 2) soft values: integer channels within their field
    range (the contract of the values-in entry); FP32 beyond the [-8, 7]
    window, with NaN, +-inf and values past the int32 range, which the
    values-in entry does not clamp."""
    if ch == ChannelIn.FP32:
        r = (rng.standard_normal((n_stages, 2)) * 30).astype(np.float32)
        for frac, v in ((0.04, np.nan), (0.02, np.inf), (0.02, -np.inf),
                        (0.02, 3e9), (0.02, -5e9)):
            r[rng.random(r.shape) < frac] = v
        return r
    if ch == ChannelIn.HARD:
        return rng.choice(np.array([-1, 1], np.int32), size=(n_stages, 2))
    half = 1 << (DecoderConfig(ch).enc_data_width - 1)
    return rng.integers(-half, half, size=(n_stages, 2)).astype(np.int32)


def _words(rng, jcfg, jplan):
    """The reference input length for the plan: full-range random words,
    or FP32 values of scale 9 with NaN and +-inf."""
    n = jcfg.get_input_words(2 * (jplan.message_len + 64))
    if jcfg.channel_in == ChannelIn.FP32:
        x = (rng.standard_normal(n) * 9).astype(np.float32)
        x[rng.random(n) < 0.05] = np.nan
        x[rng.random(n) < 0.02] = np.inf
        x[rng.random(n) < 0.02] = -np.inf
        return x
    return rng.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int32)


def _masked(words, bpp):
    return np.asarray(words).astype(np.int64) & ((1 << bpp) - 1)


@pytest.mark.parametrize("dec_len", [32, 96])
@pytest.mark.parametrize("out", [B32, B16], ids=lambda o: o.name)
@pytest.mark.parametrize("ch", CHANNELS, ids=lambda c: c.name)
def test_decode_blocks_matches_xla(rng, ch, out, dec_len):
    """decode_blocks(gather_blocks(r)) on both packages, and the port's
    values-in entry decode_blocks_cuda, on a partial last block whose tail
    runs past the stream (natural framing, zero fill)."""
    bpp = 16 if out == B16 else 32
    jcfg, jplan, cfg, plan = _pair(ch, out, dec_len * 5 - bpp, dec_len)
    assert plan.overlap_bits > 0 or dec_len == bpp   # none at one pack
    r = _values(rng, ch, plan.message_len + 64 - 7)
    want = _masked(core_xla.decode_blocks(
        core_xla.gather_blocks(jnp.asarray(r), jplan), jcfg, jplan), bpp)
    rt = torch.from_numpy(r)
    got = core_torch.decode_blocks(core_torch.gather_blocks(rt, plan), cfg,
                                   plan)
    assert np.array_equal(_masked(got, bpp), want)
    assert np.array_equal(
        _masked(core_cuda.decode_blocks_cuda(rt, cfg, plan), bpp), want)


@pytest.mark.parametrize("jcfg,dec_len", [
    (DecoderConfig(ChannelIn.SOFT8), 96),
    (DecoderConfig(ChannelIn.HARD, decode_out=B16), 32),
    (DecoderConfig(ChannelIn.FP32), 64)],
    ids=["SOFT8-b32", "HARD-b16", "FP32-b32"])
def test_decode_blocks_cuda_matches_golden(rng, jcfg, dec_len):
    """decode_blocks_cuda (plain on the CPU) against the int64 oracle,
    block by block, from the port's copy of golden.py and from JAX's."""
    bpp = jcfg.bits_per_pack
    plan = core_torch.plan_blocks(3 * dec_len, bpp, dec_len)
    r = _values(rng, jcfg.channel_in, plan.message_len + 64)
    if jcfg.channel_in == ChannelIn.FP32:
        r[~np.isfinite(r) | (np.abs(r) > 1e6)] = -20.5
    out = core_cuda.decode_blocks_cuda(torch.from_numpy(r),
                                       from_reference(jcfg), plan)
    bits = np.unpackbits(_masked(out, bpp).astype(
        ">u4" if bpp == 32 else ">u2").view(np.uint8))
    for k, off in enumerate(plan.offsets()):
        blk = r[off:off + plan.block_len]
        if jcfg.channel_in != ChannelIn.FP32:
            blk = blk.astype(np.int64)
        for golden in (tgolden, jgolden):
            assert np.array_equal(bits[off:off + dec_len],
                                  golden.golden_decode_block(blk, dec_len)), \
                f"block {k} ({golden.__name__})"


def test_golden_copy_matches_jax(rng):
    """The port's golden.py is the JAX package's oracle: the same bits on
    random integer and float blocks, one block and the whole message."""
    for r in (rng.integers(-128, 128, size=(160, 2)).astype(np.int64),
              (rng.standard_normal((160, 2)) * 20).astype(np.float32)):
        assert np.array_equal(tgolden.golden_decode_block(r, 96),
                              jgolden.golden_decode_block(r, 96))
        assert np.array_equal(tgolden.golden_decode_full(r, 120),
                              jgolden.golden_decode_full(r, 120))
        assert np.array_equal(
            tgolden.golden_decode_block(r, 96, integer_metric=False),
            jgolden.golden_decode_block(r, 96, integer_metric=False))


@pytest.mark.parametrize("ch", [ChannelIn.SOFT8, ChannelIn.FP32],
                         ids=lambda c: c.name)
def test_forward_scan_takes_blocks_like_jax(rng, ch):
    """forward_scan takes (B, L, 2) blocks as core_xla.forward_scan does
    (the port's took the staged layout, now forward_scan_staged's, which
    takes JAX's (n_packs, bpp, 2, B) too): the same survivor store."""
    jcfg, jplan, cfg, plan = _pair(ch, B16, 16 * 14, 64)
    r = _values(rng, ch, plan.message_len + 64)
    jblocks = core_xla.gather_blocks(jnp.asarray(r), jplan)
    want = np.asarray(core_xla.forward_scan(jblocks, jcfg, jplan)) \
        .astype(np.int64)
    blocks = np.array(jblocks)
    assert np.array_equal(core_torch.forward_scan(
        torch.from_numpy(blocks), cfg, plan).numpy(), want)
    assert np.array_equal(core_torch.gather_blocks(
        torch.from_numpy(r), plan).numpy(), blocks, equal_nan=True)
    rs = blocks.transpose(1, 2, 0).reshape(
        plan.n_packs, plan.bits_per_pack, 2, plan.num_blocks)
    staged = np.asarray(core_xla.forward_scan_staged(jnp.asarray(rs), jcfg,
                                                     jplan))
    assert np.array_equal(staged.astype(np.int64), want)
    assert np.array_equal(core_torch.forward_scan_staged(
        torch.from_numpy(rs), cfg, plan).numpy(), want)


@pytest.mark.parametrize("dec_len", [32, 96])
@pytest.mark.parametrize("ch", CHANNELS, ids=lambda c: c.name)
def test_stage_words_is_word_major_like_jax(rng, ch, dec_len):
    """stage_words returns JAX's (Lw, b_pad) word-major layout at
    b_pad = B (the port's gave the block-major (B, Lw) view, now
    block_words'); stage_words_cuda (K6's plain version here) equals it."""
    jcfg, jplan, cfg, plan = _pair(ch, B32, dec_len * 4 - 32, dec_len)
    x = _words(rng, jcfg, jplan)
    want = np.asarray(core_xla.stage_words(jnp.asarray(x), jcfg, jplan,
                                           jplan.num_blocks))
    wpb, wph = core_torch.words_per_block(cfg, plan)
    assert want.shape == (wpb + wph, plan.num_blocks)
    xt = torch.from_numpy(x)
    got = core_torch.stage_words(xt, cfg, plan)
    assert np.array_equal(got.numpy(), want, equal_nan=True)
    for other in (core_cuda.stage_words_cuda(xt, cfg, plan),
                  core_torch.block_words(xt, cfg, plan).t()):
        assert np.array_equal(other.numpy(), want, equal_nan=True)


@pytest.mark.parametrize("dec_len", [32, 96])
@pytest.mark.parametrize("out", [B32, B16], ids=lambda o: o.name)
def test_stage_floats_2streams_matches_jax(rng, out, dec_len):
    """The clamp and the stride-2 row split, NaN kept NaN and +-inf
    clamped to the window's bounds."""
    bpp = 16 if out == B16 else 32
    jcfg, jplan, cfg, plan = _pair(ChannelIn.FP32, out, dec_len * 4 - bpp,
                                   dec_len)
    x = _words(rng, jcfg, jplan)
    want = core_xla.stage_floats_2streams(jnp.asarray(x), jcfg, jplan,
                                          jplan.num_blocks)
    got = core_torch.stage_floats_2streams(torch.from_numpy(x), cfg, plan)
    assert np.isnan(np.asarray(want[0])).any()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w), equal_nan=True)


STAGED_CASES = [(ch, out, dl) for ch in CHANNELS for out in (B32, B16)
                for dl in (96,)] + [(ChannelIn.SOFT8, B32, 32),
                                    (ChannelIn.HARD, B16, 32),
                                    (ChannelIn.FP32, B16, 32)]


@pytest.mark.parametrize("ch,out,dec_len", STAGED_CASES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_staged_packed_paths_match_xla(rng, ch, out, dec_len):
    """decode_packed_cuda(fused=False) (K6 -> K4 word mode) for the integer
    channels and (fp32_words=False) (K6 -> clamp and split -> K5) for FP32
    against decode_packed_xla, and their windowed forms against the plain
    windowed core (window and full store differ on random words)."""
    bpp = 16 if out == B16 else 32
    jcfg, jplan, cfg, plan = _pair(ch, out, dec_len * 5 - bpp, dec_len)
    x = _words(rng, jcfg, jplan)
    want = _masked(core_xla.decode_packed_xla(jnp.asarray(x), jcfg, jplan),
                   bpp)
    kw = {"fp32_words": False} if ch == ChannelIn.FP32 else {"fused": False}
    xt = torch.from_numpy(x)
    got = core_cuda.decode_packed_cuda(xt, cfg, plan, **kw)
    assert np.array_equal(_masked(got, bpp), want)
    assert torch.equal(core_cuda.decode_packed_cuda(xt, cfg, plan),
                       got)                               # K1 / K2 route
    win = core_cuda.decode_packed_cuda(xt, cfg, plan, window=True, **kw)
    assert torch.equal(win, core_torch.decode_packed_torch(xt, cfg, plan,
                                                           window=True))


def test_s16_layouts_and_rejection_match_jax(rng):
    """The four s16 names decode alike; any other raises the JAX kernel's
    ValueError, word for word."""
    from tpu_viterbi.decoder.core_pallas import decode_packed_pallas
    jcfg, jplan, cfg, plan = _pair(ChannelIn.SOFT16, B32, 32 * 5, 64)
    x = _words(rng, jcfg, jplan)
    with pytest.raises(ValueError) as want:
        decode_packed_pallas(jnp.asarray(x), jcfg, jplan, interpret=True,
                             s16="rows")
    xt = torch.from_numpy(x)
    for fused in (True, False):
        with pytest.raises(ValueError) as got:
            core_cuda.decode_packed_cuda(xt, cfg, plan, fused=fused,
                                         s16="rows")
        assert str(got.value) == str(want.value)
    outs = [core_cuda.decode_packed_cuda(xt, cfg, plan, fused=False, s16=s)
            for s in core_cuda.S16_LAYOUTS]
    assert all(torch.equal(o, outs[0]) for o in outs)


def _interpret_case(rng):
    jcfg, jplan, cfg, plan = _pair(ChannelIn.SOFT8, B16, 128, 64)
    assert plan.num_blocks == 2
    return jcfg, jplan, cfg, plan


def test_decode_blocks_matches_pallas_interpret(rng):
    """The values-in entry against the TPU kernel's own value mode (K4),
    decode_blocks_pallas in interpret mode: SOFT8 b16, dec_len 64, 2
    blocks, the size of the unmarked test_kernel_interpret case."""
    from tpu_viterbi.decoder.core_pallas import decode_blocks_pallas
    jcfg, jplan, cfg, plan = _interpret_case(rng)
    r = _values(rng, ChannelIn.SOFT8, plan.message_len + 64)
    want = _masked(decode_blocks_pallas(jnp.asarray(r), jcfg, jplan,
                                        interpret=True), 16)
    got = core_cuda.decode_blocks_cuda(torch.from_numpy(r), cfg, plan)
    assert np.array_equal(_masked(got, 16), want)


@pytest.mark.slow
@pytest.mark.parametrize("ch", [ChannelIn.SOFT8, ChannelIn.FP32],
                         ids=lambda c: c.name)
def test_staged_packed_paths_match_pallas_interpret(rng, ch):
    """fused=False (K6 -> K4 word mode) and fp32_words=False (K5) against
    decode_packed_pallas in interpret mode, the TPU kernels themselves."""
    from tpu_viterbi.decoder.core_pallas import decode_packed_pallas
    jcfg, jplan, cfg, plan = _pair(ch, B16, 128, 64)
    x = _words(rng, jcfg, jplan)
    kw = {"fp32_words": False} if ch == ChannelIn.FP32 else {"fused": False}
    want = _masked(decode_packed_pallas(jnp.asarray(x), jcfg, jplan,
                                        interpret=True, **kw), 16)
    got = core_cuda.decode_packed_cuda(torch.from_numpy(x), cfg, plan, **kw)
    assert np.array_equal(_masked(got, 16), want)


def test_staged_wrappers_run_plain_versions_on_cpu(rng):
    """On CPU tensors K4, K5 and K6 are their plain versions and launch
    nothing; K4 reads its mode from the staged shape and refuses others,
    K5 decodes FP32 only."""
    jcfg, jplan, cfg, plan = _pair(ChannelIn.SOFT8, B32, 32 * 37, 256)
    x = torch.from_numpy(_words(rng, jcfg, jplan))
    before = [k.launches for k in (core_cuda.K4, core_cuda.K5,
                                   core_cuda.K6)]
    wpb, wph = core_torch.words_per_block(cfg, plan)
    wt = core_cuda.K6(x, wpb, wpb + wph, plan.num_blocks)
    assert torch.equal(wt, core_torch.stage_words(x, cfg, plan))
    assert torch.equal(core_cuda.K4(wt, cfg, plan),
                       core_torch.decode_blocks_torch(x, cfg, plan))
    fcfg = from_reference(DecoderConfig(ChannelIn.FP32))
    f = torch.from_numpy(_words(rng, DecoderConfig(ChannelIn.FP32), jplan))
    r0, r1 = core_torch.stage_floats_2streams(f, fcfg, plan)
    assert torch.equal(core_cuda.K5(r0, r1, fcfg, plan),
                       core_torch.decode_blocks_torch(f, fcfg, plan))
    assert [k.launches for k in (core_cuda.K4, core_cuda.K5,
                                 core_cuda.K6)] == before
    with pytest.raises(ValueError, match="staged words"):
        core_cuda.K4(wt[:-1], cfg, plan)
    with pytest.raises(ValueError, match="staged words"):
        core_cuda.K4(wt, fcfg, plan)           # FP32 has no word mode
    with pytest.raises(ConfigResolutionError, match="FP32"):
        core_cuda.K5(r0, r1, cfg, plan)
    with pytest.raises(ValueError, match="planes"):
        core_cuda.K5(r0[:-1], r1, fcfg, plan)
    with pytest.raises(ValueError, match="positive"):
        core_cuda.K6(x, 0, 8, 4)
