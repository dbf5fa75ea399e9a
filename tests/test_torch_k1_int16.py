"""K1's int16 path metrics (``csrc/acs.cuh``: ``acs_stage16`` with
``renorm16`` once a pack) through their plain version,
``core_torch.decode_blocks_i16_torch``: it must decode exactly as the int32
core ``decode_blocks_torch`` and as the JAX package's XLA core at
``Metric.M_B32`` and ``Metric.M_B16`` on HARD, SOFT4, SOFT8 and the FP32
channel's u/d words, b32 and b16, with every field at its extremes; its
largest candidate metric must stay under the bound acs.cuh states; and
without the renormalisation it must go wrong on the worst case, which shows
that these tests can fail.  The kernel itself is held against the same
plain versions on the card by test_torch_cuda.py and chip_smoke.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_viterbi.config import ChannelIn, DecodeOut, DecoderConfig, Metric
from tpu_viterbi.decoder import core_xla
from tpu_viterbi_torch import ConfigResolutionError
from tpu_viterbi_torch.chain.encode import conv_encode_np
from tpu_viterbi_torch.chain.quantize import quantize_and_pack
from tpu_viterbi_torch.config import from_reference
from tpu_viterbi_torch.decoder import core_cuda, core_torch
from tpu_viterbi_torch.library import CSRC
from tpu_viterbi_torch.utils.bits import extreme_field_words

torch.set_num_threads(1)

UD = "UD"           # the FP32 channel's u/d words
CHANNELS = [ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT8, UD]
OUTS = [DecodeOut.O_B32, DecodeOut.O_B16]


def _name(c):
    return c if isinstance(c, str) else c.name


def _case(rng, channel, out, metric, dec_len, blocks):
    """(JAX cfg, JAX plan, port cfg, port plan, the JAX decode's input,
    the port's input): extreme words, or for UD an FP32 wire saturated past
    the [-8, 7] clamp (so u, d reach -16 and 14) and its u/d words."""
    ch = ChannelIn.FP32 if channel == UD else channel
    jcfg = DecoderConfig(ch, metric, out)
    bpp = jcfg.bits_per_pack
    jplan = core_xla.plan_blocks(dec_len * blocks - bpp, bpp, dec_len)
    cfg, plan = from_reference(jcfg), core_torch.plan_from_reference(jplan)
    n = jcfg.get_input_words(2 * (jplan.message_len + 64))
    if channel == UD:
        wire = (rng.choice([-100.0, 100.0, 7.0, -8.0], size=n) +
                rng.standard_normal(n)).astype(np.float32)
        return jcfg, jplan, cfg, plan, wire, \
            core_torch.fp32_ud_words_torch(torch.from_numpy(wire))
    x = extreme_field_words(rng, n, jcfg.enc_data_width)
    return jcfg, jplan, cfg, plan, x, torch.from_numpy(x)


def _i16(x, cfg, plan, **kw):
    return core_torch.decode_blocks_i16_torch(
        x, cfg, plan, ud=cfg.channel_in == ChannelIn.FP32, **kw)


def _int32(x, cfg, plan):
    if cfg.channel_in == ChannelIn.FP32:
        return core_torch.decode_ud_words_torch(x, cfg, plan)
    return core_torch.decode_blocks_torch(x, cfg, plan)


@pytest.mark.parametrize("dec_len", [96, 2048])
@pytest.mark.parametrize("out", OUTS, ids=lambda o: o.name)
@pytest.mark.parametrize("channel", CHANNELS, ids=_name)
def test_i16_matches_int32(rng, channel, out, dec_len):
    """Extreme fields (u/d words: every 8-bit field, not only those a
    wire can give): the int16 decode equals the int32 one, and its largest
    candidate stays under the channel's bound."""
    cfg = DecoderConfig(ChannelIn.FP32 if channel == UD else channel,
                        decode_out=out)
    bpp = cfg.bits_per_pack
    plan = core_torch.plan_blocks(dec_len * 2 - bpp, bpp, dec_len)
    if channel == UD:
        wpb, wph = core_torch.ud_words_per_block(plan)
        x = torch.from_numpy(extreme_field_words(rng, 2 * wpb + wph, 8))
    else:
        x = torch.from_numpy(extreme_field_words(
            rng, cfg.get_input_words(2 * (plan.message_len + 64)),
            cfg.enc_data_width))
    got, peak = _i16(x, cfg, plan, return_peak=True)
    assert torch.equal(got, _int32(x, cfg, plan))
    max_bm = core_torch.PM16_MAX_ABS_BM[cfg.channel_in]
    assert peak <= core_torch.pm16_bound(max_bm, bpp)


@pytest.mark.parametrize("out,metric", [
    (DecodeOut.O_B32, Metric.M_B32), (DecodeOut.O_B32, Metric.M_B16),
    (DecodeOut.O_B16, Metric.M_B16)], ids=lambda v: v.name)
@pytest.mark.parametrize("channel", CHANNELS, ids=_name)
def test_i16_matches_xla(rng, channel, out, metric):
    """The JAX package's XLA core at both metric widths (M_B16: its own
    int16 metrics with its renorm rule) decodes the same bits; the u/d
    words against the XLA decode of the wire they were staged from.  (b16
    at M_B32 is the int32 core, which test_torch_core.py holds to XLA and
    test_i16_matches_int32 to this one.)"""
    jcfg, jplan, cfg, plan, xj, x = _case(rng, channel, out, metric, 96, 5)
    want = np.asarray(core_xla.decode_packed_xla(jnp.asarray(xj), jcfg,
                                                 jplan))
    got = core_torch.assemble_output(_i16(x, cfg, plan), cfg, plan).numpy()
    mask = (1 << cfg.bits_per_pack) - 1
    assert np.array_equal(got.astype(np.int64) & mask,
                          want.astype(np.int64) & mask)


@pytest.mark.parametrize("channel", [ChannelIn.SOFT8, UD], ids=_name)
def test_i16_matches_xla_m16_at_2048(rng, channel):
    """At dec_len 2048 (the default; 66 packs a block, so 65
    renormalisations) against the XLA core's int16 metrics."""
    jcfg, jplan, cfg, plan, xj, x = _case(rng, channel, DecodeOut.O_B32,
                                          Metric.M_B16, 2048, 2)
    want = np.asarray(core_xla.decode_packed_xla(jnp.asarray(xj), jcfg,
                                                 jplan))
    got = core_torch.assemble_output(_i16(x, cfg, plan), cfg, plan).numpy()
    assert np.array_equal(got.astype(np.int64) & 0xFFFFFFFF,
                          want.astype(np.int64) & 0xFFFFFFFF)


def test_renorm_needed_and_bound_held(rng):
    """Noiseless coded SOFT8 at +-127 over 2 blocks of dec_len 2048: with
    the renormalisation the int16 decode equals the int32 one and its
    largest candidate stays under acs.cuh's kPm16Bound; without it the
    candidates pass 32,767 within a block and the decode goes wrong."""
    cfg = DecoderConfig(ChannelIn.SOFT8)
    plan = core_torch.plan_blocks(2 * 2048, 32, 2048)
    bits = rng.integers(0, 2, size=plan.message_len + 64)
    x = quantize_and_pack(torch.from_numpy(
        conv_encode_np(bits).astype(np.float32) * 254 - 127), ChannelIn.SOFT8)
    want = core_torch.decode_blocks_torch(x, cfg, plan)
    got, peak = core_torch.decode_blocks_i16_torch(x, cfg, plan,
                                                   return_peak=True)
    src = (CSRC / "acs.cuh").read_text()
    m = re.search(r"constexpr int kPm16Bound = \(12 \+ (\d+)\) \* (\d+);",
                  src)
    assert m is not None
    bound = (12 + int(m.group(1))) * int(m.group(2))
    assert bound == core_torch.PM16_BOUND == 11264 < 2 ** 15
    assert torch.equal(got, want)
    assert 8192 < peak <= bound
    bad, bad_peak = core_torch.decode_blocks_i16_torch(
        x, cfg, plan, renorm=False, return_peak=True)
    assert bad_peak > 2 ** 15
    assert not torch.equal(bad, want)


def test_i16_refuses_int32_channels():
    """SOFT16 (|bm| to 65,536) keeps int32 metrics: the plain int16 version
    refuses it, and u/d words on another channel than FP32; the FP32 wire
    runs int16 metrics in K2 and K3, so the plain int16 version decodes it,
    equal to decode_blocks_torch.  The int32 A/B wrappers take their own
    channels only (K1_I32 SOFT8, K2_I32 FP32, K3_I32 SOFT8 and FP32); on
    CPU tensors each runs its plain version, as its kernel does."""
    plan = core_torch.plan_blocks(256, 32, 128)
    x = torch.zeros(100, dtype=torch.int32)
    for cfg, ud in ((DecoderConfig(ChannelIn.SOFT16), False),
                    (DecoderConfig(ChannelIn.SOFT8), True)):
        with pytest.raises(ValueError, match="int16"):
            core_torch.decode_blocks_i16_torch(x, cfg, plan, ud=ud)
    fp32 = DecoderConfig(ChannelIn.FP32)
    wire = torch.linspace(-20.0, 20.0, 2 * (256 + 64))
    wire[::7] = float("nan")
    assert torch.equal(core_torch.decode_blocks_i16_torch(wire, fp32, plan),
                       core_torch.decode_blocks_torch(wire, fp32, plan))
    for kernel, channel, match in (
            (core_cuda.K1_I32, ChannelIn.HARD, "SOFT8 only"),
            (core_cuda.K2_I32, ChannelIn.SOFT8, "FP32 only"),
            (core_cuda.K3_I32, ChannelIn.SOFT4, "SOFT8 and FP32 only")):
        with pytest.raises(ConfigResolutionError, match=match):
            kernel(x, DecoderConfig(channel), plan)
    for kernel, cfg, words in (
            (core_cuda.K1_I32, DecoderConfig(ChannelIn.SOFT8), x),
            (core_cuda.K2_I32, fp32, wire),
            (core_cuda.K3_I32, DecoderConfig(ChannelIn.SOFT8), x),
            (core_cuda.K3_I32, fp32, wire)):
        before = kernel.launches
        assert torch.equal(kernel(words, cfg, plan),
                           core_torch.decode_blocks_torch(words, cfg, plan,
                                                          kernel.window))
        assert kernel.launches == before


def test_k1_entry_routes_pm16_by_width():
    """viterbi_k1_launch instantiates the int16x2 stage for widths 1, 4, 8
    and the u/d words and the int32 stage for 16; viterbi_k1_i32_launch
    only SOFT8's int32 instances."""
    src = (CSRC / "viterbi.cu").read_text()
    body = src.split('extern "C" int viterbi_k1_launch(')[1].split("\n}")[0]
    pm16 = re.findall(r"VITERBI_LAUNCH\((\S+), \S+, (\d+), false, true\)",
                      body)
    i32 = re.findall(r"VITERBI_CASE\((\S+), \S+, (\d+), false\)", body)
    assert sorted(pm16) == sorted((w, b) for w in ("1", "4", "8", "kUdWidth")
                                  for b in ("32", "16"))
    assert sorted(i32) == [("16", "16"), ("16", "32")]
    ab = src.split('extern "C" int viterbi_k1_i32_launch(')[1] \
        .split("\n}")[0]
    assert sorted(re.findall(r"VITERBI_CASE\((\S+), \S+, (\d+), false\)",
                             ab)) == [("8", "16"), ("8", "32")]
