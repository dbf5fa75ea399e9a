"""K2's and K3's int16 path metrics (``csrc/acs.cuh``: ``acs_stage16`` with
``renorm16`` once a pack) through their plain version,
``core_torch.decode_blocks_i16_torch``, the one int16 scan of K1, K2 and
K3: on the FP32 wire (K2's full store) it must decode exactly as the int32
core ``decode_blocks_torch`` and as the JAX package's XLA core at
``Metric.M_B32`` and ``Metric.M_B16``, on wires of NaN, +-inf, values past
the clamp and noise; with the window (K3) exactly as the plain window
``window_scan`` on random words of every int16 input (HARD, SOFT4, SOFT8,
the FP32 channel's u/d words and its wire; tests/test_torch_window.py holds
that plain window to the Pallas window branch in interpret mode), and as
the XLA core's full store on coded input; its largest candidate metric
must stay under each input's bound that acs.cuh states; and without the
renormalisation it must go wrong on a long worst-case block, which shows
that these tests can fail.  The kernels themselves are held against the
same plain versions on the card by test_torch_cuda.py and chip_smoke.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_viterbi.config import ChannelIn, DecodeOut, DecoderConfig, Metric
from tpu_viterbi.decoder import core_xla
from tpu_viterbi_torch.chain.encode import conv_encode_np
from tpu_viterbi_torch.chain.quantize import quantize_and_pack
from tpu_viterbi_torch.config import from_reference
from tpu_viterbi_torch.decoder import core_torch
from tpu_viterbi_torch.library import CSRC
from tpu_viterbi_torch.sharding.simulate import DEFAULT_SCALES
from tpu_viterbi_torch.utils.bits import extreme_wire

torch.set_num_threads(1)

UD = "UD"           # the FP32 channel's u/d words
WIRE = "WIRE"       # the FP32 channel's raw f32 wire
INPUTS = [ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT8, UD, WIRE]
OUTS = [DecodeOut.O_B32, DecodeOut.O_B16]
METRICS = [(DecodeOut.O_B32, Metric.M_B32), (DecodeOut.O_B32, Metric.M_B16),
           (DecodeOut.O_B16, Metric.M_B16)]


def _name(c):
    return c if isinstance(c, str) else c.name


def _channel(inp):
    return ChannelIn.FP32 if inp in (UD, WIRE) else inp


def _random_input(rng, inp, cfg, plan):
    """Random input of the plan: full-range int32 words (u/d words: every
    8-bit field), or an extreme wire."""
    n = cfg.get_input_words(2 * (plan.message_len + 64))
    if inp == WIRE:
        return torch.from_numpy(extreme_wire(rng, n))
    if inp == UD:
        wpb, wph = core_torch.ud_words_per_block(plan)
        n = plan.num_blocks * wpb + wph
    return torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int32))


def _i16(x, inp, cfg, plan, **kw):
    return core_torch.decode_blocks_i16_torch(x, cfg, plan, ud=inp == UD,
                                              **kw)


def _int32(x, inp, cfg, plan, window=False):
    if inp == UD:
        return core_torch.decode_ud_words_torch(x, cfg, plan, window)
    return core_torch.decode_blocks_torch(x, cfg, plan, window)


def _bound(inp, cfg):
    key = core_torch.pm16_input(cfg, ud=inp == UD)
    return core_torch.pm16_bound(core_torch.PM16_MAX_ABS_BM[key],
                                 cfg.bits_per_pack)


def _masked(x, bpp):
    return np.asarray(x).astype(np.int64) & ((1 << bpp) - 1)


@pytest.mark.parametrize("dec_len", [32, 96, 2048])
@pytest.mark.parametrize("out,metric", METRICS, ids=lambda v: v.name)
def test_wire_full_store_matches_int32_and_xla(rng, out, metric, dec_len):
    """K2's arithmetic: on a wire of NaN, +-inf, values past the clamp and
    noise, the int16 full store equals the int32 core and the XLA core at
    this metric width (M_B16: the JAX package's own int16 metrics with its
    renorm rule), and its largest candidate stays under the wire's bound."""
    jcfg = DecoderConfig(ChannelIn.FP32, metric, out)
    bpp = jcfg.bits_per_pack
    jplan = core_xla.plan_blocks(dec_len * (2 if dec_len > 96 else 5) - bpp,
                                 bpp, dec_len)
    cfg, plan = from_reference(jcfg), core_torch.plan_from_reference(jplan)
    wire = extreme_wire(rng, jcfg.get_input_words(
        2 * (jplan.message_len + 64)))
    x = torch.from_numpy(wire)
    got, peak = core_torch.decode_blocks_i16_torch(x, cfg, plan,
                                                   return_peak=True)
    assert torch.equal(got, core_torch.decode_blocks_torch(x, cfg, plan))
    assert peak <= core_torch.pm16_bound(16, bpp)
    want = core_xla.decode_packed_xla(jnp.asarray(wire), jcfg, jplan)
    flat = core_torch.assemble_output(got, cfg, plan)
    assert np.array_equal(_masked(flat, bpp), _masked(want, bpp))


@pytest.mark.parametrize("dec_len", [32, 224, 2048])
@pytest.mark.parametrize("out", OUTS, ids=lambda o: o.name)
@pytest.mark.parametrize("inp", INPUTS, ids=_name)
def test_window_matches_int32_window(rng, inp, out, dec_len):
    """K3's arithmetic: on random words (and an extreme wire) the int16
    window equals the plain int32 window (window_scan), from the framing
    where every emitted pack is chased after the loop (dec_len 32) to the
    one where most are chased in it (2048); the ring has W = 4 slots at b32,
    6 at b16.  Its largest candidate stays under the input's bound."""
    cfg = from_reference(DecoderConfig(_channel(inp), decode_out=out))
    bpp = cfg.bits_per_pack
    plan = core_torch.plan_blocks(dec_len * (2 if dec_len > 224 else 4) - bpp,
                                  bpp, dec_len)
    x = _random_input(rng, inp, cfg, plan)
    got, peak = _i16(x, inp, cfg, plan, window=True, return_peak=True)
    assert torch.equal(got, _int32(x, inp, cfg, plan, window=True))
    assert peak <= _bound(inp, cfg)


def _coded_input(rng, inp, cfg, plan, sigma):
    """(the JAX decode's input, the port's input) of a coded message at
    noise ``sigma`` on BPSK +-1, quantized at the simulation's default
    scale; for UD the wire and the u/d words staged from it."""
    ch = cfg.channel_in
    bits = rng.integers(0, 2, size=plan.message_len + 64)
    sym = 2 * conv_encode_np(bits).astype(np.float32) - 1
    sym = sym + sigma * rng.standard_normal(sym.shape).astype(np.float32)
    x = quantize_and_pack(torch.from_numpy(sym), ch, DEFAULT_SCALES[ch])
    if inp == UD:
        return x.numpy(), core_torch.fp32_ud_words_torch(x)
    return x.numpy(), x


@pytest.mark.parametrize("out", OUTS, ids=lambda o: o.name)
@pytest.mark.parametrize("inp", INPUTS, ids=_name)
def test_window_coded_matches_xla_full_store(rng, inp, out):
    """On coded BPSK input with noise of sigma 0.5 the int16 window decodes
    as the XLA core's full store (the window's chase merges paths there)."""
    jcfg = DecoderConfig(_channel(inp), Metric.M_B32, out)
    bpp = jcfg.bits_per_pack
    jplan = core_xla.plan_blocks(96 * 5 - bpp, bpp, 96)
    cfg, plan = from_reference(jcfg), core_torch.plan_from_reference(jplan)
    xj, x = _coded_input(rng, inp, cfg, plan, 0.5)
    want = core_xla.decode_packed_xla(jnp.asarray(xj), jcfg, jplan)
    got = core_torch.assemble_output(_i16(x, inp, cfg, plan, window=True),
                                     cfg, plan)
    assert np.array_equal(_masked(got, bpp), _masked(want, bpp))


@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
@pytest.mark.parametrize("out", OUTS, ids=lambda o: o.name)
@pytest.mark.parametrize("inp", INPUTS, ids=_name)
def test_bound_held_at_fastest_growth(rng, inp, out, window):
    """Noiseless coded input at full amplitude, the metrics' fastest growth
    (the wire at -8 and 7, the u/d words staged from it, the words' fields
    at their extremes), over a block of dec_len 2048: the int16 decode
    equals the int32 one and its largest candidate stays under the bound
    acs.cuh states for the input, (12 + bpp) * max|bm|."""
    cfg = from_reference(DecoderConfig(_channel(inp), decode_out=out))
    bpp = cfg.bits_per_pack
    plan = core_torch.plan_blocks(2048, bpp, 2048)
    bits = rng.integers(0, 2, size=plan.message_len + 64)
    coded = conv_encode_np(bits).astype(np.float32)
    ch = cfg.channel_in
    if ch == ChannelIn.FP32:
        x = torch.from_numpy(coded * 15 - 8)             # -8 and 7
        if inp == UD:
            x = core_torch.fp32_ud_words_torch(x)
    else:
        hi = {ChannelIn.HARD: 1, ChannelIn.SOFT4: 7, ChannelIn.SOFT8: 127}[ch]
        x = quantize_and_pack(torch.from_numpy(coded * 2 * hi - hi), ch)
    got, peak = _i16(x, inp, cfg, plan, window=window, return_peak=True)
    assert torch.equal(got, _int32(x, inp, cfg, plan, window))
    assert peak <= _bound(inp, cfg)


@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
@pytest.mark.parametrize("out", OUTS, ids=lambda o: o.name)
def test_wire_renorm_needed(rng, out, window):
    """Noiseless coded wire at -8 and 7 over one block of dec_len 16384:
    with the renormalisation the int16 decode equals the int32 one under
    the wire's bound; without it the candidates pass 32,767 and the decode
    goes wrong, full store (K2) and window (K3)."""
    cfg = from_reference(DecoderConfig(ChannelIn.FP32, decode_out=out))
    bpp = cfg.bits_per_pack
    plan = core_torch.plan_blocks(16384, bpp, 16384)
    bits = rng.integers(0, 2, size=plan.message_len + 64)
    x = torch.from_numpy(conv_encode_np(bits).astype(np.float32) * 15 - 8)
    want = core_torch.decode_blocks_torch(x, cfg, plan, window)
    got, peak = core_torch.decode_blocks_i16_torch(x, cfg, plan,
                                                   window=window,
                                                   return_peak=True)
    assert torch.equal(got, want)
    assert peak <= core_torch.pm16_bound(16, bpp)
    bad, bad_peak = core_torch.decode_blocks_i16_torch(
        x, cfg, plan, window=window, renorm=False, return_peak=True)
    assert bad_peak > 2 ** 15
    assert not torch.equal(bad, want)


def _entry(src, name):
    return src.split(f'extern "C" int {name}(')[1].split("\n}")[0]


def test_k2_k3_entries_route_pm16_by_width():
    """viterbi_k2_launch instantiates the int16x2 stage on the FP32 wire at
    b32 and b16; viterbi_k3_launch on the wire, HARD, SOFT4, SOFT8 and the
    u/d words, and the int32 stage on SOFT16 only; the int32 A/B entries
    only their own instances: K2_I32 the wire's full store, K3_I32 SOFT8's
    and the wire's window.  acs.cuh's header states the wire's bound,
    core_torch's: 704 at b32, 448 at b16."""
    header = re.sub(r"\s*//\s*", " ", (CSRC / "acs.cuh").read_text())
    wire = core_torch.PM16_MAX_ABS_BM[core_torch.FP32_WIRE]
    for b, want in ((32, 704), (16, 448)):
        assert core_torch.pm16_bound(wire, b) == want
        assert f"(12 + {b}) * 16 = {want}" in header
    src = (CSRC / "viterbi.cu").read_text()
    pm16 = r"VITERBI_LAUNCH\((\S+), \S+, (\d+), (\w+), true\)"
    i32 = r"VITERBI_CASE\((\S+), \S+, (\d+), (\w+)\)"

    def cases(widths, window):
        return sorted((w, b, window) for w in widths for b in ("32", "16"))
    k2 = _entry(src, "viterbi_k2_launch")
    assert sorted(re.findall(pm16, k2)) == cases(["0"], "false")
    assert re.findall(i32, k2) == []
    k3 = _entry(src, "viterbi_k3_launch")
    assert sorted(re.findall(pm16, k3)) == cases(
        ["0", "1", "4", "8", "kUdWidth"], "true")
    assert sorted(re.findall(i32, k3)) == cases(["16"], "true")
    for name, want in (("viterbi_k2_i32_launch", cases(["0"], "false")),
                       ("viterbi_k3_i32_launch", cases(["0", "8"], "true"))):
        body = _entry(src, name)
        assert "VITERBI_LAUNCH" not in body
        assert sorted(re.findall(i32, body)) == want
