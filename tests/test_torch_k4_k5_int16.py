"""K4's and K5's int16 path metrics (``csrc/acs.cuh``: ``acs_stage16``
with ``renorm16`` once a pack) through their plain versions,
``core_torch.decode_staged_i16_torch`` (K4: staged words and integer
values of HARD, SOFT4 and SOFT8) and ``decode_planes_i16_torch`` (K5: the
two clamped f32 planes): full store and window, each must decode exactly
as the int32 plain version (``decode_staged_torch``,
``decode_planes_torch``, whose window is ``window_scan``), and the full
store as the JAX package's XLA core (``decode_packed_xla`` on the words
and the f32 wire, ``decode_blocks`` on the values) at ``Metric.M_B32`` and
``Metric.M_B16``; at the metrics' fastest growth its largest candidate
metric must stay under the bound acs.cuh states; without the
renormalisation it must go wrong on a long block, which shows that these
tests can fail.  K4's entry routes SOFT16 and the unclamped f32 values to
the int32 stage: a test reads the instances in viterbi.cu, and another
holds the f32 reader's negation (``neg_trunc``: ~u where the conversion
saturated, else -u) to the plain version's saturating conversion.  The
kernels themselves are held against the same plain versions on the card
by test_torch_cuda.py and chip_smoke.py.
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
from tpu_viterbi_torch.decoder import core_cuda, core_torch
from tpu_viterbi_torch.library import CSRC
from tpu_viterbi_torch.utils.bits import extreme_field_words, extreme_wire

torch.set_num_threads(1)

WORDS, VALUES, PLANES = "words", "values", "planes"
B32, B16 = DecodeOut.O_B32, DecodeOut.O_B16
# (mode, channel, decode_out, metric, dec_len): each mode at b32 and b16,
# M_B32 and M_B16, at dec_len 96, below 64 (32) and at the default 2048
# (65 renormalisations a block at b32), and every channel it takes
CASES = [(WORDS, ChannelIn.HARD, B32, Metric.M_B32, 96),
         (WORDS, ChannelIn.SOFT4, B16, Metric.M_B16, 96),
         (WORDS, ChannelIn.SOFT8, B32, Metric.M_B16, 32),
         (WORDS, ChannelIn.SOFT8, B32, Metric.M_B16, 2048),
         (VALUES, ChannelIn.SOFT8, B32, Metric.M_B32, 96),
         (VALUES, ChannelIn.HARD, B16, Metric.M_B16, 96),
         (VALUES, ChannelIn.SOFT4, B32, Metric.M_B16, 32),
         (VALUES, ChannelIn.SOFT8, B32, Metric.M_B16, 2048),
         (PLANES, ChannelIn.FP32, B32, Metric.M_B32, 96),
         (PLANES, ChannelIn.FP32, B16, Metric.M_B16, 96),
         (PLANES, ChannelIn.FP32, B32, Metric.M_B16, 32),
         (PLANES, ChannelIn.FP32, B32, Metric.M_B16, 2048)]


def _id(v):
    return getattr(v, "name", str(v))


def _field_values(rng, ch, n_stages):
    """(n_stages, 2) int32 values at the extremes of the channel's field
    range and anywhere in it (the contract of K4's value mode)."""
    if ch == ChannelIn.HARD:
        return rng.choice(np.array([-1, 1], np.int32), size=(n_stages, 2))
    half = 1 << (DecoderConfig(ch).enc_data_width - 1)
    ext = rng.choice(np.array([-half, half - 1], np.int32),
                     size=(n_stages, 2))
    anywhere = rng.integers(-half, half, size=(n_stages, 2)).astype(np.int32)
    return np.where(rng.random((n_stages, 2)) < 0.5, ext, anywhere)


def _staged(mode, x, cfg, plan):
    """K6's plain staging of ``x`` for K4 (words, values) or the clamped
    planes of K5: the kernel's input."""
    if mode == WORDS:
        return (core_torch.stage_words(x, cfg, plan),)
    if mode == VALUES:
        return (core_torch.stage_transpose(x.reshape(-1), 2 * plan.dec_len,
                                           2 * plan.block_len,
                                           plan.num_blocks),)
    return core_torch.stage_floats_2streams(x, cfg, plan)


def _i16(mode, staged, cfg, plan, **kw):
    if mode == PLANES:
        return core_torch.decode_planes_i16_torch(*staged, cfg, plan, **kw)
    return core_torch.decode_staged_i16_torch(*staged, cfg, plan, **kw)


def _int32(mode, staged, cfg, plan, window=False):
    if mode == PLANES:
        return core_torch.decode_planes_torch(*staged, cfg, plan, window)
    return core_torch.decode_staged_torch(*staged, cfg, plan, window)


def _bound(cfg):
    key = core_torch.pm16_input(cfg)
    return core_torch.pm16_bound(core_torch.PM16_MAX_ABS_BM[key],
                                 cfg.bits_per_pack)


def _masked(x, bpp):
    return np.asarray(x).astype(np.int64) & ((1 << bpp) - 1)


@pytest.mark.parametrize("mode,ch,out,metric,dec_len", CASES, ids=_id)
def test_i16_matches_int32_and_xla(rng, mode, ch, out, metric, dec_len):
    """Extreme input of the plan (words: every field at its extremes or
    anywhere; values: the field range's ends or anywhere in it; planes:
    the wire's NaN, +-inf, values past the clamp and noise): the int16 K4
    or K5 equals its int32 plain version, full store and window, under the
    input's bound, and its full store equals the XLA core at this metric
    width (M_B16: the JAX package's own int16 metrics and renorm rule)."""
    jcfg = DecoderConfig(ch, metric, out)
    bpp = jcfg.bits_per_pack
    jplan = core_xla.plan_blocks(dec_len * (2 if dec_len > 96 else 5) - bpp,
                                 bpp, dec_len)
    cfg, plan = from_reference(jcfg), core_torch.plan_from_reference(jplan)
    n = jcfg.get_input_words(2 * (jplan.message_len + 64))
    if mode == VALUES:
        x = _field_values(rng, ch, jplan.message_len + 64 - 7)
        want = core_xla.decode_blocks(
            core_xla.gather_blocks(jnp.asarray(x), jplan), jcfg, jplan)
    else:
        x = extreme_wire(rng, n) if mode == PLANES else \
            extreme_field_words(rng, n, jcfg.enc_data_width)
        want = core_xla.decode_packed_xla(jnp.asarray(x), jcfg, jplan)
    staged = _staged(mode, torch.from_numpy(x), cfg, plan)
    got, peak = _i16(mode, staged, cfg, plan, return_peak=True)
    assert torch.equal(got, _int32(mode, staged, cfg, plan))
    assert peak <= _bound(cfg)
    flat = core_torch.assemble_output(got, cfg, plan)
    assert np.array_equal(_masked(flat, bpp), _masked(want, bpp))
    win, peak = _i16(mode, staged, cfg, plan, window=True, return_peak=True)
    assert torch.equal(win, _int32(mode, staged, cfg, plan, window=True))
    assert peak <= _bound(cfg)


def _noiseless(rng, mode, ch, plan):
    """A noiseless coded stream of the plan's message at full amplitude,
    the metrics' fastest growth: words and values at +-the field's
    largest magnitude (HARD +-1, SOFT4 +-7, SOFT8 +-127), the wire at -8
    and 7."""
    bits = rng.integers(0, 2, size=plan.message_len + 64)
    coded = conv_encode_np(bits).astype(np.float32)
    if mode == PLANES:
        return torch.from_numpy(coded * 15 - 8)
    hi = {ChannelIn.HARD: 1, ChannelIn.SOFT4: 7, ChannelIn.SOFT8: 127}[ch]
    sym = torch.from_numpy(coded * 2 * hi - hi)
    if mode == VALUES:
        return sym.to(torch.int32).reshape(-1, 2)
    return quantize_and_pack(sym, ch)


@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
@pytest.mark.parametrize("out", [B32, B16], ids=_id)
@pytest.mark.parametrize("mode,ch", [(WORDS, ChannelIn.SOFT8),
                                     (VALUES, ChannelIn.SOFT4),
                                     (PLANES, ChannelIn.FP32)], ids=_id)
def test_bound_held_at_fastest_growth(rng, mode, ch, out, window):
    """Noiseless coded input at full amplitude over a block of dec_len 512
    (the metrics' spread saturates within a few stages, so 18 packs at
    b32 reach the peak): the int16 decode equals the int32 one and its
    largest candidate stays under the bound acs.cuh states, (12 + bpp) *
    max|bm|, and above half of it."""
    cfg = from_reference(DecoderConfig(ch, decode_out=out))
    plan = core_torch.plan_blocks(512, cfg.bits_per_pack, 512)
    staged = _staged(mode, _noiseless(rng, mode, ch, plan), cfg, plan)
    got, peak = _i16(mode, staged, cfg, plan, window=window,
                     return_peak=True)
    assert torch.equal(got, _int32(mode, staged, cfg, plan, window))
    assert _bound(cfg) // 2 < peak <= _bound(cfg)


@pytest.mark.parametrize("mode", [WORDS, VALUES])
def test_renorm_needed(rng, mode):
    """Noiseless coded SOFT8 at +-127 over one block of dec_len 2048: with
    the renormalisation the int16 decode equals the int32 one; without it
    the candidates pass 32,767 and the decode goes wrong."""
    ch = ChannelIn.SOFT8
    cfg = from_reference(DecoderConfig(ch))
    plan = core_torch.plan_blocks(2048, 32, 2048)
    staged = _staged(mode, _noiseless(rng, mode, ch, plan), cfg, plan)
    want = _int32(mode, staged, cfg, plan)
    got, peak = _i16(mode, staged, cfg, plan, return_peak=True)
    assert torch.equal(got, want) and peak <= _bound(cfg)
    bad, bad_peak = _i16(mode, staged, cfg, plan, renorm=False,
                         return_peak=True)
    assert bad_peak > 2 ** 15
    assert not torch.equal(bad, want)


def test_i16_refuses_int32_inputs(rng):
    """K4 keeps int32 metrics on SOFT16 (|bm| to 65,536) and on the FP32
    channel's unclamped f32 values (saturating at +-2^31): its int16 plain
    version refuses both, and K5's refuses another channel than FP32; the
    wrappers pass integer values' width to the entry as VALUE_WIDTH plus
    the field width, viterbi.cu's kValueWidth."""
    plan = core_torch.plan_blocks(256, 32, 128)
    soft16 = DecoderConfig(ChannelIn.SOFT16)
    words = torch.zeros(sum(core_torch.words_per_block(soft16, plan)),
                        plan.num_blocks, dtype=torch.int32)
    with pytest.raises(ValueError, match="SOFT16"):
        core_torch.decode_staged_i16_torch(words, soft16, plan)
    fp32 = DecoderConfig(ChannelIn.FP32)
    vals = torch.zeros(2 * plan.block_len, plan.num_blocks)
    with pytest.raises(ValueError, match="f32 values"):
        core_torch.decode_staged_i16_torch(vals, fp32, plan)
    with pytest.raises(ValueError, match="SOFT8"):
        core_torch.decode_planes_i16_torch(vals[0::2], vals[1::2],
                                           DecoderConfig(ChannelIn.SOFT8),
                                           plan)
    src = (CSRC / "viterbi.cu").read_text()
    assert f"constexpr int kValueWidth = {core_cuda.VALUE_WIDTH};" in src


def _body(src, name):
    """The body of viterbi.cu's entry ``name`` (extern "C" or not)."""
    return re.split(rf"\bint {name}\(VITERBI_ARGS\) {{", src)[1] \
        .split("\n}")[0]


def test_k4_k5_entries_route_pm16_by_width():
    """viterbi_k4_launch instantiates the int16x2 stage on HARD, SOFT4 and
    SOFT8 words and the int32 stage on SOFT16; k4_values on HARD, SOFT4
    and SOFT8 values (kValueWidth + 1, 4, 8) and int32 on SOFT16 values and
    the unclamped f32 values (UnclampedReader); viterbi_k5_launch the
    int16x2 stage on its planes.  Each VITERBI_STAGED is the four instances
    of b32 and b16, full store and window."""
    src = (CSRC / "viterbi.cu").read_text()
    staged = r"VITERBI_STAGED\(([^,]+), (\S+), (true|false)\)"
    k4 = _body(src, "viterbi_k4_launch")
    assert sorted(re.findall(staged, k4)) == sorted(
        [(str(w), f"StagedIntReader<{w}>", "true") for w in (1, 4, 8)] +
        [("16", "StagedIntReader<16>", "false")])
    values = _body(src, "k4_values")
    assert sorted(re.findall(staged, values)) == sorted(
        [(f"kValueWidth + {w}", "PlaneReader<int>", "true")
         for w in (1, 4, 8)] +
        [("kValueWidth + 16", "PlaneReader<int>", "false"),
         ("0", "UnclampedReader", "false")])
    assert re.findall(staged, _body(src, "viterbi_k5_launch")) == [
        ("0", "PlaneReader<float>", "true")]
    for body in (k4, values, _body(src, "viterbi_k5_launch")):
        assert "VITERBI_LAUNCH" not in body and "VITERBI_CASE" not in body
    macro = src.split("#define VITERBI_STAGED(W, R, PM16)")[1] \
        .split("#define")[0]
    assert sorted(re.findall(r"VITERBI_LAUNCH\(W, R, (\d+), (\w+), PM16\)",
                             macro)) == sorted(
        (b, w) for b in ("32", "16") for w in ("true", "false"))


# f32 values at the conversion's edges: NaN, +-inf, past the int32 range,
# +-2^31 and the floats next to it, and ordinary values
EDGES = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0 ** 31,
                  -2.0 ** 31, 2.0 ** 31 - 128, -(2.0 ** 31 - 128), 0.0,
                  -0.0, 0.5, -0.5, 1.5, -1.5, 7.0, -8.0, 123456.7,
                  -98765.4], dtype=np.float32)


def _neg_trunc(u: torch.Tensor) -> torch.Tensor:
    """viterbi.cu's neg_trunc in plain torch: ~u where u is INT32_MAX or
    INT32_MIN (the conversion saturated, or x was -2^31), else -u."""
    sat = (u == 2 ** 31 - 1) | (u == -2 ** 31)
    return torch.where(sat, ~u, -u.to(torch.int64)).to(torch.int32)


def test_neg_trunc_is_the_saturating_conversion_of_minus_x():
    """K4's f32 value reader converts u = trunc(r0 + r1) and d = trunc(r0 -
    r1) and takes nu, nd by neg_trunc: on every sum and difference of two
    edge values (NaN, +-inf, +-3e9, +-2^31, +-(2^31 - 128), ...) that
    equals the plain version's saturating conversion of the negated f32
    value, trunc_int32(-x), which its branch metrics take (s0 * r0 + s1 *
    r1 with the signs -1 is -(r0 + r1) exactly)."""
    r0, r1 = (torch.from_numpy(v) for v in np.meshgrid(EDGES, EDGES))
    for x in (r0 + r1, r0 - r1):
        u = core_torch.trunc_int32(x)
        assert torch.equal(_neg_trunc(u), core_torch.trunc_int32(-x))
    s0 = -torch.ones(1, 1)
    bm = core_torch._branch_metrics(r0.reshape(-1), r1.reshape(-1), s0, s0,
                                    True)
    assert torch.equal(bm[0], _neg_trunc(core_torch.trunc_int32(
        (r0 + r1).reshape(-1))))
    src = (CSRC / "viterbi.cu").read_text()
    assert re.search(r"static_cast<uint32_t>\(u\) - 0x7FFFFFFFu < 2u;\s*"
                     r"return sat \? ~u : -u;", src)
