"""Kernels K1-K6 on the card against their plain PyTorch versions (the
int16x2 metrics of K1, K2 and K3 on extreme fields and wires against the
int32 core, the int16 plain version and their int32 instances K1_I32,
K2_I32 and K3_I32 too; K4's and K5's on extreme words, values and planes
against both plain versions, and K4's unclamped f32 values at the
conversion's edges), the
staged-input paths (``decode_packed_cuda(fused=False)``,
``fp32_words=False``, ``decode_blocks_cuda``) and their launch counts, and
ViterbiGPU's CUDA path (run, run_stream, streaming); the generator
kernels K7 and K8 against theirs, and the in-graph simulation on the card;
the hardware model (K9's probe, K3's shared-memory gate), the op-cost
kernels K11 and the canary K10; the probes' kernels K12-K15 (layout,
ablation, ACS variants, ILP) and K16-K19 (constructs, dtype rates, int16x2
SWAR, 16-bit ACS) against their plain versions, the generator probe K20
and the roll-halo decode K23 against theirs, K1's and K3's u/d-word reader,
the last probes' kernels K25 (SOFT16 ablation), K26 (transpose and its
consumer, one launch on reused memory; each tiling on its bulk or
element route, and replayed from a CUDA graph) and K28 (interleave) against
theirs, and the probes' entry points; K1's and K3's tail halo against
the plain version and the same kernel on the appended stream, the sharded
generator's slabs and the split's ranks (in this process) on the card;
one 32M-bit call of each deep-BER tail row (the kernels' words and BEN
equal to the plain versions'), the fuzz script's trials, the generator
BER check, ``--profile`` (a trace holding K7's and K1's launches; each
decode kernel of a traced ``run_on_device`` linked to its launch inside
``api.launch``), and
the timing sweeps' rows at small sizes; a BER-curve point of each
configuration against the plain decode.
Every test here needs a CUDA GPU and skips without one; the
file imports no jax, so it runs on a machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import itertools
import math

import numpy as np
import pytest
import torch

from tpu_viterbi_torch import (ConfigResolutionError, ViterbiGPU, cli,
                               hardware)
from tpu_viterbi_torch.chain import genkernel
from tpu_viterbi_torch.chain.encode import conv_encode_np
from tpu_viterbi_torch.chain.quantize import quantize_and_pack
from tpu_viterbi_torch.chain.quantize import unpack_to_soft
from tpu_viterbi_torch.config import ChannelIn, DecodeOut, DecoderConfig
from tpu_viterbi_torch.decoder import core_cuda, core_torch
from tpu_viterbi_torch.decoder.streaming import StreamingViterbi
from tpu_viterbi_torch.scripts import (acs_variants_bench, bench_profile,
                                       bench_split, dtype_throughput,
                                       fp32_fused_value_probe,
                                       genkernel_probe, ilp_probe,
                                       interleave_bench, kernel_ablation,
                                       kernel_microbench, layout_probe,
                                       op_cost_probe, opt_bench,
                                       soft16_ablation, soft16_pieces,
                                       staging_cost, swar_probe,
                                       transpose_bench)
from tpu_viterbi_torch.scripts import (ber_curve, ber_deep_tail,
                                       check_gen_ber, fuzz_gpu)
from tpu_viterbi_torch.scripts import (channel_throughput, scaling_curve,
                                       small_msg_sweep)
from tpu_viterbi_torch.sharding import blocks, simulate
from tpu_viterbi_torch.sharding.certify import coded_workload
from tpu_viterbi_torch.sharding.mesh import BlockMesh
from tpu_viterbi_torch.utils import profile, timing
from tpu_viterbi_torch.utils.bits import extreme_field_words, extreme_wire

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _words(rng, cfg, plan):
    n = cfg.get_input_words(2 * (plan.message_len + 64))
    if cfg.channel_in == ChannelIn.FP32:
        x = (rng.standard_normal(n) * 9).astype(np.float32)
        x[rng.random(n) < 0.05] = np.nan
        x[rng.random(n) < 0.02] = np.inf
        x[rng.random(n) < 0.02] = -np.inf
        return x
    return rng.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int32)


@pytest.mark.parametrize("channel", [ChannelIn.HARD, ChannelIn.SOFT4,
                                     ChannelIn.SOFT8, ChannelIn.SOFT16],
                         ids=lambda c: c.name)
@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [32, 96])
def test_k1_matches_plain(gpu, rng, channel, out, dec_len):
    cfg = DecoderConfig(channel, decode_out=out)
    m = 16 * 301 if out == DecodeOut.O_B16 else 32 * 151
    plan = core_torch.plan_blocks(m, cfg.bits_per_pack, dec_len)
    x = torch.from_numpy(_words(rng, cfg, plan)).to(gpu)
    before = core_cuda.K1.launches
    got = core_cuda.K1(x, cfg, plan)
    torch.cuda.synchronize()
    assert core_cuda.K1.launches == before + 1
    assert torch.equal(got, core_torch.decode_blocks_torch(x, cfg, plan))
    assert torch.equal(core_cuda.decode_packed_cuda(x, cfg, plan),
                       core_torch.decode_packed_torch(x, cfg, plan))


def test_k1_rejects_bad_input(gpu):
    cfg = DecoderConfig(ChannelIn.SOFT8)
    plan = core_torch.plan_blocks(2048, 32)
    with pytest.raises(ValueError, match="int32"):
        core_cuda.K1(torch.zeros(600, dtype=torch.int64, device=gpu), cfg,
                     plan)
    with pytest.raises(ConfigResolutionError, match="K2"):
        core_cuda.K1(torch.zeros(600, device=gpu),
                     DecoderConfig(ChannelIn.FP32), plan)


@pytest.mark.parametrize("channel", [ChannelIn.HARD, ChannelIn.SOFT8],
                         ids=lambda c: c.name)
@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [96, 2048, 16384])
def test_k1_int16_extreme_fields(gpu, rng, channel, out, dec_len):
    """K1's int16x2 metrics on fields at their extremes (and, for SOFT8,
    noiseless coded words at +-127, the metrics' fastest growth) equal the
    int32 core; on SOFT8 K1_I32, the int32 instances, equals both.  Each
    decode is one launch of its own kernel."""
    cfg = DecoderConfig(channel, decode_out=out)
    bpp = cfg.bits_per_pack
    plan = core_torch.plan_blocks(dec_len * 20 - bpp, bpp, dec_len)
    n = cfg.get_input_words(2 * (plan.message_len + 64))
    inputs = [extreme_field_words(rng, n, cfg.enc_data_width)]
    if channel == ChannelIn.SOFT8:
        bits = rng.integers(0, 2, size=plan.message_len + 64)
        coded = conv_encode_np(bits).astype(np.float32) * 254 - 127
        inputs.append(quantize_and_pack(torch.from_numpy(coded),
                                        ChannelIn.SOFT8).numpy())
    for words in inputs:
        x = torch.from_numpy(words).to(gpu)
        want = core_torch.decode_blocks_torch(x, cfg, plan)
        got, n_launch = _launched([core_cuda.K1, core_cuda.K1_I32],
                                  lambda: core_cuda.K1(x, cfg, plan))
        assert n_launch == [1, 0] and torch.equal(got, want)
        if channel == ChannelIn.SOFT8:
            got, n_launch = _launched(
                [core_cuda.K1, core_cuda.K1_I32],
                lambda: core_cuda.K1_I32(x, cfg, plan))
            assert n_launch == [0, 1] and torch.equal(got, want)


def test_k1_i32_takes_soft8_only(gpu):
    plan = core_torch.plan_blocks(2048, 32)
    with pytest.raises(ConfigResolutionError, match="SOFT8 only"):
        core_cuda.K1_I32(torch.zeros(600, dtype=torch.int32, device=gpu),
                         DecoderConfig(ChannelIn.SOFT4), plan)


def _noiseless(rng, plan, lo, hi):
    """A noiseless coded stream of the plan's message, each coded bit at
    ``lo`` (0) or ``hi`` (1): the path metrics' fastest growth."""
    bits = rng.integers(0, 2, size=plan.message_len + 64)
    return conv_encode_np(bits).astype(np.float32) * (hi - lo) + lo


@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [96, 2048, 16384])
def test_k2_int16extreme_wire(gpu, rng, out, dec_len):
    """K2's int16x2 metrics on wires of NaN, +-inf and values past the
    clamp, and on the noiseless coded wire at -8 and 7, equal K2_I32 (its
    int32 instances), the int16 plain version and the int32 core; each
    decode is one launch of its own kernel."""
    cfg = DecoderConfig(ChannelIn.FP32, decode_out=out)
    bpp = cfg.bits_per_pack
    plan = core_torch.plan_blocks(dec_len * 20 - bpp, bpp, dec_len)
    n = cfg.get_input_words(2 * (plan.message_len + 64))
    for wire in (extreme_wire(rng, n), _noiseless(rng, plan, -8.0, 7.0)):
        x = torch.from_numpy(wire).to(gpu)
        want = core_torch.decode_blocks_torch(x, cfg, plan)
        assert torch.equal(core_torch.decode_blocks_i16_torch(x, cfg, plan),
                           want)
        kernels = [core_cuda.K2, core_cuda.K2_I32]
        for k, launched in ((core_cuda.K2, [1, 0]),
                            (core_cuda.K2_I32, [0, 1])):
            got, n_launch = _launched(kernels, lambda: k(x, cfg, plan))
            assert n_launch == launched and torch.equal(got, want)


@pytest.mark.parametrize("inp", [ChannelIn.HARD, ChannelIn.SOFT4,
                                 ChannelIn.SOFT8, ChannelIn.SOFT16, "UD",
                                 "WIRE"],
                         ids=lambda c: c if isinstance(c, str) else c.name)
@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [96, 2048])
def test_k3_int16_extreme_fields(gpu, rng, inp, out, dec_len):
    """K3 with the ring at W = 4 (b32) and W = 6 (b16) slots: on fields at
    their extremes of every int16 input (HARD, SOFT4, SOFT8, the FP32
    channel's u/d words, its wire with NaN, +-inf and values past the
    clamp), and on noiseless coded SOFT8 at +-127 and wire at -8 and 7, it
    equals the int16 plain window and the int32 one, and K3_I32 (its int32
    instances) on SOFT8 and the wire; SOFT16 runs its int32 stage, equal to
    the int32 plain window.  Each decode is one launch of its own
    kernel."""
    channel = ChannelIn.FP32 if inp in ("UD", "WIRE") else inp
    cfg = DecoderConfig(channel, decode_out=out)
    bpp = cfg.bits_per_pack
    assert core_torch.survivor_window_slots(cfg) == (4 if bpp == 32 else 6)
    plan = core_torch.plan_blocks(dec_len * 20 - bpp, bpp, dec_len)
    n = cfg.get_input_words(2 * (plan.message_len + 64))
    if inp == "WIRE":
        inputs = [extreme_wire(rng, n), _noiseless(rng, plan, -8.0, 7.0)]
    elif inp == "UD":
        wpb, wph = core_torch.ud_words_per_block(plan)
        inputs = [extreme_field_words(rng, plan.num_blocks * wpb + wph, 8)]
    else:
        inputs = [extreme_field_words(rng, n, cfg.enc_data_width)]
        if channel == ChannelIn.SOFT8:
            inputs.append(quantize_and_pack(torch.from_numpy(
                _noiseless(rng, plan, -127.0, 127.0)), channel).numpy())
    k3, k3_i32 = core_cuda.K3, core_cuda.K3_I32
    for words in inputs:
        x = torch.from_numpy(words).to(gpu)
        if inp == "UD":
            want = core_torch.assemble_output(core_torch.decode_ud_words_torch(
                x, cfg, plan, window=True), cfg, plan)
            plain16 = core_torch.assemble_output(
                core_torch.decode_blocks_i16_torch(x, cfg, plan, ud=True,
                                                   window=True), cfg, plan)
            got, n_launch = _launched([k3, k3_i32], lambda: (
                core_cuda.decode_ud_words_cuda(x, cfg, plan, window=True)))
        else:
            want = core_torch.decode_blocks_torch(x, cfg, plan, window=True)
            plain16 = want if channel == ChannelIn.SOFT16 else \
                core_torch.decode_blocks_i16_torch(x, cfg, plan, window=True)
            got, n_launch = _launched([k3, k3_i32], lambda: k3(x, cfg, plan))
        assert n_launch == [1, 0] and torch.equal(got, want)
        assert torch.equal(plain16, want)
        if channel in k3_i32.channels and inp != "UD":
            got, n_launch = _launched([k3, k3_i32],
                                      lambda: k3_i32(x, cfg, plan))
            assert n_launch == [0, 1] and torch.equal(got, want)


def test_viterbi_gpu_launches_k1(gpu, rng):
    """run() launches K1 for the integer channels, K2 for FP32 and K3 for
    the window, each equal to the plain version on the CPU."""
    input_num = 2 * (9_000 + 64)
    for cfg, survivor, kernel in (
            (DecoderConfig(ChannelIn.SOFT8), "auto", core_cuda.K1),
            (DecoderConfig(ChannelIn.FP32), "full", core_cuda.K2),
            (DecoderConfig(ChannelIn.HARD), "window", core_cuda.K3)):
        plan = core_torch.plan_blocks(9_024, 32)      # covers input_num
        x = _words(rng, cfg, plan)[:cfg.get_input_words(input_num)]
        before = kernel.launches
        got, seconds = ViterbiGPU(cfg, survivor=survivor).run(x, input_num)
        assert kernel.launches == before + 1 and seconds > 0
        want, _ = ViterbiGPU(cfg, backend="torch", device="cpu",
                             survivor=survivor).run(x, input_num)
        assert np.array_equal(got, want)
        torch_on_gpu, _ = ViterbiGPU(cfg, backend="torch",
                                     survivor=survivor).run(x, input_num)
        assert np.array_equal(torch_on_gpu, want)


@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [32, 96, 2048])
def test_k2_matches_plain(gpu, rng, out, dec_len):
    cfg = DecoderConfig(ChannelIn.FP32, decode_out=out)
    plan = core_torch.plan_blocks(dec_len * 9 - cfg.bits_per_pack,
                                  cfg.bits_per_pack, dec_len)
    x = torch.from_numpy(_words(rng, cfg, plan)).to(gpu)
    before = core_cuda.K2.launches
    got = core_cuda.K2(x, cfg, plan)
    torch.cuda.synchronize()
    assert core_cuda.K2.launches == before + 1
    assert torch.equal(got, core_torch.decode_blocks_torch(x, cfg, plan))


@pytest.mark.parametrize("channel", [ChannelIn.HARD, ChannelIn.SOFT4,
                                     ChannelIn.SOFT8, ChannelIn.SOFT16,
                                     ChannelIn.FP32], ids=lambda c: c.name)
@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [32, 224])
def test_k3_matches_plain_window(gpu, rng, channel, out, dec_len):
    cfg = DecoderConfig(channel, decode_out=out)
    plan = core_torch.plan_blocks(dec_len * 9 - cfg.bits_per_pack,
                                  cfg.bits_per_pack, dec_len)
    x = torch.from_numpy(_words(rng, cfg, plan)).to(gpu)
    before = core_cuda.K3.launches
    got = core_cuda.K3(x, cfg, plan)
    torch.cuda.synchronize()
    assert core_cuda.K3.launches == before + 1
    assert torch.equal(got, core_torch.decode_blocks_torch(x, cfg, plan,
                                                           window=True))


def _soft_values(rng, cfg, n_stages):
    """(n_stages, 2) soft values for the values-in entry: integer channels
    within their field range; FP32 unclamped, with NaN, +-inf and values
    past the int32 range."""
    if cfg.channel_in == ChannelIn.FP32:
        r = (rng.standard_normal((n_stages, 2)) * 30).astype(np.float32)
        for frac, v in ((0.04, np.nan), (0.02, np.inf), (0.02, -np.inf),
                        (0.02, 3e9), (0.02, -5e9)):
            r[rng.random(r.shape) < frac] = v
        return r
    if cfg.channel_in == ChannelIn.HARD:
        return rng.choice(np.array([-1, 1], np.int32), size=(n_stages, 2))
    half = 1 << (cfg.enc_data_width - 1)
    return rng.integers(-half, half, size=(n_stages, 2)).astype(np.int32)


def _launched(kernels, fn):
    """fn()'s result and the launches it added to each kernel."""
    before = [k.launches for k in kernels]
    out = fn()
    torch.cuda.synchronize()
    return out, [k.launches - b for k, b in zip(kernels, before)]


@pytest.mark.parametrize("channel", [ChannelIn.HARD, ChannelIn.SOFT4,
                                     ChannelIn.SOFT8, ChannelIn.SOFT16],
                         ids=lambda c: c.name)
@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [32, 96])
@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
def test_k6_k4_word_mode_match_plain(gpu, rng, channel, out, dec_len,
                                     window):
    """K6 stages the packed words word-major, K4 decodes them (word mode),
    each equal to its plain version; fused=False launches both once."""
    cfg = DecoderConfig(channel, decode_out=out)
    plan = core_torch.plan_blocks(dec_len * 9 - cfg.bits_per_pack,
                                  cfg.bits_per_pack, dec_len)
    x = torch.from_numpy(_words(rng, cfg, plan)).to(gpu)
    wt, n = _launched([core_cuda.K6], lambda: core_cuda.stage_words_cuda(
        x, cfg, plan))
    assert n == [1] and torch.equal(wt, core_torch.stage_words(x, cfg, plan))
    got, n = _launched([core_cuda.K4], lambda: core_cuda.K4(wt, cfg, plan,
                                                            window))
    assert n == [1]
    assert torch.equal(got, core_torch.decode_staged_torch(wt, cfg, plan,
                                                           window))
    flat, n = _launched([core_cuda.K6, core_cuda.K4, core_cuda.K1],
                        lambda: core_cuda.decode_packed_cuda(
                            x, cfg, plan, fused=False, window=window))
    assert n == [1, 1, 0]
    assert torch.equal(flat, core_torch.decode_packed_torch(x, cfg, plan,
                                                            window))


@pytest.mark.parametrize("channel", list(ChannelIn), ids=lambda c: c.name)
@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
def test_k4_value_mode_matches_plain(gpu, rng, channel, out, window):
    """K6 stages (S, 2) soft values as 2S words, K4 decodes them in value
    mode (int32, or f32 unclamped), each equal to its plain version;
    decode_blocks_cuda launches both once and equals decode_blocks."""
    cfg = DecoderConfig(channel, decode_out=out)
    plan = core_torch.plan_blocks(96 * 9 - cfg.bits_per_pack,
                                  cfg.bits_per_pack, 96)
    r = torch.from_numpy(_soft_values(rng, cfg, plan.message_len + 57)) \
        .to(gpu)
    args = (2 * plan.dec_len, 2 * plan.block_len, plan.num_blocks)
    st = core_cuda.K6(r.reshape(-1), *args)
    assert torch.equal(st.view(torch.int32), core_torch.stage_transpose(
        r.reshape(-1), *args).view(torch.int32))
    got, n = _launched([core_cuda.K4], lambda: core_cuda.K4(st, cfg, plan,
                                                            window))
    assert n == [1]
    assert torch.equal(got, core_torch.decode_staged_torch(st, cfg, plan,
                                                           window))
    if not window:
        flat, n = _launched([core_cuda.K6, core_cuda.K4], lambda:
                            core_cuda.decode_blocks_cuda(r, cfg, plan))
        assert n == [1, 1]
        assert torch.equal(flat, core_torch.decode_blocks(
            core_torch.gather_blocks(r, plan), cfg, plan))


@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [32, 96, 2048])
@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
def test_k5_matches_plain_and_k2(gpu, rng, out, dec_len, window):
    """K5 on the clamped planes of the staged f32 wire equals its plain
    version, and (fp32_words=False) the raw-wire decode K2 / K3."""
    cfg = DecoderConfig(ChannelIn.FP32, decode_out=out)
    plan = core_torch.plan_blocks(dec_len * 9 - cfg.bits_per_pack,
                                  cfg.bits_per_pack, dec_len)
    x = torch.from_numpy(_words(rng, cfg, plan)).to(gpu)
    r0, r1 = core_torch.clamp_split(core_cuda.stage_words_cuda(x, cfg, plan),
                                    plan)
    got, n = _launched([core_cuda.K5], lambda: core_cuda.K5(r0, r1, cfg, plan,
                                                            window))
    assert n == [1]
    assert torch.equal(got, core_torch.decode_planes_torch(r0, r1, cfg, plan,
                                                           window))
    flat, n = _launched([core_cuda.K6, core_cuda.K5],
                        lambda: core_cuda.decode_packed_cuda(
                            x, cfg, plan, fp32_words=False, window=window))
    assert n == [1, 1]
    assert torch.equal(flat, core_cuda.decode_packed_cuda(x, cfg, plan,
                                                          window=window))
    planes = [r.contiguous() for r in (r0, r1)]     # two contiguous planes
    assert torch.equal(core_cuda.K5(*planes, cfg, plan, window), got)


def _field_extremes(rng, channel, n_stages):
    """(n_stages, 2) int32 values at the ends of the channel's field range
    (HARD +-1, SOFTw -2^(w-1) and 2^(w-1) - 1)."""
    half = 1 if channel == ChannelIn.HARD else \
        1 << (DecoderConfig(channel).enc_data_width - 1)
    hi = 1 if channel == ChannelIn.HARD else half - 1
    return rng.choice(np.array([-half, hi], np.int32), size=(n_stages, 2))


@pytest.mark.parametrize("mode", ["words", "values", "planes"])
@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [96, 2048])
@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
def test_k4_k5_int16_extreme_input(gpu, rng, mode, out, dec_len, window):
    """K4's and K5's int16x2 metrics at the ends of their input range: K4
    in word mode on HARD, SOFT4 and SOFT8 fields at their extremes and on
    noiseless coded SOFT8 at +-127, in value mode on values at the ends of
    each field range and on the same noiseless SOFT8, K5 on planes of -8, 7
    and NaN and on the noiseless coded wire at -8 and 7 (the metrics'
    fastest growth): each equals the int32 plain version and the int16
    one, one launch of its own kernel a decode."""
    kernel = core_cuda.K5 if mode == "planes" else core_cuda.K4
    channels = [ChannelIn.FP32] if mode == "planes" else [
        ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT8]
    for channel in channels:
        cfg = DecoderConfig(channel, decode_out=out)
        bpp = cfg.bits_per_pack
        plan = core_torch.plan_blocks(dec_len * 20 - bpp, bpp, dec_len)
        n = cfg.get_input_words(2 * (plan.message_len + 64))
        b = plan.num_blocks
        if mode == "planes":
            x = rng.choice(np.array([-8.0, 7.0, np.nan], np.float32), size=n)
            inputs = [x, _noiseless(rng, plan, -8.0, 7.0)]
        elif mode == "words":
            inputs = [extreme_field_words(rng, n, cfg.enc_data_width)]
        else:
            inputs = [_field_extremes(rng, channel, plan.message_len + 57)]
        if channel == ChannelIn.SOFT8:
            coded = _noiseless(rng, plan, -127.0, 127.0)
            inputs.append(coded.astype(np.int32).reshape(-1, 2)
                          if mode == "values" else quantize_and_pack(
                              torch.from_numpy(coded), channel).numpy())
        for x in inputs:
            x = torch.from_numpy(x).to(gpu)
            if mode == "planes":
                staged = core_torch.clamp_split(
                    core_cuda.stage_words_cuda(x, cfg, plan), plan)
                want = core_torch.decode_planes_torch(*staged, cfg, plan,
                                                      window)
                plain16 = core_torch.decode_planes_i16_torch(
                    *staged, cfg, plan, window)
            else:
                staged = (core_cuda.stage_words_cuda(x, cfg, plan)
                          if mode == "words" else core_cuda.K6(
                              x.reshape(-1), 2 * plan.dec_len,
                              2 * plan.block_len, b),)
                want = core_torch.decode_staged_torch(*staged, cfg, plan,
                                                      window)
                plain16 = core_torch.decode_staged_i16_torch(
                    *staged, cfg, plan, window)
            got, n_launch = _launched([kernel], lambda: kernel(
                *staged, cfg, plan, window))
            assert n_launch == [1]
            assert torch.equal(plain16, want) and torch.equal(got, want)


# f32 values at the conversion's edges: NaN, +-inf, past the int32 range,
# +-2^31 and the floats next to it, zeros, halves and the clamp's ends
F32_EDGES = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0 ** 31,
                      -2.0 ** 31, 2.0 ** 31 - 128, -(2.0 ** 31 - 128), 0.0,
                      -0.0, 0.5, -0.5, 7.0, -8.0], dtype=np.float32)


@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [96, 2048])
@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
def test_k4_f32_values_at_the_edges(gpu, rng, out, dec_len, window):
    """K4 on unclamped f32 values (int32 metrics, two conversions a stage
    and nu, nd from them), drawn from NaN, +-inf, +-3e9, +-2^31,
    +-(2^31 - 128) and small values, half of them noise of scale 30: equal
    to decode_staged_torch, whose branch metrics convert every state's
    correlation with saturation; one launch."""
    cfg = DecoderConfig(ChannelIn.FP32, decode_out=out)
    bpp = cfg.bits_per_pack
    plan = core_torch.plan_blocks(dec_len * 9 - bpp, bpp, dec_len)
    shape = (plan.message_len + 57, 2)
    r = np.where(rng.random(shape) < 0.5, rng.choice(F32_EDGES, size=shape),
                 rng.standard_normal(shape) * 30).astype(np.float32)
    r = torch.from_numpy(r).to(gpu)
    st = core_cuda.K6(r.reshape(-1), 2 * plan.dec_len, 2 * plan.block_len,
                      plan.num_blocks)
    got, n = _launched([core_cuda.K4], lambda: core_cuda.K4(st, cfg, plan,
                                                            window))
    assert n == [1]
    assert torch.equal(got, core_torch.decode_staged_torch(st, cfg, plan,
                                                           window))


def _k6_cases():
    """(id, stride, win, num, n, offset): every shape K6 treats apart."""
    cases = []
    for ch in ChannelIn:
        for dec_len in (32, 96):
            cfg = DecoderConfig(ch)
            plan = core_torch.plan_blocks(dec_len * 37 - 32, 32, dec_len)
            wpb, wph = core_torch.words_per_block(cfg, plan)
            n = cfg.get_input_words(2 * (plan.message_len + 64))
            cases.append((f"{ch.name}-{dec_len}", wpb, wpb + wph,
                          plan.num_blocks, n, 0))
    for stride in (64, 65, 66, 67):
        for num, short, what in ((333, 0, "odd-num"), (5, 0, "below-a-tile"),
                                 (333, 17, "ends-mid-window")):
            cases.append((f"stride{stride}-{what}", stride, 3 * stride, num,
                          (num - 1) * stride + 3 * stride - short, 0))
    for off in (1, 2, 3):
        cases += [(f"wide-offset{off}", 1024, 1056, 129, 1024 * 129, off),
                  (f"HARD-32-offset{off}", 2, 6, 600, 1200, off)]
    cases += [("HARD-32-full", 2, 6, 1_000_000, 2_000_004, 0),
              ("HARD-32-full-offset1", 2, 6, 1_000_000, 2_000_004, 1),
              ("halo-over-strides", 8, 40, 1000, 5000, 0),
              ("one-block", 100, 100, 1, 20, 0),
              ("wide-ragged", 64, 160, 33, 64 * 33 + 10, 0),
              ("wide-100", 1024, 1056, 100, 1024 * 100, 0)]
    return cases


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("case", _k6_cases(), ids=lambda c: c[0])
def test_k6_matches_plain(gpu, case, dtype):
    """K6 bit for bit against its plain version (float32 with NaN payloads
    and infs) at every channel's dec_len 32 and 96, every stride % 4, an
    odd num, one below a tile, a stream ending mid-window (zero past it),
    halos over several strides, one block, streams 1-3 words off an
    aligned start, and HARD at dec_len 32 over its 1,000,000 blocks: one
    launch, counted on the route transpose_route picks."""
    _, stride, win, num, n, off = case
    g = torch.Generator(device=gpu)
    g.manual_seed(n + off)
    bits = torch.randint(-2 ** 31, 2 ** 31, (n + off,), generator=g,
                         device=gpu, dtype=torch.int64).to(torch.int32)
    if dtype == torch.float32:
        bits[::7] = 0x7FC00001 + torch.arange(bits[::7].numel(), device=gpu,
                                              dtype=torch.int32)
        bits[3::11] = 0x7F800000
    x = bits.view(dtype)[off:]
    route = core_cuda.transpose_route(x.data_ptr(), stride, win)
    before = core_cuda.K6.route_launches[route]
    got, launches = _launched([core_cuda.K6], lambda: core_cuda.K6(
        x, stride, win, num))
    assert launches == [1] and got.dtype == dtype and got.is_contiguous()
    assert core_cuda.K6.route_launches[route] == before + 1
    want = core_torch.stage_transpose(x, stride, win, num)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if off % 2:
        assert route[0] == 1


def test_staged_wrappers_reject_bad_input(gpu):
    soft8 = DecoderConfig(ChannelIn.SOFT8)
    fp32 = DecoderConfig(ChannelIn.FP32)
    plan = core_torch.plan_blocks(2048 * 3, 32)
    wpb, wph = core_torch.words_per_block(soft8, plan)
    words = torch.zeros((wpb + wph, 3), dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError, match="int32"):
        core_cuda.K4(words.float(), soft8, plan)
    with pytest.raises(ValueError, match="contiguous"):
        core_cuda.K4(torch.zeros((3, wpb + wph), dtype=torch.int32,
                                 device=gpu).t(), soft8, plan)
    with pytest.raises(ValueError, match="staged words"):
        core_cuda.K4(words[:-1], soft8, plan)
    with pytest.raises(ValueError, match="one device"):
        core_cuda.K5(torch.zeros(plan.block_len, 3),
                     torch.zeros(plan.block_len, 3, device=gpu), fp32, plan)
    plane = torch.zeros((plan.block_len, 3), device=gpu)
    with pytest.raises(ValueError, match="row stride"):
        core_cuda.K5(plane, torch.zeros((plan.block_len, 6), device=gpu
                                        )[:, ::2], fp32, plan)
    with pytest.raises(ValueError, match="float32"):
        core_cuda.K5(plane.double(), plane, fp32, plan)
    with pytest.raises(ConfigResolutionError, match="FP32"):
        core_cuda.K5(plane, plane, soft8, plan)
    with pytest.raises(ValueError, match="int32 or float32"):
        core_cuda.K6(torch.zeros(100, dtype=torch.int64, device=gpu), 8, 8, 4)
    with pytest.raises(ValueError, match="1-D"):
        core_cuda.K6(torch.zeros((10, 10), device=gpu), 8, 8, 4)
    with pytest.raises(ValueError, match="unknown s16 layout"):
        core_cuda.decode_packed_cuda(words.reshape(-1), soft8, plan,
                                     s16="rows")


@pytest.mark.parametrize("survivor", ["full", "window"])
def test_run_stream_matches_run(gpu, rng, survivor):
    cfg = DecoderConfig(ChannelIn.SOFT8)
    input_num = 2 * (20_000 + 64)
    xs = [rng.integers(-2 ** 31, 2 ** 31, size=cfg.get_input_words(
        input_num)).astype(np.int32) for _ in range(4)]
    dec = ViterbiGPU(cfg, survivor=survivor)
    kernel = core_cuda.kernel_for(cfg, survivor == "window")
    before = kernel.launches
    outs, per = dec.run_stream(xs, input_num)
    assert kernel.launches == before + 4 and per > 0
    for x, got in zip(xs, outs):
        assert np.array_equal(got, dec.run(x, input_num)[0])


def test_streaming_on_gpu_matches_cpu(gpu, rng):
    cfg = DecoderConfig(ChannelIn.FP32, decode_out=DecodeOut.O_B16)
    x = (rng.standard_normal(cfg.get_input_words(2 * 9_000)) * 6
         ).astype(np.float32)
    on_gpu = StreamingViterbi(cfg, dec_len=512, survivor="window")
    on_cpu = StreamingViterbi(cfg, dec_len=512, survivor="window",
                              device="cpu")
    for a in range(0, x.shape[0], 2048):
        assert np.array_equal(on_gpu.push(x[a:a + 2048]),
                              on_cpu.push(x[a:a + 2048]))
    assert np.array_equal(on_gpu.flush(), on_cpu.flush())


GEN_N = 33 * 1024 + 13      # not a multiple of 32: the tail pack is masked


def _assert_generated_close(channel, got, want):
    """Noisy streams of a generator kernel and its plain version: at most
    1e-4 of the fields differ, each by one quantization step (an ulp of a
    libm result moved a value across a rounding boundary); FP32 values
    within 4 ulp of the noise term plus 4 ulp of the value."""
    got, want = got.cpu(), want.cpu()
    if channel == ChannelIn.FP32:
        scale = simulate.DEFAULT_SCALES[channel]
        noise = (want.abs() - scale).abs().numpy()
        tol = 4 * (np.spacing(noise) + np.spacing(want.abs().numpy()))
        assert np.all((got - want).abs().numpy() <= tol)
        return
    diff = (unpack_to_soft(got, channel).to(torch.int64)
            - unpack_to_soft(want, channel)).abs()
    assert int(diff.max()) <= 1
    assert int(diff.count_nonzero()) <= 1e-4 * diff.numel()


@pytest.mark.parametrize("channel", list(ChannelIn), ids=lambda c: c.name)
@pytest.mark.parametrize("snr_db", [math.inf, 3.0])
def test_generator_kernel_matches_plain(gpu, channel, snr_db):
    """K7 (integer channels) / K8 (FP32) against their plain version on the
    same device: bit packs equal, noiseless streams equal, noisy ones within
    the stated tolerance; a launch at a non-zero base writes that slice."""
    kernel = genkernel.K8 if channel == ChannelIn.FP32 else genkernel.K7
    scale = simulate.DEFAULT_SCALES[channel]
    before = kernel.launches
    bits, got = genkernel.packed_workload_cuda(9, GEN_N, channel, snr_db,
                                               scale, device=gpu)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    sigma = 0.0 if math.isinf(snr_db) else 10.0 ** (-snr_db / 5.0)
    plain = (genkernel.gen_values_torch(0, 9, GEN_N, sigma, scale,
                                        device=gpu)
             if channel == ChannelIn.FP32 else
             genkernel.gen_words_torch(0, 9, GEN_N, channel, sigma, scale,
                                       device=gpu))
    assert got.dtype == plain[1].dtype and got.shape == plain[1].shape
    assert torch.equal(bits, plain[0])
    if math.isinf(snr_db):
        assert torch.equal(got, plain[1])
    else:
        _assert_generated_close(channel, got, plain[1])
    quantum = 64 if channel == ChannelIn.FP32 else \
        genkernel.word_format(channel)[2]
    base = quantum * (got.shape[0] // quantum // 3)
    bits_b, got_b = genkernel.packed_workload_cuda(
        9, GEN_N, channel, snr_db, scale, device=gpu, base=base)
    assert torch.equal(got_b, got[base:])
    assert torch.equal(bits_b, bits[base // quantum:])


GEN_RAGGED = 5 * 4096 + 77   # ends mid-CTA and mid-pack for every width


def _quantum(channel):
    """Words (FP32: values) a bit pack takes: the step of ``base``."""
    return 64 if channel == ChannelIn.FP32 else \
        genkernel.word_format(channel)[2]


def _generate(kernel, channel, sigma, base, device):
    scale = simulate.DEFAULT_SCALES[channel]
    return kernel(0, 9, GEN_RAGGED, channel, sigma, scale, base, device)


@pytest.mark.parametrize("channel", list(ChannelIn), ids=lambda c: c.name)
@pytest.mark.parametrize("packs", [0, 1, 2], ids=["base0", "even", "odd"])
@pytest.mark.parametrize("snr_db", [math.inf, 3.0])
def test_generator_pack_table_matches_plain(gpu, channel, packs, snr_db):
    """K7 (each width) and K8 from base 0 (the first CTA's span starts at
    pack -1), one pack (its CTAs' spans start on an even pack) and two
    packs (an odd pack), at a length that ends mid-CTA and mid-pack:
    equal to the plain version's slice (noisy: within tolerance)."""
    kernel = genkernel.K8 if channel == ChannelIn.FP32 else genkernel.K7
    sigma = 0.0 if math.isinf(snr_db) else 10.0 ** (-snr_db / 5.0)
    base = packs * _quantum(channel)
    bits, got = _generate(kernel, channel, sigma, base, gpu)
    want_bits, want = _generate(kernel, channel, sigma, base, "cpu")
    assert torch.equal(bits.cpu(), want_bits)
    assert got.shape == want.shape
    if math.isinf(snr_db):
        assert torch.equal(got.cpu(), want)
    else:
        _assert_generated_close(channel, got, want)


@pytest.mark.parametrize("channel", list(ChannelIn), ids=lambda c: c.name)
@pytest.mark.parametrize("snr_db", [math.inf, 3.0])
def test_generator_matches_first_design(gpu, channel, snr_db):
    """The pack-table design against K7_OLD / K8_OLD, the first design, on
    the card from base 0 and two packs: bit packs and noiseless streams
    equal, noisy streams within the plain version's tolerance.  The first
    design's wrappers count their own launches."""
    new, old = ((genkernel.K8, genkernel.K8_OLD)
                if channel == ChannelIn.FP32 else
                (genkernel.K7, genkernel.K7_OLD))
    sigma = 0.0 if math.isinf(snr_db) else 10.0 ** (-snr_db / 5.0)
    for base in (0, 2 * _quantum(channel)):
        before = (new.launches, old.launches)
        bits, got = _generate(new, channel, sigma, base, gpu)
        old_bits, want = _generate(old, channel, sigma, base, gpu)
        torch.cuda.synchronize()
        assert (new.launches, old.launches) == (before[0] + 1, before[1] + 1)
        assert torch.equal(bits, old_bits)
        if math.isinf(snr_db):
            assert torch.equal(got, want)
        else:
            _assert_generated_close(channel, got, want)


@pytest.mark.parametrize("generator", ["cuda", "torch"])
@pytest.mark.parametrize("cfg,survivor", [
    (DecoderConfig(ChannelIn.SOFT8), "auto"),
    (DecoderConfig(ChannelIn.FP32, decode_out=DecodeOut.O_B16), "auto"),
    (DecoderConfig(ChannelIn.HARD), "window")], ids=["SOFT8", "FP32-b16",
                                                     "HARD-window"])
def test_simulation_on_gpu_ben0(gpu, generator, cfg, survivor):
    """The in-graph simulation on the card: BEN 0 without noise, launching
    K7/K8 for generator 'cuda' (none for 'torch') and the decode kernel."""
    gen_kernel = genkernel.K8 if cfg.channel_in == ChannelIn.FP32 \
        else genkernel.K7
    dec_kernel = core_cuda.kernel_for(cfg, survivor == "window")
    fn, m = simulate.build_sharded_simulation(
        cfg, 50_000, snr_db=math.inf, generator=generator,
        survivor=survivor, device=gpu)
    before = (gen_kernel.launches, dec_kernel.launches)
    ben = fn(3)
    assert ben.device.type == "cuda" and int(ben) == 0
    assert dec_kernel.launches == before[1] + 1
    assert gen_kernel.launches == before[0] + (generator == "cuda")


def test_k9_probe_finds_the_opt_in_limit(gpu):
    """K9's binary search ends at the CUDA opt-in attribute, which the
    per-kind table holds for this card; every accepted probe counts."""
    optin = hardware.optin_smem_bytes()
    before = hardware.K9.launches
    assert hardware.probe_smem_budget() == optin
    assert hardware.K9.launches - before >= 3
    assert hardware.smem_budget_bytes() == optin


def test_k9_output_and_refusal(gpu):
    """K9 writes its plain version's zeros; a request one byte over the
    limit is refused as cudaErrorInvalidValue, not counted, and leaves no
    stale error for the next launch."""
    optin = hardware.optin_smem_bytes()
    out = torch.full((8, 128), -1, dtype=torch.int32, device=gpu)
    before = hardware.K9.launches
    assert hardware.K9(optin + 1, out) == hardware.CUDA_ERROR_INVALID_VALUE
    assert hardware.K9.launches == before
    assert hardware.K9(optin, out) == 0
    torch.cuda.synchronize()
    assert hardware.K9.launches == before + 1 and not out.any()
    assert hardware.sm_clock_hz() > 1e8


def test_k9_and_its_empty_launch_replay_from_a_graph(gpu):
    """K9's bound, the empty kernel, launches at 48 KB and at the opt-in
    limit and refuses one byte more; K9 and the empty launch, their
    attributes set before capture, replay from a CUDA graph, and K9's
    output stays its plain version's zeros."""
    optin = hardware.optin_smem_bytes()
    out = torch.full((8, 128), -1, dtype=torch.int32, device=gpu)
    for nbytes in (48 * 1024, optin):
        empty = hardware.empty_launcher(nbytes)
        assert empty() == 0 and hardware.K9(nbytes, out) == 0
        ms, _, err = timing.graph_ms(empty, 10, 3)
        assert err == 0 and ms > 0
        ms, _, err = timing.graph_ms(lambda: hardware.K9(nbytes, out), 10,
                                     3)
        assert err == 0 and ms > 0
    torch.cuda.synchronize()
    assert not out.any()
    with pytest.raises(RuntimeError, match="refused"):
        hardware.empty_launcher(optin + 1)


@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
def test_window_gate_refuses_before_launch(gpu, rng, monkeypatch, out):
    """K3, and K4/K5 with window, refuse a ring one byte over the budget
    with a ValueError naming shared memory, before any launch; at the
    budget they launch."""
    cfg = DecoderConfig(ChannelIn.SOFT8, decode_out=out)
    fp32 = DecoderConfig(ChannelIn.FP32, decode_out=out)
    plan = core_torch.plan_blocks(96 * 9 - cfg.bits_per_pack,
                                  cfg.bits_per_pack, 96)
    x = torch.from_numpy(_words(rng, cfg, plan)).to(gpu)
    xf = torch.from_numpy(_words(rng, fp32, plan)).to(gpu)
    wt = core_cuda.stage_words_cuda(x, cfg, plan)
    planes = core_torch.clamp_split(core_cuda.stage_words_cuda(xf, fp32,
                                                               plan), plan)
    ring = core_cuda.ring_bytes(cfg)
    calls = ((core_cuda.K3, lambda: core_cuda.K3(x, cfg, plan)),
             (core_cuda.K4, lambda: core_cuda.K4(wt, cfg, plan, True)),
             (core_cuda.K5, lambda: core_cuda.K5(*planes, fp32, plan, True)))
    for kernel, call in calls:
        monkeypatch.setenv("TPU_VITERBI_SMEM_BUDGET", str(ring - 1))
        before = kernel.launches
        with pytest.raises(ValueError, match="shared memory"):
            call()
        assert kernel.launches == before
        monkeypatch.setenv("TPU_VITERBI_SMEM_BUDGET", str(ring))
        call()
        torch.cuda.synchronize()
        assert kernel.launches == before + 1


def test_auto_keeps_full_store_at_headline(gpu):
    cfg = DecoderConfig(ChannelIn.SOFT8)
    plan = core_torch.plan_blocks(cfg.get_message_len(64_000_000), 32, 2048)
    assert core_cuda.resolve_window("auto", cfg, plan, gpu) is False
    assert ViterbiGPU(cfg).window(64_000_000) is False


@pytest.mark.parametrize("variant", op_cost_probe.VARIANTS)
def test_op_cost_kernel_matches_plain(gpu, variant):
    """K11 on a grid that fills every SM: every tile equals the plain
    version after the same steps; one launch."""
    x = op_cost_probe.probe_input(gpu)
    tiles = op_cost_probe.grid_tiles()
    before = op_cost_probe.K11.launches
    got = op_cost_probe.K11(variant, x, 20, tiles)
    torch.cuda.synchronize()
    assert op_cost_probe.K11.launches == before + 1
    want = op_cost_probe.op_cost_torch(variant, x, 20)
    assert torch.equal(got, want.expand_as(got))
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    assert (tiles * op_cost_probe.TILE_BLOCKS) % sms == 0


def test_op_cost_sass_loops(gpu):
    """Each variant's step loop is found in the library's SASS, with at
    least one instruction a construct pair and the loop's own three."""
    counts = op_cost_probe.sass_loop_counts()
    assert set(counts) == set(op_cost_probe.VARIANTS)
    assert all(n >= op_cost_probe.UNROLL // 2 + 3 for n in counts.values())


def test_canary_and_timing(gpu):
    """K10 at a small shape: K4's packs equal decode_staged_torch on the
    canary's words; canary_ns launches K4 (warm-up and reps) and gives a
    positive time; time_in_graph gives seconds per call."""
    cfg, plan = timing.canary_plan(1, 16)
    words = timing.canary_words(cfg, plan)
    assert torch.equal(core_cuda.K4(words, cfg, plan),
                       core_torch.decode_staged_torch(words, cfg, plan))
    before = core_cuda.K4.launches
    ns = timing.canary_ns(tiles=1, n_packs=16, reps=3)
    assert ns > 0 and core_cuda.K4.launches == before + 4
    assert timing.time_in_graph(lambda t: t * 2, words, runs=3) > 0


# --- the probes' kernels K12-K15 ---

@pytest.mark.parametrize("variant,lanes", [
    (v, n) for v in layout_probe.VARIANTS
    for n in (None,) + layout_probe.variant_lanes(v)])
def test_k12_matches_plain(gpu, variant, lanes):
    """Four tiles at 32, 64 and 96 stages (tails of 2, 4 and 0 stages after
    the lane-split loop's passes), at the lanes the wrapper picks (None)
    and at every lane count the variant is built for: every program equals
    the plain version's; one launch each, counted at its lanes; a refused
    shape raises before any launch."""
    x = layout_probe.probe_input(4, gpu, seed=1)
    K12 = layout_probe.K12
    n = K12.lanes_of(variant, 4 // layout_probe.TILES_A_PROGRAM[variant],
                          lanes)
    before = (K12.launches, K12.lane_launches[n])
    for stages in (32, 64, 96):
        got = K12(variant, x, stages, lanes)
        torch.cuda.synchronize()
        assert torch.equal(got, layout_probe.layout_torch(variant, x, stages))
    assert (K12.launches, K12.lane_launches[n]) == (before[0] + 3,
                                                    before[1] + 3)
    with pytest.raises(ValueError):
        K12(variant, x[:100], 64, lanes)
    with pytest.raises(ValueError):
        K12(variant, x, 40, lanes)
    assert K12.launches == before[0] + 3


@pytest.mark.parametrize("programs", [3, 16])
@pytest.mark.parametrize("lanes", (None,) + soft16_ablation.LANES)
@pytest.mark.parametrize("variant", kernel_ablation.VARIANTS)
def test_k13_matches_plain(gpu, variant, lanes, programs):
    """Three programs and the JAX grid's 16 of 4, 5 and 6 packs (pack ends
    in all three phases of the lane-split pass, tails of 2, 4 and 0
    stages), at the lanes the wrapper picks (None) and split over every
    lane count: output and survivor store equal the plain version's; one
    launch each, counted at its lanes; a refused shape raises before any
    launch."""
    K13 = kernel_ablation.K13
    n = soft16_ablation.lanes_for(programs * 128) if lanes is None else lanes
    for n_packs in (4, 5, 6):
        words = kernel_ablation.probe_input(programs, n_packs, gpu,
                                            seed=2 + n_packs)
        before = (K13.launches, K13.lane_launches[n])
        out, store = K13(variant, words, programs, lanes)
        torch.cuda.synchronize()
        assert (K13.launches, K13.lane_launches[n]) == (before[0] + 1,
                                                        before[1] + 1)
        want, want_store = kernel_ablation.ablation_torch(variant, words,
                                                          programs)
        assert torch.equal(out, want)
        assert (store is None) == (want_store is None)
        if store is not None:
            assert torch.equal(store, want_store)
    with pytest.raises(ValueError):
        K13(variant, words, 7, lanes)
    assert K13.launches == before[0] + 1


@pytest.mark.parametrize("lanes", (None,) + soft16_ablation.LANES)
@pytest.mark.parametrize("variant", acs_variants_bench.VARIANTS)
def test_k14_matches_plain(gpu, variant, lanes):
    """One, two and three packs (32, 64 and 96 stages: tails of 2, 4 and
    0 stages after the lane-split loop's six-stage passes) on 300 arrays
    (a ragged CUDA block), at the lanes the wrapper picks (None) and split
    over every lane count: equal to the plain version; one launch each,
    counted at its lanes; a refused shape raises before any launch."""
    K14 = acs_variants_bench.K14
    n = soft16_ablation.lanes_for(300) if lanes is None else lanes
    before = (K14.launches, K14.lane_launches[n])
    for n_packs in (1, 2, 3):
        rs = acs_variants_bench.probe_input(n_packs, 300, gpu, seed=3)
        got = K14(variant, rs, lanes)
        torch.cuda.synchronize()
        assert torch.equal(got,
                           acs_variants_bench.acs_variants_torch(variant, rs))
    assert (K14.launches, K14.lane_launches[n]) == (before[0] + 3,
                                                    before[1] + 3)
    with pytest.raises(ValueError):
        K14(variant, rs[:, :16].contiguous(), lanes)
    assert K14.launches == before[0] + 3


@pytest.mark.parametrize("occupancy", ilp_probe.OCCUPANCIES)
@pytest.mark.parametrize("chains", ilp_probe.CHAINS)
def test_k15_matches_plain(gpu, chains, occupancy):
    """Each occupancy's grid at 20 steps: every element equals the plain
    value at its tile position; one launch; a refused grid raises before
    any launch."""
    x = ilp_probe.probe_input(gpu)
    blocks, threads = ilp_probe.grid(occupancy)
    K15 = ilp_probe.K15
    before = K15.launches
    got = K15(chains, x, 20, blocks, threads)
    torch.cuda.synchronize()
    assert K15.launches == before + 1
    flat = ilp_probe.ilp_torch(chains, x, 20).reshape(-1)
    idx = torch.arange(got.numel(), device=gpu) % flat.numel()
    assert torch.equal(got, flat[idx])
    with pytest.raises(ValueError):
        K15(chains, x, 20, blocks, 48)
    assert K15.launches == before + 1


def test_probe_sass_readings(gpu):
    """Every kernel of K12-K19 has a stage (step) loop in the library's
    SASS, a register count and an opcode mix that sums to the loop."""
    for mod, keys in ((layout_probe, [
                          (v, n) for v in layout_probe.VARIANTS
                          for n in layout_probe.variant_lanes(v)]),
                      (kernel_ablation, list(itertools.product(
                          kernel_ablation.VARIANTS, soft16_ablation.LANES))),
                      (acs_variants_bench, list(itertools.product(
                          acs_variants_bench.VARIANTS,
                          soft16_ablation.LANES))),
                      (ilp_probe, ilp_probe.CHAINS),
                      (kernel_microbench, list(itertools.product(
                          kernel_microbench.VARIANTS,
                          soft16_ablation.LANES))),
                      (dtype_throughput, dtype_throughput.DTYPES),
                      (swar_probe, list(itertools.product(
                          swar_probe.VARIANTS, soft16_ablation.LANES))),
                      (opt_bench, list(itertools.product(
                          opt_bench.VARIANTS, opt_bench.LTS,
                          soft16_ablation.LANES)))):
        counts = mod.sass_counts()
        assert set(counts) == set(keys)
        for loop, res, mix in counts.values():
            assert loop > 0 and 0 < res["REG"] <= 255
            assert sum(mix.values()) == loop


# --- the ACS-arithmetic probes' kernels K16-K19 ---

@pytest.mark.parametrize("lanes", (None,) + soft16_ablation.LANES)
@pytest.mark.parametrize("width", [kernel_microbench.N_TILES * 128,
                                   kernel_microbench.HEADLINE_TILES * 128])
@pytest.mark.parametrize("variant", kernel_microbench.VARIANTS)
def test_k16_matches_plain(gpu, variant, width, lanes):
    """One, two and three packs (32, 64 and 96 stages: tails of 2, 4 and
    0 stages after the lane-split loop's six-stage passes) at the JAX width
    (2048 arrays) and at 15,872, at the lanes the wrapper picks (None) and
    split over every lane count: equal to the plain version; one launch
    each, counted at its lanes; a refused shape raises before any
    launch."""
    K16 = kernel_microbench.K16
    n = soft16_ablation.lanes_for(width) if lanes is None else lanes
    before = (K16.launches, K16.lane_launches[n])
    for n_packs in (1, 2, 3):
        rs = kernel_microbench.probe_input(n_packs, width, gpu, seed=6)
        got = K16(variant, rs, lanes)
        torch.cuda.synchronize()
        assert torch.equal(got,
                           kernel_microbench.microbench_torch(variant, rs))
    assert (K16.launches, K16.lane_launches[n]) == (before[0] + 3,
                                                    before[1] + 3)
    with pytest.raises(ValueError):
        K16(variant, rs[:, :16].contiguous(), lanes)
    assert K16.launches == before[0] + 3


@pytest.mark.parametrize("occupancy", dtype_throughput.OCCUPANCIES)
@pytest.mark.parametrize("dtype", dtype_throughput.DTYPES)
def test_k17_matches_plain(gpu, dtype, occupancy):
    """Each occupancy's grid (the JAX tile, the SM's 2048 threads) at 20
    steps on the probe's tile and at 3 steps on values near +-16,000:
    every element equals the plain value at its tile position; one launch
    each; a refused grid raises before any launch."""
    dt = dtype_throughput
    wide = torch.from_numpy(np.random.default_rng(7).integers(
        -16000, 16001, (32, 128)).astype(np.int32)).to(gpu)
    blocks, threads = dt.grid(dtype, occupancy)
    K17 = dt.K17
    before = K17.launches
    for x, steps in ((dt.probe_input(gpu), 20), (wide, 3)):
        got = K17(dtype, x, steps, blocks, threads)
        torch.cuda.synchronize()
        flat = dt.dtype_torch(dtype, x, steps).reshape(-1)
        idx = torch.arange(got.numel(), device=gpu) % flat.numel()
        assert torch.equal(got, flat[idx])
    assert K17.launches == before + 2
    with pytest.raises(ValueError):
        K17(dtype, wide, 3, blocks, 48)
    assert K17.launches == before + 2


@pytest.mark.parametrize("lanes", (None,) + soft16_ablation.LANES)
@pytest.mark.parametrize("programs", [swar_probe.GRID,
                                      swar_probe.HEADLINE_TILES])
@pytest.mark.parametrize("variant", swar_probe.VARIANTS)
def test_k18_matches_plain(gpu, variant, programs, lanes):
    """64 stages on every program of the JAX grid (2048 arrays) and of
    15,872 arrays, at the lanes the wrapper picks (None) and split over
    every lane count: equal to the plain version; one launch, counted at
    its lanes; a refused stage count raises before any launch."""
    x = swar_probe.probe_input(variant, programs, gpu, seed=8)
    K18 = swar_probe.K18
    n = soft16_ablation.lanes_for(programs * 128) if lanes is None else lanes
    before = (K18.launches, K18.lane_launches[n])
    got = K18(variant, x, 64, lanes)
    torch.cuda.synchronize()
    assert (K18.launches, K18.lane_launches[n]) == (before[0] + 1,
                                                    before[1] + 1)
    assert torch.equal(got, swar_probe.swar_torch(variant, x, 64))
    with pytest.raises(ValueError):
        K18(variant, x, 62, lanes)
    assert K18.launches == before[0] + 1


@pytest.mark.parametrize("lanes", (None,) + soft16_ablation.LANES)
@pytest.mark.parametrize("width", [opt_bench.LANES,
                                   opt_bench.HEADLINE_ARRAYS, 300])
@pytest.mark.parametrize("variant", opt_bench.VARIANTS)
def test_k19_matches_plain(gpu, variant, width, lanes):
    """One, two and three packs (the output rows mapped back from phases 2,
    4 and 0 of the lane-split pass) at the JAX width (4096 arrays), at
    15,872 and at 300 (a ragged block), at every lt, at the lanes the
    wrapper picks (None) and split over every lane count: equal to the
    plain version; one launch each, counted at its lanes; a refused lt
    raises before any launch."""
    K19 = opt_bench.K19
    n = soft16_ablation.lanes_for(width) if lanes is None else lanes
    for n_packs in (1, 2, 3):
        rs = opt_bench.probe_input(n_packs, width, gpu, seed=9 + n_packs)
        want = opt_bench.opt_bench_torch(variant, rs)
        before = (K19.launches, K19.lane_launches[n])
        for lt in opt_bench.LTS:
            got = K19(variant, rs, lt, lanes)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        assert (K19.launches, K19.lane_launches[n]) == (
            before[0] + len(opt_bench.LTS), before[1] + len(opt_bench.LTS))
    with pytest.raises(ValueError):
        K19(variant, rs, 64, lanes)
    assert K19.launches == before[0] + len(opt_bench.LTS)


@pytest.mark.parametrize("mod", [kernel_microbench, dtype_throughput,
                                 swar_probe, opt_bench],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_acs_probe_entry_points(gpu, mod):
    """`python -m tpu_viterbi_torch.scripts.<probe>`'s main() runs every
    variant on the card and returns 0."""
    assert mod.main([]) == 0


@pytest.mark.parametrize("rounds", genkernel_probe.ROUNDS_LIST)
def test_k20_matches_plain(gpu, rounds):
    """tf on the parity input and many at reps 4 and 8 on an 8 x 256-row
    grid (c0 near 2^31, so c0 + r wraps) and on 7,469 counter pairs
    bit-equal to their plain versions;
    log_sqrt within 2 ulp of the larger term of torch's; one launch each;
    the known answers at 20 rounds."""
    gp, K20 = genkernel_probe, genkernel_probe.K20
    c = gp.tf_input(gpu)
    before = K20.launches
    got = K20.tf(c, *gp.KEY, rounds=rounds)
    want = gp.tf_torch(c, *gp.KEY, rounds=rounds)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    m = gp.many_input(gpu, g=8)
    m[0] += 2 ** 31 - 300
    # 7,469 counter pairs: not a whole number of CUDA blocks or waves
    odd = gp.many_input(gpu, g=1, rb=97)[:, :, :77].contiguous()
    for counters in (m, odd):
        for reps in gp.REPS_LIST:
            assert torch.equal(
                K20.many(counters, *gp.MANY_KEY, reps, rounds),
                gp.many_torch(counters, *gp.MANY_KEY, reps, rounds))
    x = gp.log_input(gpu)
    assert gp.term_ulps(K20.log_sqrt(x), gp.log_sqrt_torch(x), x) <= 2
    assert K20.launches == before + 2 + 2 * len(gp.REPS_LIST)
    res = gp.parity(gpu)
    assert res["tf_ok"] and res["known_ok"]


@pytest.mark.parametrize("dec_len", [64, 96, 128, 2048, 8192])
def test_k23_matches_plain(gpu, dec_len):
    """K23 on random full-range SOFT8 words pre-padded to ``need`` (blocks
    past the plan decode the stream's words there): at every lane count
    (the split a cluster a tile, its halo through distributed shared
    memory) bit-equal to the plain roll decode over every block of every
    tile, tails of 2, 4 and 0 stages after the split's six-stage passes at
    dec_len 64, 96 and 128; one launch each."""
    sc = staging_cost
    cfg = sc.CFG
    plan = core_torch.plan_blocks(dec_len * 300 - 32, 32, dec_len)
    gen = torch.Generator(device=gpu)
    gen.manual_seed(dec_len)
    xp = torch.randint(-2 ** 31, 2 ** 31, (sc.need_words(cfg, plan),),
                       generator=gen, device=gpu,
                       dtype=torch.int64).to(torch.int32)
    want = sc.roll_decode_torch(xp, cfg, plan)
    for lanes in soft16_ablation.LANES:
        before = sc.K23.launches
        got = sc.K23(xp, cfg, plan, lanes)
        torch.cuda.synchronize()
        assert sc.K23.launches == before + 1
        assert got.shape == (sc.padded_blocks(plan), dec_len // 32)
        assert torch.equal(got, want), lanes


@pytest.mark.parametrize("mod,argv", [
    (genkernel_probe, []), (bench_profile, ["2000000", "2048"]),
    (bench_split, ["2000000"]), (staging_cost, ["2000000"]),
    (soft16_pieces, ["2000000"])],
    ids=lambda p: p.__name__.rsplit(".", 1)[1] if hasattr(p, "__name__")
    else " ".join(p))
def test_split_probe_entry_points(gpu, mod, argv):
    """`python -m tpu_viterbi_torch.scripts.<probe>`'s main() runs on the
    card (the decode probes at 2M bits) and returns 0."""
    assert mod.main(argv) == 0


# --- K1's u/d reader and the last probes' kernels K25, K26, K28 ---

@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("dec_len", [32, 96, 2048])
@pytest.mark.parametrize("window", [False, True])
def test_ud_words_match_plain(gpu, rng, out, dec_len, window):
    """K1 (K3 with the window) on the u/d words of a wire with NaN and
    +-inf: equal to decode_ud_words_torch on the same words, one launch;
    and, with the NaNs taken out, equal to K2 (K3) on the wire."""
    cfg = DecoderConfig(ChannelIn.FP32, decode_out=out)
    bpp = cfg.bits_per_pack
    plan = core_torch.plan_blocks(dec_len * 300 - bpp, bpp, dec_len)
    x = torch.from_numpy(_words(rng, cfg, plan)).to(gpu)
    udw = core_torch.fp32_ud_words_torch(x)
    kernel = core_cuda.K3 if window else core_cuda.K1
    before = kernel.launches
    got = core_cuda.decode_ud_words_cuda(udw, cfg, plan, window)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = core_torch.assemble_output(core_torch.decode_ud_words_torch(
        udw, cfg, plan, window), cfg, plan)
    assert torch.equal(got, want)
    x = torch.nan_to_num(x, nan=0.0, posinf=float("inf"),
                         neginf=float("-inf"))
    assert torch.equal(
        core_cuda.decode_ud_words_cuda(core_torch.fp32_ud_words_torch(x),
                                       cfg, plan, window),
        core_cuda.decode_packed_cuda(x, cfg, plan, window=window))


def test_fp32_probe_check(gpu):
    """K27's check at 200,000 bits: the u/d route equals K2 (full store,
    2048) and K3 (window, 4096) on the JAX script's wire."""
    assert fp32_fused_value_probe.check(200_000, gpu) == {"full": True,
                                                          "window": True}


@pytest.mark.parametrize("programs", [1, 3, 16, 124])
@pytest.mark.parametrize("lanes", (None,) + soft16_ablation.LANES)
@pytest.mark.parametrize("variant", soft16_ablation.VARIANTS)
def test_k25_matches_plain(gpu, variant, lanes, programs):
    """Every variant at the lanes the wrapper picks (None) and split over
    every lane count, at 1, 3, 16 (the JAX grid) and 124 programs and 1, 3
    and 4 packs (tails of 2, 0 and 2 stages after the passes of 6), equal
    to the plain version on full-range words; one launch each, counted at
    its lanes; a refused shape raises before any launch."""
    sa = soft16_ablation
    n = sa.lanes_for(programs * 128) if lanes is None else lanes
    for n_packs in (1, 3, 4):
        words = sa.probe_input(programs, n_packs, sa.WPP[variant], gpu,
                               seed=programs + n_packs)
        before = (sa.K25.launches, sa.K25.lane_launches[n])
        got = sa.K25(variant, words, programs, lanes)
        torch.cuda.synchronize()
        assert (sa.K25.launches, sa.K25.lane_launches[n]) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(got, sa.soft16_ablation_torch(variant, words,
                                                         programs))
    with pytest.raises(ValueError):
        sa.K25(variant, words[:, :8].contiguous(), programs, lanes)
    assert sa.K25.launches == before[0] + 1


@pytest.mark.parametrize("shape", [(96, 80), (15744 // 8, 1056), (33, 130),
                                   (1, 1), (64, 102), (36, 132),
                                   "misaligned"])
def test_k26_matches_plain(gpu, shape):
    """Every tiling's transpose equals x.t() (ragged tiles included) on the
    route K26.route picks, each launch counted on it: bulk where rows and
    cols are multiples of 4 and the base 16-byte aligned, element on the
    rest (a pitch off 4 words, a base off 16 bytes); a bulk launch on a
    shape it cannot take is refused.  The consumer equals its plain version
    and torch's sum; one launch each."""
    tb = transpose_bench
    if shape == "misaligned":
        x = tb.probe_input(gpu, 1, 96 * 80 + 1, seed=26).view(-1)[1:] \
            .view(96, 80)
    else:
        x = tb.probe_input(gpu, *shape, seed=26)
    rows, cols = x.shape
    bulk = rows % 4 == 0 and cols % 4 == 0 and x.data_ptr() % 16 == 0
    before = tb.K26.launches
    for tiling in tb.TILINGS:
        route = tb.K26.route(tiling, x)
        assert route == ("bulk" if bulk else "element")
        n_route = tb.K26.route_launches[route]
        assert torch.equal(tb.K26.transpose(tiling, x), x.t())
        assert tb.K26.route_launches[route] == n_route + 1
    n = len(tb.TILINGS)
    if not bulk:
        out = torch.empty((cols, rows), dtype=torch.int32, device=gpu)
        with pytest.raises(RuntimeError, match="K26 launch failed"):
            tb.K26.launch(x.device, 0, tb.ROUTES.index("bulk"),
                          x.data_ptr(), out.data_ptr(), rows, cols)
    if rows >= tb.SUM_COLS and shape != "misaligned":
        t = x.t().contiguous()
        got = tb.K26.consume(t)
        assert torch.equal(got, tb.consume_torch(t))
        assert torch.equal(got, t[:, :128].sum(0, dtype=torch.int32))
        n += 1
    torch.cuda.synchronize()
    assert tb.K26.launches == before + n


def test_k26_consume_writes_reused_memory(gpu):
    """The consumer writes its 128 sums, one launch and no zeroing: on the
    block a freed tensor of junk left in the caching allocator it still
    equals its plain version and torch's sum."""
    tb = transpose_bench
    t = tb.probe_input(gpu, 1056, 15744 // 4, seed=27)
    want = tb.consume_torch(t)
    for _ in range(3):
        junk = torch.full((tb.SUM_COLS,), -1, dtype=torch.int32, device=gpu)
        del junk
        got, n = _launched([tb.K26], lambda: tb.K26.consume(t))
        assert n == [1] and torch.equal(got, want)
        assert torch.equal(got, t[:, :tb.SUM_COLS].sum(0, dtype=torch.int32))


def test_graph_ms_replays_k26_consume(gpu):
    """timing.graph_ms captures the consumer's calls into one CUDA graph
    (each wrapper call counted once, at capture) and replays them: a
    positive time a call and the right sums."""
    tb = transpose_bench
    t = tb.probe_input(gpu, 1056, 256, seed=28)
    before = tb.K26.launches
    ms, all_ms, got = timing.graph_ms(lambda: tb.K26.consume(t), 10, 3)
    assert tb.K26.launches == before + 10
    assert ms > 0 and len(all_ms) == 3
    assert torch.equal(got, tb.consume_torch(t))


def test_graph_ms_replays_k26_tiling_and_k20_many(gpu):
    """timing.graph_ms captures K26's bulk 32x32 transpose and K20's many
    into CUDA graphs, each wrapper call counted once, at capture (K26's on
    its route), and replays them: positive times and the right results."""
    tb, gp = transpose_bench, genkernel_probe
    x = tb.probe_input(gpu, 1968, 1056, seed=29)
    before = (tb.K26.launches, tb.K26.route_launches["bulk"])
    ms, all_ms, got = timing.graph_ms(lambda: tb.K26.transpose("32x32", x),
                                      5, 2)
    assert (tb.K26.launches, tb.K26.route_launches["bulk"]) == (
        before[0] + 5, before[1] + 5)
    assert ms > 0 and len(all_ms) == 2 and torch.equal(got, x.t())
    c = gp.many_input(gpu, g=2)
    before = gp.K20.launches
    ms, all_ms, got = timing.graph_ms(
        lambda: gp.K20.many(c, *gp.MANY_KEY, 4, gp.GEN_ROUNDS), 5, 2)
    assert gp.K20.launches == before + 5
    assert ms > 0 and len(all_ms) == 2
    assert torch.equal(got, gp.many_torch(c, *gp.MANY_KEY, 4,
                                          gp.GEN_ROUNDS))


@pytest.mark.parametrize("reps", range(14))
@pytest.mark.parametrize("variant", interleave_bench.VARIANTS)
def test_k28_matches_plain(gpu, variant, reps):
    """Two tiles and a ragged 200 columns, reps 0-13 (two passes of the
    shuffle's order 6 and every tail), at every lane count the variant is
    built for: equal to the plain version; one launch each; the script's
    check."""
    ib = interleave_bench
    counts = ib.variant_lanes(variant)
    before = ib.K28.launches
    for x in (ib.probe_input(2, gpu, seed=reps), ib.probe_input(
            2, gpu, seed=reps)[:, :200].contiguous()):
        want = ib.interleave_torch(variant, x, reps)
        for lanes in counts:
            assert torch.equal(ib.K28(variant, x, reps, lanes=lanes),
                               want), lanes
    torch.cuda.synchronize()
    assert ib.K28.launches == before + 2 * len(counts)
    assert ib.check_correct(variant, gpu) == (variant != "concat")


def test_last_probe_sass_readings(gpu):
    """K25's and K28's loops, K11's relayouts and K13's bisect are in the
    library's SASS; a relayout's step loop holds a SHFL a construct.
    K25's, K13's, K19's, K12's (A, B and C), K18's swar, K14's forward and
    K16's trellis (bcast, no_pp) lane-split loops shuffle (L = 1 does not;
    K18's baseline, K16's fixed-partner variants and K14's chase loop
    never do), and no branch splits their warps around the shuffles; B
    spills at neither of its picks (32 and 16 lanes); swar/stage's repack
    is two shuffles a word."""
    sa = soft16_ablation
    k12, k18 = layout_probe.sass_counts(), swar_probe.sass_counts()
    no_shfl = ("baseline", "no_acs", "concat", "pltpu_repeat", "bit_tb")
    for table in (sa.sass_counts(), kernel_ablation.sass_counts(),
                  opt_bench.sass_counts(), k12, k18,
                  acs_variants_bench.sass_counts(),
                  kernel_microbench.sass_counts()):
        for key, (loop, res, mix) in table.items():
            split = key[-1] > 1 and key[0] not in no_shfl
            assert (sa.shfl_count(mix) > 0) == split, key
            assert not any("DIV" in op or "COLLECTIVE" in op for op in mix)
    for n in (16, 32):
        assert k12["dual", n][1]["STACK"] == 0, n
    for n in sa.LANES[1:]:
        assert sa.shfl_count(k18["swar/stage", n][2]) == \
            2 * 32 // n * swar_probe.SPLIT_LOOP_STAGES, n
    ib = interleave_bench
    for mod, keys in ((sa, list(itertools.product(sa.VARIANTS, sa.LANES))),
                      (ib, [(v, n) for v in ib.VARIANTS
                            for n in ib.variant_lanes(v)]),
                      (staging_cost, list(sa.LANES)),
                      (kernel_ablation, list(itertools.product(
                          kernel_ablation.VARIANTS, sa.LANES)))):
        counts = mod.sass_counts()
        assert set(counts) == set(keys)
        for loop, res, mix in counts.values():
            assert loop > 0 and 0 < res["REG"] <= 255
    for key, (loop, res, mix) in ib.sass_counts().items():
        assert (sa.shfl_count(mix) > 0) == (key[0] == "shfl"), key
    for n, (loop, res, mix) in staging_cost.sass_counts().items():
        assert (sa.shfl_count(mix) > 0) == (n > 1), n
        assert not any("DIV" in op for op in mix), n
    counts = op_cost_probe.sass_loop_counts()
    assert set(counts) == set(op_cost_probe.VARIANTS)


@pytest.mark.parametrize("mod,argv", [
    (soft16_ablation, ["s8/unpack"]), (kernel_ablation, ["+dump"]),
    (transpose_bench, []),
    (fp32_fused_value_probe, ["2000000"]), (interleave_bench, ["shfl"])],
    ids=lambda p: p.__name__.rsplit(".", 1)[1] if hasattr(p, "__name__")
    else " ".join(p))
def test_last_probe_entry_points(gpu, mod, argv):
    """`python -m tpu_viterbi_torch.scripts.<probe>`'s main() runs on the
    card and returns 0."""
    assert mod.main(argv) == 0


@pytest.mark.parametrize("channel", [ChannelIn.HARD, ChannelIn.SOFT4,
                                     ChannelIn.SOFT8, ChannelIn.SOFT16],
                         ids=lambda c: c.name)
@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=lambda o: o.name)
@pytest.mark.parametrize("window", [False, True], ids=["full", "window"])
def test_tail_halo_matches_plain(gpu, rng, channel, out, window):
    """K1 (K3 with the window) reading a tail halo in place: equal to its
    plain version with the halo, and to the same kernel on the stream with
    the halo appended; a ragged stream too; the launch counts once in
    ``launches`` and once in ``halo_launches``."""
    cfg = DecoderConfig(channel, decode_out=out)
    kernel = core_cuda.kernel_for(cfg, window)
    for dec_len, ragged in ((64, 0), (256, 5)):
        plan = core_torch.plan_blocks(dec_len * 40, cfg.bits_per_pack,
                                      dec_len)
        wpb, wph = core_torch.words_per_block(cfg, plan)
        x = torch.from_numpy(_words(rng, cfg, plan)).to(gpu)
        words = x[: plan.num_blocks * wpb - ragged].contiguous()
        halo = x[words.shape[0]: words.shape[0] + wph].contiguous()
        before = (kernel.launches, kernel.halo_launches)
        got = kernel(words, cfg, plan, tail_halo=halo)
        torch.cuda.synchronize()
        assert (kernel.launches, kernel.halo_launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(got, core_torch.decode_blocks_torch(
            words, cfg, plan, window, tail_halo=halo))
        assert torch.equal(got, kernel(torch.cat([words, halo]), cfg, plan))


@pytest.mark.parametrize("channel", list(ChannelIn), ids=lambda c: c.name)
def test_sharded_generator_on_gpu(gpu, channel):
    """K7/K8 at every rank's base offset: the slabs, concatenated, are the
    one-rank stream, zero past its end."""
    n = 300_001
    bits, words = genkernel.packed_workload_cuda(3, n, channel, 1.0, 4.0,
                                                 gpu)
    mesh = BlockMesh(0, 3, gpu)
    slabs = [genkernel.packed_workload_cuda_sharded(3, n, channel, 1.0, 4.0,
                                                    mesh, rank=r)
             for r in range(3)]
    for i, whole in ((0, bits), (1, words)):
        cat = torch.cat([s[i] for s in slabs])
        assert torch.equal(cat[: whole.shape[0]], whole)
        assert not cat[whole.shape[0]:].any()


@pytest.mark.parametrize("cfg", [DecoderConfig(ChannelIn.SOFT8),
                                 DecoderConfig(ChannelIn.FP32),
                                 DecoderConfig(ChannelIn.HARD,
                                               decode_out=DecodeOut.O_B16)],
                         ids=["SOFT8", "FP32", "HARD-b16"])
def test_split_ranks_on_gpu(gpu, cfg):
    """The split's ranks held in one process on the card: every rank's
    decode (K1/K3 with the tail halo, K2 on FP32) equals the plain
    version's ranks, and the noiseless simulation counts 0."""
    n = 200_000
    _, packed = coded_workload(n, 0.6, 4, cfg.channel_in,
                               simulate.DEFAULT_SCALES[cfg.channel_in])
    for ranks in (1, 2):
        got, m = blocks.decode_all_ranks(packed, 2 * n, cfg, ranks, gpu, 512)
        want, _ = blocks.decode_all_ranks(packed, 2 * n, cfg, ranks, gpu,
                                          512, backend="torch")
        assert np.array_equal(got, want)
        s = simulate.ShardedSimulation(cfg, n, BlockMesh(0, ranks, gpu),
                                       snr_db=math.inf, dec_len=512,
                                       generator="cuda")
        assert int(s.all_ranks(2)[0]) == 0


@pytest.mark.parametrize("name", list(ber_deep_tail.CASES))
def test_ber_deep_tail_row_kernels_equal_plain_on_gpu(gpu, name):
    """One 32M-bit call of the row at its first seed, on JAX's survivor
    plan: the simulation's decoded words and BEN (K7/K8, then K1, K2 or K3)
    equal the plain decode's of the same generated words on the card."""
    r = ber_deep_tail.row_against_plain(name, gpu)
    gen = genkernel.kernel_for(r.cfg.channel_in).name
    dec = core_cuda.kernel_for(r.cfg, r.window).name
    assert r.launches == {gen: 1, dec: 1}
    assert torch.equal(r.got, r.want)
    assert r.ben == r.plain_ben > 0


def test_fuzz_gpu_trials_on_gpu(gpu, capsys):
    """A few of the fuzz script's trials: K1/K2 equal to the plain core on
    random words, K3 equal to the full store on coded streams."""
    before = core_cuda.K3.launches
    assert fuzz_gpu.run(6, 5000, 4, gpu) == (10, 10)
    assert core_cuda.K3.launches - before == 4
    assert all(line.endswith("-> OK")
               for line in capsys.readouterr().out.splitlines())


def test_check_gen_ber_on_gpu(gpu, monkeypatch):
    """K7 against the element chain at 0 dB, 4M bits: the 25 % rule."""
    monkeypatch.setattr(check_gen_ber, "SNRS", (0.0,))
    before = genkernel.K7.launches
    rows, ok = check_gen_ber.run(gpu, call_bits=4_000_000)
    assert ok and genkernel.K7.launches == before + 1
    assert [r["kernels"] for r in rows] == ["K7 x1 + K1 x1", "K1 x1"]


def test_profile_trace_holds_k7_and_k1_on_gpu(gpu, tmp_path, capsys):
    """--e2e-device --profile on the card: the trace holds K7's and K1's
    launches, as ranges under their names and as device kernels."""
    d = tmp_path / "trace"
    assert cli.main(["-n", "1000000", "-s", "5.5", "-i", "s8", "--seed", "7",
                     "--e2e-device", "--profile", str(d)]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == \
        "Final results -> BEN: 0   BER: 0"
    (path,) = d.glob("*.pt.trace.json")
    s = profile.summarize(path)
    assert s["annotations"]["K7"] == s["annotations"]["K1"] == 1
    names = " ".join(s["kernel_ms"])
    assert "gen_words_kernel" in names and "viterbi_kernel" in names
    assert 0 < s["busy_share"] < 1


def test_decode_kernel_launch_lies_in_api_launch_on_gpu(gpu, rng,
                                                        tmp_path):
    """Traced run_on_device calls on the card: every decode kernel carries
    the ``correlation`` of a runtime launch call, and that call starts
    inside the call's ``api.launch`` range."""
    cfg = DecoderConfig(ChannelIn.SOFT8)
    input_num = 2 * 1_000_000
    dec = ViterbiGPU(cfg, input_num=input_num)
    x = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, size=cfg.get_input_words(input_num),
        dtype=np.int64).astype(np.int32)).to(gpu)
    dec.run_on_device(x, input_num)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            dec.run_on_device(x, input_num)
    path = tmp_path / "run.pt.trace.json"
    prof.export_chrome_trace(str(path))
    events = profile.load_events(path)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e["name"] == "api.launch"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and profile.short_name(e["name"]).endswith("viterbi_kernel")]
    assert len(kernels) == len(ranges) == 3
    for k in kernels:
        start = launches[k["args"]["correlation"]]["ts"]
        assert sum(lo <= start <= hi for lo, hi in ranges) == 1


# --- the timing sweeps -------------------------------------------------------

def _launches():
    return {k.name: k.launches for k in (core_cuda.K1, core_cuda.K2,
                                         genkernel.K7, genkernel.K8)}


def _launched_since(before):
    """{kernel name: launches} added since the ``_launches()`` count
    ``before``, the kernels that launched."""
    torch.cuda.synchronize()
    return {k: n - before[k] for k, n in _launches().items()
            if n > before[k]}


def test_channel_throughput_rows_on_gpu(gpu):
    """Every format at every candidate dec_len at 100,000 bits: each first
    call equal to the plain decode, every row timed, a decode call one
    launch of K1 (K2 on FP32), six workloads a format from K7 (K8)."""
    before = _launches()
    rows = channel_throughput.run(100_000, gpu, log=lambda msg: None)
    assert [r["channel"] for r in rows] == [
        c for c in channel_throughput.CHANNELS for _ in range(4)]
    assert sum(r["jax_pick"] for r in rows) == 5
    assert all(r["kernel_seconds"] > 0 and r["decode_check_seconds"] > 0
               and 0 < r["share_of_bound"] < 1 for r in rows)
    n = channel_throughput.N_INPUTS
    assert _launched_since(before) == {
        "K1": sum(r["calls"] for r in rows if r["kernel"] == "K1"),
        "K2": sum(r["calls"] for r in rows if r["kernel"] == "K2"),
        "K7": 4 * n, "K8": n}


def test_small_msg_sweep_rows_on_gpu(gpu):
    """99,968 bits at JAX's candidates and the card's short blocks:
    queued times, a graph capture and replay on every row, one fastest
    row (by graph time), a launch a decode call."""
    before = _launches()
    rows = small_msg_sweep.run(99_968, gpu, log=lambda msg: None)
    assert [(r["dec_len"], r["card_only"]) for r in rows] == [
        (8192, False), (4096, False), (2048, False), (1024, False),
        (512, False), (800, False), (256, True), (128, True), (64, True)]
    assert all(r["decode_seconds"] or r["slope_nonpositive"] for r in rows)
    assert all(r["graph_seconds"] > 0 and "graph_error" not in r
               for r in rows)
    best = [r for r in rows if r["fastest"]]
    assert len(best) == 1 and best[0]["graph_seconds"] == min(
        r["graph_seconds"] for r in rows)
    assert _launched_since(before) == {"K1": sum(r["calls"] for r in rows)}


def test_scaling_curve_rows_on_gpu(gpu):
    """Two sizes at both policies; queued_s on the card."""
    before = _launches()
    rows = scaling_curve.run(249_984, gpu, log=lambda msg: None)
    assert [(r["message_len"], r["dec_len_policy"], r["dec_len"])
            for r in rows] == scaling_curve.row_table([99_968, 249_984])
    assert all(r["decode_seconds"] > 0 and r["graph_seconds"] > 0
               for r in rows)
    assert sum(r["fastest"] for r in rows) == 2
    assert _launched_since(before) == {"K1": sum(r["calls"] for r in rows)}
    xs = [torch.full((1 << 20,), i, device=gpu) for i in range(4)]
    assert timing.queued_s(lambda x: x * 2, xs, 16) > 0


@pytest.mark.parametrize("spec", ber_curve.CONFIGS.split(","))
def test_ber_curve_point_equals_plain_on_gpu(gpu, spec):
    """A curve point at 200,000 bits on the card: one launch of K1 (K2 on
    FP32) through ViterbiGPU.run, its words equal to the plain decode of
    the same packed words on the card; run_point counts them, and b16
    counts b32's BEN."""
    cfg = ber_curve.spec_config(spec)
    n = 200_000
    bits, noisy = ber_curve.draw(n, 0.5, 123, gpu)
    dec = ViterbiGPU(cfg, dec_len=ber_curve.DEC_LEN, device=gpu)
    before = _launches()
    packed, out, seconds = ber_curve.decode_values(cfg, noisy, dec)
    kernel = "K2" if cfg.channel_in == ChannelIn.FP32 else "K1"
    assert _launched_since(before) == {kernel: 1} and seconds > 0
    plain, _ = ViterbiGPU(cfg, dec_len=ber_curve.DEC_LEN, backend="torch",
                          device=gpu).run(packed, 2 * n)
    np.testing.assert_array_equal(out, plain)
    ben, m = ber_curve.run_point(cfg, n, 0.5, 123, gpu, dec)
    assert (ben, m) == (ber_curve.errors(out, cfg, bits.cpu().numpy()),
                        cfg.get_message_len(2 * n))
    assert 0 < ben < m // 4
    if spec.endswith("/b16"):
        b32 = ber_curve.spec_config(spec.replace("b16", "b32"))
        assert ber_curve.run_point(b32, n, 0.5, 123, gpu) == (ben, m)
