"""Kernels K1, K2 and K3 on the card against their plain PyTorch version,
and ViterbiGPU's CUDA path (run, run_stream, streaming); the generator
kernels K7 and K8 against theirs, and the in-graph simulation on the card.
Every test here needs a CUDA GPU and skips without one; the
file imports no jax, so it runs on a machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import math

import numpy as np
import pytest
import torch

from tpu_viterbi_torch import ConfigResolutionError, ViterbiGPU
from tpu_viterbi_torch.chain import genkernel
from tpu_viterbi_torch.chain.quantize import unpack_to_soft
from tpu_viterbi_torch.config import ChannelIn, DecodeOut, DecoderConfig
from tpu_viterbi_torch.decoder import core_cuda, core_torch
from tpu_viterbi_torch.decoder.streaming import StreamingViterbi
from tpu_viterbi_torch.sharding import simulate

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
