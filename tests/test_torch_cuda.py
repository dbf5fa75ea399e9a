"""Kernels K1, K2 and K3 on the card against their plain PyTorch version,
and ViterbiGPU's CUDA path (run, run_stream, streaming).  Every test here needs a CUDA GPU and skips without one; the
file imports no jax, so it runs on a machine that has only the port's
dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from tpu_viterbi_torch import ConfigResolutionError, ViterbiGPU
from tpu_viterbi_torch.config import ChannelIn, DecodeOut, DecoderConfig
from tpu_viterbi_torch.decoder import core_cuda, core_torch
from tpu_viterbi_torch.decoder.streaming import StreamingViterbi

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
