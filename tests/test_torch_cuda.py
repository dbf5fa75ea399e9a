"""Kernel K1 on the card against its plain PyTorch version, and ViterbiGPU's
CUDA path.  Every test here needs a CUDA GPU and skips without one; the
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

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: kernel K1 has no CPU mode")
    return torch.device("cuda")


def _words(rng, cfg, plan):
    n = cfg.get_input_words(2 * (plan.message_len + 64))
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
    cfg = DecoderConfig(ChannelIn.SOFT8)
    input_num = 2 * (9_000 + 64)
    x = rng.integers(-2 ** 31, 2 ** 31,
                     size=cfg.get_input_words(input_num)).astype(np.int32)
    before = core_cuda.K1.launches
    got, seconds = ViterbiGPU(cfg).run(x, input_num)
    assert core_cuda.K1.launches == before + 1 and seconds > 0
    want, _ = ViterbiGPU(cfg, backend="torch", device="cpu").run(x, input_num)
    assert np.array_equal(got, want)
    torch_on_gpu, _ = ViterbiGPU(cfg, backend="torch").run(x, input_num)
    assert np.array_equal(torch_on_gpu, want)
    with pytest.raises(ConfigResolutionError, match="K2"):
        ViterbiGPU(DecoderConfig(ChannelIn.FP32))
    with pytest.raises(ConfigResolutionError, match="K3"):
        ViterbiGPU(cfg, survivor="window")
