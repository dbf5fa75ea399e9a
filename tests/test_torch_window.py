"""The plain windowed survivor (core_torch.window_scan, the plain version of
kernel K3) against the JAX package.  On coded input the windowed decode
equals the full store for every channel and pack width (its chase merges
paths); on random words the two legitimately differ, so there it is held
bit-equal to the Pallas kernel's own window branch in interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_viterbi.chain.encode import conv_encode_np
from tpu_viterbi.chain.quantize import quantize_and_pack
from tpu_viterbi.config import (ChannelIn as JChannelIn,
                                DecodeOut as JDecodeOut,
                                DecoderConfig as JDecoderConfig)
from tpu_viterbi.decoder.core_pallas import (decode_packed_pallas,
                                             survivor_window_slots)
from tpu_viterbi.decoder.core_xla import decode_packed_xla, plan_blocks
from tpu_viterbi.sharding.simulate import DEFAULT_SCALES
from tpu_viterbi_torch import ViterbiGPU
from tpu_viterbi_torch.config import from_reference
from tpu_viterbi_torch.decoder import core_cuda, core_torch

torch.set_num_threads(1)

CHANNELS = [JChannelIn.HARD, JChannelIn.SOFT4, JChannelIn.SOFT8,
            JChannelIn.SOFT16, JChannelIn.FP32]
OUTS = [JDecodeOut.O_B32, JDecodeOut.O_B16]


@pytest.fixture(autouse=True)
def _fresh_compiler_state():
    # keep the CPU XLA compiler's live-executable set small across
    # interpret-mode kernel compiles (tests/test_survivor_window.py)
    import jax
    jax.clear_caches()
    yield


def _coded(n, sigma, channel, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    sym = 2 * conv_encode_np(bits).astype(np.float32) - 1
    if sigma:
        sym = sym + rng.normal(0, sigma, sym.shape).astype(np.float32)
    return np.asarray(quantize_and_pack(jnp.asarray(sym), channel,
                                        DEFAULT_SCALES[channel]))


def _port(x, jcfg, jplan, window):
    cfg = from_reference(jcfg)
    plan = core_torch.plan_from_reference(jplan)
    out = core_torch.decode_packed_torch(torch.from_numpy(np.array(x)), cfg,
                                         plan, window=window).numpy()
    return out.astype(np.int64) & ((1 << jcfg.bits_per_pack) - 1)


@pytest.mark.parametrize("out", OUTS, ids=lambda o: o.name)
def test_window_slots_match_jax(out):
    jcfg = JDecoderConfig(JChannelIn.SOFT8, decode_out=out)
    w = core_torch.survivor_window_slots(from_reference(jcfg))
    assert w == survivor_window_slots(jcfg)
    assert w == (4 if jcfg.bits_per_pack == 32 else 6)


@pytest.mark.parametrize("dec_mult", [1, 7], ids=["post-loop", "in-loop"])
@pytest.mark.parametrize("out", OUTS, ids=lambda o: o.name)
@pytest.mark.parametrize("channel", CHANNELS, ids=lambda c: c.name)
def test_window_matches_full_on_coded_input(channel, out, dec_mult):
    """dec_len = bpp leaves n_packs < W, so only the post-loop chase
    emits; dec_len = 7 bpp emits most packs inside the loop."""
    jcfg = JDecoderConfig(channel, decode_out=out)
    bpp = jcfg.bits_per_pack
    n = 3000
    x = _coded(n, 0.5, channel, seed=17)
    jplan = plan_blocks(jcfg.get_message_len(2 * n), bpp, dec_mult * bpp)
    want = np.asarray(decode_packed_xla(jnp.asarray(x), jcfg, jplan)) \
        .astype(np.int64) & ((1 << bpp) - 1)
    assert np.array_equal(_port(x, jcfg, jplan, window=False), want)
    assert np.array_equal(_port(x, jcfg, jplan, window=True), want)


# one interpret compile each: the SOFT8 b32 case stays fast as the
# representative; the other channels and b16 run with --full
@pytest.mark.parametrize("jcfg", [
    JDecoderConfig(JChannelIn.SOFT8),
    pytest.param(JDecoderConfig(JChannelIn.HARD), marks=pytest.mark.slow),
    pytest.param(JDecoderConfig(JChannelIn.SOFT4), marks=pytest.mark.slow),
    pytest.param(JDecoderConfig(JChannelIn.SOFT16), marks=pytest.mark.slow),
    pytest.param(JDecoderConfig(JChannelIn.FP32), marks=pytest.mark.slow),
    pytest.param(JDecoderConfig(JChannelIn.SOFT8,
                                decode_out=JDecodeOut.O_B16),
                 marks=pytest.mark.slow),
    pytest.param(JDecoderConfig(JChannelIn.FP32,
                                decode_out=JDecodeOut.O_B16),
                 marks=pytest.mark.slow),
], ids=lambda c: f"{c.channel_in.name}-{c.decode_out.name}")
def test_window_matches_pallas_interpret_on_random_words(rng, jcfg):
    bpp = jcfg.bits_per_pack
    jplan = plan_blocks(7 * bpp * 5 - bpp, bpp, 7 * bpp)
    n = jcfg.get_input_words(2 * (jplan.message_len + 64))
    if jcfg.channel_in == JChannelIn.FP32:
        x = (rng.standard_normal(n) * 6).astype(np.float32)
    else:
        x = rng.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int32)
    want = np.asarray(decode_packed_pallas(jnp.asarray(x), jcfg, jplan,
                                           interpret=True, window=True)) \
        .astype(np.int64) & ((1 << bpp) - 1)
    got = _port(x, jcfg, jplan, window=True)
    assert np.array_equal(got, want)
    # random words: the full store decodes them differently
    assert not np.array_equal(_port(x, jcfg, jplan, window=False), want)


def test_k3_wrapper_runs_plain_window_on_cpu(rng):
    jcfg = JDecoderConfig(JChannelIn.HARD, decode_out=JDecodeOut.O_B16)
    cfg = from_reference(jcfg)
    plan = core_torch.plan_blocks(16 * 41, 16, 96)
    x = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, size=cfg.get_input_words(
            2 * (plan.message_len + 64))).astype(np.int32))
    before = core_cuda.K3.launches
    packs = core_cuda.K3(x, cfg, plan)
    assert core_cuda.K3.launches == before
    assert torch.equal(packs, core_torch.decode_blocks_torch(x, cfg, plan,
                                                             window=True))
    assert core_cuda.kernel_for(cfg, True) is core_cuda.K3


@pytest.mark.parametrize("total_bytes, want", [(1 << 40, False),
                                               (1 << 20, True)],
                         ids=["fits", "exceeds"])
def test_resolve_window_auto_uses_total_memory(monkeypatch, total_bytes,
                                               want):
    """'auto' windows exactly when the full store (n_packs * 64 * B * 4
    bytes) exceeds half of the card's total memory, a fixed quantity: the
    live free memory is never read.  The card is stubbed."""
    plan = core_torch.plan_blocks(32 * 2000, 32, 2048)
    store = plan.n_packs * 64 * plan.num_blocks * 4
    assert (1 << 20) // 2 < store < (1 << 40) // 2

    def no_free_memory(*args):
        raise AssertionError("resolve_window read the live free memory")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_free_memory)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("Props", (), {
                            "total_memory": total_bytes})())
    assert core_cuda.resolve_window("auto", plan, "cuda") is want
    assert core_cuda.resolve_window("auto", plan, "cpu") is False
    assert core_cuda.resolve_window("full", plan, "cuda") is False
    assert core_cuda.resolve_window("window", plan, "cuda") is True
    cfg = from_reference(JDecoderConfig(JChannelIn.SOFT8))
    dec = ViterbiGPU(cfg, device="cuda")
    input_num = 2 * (plan.message_len + cfg.extra_l + cfg.extra_r)
    assert dec.plan(input_num) == plan
    assert dec.window(input_num) is want


def test_viterbi_gpu_window_on_cpu(rng):
    """survivor='window' decodes through the plain windowed core on the
    CPU; on coded input it gives the full store's words."""
    jcfg = JDecoderConfig(JChannelIn.SOFT4)
    cfg = from_reference(jcfg)
    n = 6000
    x = _coded(n, 0.4, JChannelIn.SOFT4, seed=3)
    full, _ = ViterbiGPU(cfg, dec_len=224, device="cpu").run(x, 2 * n)
    dec = ViterbiGPU(cfg, dec_len=224, device="cpu", survivor="window")
    assert dec.window(2 * n) and not ViterbiGPU(cfg, device="cpu").window(
        2 * n)
    win, _ = dec.run(x, 2 * n)
    assert np.array_equal(win, full)
