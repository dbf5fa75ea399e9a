"""The port's decoder core (tpu_viterbi_torch.decoder.core_torch, the plain
version of kernel K1) against the JAX package's, bit for bit: the same
numpy-seeded packed words go through ``decode_packed_xla`` and
``decode_packed_torch`` under the same config and block plan, handed over
with from_reference / plan_from_reference.

The K1 wrapper (core_cuda.K1) runs its plain version on CPU tensors, so the
CPU cases also cover the wrapper's dispatch; the kernel itself is compared
with the plain version on the card by test_torch_cuda.py (skipped without
a GPU) and by chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_viterbi.config import (ChannelIn, CompMode, DecodeOut, DecoderConfig,
                                Metric)
from tpu_viterbi.decoder import core_xla
from tpu_viterbi.decoder.golden import golden_decode_block
from tpu_viterbi_torch.config import from_reference
from tpu_viterbi_torch.decoder import core_cuda, core_torch

torch.set_num_threads(1)


def _pair(jcfg, m, dec_len):
    """(jax cfg, jax plan, port cfg, port plan) for one decode."""
    jplan = core_xla.plan_blocks(m, jcfg.bits_per_pack, dec_len)
    return jcfg, jplan, from_reference(jcfg), \
        core_torch.plan_from_reference(jplan)


def _words(rng, jcfg, jplan):
    """Exactly the reference input length (get_input_words) for the plan:
    integer channels get full-range random words, FP32 scaled floats that
    cross the [-8, 7] clamp and the trunc boundaries."""
    n = jcfg.get_input_words(2 * (jplan.message_len + 64))
    if jcfg.channel_in == ChannelIn.FP32:
        return (rng.standard_normal(n) * 6).astype(np.float32)
    return rng.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int32)


def _xla(x, jcfg, jplan):
    out = np.asarray(core_xla.decode_packed_xla(jnp.asarray(x), jcfg, jplan))
    return out.astype(np.int64) & ((1 << jcfg.bits_per_pack) - 1)


def _port(x, cfg, plan, fn=core_torch.decode_packed_torch):
    out = fn(torch.from_numpy(x), cfg, plan).numpy()
    return out.astype(np.int64) & ((1 << cfg.bits_per_pack) - 1)


def _cfg(ch, out=DecodeOut.O_B32, metric=Metric.M_B32, comp=CompMode.REG):
    return DecoderConfig(ch, metric, out, comp)


B32, B16 = DecodeOut.O_B32, DecodeOut.O_B16
CASES = {
    # headline config, whole blocks and a partial (natural-framed) last one
    "soft8-b32": (_cfg(ChannelIn.SOFT8), 256 * 5, 256),
    "soft8-b32-overlap": (_cfg(ChannelIn.SOFT8), 32 * 37, 256),
    "hard-b32": (_cfg(ChannelIn.HARD), 32 * 37, 128),
    "soft4-b32": (_cfg(ChannelIn.SOFT4), 32 * 37, 128),
    "soft16-b32": (_cfg(ChannelIn.SOFT16), 32 * 37, 128),
    # bpp 16 with m % 32 == 16
    "hard-b16": (_cfg(ChannelIn.HARD, B16), 16 * 73, 96),
    "soft4-b16": (_cfg(ChannelIn.SOFT4, B16), 16 * 73, 96),
    "soft8-b16": (_cfg(ChannelIn.SOFT8, B16), 16 * 73, 96),
    "soft16-b16": (_cfg(ChannelIn.SOFT16, B16), 16 * 73, 96),
    "fp32-b32": (_cfg(ChannelIn.FP32), 32 * 37, 128),
    "fp32-b16": (_cfg(ChannelIn.FP32, B16), 16 * 73, 96),
    # num_blocks == 1
    "soft8-one-block": (_cfg(ChannelIn.SOFT8), 512, 512),
    "hard-b16-one-block": (_cfg(ChannelIn.HARD, B16), 16 * 9, 2048),
    # dec_len < 64: the halo spans several following bodies
    "soft8-declen32": (_cfg(ChannelIn.SOFT8), 32 * 11, 32),
    "hard-declen32": (_cfg(ChannelIn.HARD), 32 * 11, 32),
    "soft16-b16-declen16": (_cfg(ChannelIn.SOFT16, B16), 16 * 13, 16),
    # metric modes and DPX ride the int32 core; the JAX core keeps int16 /
    # fp16 metrics with renorm, so these also pin the decode identity
    "soft8-m16": (_cfg(ChannelIn.SOFT8, metric=Metric.M_B16), 32 * 37, 128),
    "soft4-fp16-b16": (_cfg(ChannelIn.SOFT4, B16, Metric.M_FP16), 16 * 73, 96),
    "hard-m16-dpx": (_cfg(ChannelIn.HARD, metric=Metric.M_B16,
                          comp=CompMode.DPX), 32 * 37, 128),
    "fp32-fp16": (_cfg(ChannelIn.FP32, metric=Metric.M_FP16), 32 * 37, 128),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_packed_torch_matches_xla(rng, name):
    jcfg, m, dec_len = CASES[name]
    jcfg, jplan, cfg, plan = _pair(jcfg, m, dec_len)
    assert plan.message_len == m
    x = _words(rng, jcfg, jplan)
    want = _xla(x, jcfg, jplan)
    got = _port(x, cfg, plan)
    assert got.shape == want.shape == (m // cfg.bits_per_pack,)
    assert np.array_equal(got, want), \
        f"{int(np.count_nonzero(got != want))}/{len(want)} words differ"


def test_framing_edges_are_exercised():
    """The CASES table really covers the framing edges it names."""
    plans = {name: core_torch.plan_blocks(m, c.bits_per_pack, dl)
             for name, (c, m, dl) in CASES.items()}
    assert any(p.num_blocks == 1 for p in plans.values())
    assert any(p.overlap_bits > 0 for p in plans.values())
    assert any(p.dec_len < 64 for p in plans.values())
    assert any(p.message_len % 32 == 16 for p in plans.values())


@pytest.mark.parametrize("m", [16_288, 16_320])
def test_renorm_boundary_matches_xla(rng, m):
    """SOFT16 at the int32 renorm boundary (plans as in test_renorm.py):
    16288 runs renorm-free, 16320 switches the per-pack min-subtract on;
    near-max-magnitude fields drive the path metrics at ~max|bm| a stage."""
    jcfg, jplan, cfg, plan = _pair(_cfg(ChannelIn.SOFT16), m, m)
    assert core_torch.needs_int32_renorm(cfg, plan) == (m == 16_320)
    fields = rng.choice(np.array([-32768, -32767, 32766, 32767]),
                        size=2 * (m + 64)).astype(np.int64) & 0xFFFF
    x = ((fields[0::2] << 16) | fields[1::2]).astype(np.uint32) \
        .view(np.int32)
    assert np.array_equal(_port(x, cfg, plan), _xla(x, jcfg, jplan))


@pytest.mark.parametrize("channel", [ChannelIn.SOFT8, ChannelIn.SOFT16])
def test_forced_renorm_is_decision_invariant(rng, monkeypatch, channel):
    """The renorm path itself, forced on at a small shape, against the
    int64 golden oracle and against the renorm-free decode."""
    cfg = from_reference(_cfg(channel))
    dec_len, b = 96, 2
    plan = core_torch.plan_blocks(dec_len * b, cfg.bits_per_pack, dec_len)
    x = _words(rng, _cfg(channel), plan)
    plain = _port(x, cfg, plan)
    monkeypatch.setattr(core_torch, "needs_int32_renorm", lambda c, p: True)
    forced = _port(x, cfg, plan)
    assert np.array_equal(forced, plain)
    rs = core_torch.stage_values(torch.from_numpy(x), cfg, plan)
    bits = np.unpackbits(forced.astype(">u4").view(np.uint8))
    for k, off in enumerate(plan.offsets()):
        r = rs[:, :, k].numpy().astype(np.int64)
        want = golden_decode_block(r, dec_len)
        assert np.array_equal(bits[off:off + dec_len], want), f"block {k}"


@pytest.mark.parametrize("channel", [ChannelIn.HARD, ChannelIn.SOFT4,
                                     ChannelIn.SOFT8, ChannelIn.SOFT16,
                                     ChannelIn.FP32])
def test_stage_values_match_stage_layout_packed(rng, channel):
    """The word unpack (stage_layout_packed, core_xla.py:212-245) on the
    per-block windows, halo and zero fill included."""
    jcfg, jplan, cfg, plan = _pair(_cfg(channel), 32 * 7, 64)
    x = _words(rng, jcfg, jplan)
    want = np.asarray(core_xla.stage_layout_packed(
        jnp.asarray(x), jcfg, jplan, jplan.num_blocks))
    got = core_torch.stage_values(torch.from_numpy(x), cfg, plan)
    assert np.array_equal(got.numpy().reshape(want.shape), want)


def test_survivors_and_traceback_match_xla(rng):
    jcfg, jplan, cfg, plan = _pair(_cfg(ChannelIn.SOFT8, B16), 16 * 21, 64)
    x = _words(rng, jcfg, jplan)
    rs_j = core_xla.stage_layout_packed(jnp.asarray(x), jcfg, jplan,
                                        jplan.num_blocks)
    surv_j = core_xla.forward_scan_staged(rs_j, jcfg, jplan)
    rs_t = core_torch.stage_values(torch.from_numpy(x), cfg, plan)
    surv_t = core_torch.forward_scan(rs_t, cfg, plan)
    assert np.array_equal(surv_t.numpy(), np.asarray(surv_j).astype(np.int64))
    tb_j = np.asarray(core_xla.traceback_scan(surv_j, jcfg, jplan))
    tb_t = core_torch.traceback_scan(surv_t, cfg, plan)
    assert np.array_equal(tb_t.numpy(), tb_j.astype(np.int64))


def test_matches_pallas_kernel_interpret(rng):
    """One small case against the TPU kernel itself (fused word mode, the
    roll-halo path K1 replaces), run in interpret mode: b16, dec_len 64,
    2 blocks, the size of the unmarked test_kernel_interpret case."""
    from tpu_viterbi.decoder.core_pallas import decode_packed_pallas
    jcfg, jplan, cfg, plan = _pair(_cfg(ChannelIn.SOFT8, B16), 128, 64)
    assert plan.num_blocks == 2
    x = _words(rng, jcfg, jplan)
    want = np.asarray(decode_packed_pallas(jnp.asarray(x), jcfg, jplan,
                                           interpret=True)).astype(np.int64)
    assert np.array_equal(_port(x, cfg, plan, core_cuda.decode_packed_cuda),
                          want & 0xFFFF)


def test_k1_wrapper_runs_plain_version_on_cpu(rng):
    """On a CPU tensor the K1 wrapper is its plain version and launches
    nothing: the launch counter stays put."""
    jcfg, jplan, cfg, plan = _pair(_cfg(ChannelIn.SOFT8), 32 * 37, 256)
    x = torch.from_numpy(_words(rng, jcfg, jplan))
    before = core_cuda.K1.launches
    packs = core_cuda.K1(x, cfg, plan)
    assert core_cuda.K1.launches == before
    assert torch.equal(packs, core_torch.decode_blocks_torch(x, cfg, plan))
    assert packs.shape == (plan.num_blocks, plan.dec_len // 32)
    assert packs.dtype == torch.int32


def test_k1_rejects_what_it_does_not_decode():
    from tpu_viterbi_torch.config import ConfigResolutionError
    with pytest.raises(ConfigResolutionError, match="K2"):
        core_cuda.check_supported(from_reference(_cfg(ChannelIn.FP32)))
    with pytest.raises(ConfigResolutionError, match="K3"):
        core_cuda.check_supported(from_reference(_cfg(ChannelIn.SOFT8)),
                                  survivor="window")
