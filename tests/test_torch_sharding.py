"""The port's multi-rank split (tpu_viterbi_torch.sharding: blocks,
certify, the sharded generator and simulation) and K1's/K3's tail halo,
against the JAX package on the CPU.  Every rank of an N-rank decode is held
in this process through the per-rank function (blocks.decode_all_ranks);
the real processes are tests/test_torch_distributed.py's.  Inputs come from
numpy generators with fixed seeds; every comparison is bit-exact unless it
says otherwise."""

import math

import jax
import numpy as np
import pytest
import torch

from tpu_viterbi.config import (ChannelIn as JChannelIn,
                                DecodeOut as JDecodeOut,
                                DecoderConfig as JDecoderConfig)
from tpu_viterbi.chain.genkernel import (generator_span_stages as
                                         jgenerator_span_stages)
from tpu_viterbi.decoder.core_pallas import decode_packed_pallas
from tpu_viterbi.decoder.core_xla import (auto_dec_len as jauto_dec_len,
                                          decode_packed_xla,
                                          plan_blocks as jplan_blocks)
from tpu_viterbi.sharding import blocks as jblocks
from tpu_viterbi.sharding import simulate as jsimulate
from tpu_viterbi.sharding.certify import coded_workload as jcoded_workload
from tpu_viterbi.sharding.mesh import make_block_mesh
from tpu_viterbi_torch.chain.genkernel import (generator_span_stages,
                                               packed_workload_cuda,
                                               packed_workload_cuda_sharded,
                                               ref_words_from_packs)
from tpu_viterbi_torch.config import (ChannelIn, DecodeOut, DecoderConfig,
                                      from_reference)
from tpu_viterbi_torch.decoder import core_cuda
from tpu_viterbi_torch.decoder.core_torch import (TAIL_HALO_REFUSAL,
                                                  decode_blocks_i16_torch,
                                                  decode_blocks_torch,
                                                  decode_packed_torch,
                                                  plan_blocks,
                                                  words_per_block)
from tpu_viterbi_torch.sharding import blocks, simulate as sim
from tpu_viterbi_torch.sharding.certify import coded_workload, run_sharded
from tpu_viterbi_torch.sharding.mesh import BlockMesh

torch.set_num_threads(1)
CPU = torch.device("cpu")
SCALES = {ChannelIn.HARD: 1.0, ChannelIn.SOFT4: 4.0, ChannelIn.SOFT8: 32.0,
          ChannelIn.SOFT16: 8192.0, ChannelIn.FP32: 4.0}


def _jmesh(n: int):
    return make_block_mesh(jax.devices()[:n])


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


# --- K1's and K3's tail halo, on the plain version -----------------------

def _stream_and_halo(cfg, sigma: float, dec_len: int, blocks_: int,
                     ragged: int):
    """Coded words of ``blocks_`` blocks less ``ragged`` words, and the wph
    words that follow them in the coded stream."""
    wpb, wph = words_per_block(cfg, plan_blocks(dec_len, cfg.bits_per_pack,
                                                dec_len))
    n_words = blocks_ * wpb - ragged
    bits = (n_words + wph) * cfg.enc_data_per_pack // 2 + 64
    _, packed = coded_workload(bits, sigma, 5, cfg.channel_in,
                               SCALES[cfg.channel_in])
    words = torch.from_numpy(packed[:n_words].copy())
    halo = torch.from_numpy(packed[n_words: n_words + wph].copy())
    stages = n_words * cfg.enc_data_per_pack // 2
    stages -= stages % cfg.bits_per_pack
    return words, halo, plan_blocks(stages, cfg.bits_per_pack, dec_len)


@pytest.mark.parametrize("out", [DecodeOut.O_B32, DecodeOut.O_B16],
                         ids=["b32", "b16"])
@pytest.mark.parametrize("channel", [ChannelIn.HARD, ChannelIn.SOFT4,
                                     ChannelIn.SOFT8, ChannelIn.SOFT16],
                         ids=lambda c: c.name)
@pytest.mark.parametrize("ragged", [0, 3], ids=["aligned", "ragged"])
def test_tail_halo_is_the_appended_stream(channel, out, ragged):
    """A decode with tail_halo = h equals the decode of cat(stream, h):
    through the plain version (full store and window, int32 and the int16
    twin) and K1's/K3's wrappers on CPU tensors; the full store equals
    JAX's decode_packed_xla of the concatenated words, and, on this coded
    input, the window equals the full store."""
    cfg = DecoderConfig(channel, decode_out=out)
    words, halo, plan = _stream_and_halo(cfg, 0.5, 256, 6, ragged)
    cat = torch.cat([words, halo])
    full = decode_packed_torch(cat, cfg, plan)
    assert torch.equal(decode_packed_torch(words, cfg, plan, tail_halo=halo),
                       full)
    jcfg = JDecoderConfig(channel_in=JChannelIn[channel.name],
                          decode_out=JDecodeOut[out.name])
    want = decode_packed_xla(cat.numpy(), jcfg,
                             jplan_blocks(plan.message_len,
                                          cfg.bits_per_pack, plan.dec_len))
    assert np.array_equal(_u32(want), _u32(full.numpy()))
    win = decode_packed_torch(words, cfg, plan, window=True, tail_halo=halo)
    assert torch.equal(win, decode_packed_torch(cat, cfg, plan,
                                                window=True))
    assert torch.equal(win, full)
    for kernel in (core_cuda.K1, core_cuda.K3):
        assert torch.equal(kernel(words, cfg, plan, tail_halo=halo),
                           decode_blocks_torch(cat, cfg, plan,
                                               kernel.window))
    assert torch.equal(core_cuda.decode_packed_cuda(words, cfg, plan,
                                                    tail_halo=halo), full)
    if channel != ChannelIn.SOFT16:
        assert torch.equal(
            decode_blocks_i16_torch(words, cfg, plan, tail_halo=halo),
            decode_blocks_i16_torch(cat, cfg, plan))


def test_tail_halo_refusals_match_jax():
    """fused=False and dec_len < 64 raise JAX's ValueError with its words;
    FP32 raises it too (JAX's FP32 branch returns before its check and
    drops the halo); a halo of the wrong length is refused, and so is a
    halo given to an A/B instance, which has no halo reader."""
    cfg, jcfg = DecoderConfig(ChannelIn.SOFT8), JDecoderConfig()
    halo = torch.zeros(32, dtype=torch.int32)
    words = torch.zeros(2048, dtype=torch.int32)
    for dec_len, fused in ((256, False), (32, True)):
        plan = plan_blocks(4096, 32, dec_len)
        with pytest.raises(ValueError) as want:
            decode_packed_pallas(np.zeros(2048, np.int32), jcfg,
                                 jplan_blocks(4096, 32, dec_len),
                                 fused=fused, interpret=True,
                                 tail_halo=np.zeros(32, np.int32))
        with pytest.raises(ValueError) as got:
            core_cuda.decode_packed_cuda(words, cfg, plan, fused=fused,
                                         tail_halo=halo)
        assert str(got.value) == str(want.value) == TAIL_HALO_REFUSAL
        if fused:
            with pytest.raises(ValueError, match="dec_len >= 64"):
                core_cuda.K1(words, cfg, plan, tail_halo=halo)
    fp32 = DecoderConfig(ChannelIn.FP32)
    with pytest.raises(ValueError) as got:
        core_cuda.decode_packed_cuda(torch.zeros(4096), fp32,
                                     plan_blocks(2048, 32, 256),
                                     tail_halo=torch.zeros(128))
    assert str(got.value) == TAIL_HALO_REFUSAL
    with pytest.raises(ValueError, match="32 words"):
        decode_blocks_torch(words, cfg, plan_blocks(4096, 32, 256),
                            tail_halo=halo[:16])
    with pytest.raises(ValueError, match="K1_I32 takes no tail_halo"):
        core_cuda.K1_I32(words, cfg, plan_blocks(4096, 32, 256),
                         tail_halo=halo)


# --- sizes ---------------------------------------------------------------

def test_shard_sizes_match_jax():
    """sharded_stage_count (with and without the alignment) and
    zero_copy_align_stages equal JAX's on a grid of stage counts, rank
    counts, pack widths and dec_lens, 'auto' included; the halo is JAX's
    2 WARMUP / dpp words."""
    for out in (JDecodeOut.O_B32, JDecodeOut.O_B16):
        jcfg = JDecoderConfig(decode_out=out)
        cfg = from_reference(jcfg)
        bpp = cfg.bits_per_pack
        for total in (40, 1000, 8 * 1024 + 16, 100_003, 4_000_000,
                      32_000_000):
            for n in (1, 2, 4, 8):
                for dl in (64, 256, 2048, "auto"):
                    if dl == "auto":
                        sd = blocks.sharded_stage_count(total, n, bpp)
                        dl = blocks.auto_dec_len(sd, bpp)
                        assert dl == jauto_dec_len(sd, bpp)
                    al = blocks.zero_copy_align_stages(cfg, dl)
                    assert al == jblocks.zero_copy_align_stages(jcfg, dl)
                    for a in (0, al):
                        assert blocks.sharded_stage_count(total, n, bpp, a) \
                            == jblocks.sharded_stage_count(total, n, bpp, a)
    assert blocks.shard_stages(DecoderConfig(ChannelIn.SOFT8), 64_000_000,
                               2)[0] == 16_252_928 == 62 * 128 * 2048
    for c in ChannelIn:
        dpp = 1 if c == ChannelIn.FP32 else DecoderConfig(c).enc_data_per_pack
        assert blocks.halo_words(DecoderConfig(c)) == 128 // dpp


def test_simulation_sizes_match_jax(monkeypatch):
    """The sharded simulation's shard size and dec_len are JAX's, with the
    generator-span alignment (generator 'cuda' = JAX's 'pallas') and
    without it ('torch' = 'xla'): JAX's builder is stopped where it builds
    its decoder, and its arguments read."""
    seen = []

    class Stop(Exception):
        pass

    def spy(cfg, sd, mesh, dec_len, **kwargs):
        seen.append((sd, dec_len))
        raise Stop

    monkeypatch.setattr(jsimulate, "build_sharded_decoder", spy)
    for c in ChannelIn:
        jcfg = JDecoderConfig(channel_in=JChannelIn[c.name])
        assert generator_span_stages(c) == \
            jgenerator_span_stages(jcfg.channel_in)
        for n in (1, 2, 4):
            for total in (5000, 300_000, 4_000_000, 32_000_000):
                for dl in (2048, "auto"):
                    for gen, jgen in (("cuda", "pallas"), ("torch", "xla")):
                        seen.clear()
                        with pytest.raises(Stop):
                            jsimulate.build_sharded_simulation(
                                jcfg, total, _jmesh(n), dec_len=dl,
                                generator=jgen)
                        assert sim.shard_size(from_reference(jcfg), total,
                                              n, dl, gen) == seen[0]


def test_coded_workload_is_jax():
    for c in ChannelIn:
        for sigma in (0.0, 0.7):
            b, p = coded_workload(3000, sigma, 9, c, SCALES[c])
            jb, jp = jcoded_workload(3000, sigma, 9, JChannelIn[c.name],
                                     SCALES[c])
            assert np.array_equal(b, jb)
            assert np.array_equal(p.view(np.uint32),
                                  np.asarray(jp).view(np.uint32))


# --- every rank of decode_sharded against JAX's --------------------------

SHARDED_CASES = [
    (ChannelIn.SOFT8, JDecodeOut.O_B32, 256, 3000),
    (ChannelIn.SOFT8, JDecodeOut.O_B16, 64, 3000),
    (ChannelIn.HARD, JDecodeOut.O_B32, "auto", 3000),
    (ChannelIn.HARD, JDecodeOut.O_B16, 256, 3000),
    (ChannelIn.SOFT16, JDecodeOut.O_B32, 64, 3000),
    (ChannelIn.SOFT16, JDecodeOut.O_B16, "auto", 3000),
    (ChannelIn.FP32, JDecodeOut.O_B32, "auto", 3000),
    (ChannelIn.FP32, JDecodeOut.O_B16, 256, 3000),
    # m % 32 == 16 at b16: 3152 message bits decode 3088 = 96.5 x 32
    (ChannelIn.SOFT8, JDecodeOut.O_B16, 256, 3072 + 64 + 16),
]


@pytest.mark.parametrize("channel,out,dec_len,n", SHARDED_CASES, ids=[
    f"{c.name}-b{32 if o == JDecodeOut.O_B32 else 16}-{d}-{n}"
    for c, o, d, n in SHARDED_CASES])
def test_decode_sharded_every_rank_matches_jax(channel, out, dec_len, n):
    """Noisy coded input at 1, 2 and 4 ranks: the port's ranks, each its
    per-rank decode on its shard and its neighbour's halo, give JAX's
    decode_sharded(backend='xla') on an N-device CPU mesh bit for bit; the
    in-place halo (K1/K3's tail_halo, integer channels) and the FP32
    concatenation alike."""
    jcfg = JDecoderConfig(channel_in=JChannelIn[channel.name],
                          decode_out=out)
    cfg = from_reference(jcfg)
    _, packed = coded_workload(n, 0.7, 11, channel, SCALES[channel])
    for ranks in (1, 2, 4):
        want, m = jblocks.decode_sharded(packed, 2 * n, jcfg, _jmesh(ranks),
                                         dec_len=dec_len, backend="xla")
        got, m2 = blocks.decode_all_ranks(packed, 2 * n, cfg, ranks, "cpu",
                                          dec_len)
        assert m2 == m and got.dtype == np.asarray(want).dtype
        assert np.array_equal(got, np.asarray(want)), ranks
    if n % 32 == 16:
        assert m % 32 == 16


def test_sharded_decoder_refusals_match_jax():
    jcfg, cfg = JDecoderConfig(), DecoderConfig(ChannelIn.SOFT8)
    mesh = BlockMesh(0, 2, CPU)
    for kwargs in ({"survivor": "ring"}, {}):
        sd = 2000 if not kwargs else 2048
        with pytest.raises(ValueError) as want:
            jblocks.build_sharded_decoder(jcfg, sd, _jmesh(2), 256, **kwargs)
        with pytest.raises(ValueError) as got:
            blocks.build_sharded_decoder(cfg, sd, mesh, 256, **kwargs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="'auto', 'cuda' or 'torch'"):
        blocks.build_sharded_decoder(cfg, 2048, mesh, backend="xla")
    dec, plan, lw, info = blocks.build_sharded_decoder(cfg, 2048, mesh, 256,
                                                       survivor="window")
    assert (lw, plan.message_len, info) == (1024, 2048, {
        "backend": "torch", "aligned": True, "window": True})


def test_run_sharded_certifies_the_recipe():
    """certify.run_sharded at one rank: the whole noiseless message back."""
    cfg = DecoderConfig(ChannelIn.SOFT8)
    bits, packed = coded_workload(4096, 0.0, 2)
    out, info, _, _ = run_sharded(cfg, 4096, BlockMesh(0, 1, CPU), 256,
                                  packed)
    m = cfg.get_message_len(2 * 4096)
    got = np.unpackbits(out.numpy().astype(">u4").view(np.uint8))[:m]
    assert info["aligned"] and np.array_equal(got, bits[26: 26 + m])


# --- the sharded generator and simulation --------------------------------

@pytest.mark.parametrize("channel", list(ChannelIn), ids=lambda c: c.name)
def test_sharded_generator_slabs_are_the_one_rank_stream(channel):
    """Every rank's slab (K7/K8's plain version at its base offset),
    concatenated, is the one-rank stream bit for bit, zero past its end."""
    n, seed = 7001, 4
    bits, words = packed_workload_cuda(seed, n, channel, 1.5, 4.0, "cpu")
    for ranks in (2, 3, 4):
        mesh = BlockMesh(0, ranks, CPU)
        slabs = [packed_workload_cuda_sharded(seed, n, channel, 1.5, 4.0,
                                              mesh, min_words=3000, rank=r)
                 for r in range(ranks)]
        for i, whole in ((0, bits), (1, words)):
            cat = torch.cat([s[i] for s in slabs])
            assert torch.equal(cat[: whole.shape[0]], whole)
            assert not cat[whole.shape[0]:].any()


SIM_CASES = [(DecoderConfig(ChannelIn.SOFT8), 8 * 1024 + 7),
             (DecoderConfig(ChannelIn.SOFT8, decode_out=DecodeOut.O_B16),
              8 * 1024 + 16),                           # m % 32 == 16
             (DecoderConfig(ChannelIn.HARD, decode_out=DecodeOut.O_B16),
              5000),
             (DecoderConfig(ChannelIn.FP32), 8 * 1024 + 7)]


@pytest.mark.parametrize("cfg,n", SIM_CASES,
                         ids=["SOFT8-b32", "SOFT8-b16-odd-half", "HARD-b16",
                              "FP32-b32"])
def test_sharded_simulation_counts(cfg, n):
    """At 1, 2 and 4 ranks: BEN 0 without noise; under noise the count
    equals count_errors of decode_sharded (every rank, in process) on the
    same generated stream, with the same shard size."""
    m = cfg.get_message_len(2 * n)
    for ranks in (1, 2, 4):
        mesh = BlockMesh(0, ranks, CPU)
        s = sim.ShardedSimulation(cfg, n, mesh, snr_db=math.inf,
                                  dec_len=256, generator="cuda")
        ben, _ = s.all_ranks(5)
        assert int(ben) == 0 and s.m == m
        s = sim.ShardedSimulation(cfg, n, mesh, snr_db=0.5, dec_len=256,
                                  generator="cuda")
        ben, outs = s.all_ranks(5)
        packs, words = packed_workload_cuda(5, n, cfg.channel_in, 0.5,
                                            sim.DEFAULT_SCALES[
                                                cfg.channel_in], "cpu")
        assert s.sd == blocks.shard_stages(cfg, 2 * n, ranks, 256)[0]
        out, _ = blocks.decode_all_ranks(words, 2 * n, cfg, ranks, "cpu",
                                         256)
        ref32 = ref_words_from_packs(packs, cfg.extra_l, -(-m // 32) * 32)
        want = sim.count_errors(torch.from_numpy(out.astype(np.int64)),
                                ref32, cfg.bits_per_pack, m)
        assert 0 < int(ben) == int(want), ranks
        assert torch.equal(outs[: out.shape[0]].to(torch.int64) & 0xFFFFFFFF,
                           torch.from_numpy(out.astype(np.int64)))


def test_sharded_simulation_torch_generator():
    """Generator 'torch' (the element chain, drawn whole by every rank and
    sliced): BEN 0 without noise, and under noise the count of
    decode_sharded on the chain's stream, at 1, 2 and 4 ranks."""
    cfg, n = DecoderConfig(ChannelIn.SOFT8, decode_out=DecodeOut.O_B16), \
        6000 + 16
    m = cfg.get_message_len(2 * n)
    gen = torch.Generator()
    gen.manual_seed(3)
    bits, words = sim.packed_workload(gen, n, cfg.channel_in, 0.0,
                                      sim.DEFAULT_SCALES[cfg.channel_in])
    ref32 = sim._ref_words32(bits, cfg.extra_l, -(-m // 32) * 32)
    for ranks in (1, 2, 4):
        mesh = BlockMesh(0, ranks, CPU)
        s = sim.ShardedSimulation(cfg, n, mesh, snr_db=math.inf,
                                  dec_len=256, generator="torch")
        assert int(s.all_ranks(3)[0]) == 0
        s = sim.ShardedSimulation(cfg, n, mesh, snr_db=0.0, dec_len=256,
                                  generator="torch")
        out, _ = blocks.decode_all_ranks(words, 2 * n, cfg, ranks, "cpu",
                                         256)
        want = sim.count_errors(torch.from_numpy(out.astype(np.int64)),
                                ref32, cfg.bits_per_pack, m)
        assert 0 < int(s.all_ranks(3)[0]) == int(want), ranks


def test_sharded_simulation_ber_in_jax_band():
    """SOFT8 at 0 dB, the default scale, 32768 bits, three seeds: the
    split's error count at 1, 2 and 4 ranks lies within 10 % of JAX's
    one-device simulation (its XLA generator, another random stream; the
    three seeds' totals differ by 2 % in a reference run), and is the same
    at every rank count (same streams, same framing)."""
    jcfg = JDecoderConfig()
    cfg = from_reference(jcfg)
    n, snr = 32768, 0.0
    want = sum(jsimulate.simulate_sharded(jcfg, n, _jmesh(1), snr_db=snr,
                                          seed=seed, generator="xla",
                                          dec_len=512)[0]
               for seed in (1, 2, 3))
    totals = []
    for ranks in (1, 2, 4):
        s = sim.ShardedSimulation(cfg, n, BlockMesh(0, ranks, CPU),
                                  snr_db=snr, dec_len=512, generator="cuda")
        totals.append(sum(int(s.all_ranks(seed)[0]) for seed in (1, 2, 3)))
    assert len(set(totals)) == 1
    assert 1000 < want and abs(totals[0] - want) <= want // 10


def test_simulation_without_mesh_is_unchanged():
    """mesh=None keeps the one-device simulation; a one-rank mesh runs the
    split, and both count 0 without noise."""
    cfg = DecoderConfig(ChannelIn.SOFT8)
    fn, m = sim.build_sharded_simulation(cfg, 5000, snr_db=math.inf,
                                         dec_len=256, device="cpu")
    assert not isinstance(fn, sim.ShardedSimulation) and int(fn(1)) == 0
    fn, m2 = sim.build_sharded_simulation(cfg, 5000, snr_db=math.inf,
                                          dec_len=256, generator="cuda",
                                          mesh=BlockMesh(0, 1, CPU))
    assert isinstance(fn, sim.ShardedSimulation) and int(fn(1)) == 0
    assert m == m2
    assert sim.simulate_sharded(cfg, 5000, snr_db=math.inf, seed=2,
                                dec_len=256, generator="torch",
                                mesh=BlockMesh(0, 1, CPU)) == (0, m)
