"""The benchmark's plain reference against the program's own plain versions
on the CPU, at small sizes: its decode equals ``core_torch``'s, its
streams equal ``gen_words_torch``'s and ``gen_values_torch``'s, its
framing equals the program's size calculators.  The tests import the
program; the reference does not."""

import pytest
import torch

from benchmark import framing, reference, reference_stream as rs
from tpu_viterbi_torch.chain import genkernel
from tpu_viterbi_torch.config import (ChannelIn, CompMode, DecodeOut,
                                      DecoderConfig, Metric)
from tpu_viterbi_torch.decoder import core_torch

CASES = [("HARD", 4.0, 1.0), ("SOFT4", 2.0, 4.0), ("SOFT8", 1.0, 32.0),
         ("SOFT16", 1.0, 8192.0), ("FP32", 1.0, 4.0)]


def _cfg(name, bpp=32):
    metric = Metric.M_B32
    return DecoderConfig(ChannelIn[name], metric,
                         DecodeOut.O_B32 if bpp == 32 else DecodeOut.O_B16,
                         CompMode.REG)


def _program_decode(words, name, n, dec_len, bpp=32):
    cfg = _cfg(name, bpp)
    m = cfg.get_message_len(2 * n)
    plan = core_torch.plan_blocks(m, bpp, dec_len)
    packs = core_torch.decode_blocks_torch(words, cfg, plan)
    return core_torch.assemble_output(packs, cfg, plan)


@pytest.mark.parametrize("name,snr,scale", CASES)
@pytest.mark.parametrize("n,dec_len", [(3000, 256), (5000, 2048)])
def test_decode_equals_program_on_noisy_streams(name, snr, scale, n,
                                                dec_len):
    channel = rs.CHANNELS[name]
    _, words = rs.stream((5, 77), n, channel, snr, scale, "cpu")
    plan = framing.plan(n, dec_len, 32)
    ours = reference.decode([words], channel, plan)[0]
    theirs = _program_decode(words, name, n, dec_len)
    assert torch.equal(ours, theirs)


@pytest.mark.parametrize("name", ["HARD", "SOFT8", "FP32"])
def test_decode_equals_program_on_random_words(name):
    """Words that are no codeword: ties everywhere on HARD, the last
    block's zero tail, the FP32 clamp and truncation."""
    g = torch.Generator().manual_seed(3)
    n, channel = 2500, rs.CHANNELS[name]
    if name == "FP32":
        words = torch.randn(2 * n, generator=g) * 9
    else:
        size = -(-2 * n // channel.values_per_word)
        words = torch.randint(-2 ** 31, 2 ** 31, (size,), generator=g,
                              dtype=torch.int64).to(torch.int32)
    plan = framing.plan(n, 512, 32)
    assert torch.equal(reference.decode([words], channel, plan)[0],
                       _program_decode(words, name, n, 512))


def test_decode_b16_packs_and_batches():
    """16-bit packs, and several messages in one batch decode as each
    alone."""
    channel = rs.CHANNELS["SOFT8"]
    streams = [rs.stream((1, s), 3000, channel, 1.0, 32.0, "cpu")[1]
               for s in (1, 2)]
    plan = framing.plan(3000, 256, 16)
    both = reference.decode(streams, channel, plan)
    for words, ours in zip(streams, both):
        theirs = _program_decode(words, "SOFT8", 3000, 256, bpp=16)
        assert torch.equal(ours, theirs.to(torch.int32))
        assert torch.equal(ours, reference.decode([words], channel,
                                                  plan)[0])


@pytest.mark.parametrize("name", ["HARD", "SOFT4", "SOFT8", "SOFT16"])
@pytest.mark.parametrize("sigma_snr", [1.0, float("inf")])
def test_stream_equals_program_generator(name, sigma_snr):
    channel, n, key = rs.CHANNELS[name], 4000, (0, 123456789)
    scale = dict((c, s) for c, _, s in CASES)[name]
    packs, words = rs.stream(key, n, channel, sigma_snr, scale, "cpu")
    p_packs, p_words = genkernel.gen_words_torch(
        key[0], key[1], n, ChannelIn[name], rs.sigma_of(sigma_snr), scale)
    assert torch.equal(words, p_words)
    assert torch.equal(rs.to_int32(packs), p_packs)


def test_fp32_stream_equals_program_generator():
    n, key = 4000, (0, 987654321)
    packs, vals = rs.stream(key, n, rs.CHANNELS["FP32"], 1.0, 4.0, "cpu")
    p_packs, p_vals = genkernel.gen_values_torch(key[0], key[1], n,
                                                 rs.sigma_of(1.0), 4.0)
    assert torch.equal(vals, p_vals)
    assert torch.equal(rs.to_int32(packs), p_packs)


def test_stream_chunks_join(monkeypatch):
    """A stream made a small chunk at a time equals it made whole."""
    channel = rs.CHANNELS["SOFT8"]
    whole = rs.stream((2, 3), 3000, channel, 1.0, 32.0, "cpu")[1]
    monkeypatch.setattr(rs, "CHUNK_STAGES", 250)
    assert torch.equal(rs.stream((2, 3), 3000, channel, 1.0, 32.0,
                                 "cpu")[1], whole)


def test_threefry_equals_program():
    c = torch.arange(0, 5000, 7, dtype=torch.int64)
    for rounds in (13, 20):
        ours = rs.threefry2x32(0x12345678, 0x9ABCDEF0, c, 3, rounds)
        theirs = genkernel.threefry2x32(0x12345678, 0x9ABCDEF0, c, 3,
                                        rounds)
        assert all(torch.equal(a, b) for a, b in zip(ours, theirs))


@pytest.mark.parametrize("n", [3000, 4096 + 64, 100000])
def test_framing_and_truth_equal_program(n):
    cfg = _cfg("SOFT8")
    plan = framing.plan(n, 2048, 32)
    assert plan.message_len == cfg.get_message_len(2 * n)
    theirs = core_torch.plan_blocks(plan.message_len, 32, 2048)
    assert (plan.dec_len, plan.num_blocks) == (theirs.dec_len,
                                               theirs.num_blocks)
    packs = rs.message_packs((0, 42), n, "cpu")
    truth = rs.reference_words(packs, plan.message_len)
    assert torch.equal(truth, genkernel.ref_words_from_packs(
        packs, cfg.extra_l, plan.message_len))


def test_noiseless_decode_is_the_message():
    channel = rs.CHANNELS["SOFT8"]
    packs, words = rs.stream((0, 9), 6000, channel, float("inf"), 32.0,
                             "cpu")
    plan = framing.plan(6000, 1024, 32)
    out = reference.decode([words], channel, plan)[0]
    truth = rs.to_int32(rs.reference_words(packs, plan.message_len))
    assert reference.differing_bits(out, truth) == 0
    flipped = out.clone()
    flipped[7] ^= 5
    assert reference.differing_bits(out, flipped) == 2
