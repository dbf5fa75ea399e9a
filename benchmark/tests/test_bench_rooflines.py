"""The rooflines' counts against shapes worked out by hand, and the peaks
they divide by."""

import pytest

from benchmark import framing, rooflines
from benchmark.reference_stream import CHANNELS


def test_peaks():
    assert rooflines.ISSUE_PER_S == pytest.approx(33.45408e12)
    assert rooflines.SFU_PER_S == pytest.approx(4.18176e12)
    assert rooflines.HBM_BYTES_PER_S == 3.35e12


def test_per_unit_counts():
    assert rooflines.ACS_PER_BLOCK_STAGE == 64
    assert rooflines.THREEFRY_PER_CALL == 44
    assert (rooflines.BOX_MULLER_ISSUE, rooflines.BOX_MULLER_SFU) == (8, 4)


def test_soft8_32m_decode():
    """32,000,000 source bits: 31,999,936 decoded bits, 15,625 blocks of
    2048 + 64 stages; 16,000,000 words in, 3,999,992 bytes out."""
    plan = framing.plan(32_000_000, 2048, 32)
    assert (plan.message_len, plan.num_blocks, plan.block_len) == (
        31_999_936, 15_625, 2112)
    terms = rooflines.decode_terms(CHANNELS["SOFT8"], plan)
    assert terms["issue"] == pytest.approx(15_625 * 2112 * 64 / 33.45408e12)
    assert terms["bytes"] == pytest.approx((64_000_000 + 3_999_992)
                                           / 3.35e12)
    assert rooflines.bound_s(terms) == terms["issue"]
    assert terms["issue"] * 1e3 == pytest.approx(0.063132, rel=1e-4)


def test_fp32_32m_decode_is_bound_by_bytes():
    plan = framing.plan(32_000_000, 2048, 32)
    terms = rooflines.decode_terms(CHANNELS["FP32"], plan)
    assert terms["bytes"] == pytest.approx((256_000_000 + 3_999_992)
                                           / 3.35e12)
    assert rooflines.bound_s(terms) == terms["bytes"]
    assert terms["bytes"] * 1e3 == pytest.approx(0.077612, rel=1e-4)


def test_soft8_1m_decode():
    """1,000,000 source bits: 999,936 decoded, 489 blocks (the last holds
    512 of its 2048)."""
    plan = framing.plan(1_000_000, 2048, 32)
    assert (plan.message_len, plan.num_blocks) == (999_936, 489)
    terms = rooflines.decode_terms(CHANNELS["SOFT8"], plan)
    assert terms["issue"] == pytest.approx(489 * 2112 * 64 / 33.45408e12)
    assert terms["bytes"] == pytest.approx((2_000_000 + 124_992) / 3.35e12)


def test_soft8_32m_generator():
    """A threefry call a stage (32,000,000) and one a pair of the
    1,000,000 message packs (500,000); a Box-Muller a stage."""
    terms = rooflines.generate_terms(CHANNELS["SOFT8"], 32_000_000)
    issue = 32_500_000 * 44 + 32_000_000 * 8
    assert terms["issue"] == pytest.approx(issue / 33.45408e12)
    assert terms["sfu"] == pytest.approx(128_000_000 / 4.18176e12)
    assert terms["bytes"] == pytest.approx((64_000_000 + 4_000_000)
                                           / 3.35e12)
    assert rooflines.bound_s(terms) == terms["issue"]
    assert terms["issue"] * 1e3 == pytest.approx(0.0503975, rel=1e-4)


def test_noiseless_generator_draws_only_message_bits():
    terms = rooflines.generate_terms(CHANNELS["SOFT8"], 64_000, noisy=False)
    assert terms["issue"] == pytest.approx(1000 * 44 / 33.45408e12)
    assert terms["sfu"] == 0


@pytest.mark.parametrize("name,words", [("HARD", 1000), ("SOFT4", 4000),
                                        ("SOFT16", 16000), ("FP32", 32000)])
def test_stream_bytes(name, words):
    assert rooflines.stream_bytes(CHANNELS[name], 16_000) == 4 * words
