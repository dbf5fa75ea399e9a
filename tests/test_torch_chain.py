"""The port's simulation chain (tpu_viterbi_torch.chain, utils.bits) against
the JAX package's, bit for bit where both are fed the same bits or floats:
the encoder, the quantizer/packer for every channel (half-even ties
included), the unpacker and the BER count.  The random elements (bit
source, AWGN) draw from torch generators, not threefry, so they are held to
determinism and statistics only."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_viterbi import chain as jchain
from tpu_viterbi.config import ChannelIn as JChannelIn
from tpu_viterbi.utils import bits as jbits
from tpu_viterbi_torch import chain
from tpu_viterbi_torch.config import ChannelIn
from tpu_viterbi_torch.utils import bits

torch.set_num_threads(1)

CHANNELS = list(ChannelIn)


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_conv_encode_matches_jax(rng, n):
    b = rng.integers(0, 2, size=n).astype(np.uint8)
    want = np.asarray(jchain.conv_encode(jnp.asarray(b)))
    got = chain.conv_encode(torch.from_numpy(b)).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, want)
    assert np.array_equal(chain.conv_encode_np(b), want)


def _soft_values(rng, n):
    """Gaussian values plus exact half-integer ties and saturating values
    at scale 1: rint must round half to even on both sides."""
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 7.5, -8.5, 126.5,
                     -127.5, 0.0, -0.0, 1e6, -1e6, 40000.5, -40000.5],
                    np.float32)
    vals = (rng.standard_normal(n) * 50).astype(np.float32)
    return np.concatenate([ties, vals])


@pytest.mark.parametrize("channel", CHANNELS, ids=lambda c: c.name)
@pytest.mark.parametrize("scale", [1.0, 40000.0])
def test_quantize_and_pack_matches_jax(rng, channel, scale):
    v = _soft_values(rng, 333)          # not a whole number of words
    want = np.asarray(jchain.quantize_and_pack(
        jnp.asarray(v), JChannelIn(int(channel)), scale))
    got = chain.quantize_and_pack(torch.from_numpy(v), channel, scale)
    assert got.dtype == (torch.float32 if channel == ChannelIn.FP32
                         else torch.int32)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("channel", CHANNELS[:4], ids=lambda c: c.name)
def test_quantize_fields_match_jax(rng, channel):
    v = _soft_values(rng, 64)
    want, wwidth = jchain.quantize_fields(jnp.asarray(v),
                                          JChannelIn(int(channel)), 3.0)
    got, width = chain.quantize_fields(torch.from_numpy(v), channel, 3.0)
    assert width == wwidth
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("channel", CHANNELS, ids=lambda c: c.name)
def test_unpack_to_soft_matches_jax(rng, channel):
    if channel == ChannelIn.FP32:
        w = (rng.standard_normal(200) * 10).astype(np.float32)
    else:
        w = rng.integers(-2 ** 31, 2 ** 31, size=200).astype(np.int32)
    want = np.asarray(jchain.unpack_to_soft(jnp.asarray(w),
                                            JChannelIn(int(channel))))
    got = chain.unpack_to_soft(torch.from_numpy(w), channel).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bpp", [16, 32])
@pytest.mark.parametrize("n_err", [0, 1, 97])
def test_count_bit_errors_matches_jax(rng, bpp, n_err):
    """Decoded words vs a bit stream at the extra_l offset, with the
    reference shorter than the decoded span (m % 32 == 16 at bpp 16)."""
    offset, m = 26, 16 * 73
    msg = rng.integers(0, 2, size=offset + m + 5).astype(np.uint8)
    dec_bits = msg[offset:offset + m].copy()
    flip = rng.choice(m, size=n_err, replace=False)
    dec_bits[flip] ^= 1
    pad = (-m) % bpp
    words = bits.pack_msb_first(np.concatenate(
        [dec_bits, np.zeros(pad, np.uint8)]), bpp)
    want = jbits.count_bit_errors(words, bpp, msg, offset)
    as_i32 = torch.from_numpy(words.astype(np.int64)).to(torch.int32) \
        if bpp == 16 else torch.from_numpy(words.view(np.int32))
    got = bits.count_bit_errors(as_i32, bpp, torch.from_numpy(msg), offset)
    assert got == want
    if pad == 0:
        assert got == n_err
    # a reference stream shorter than the decoded words counts only its bits
    short = torch.from_numpy(msg[:offset + m - 40])
    assert bits.count_bit_errors(as_i32, bpp, short, offset) == \
        jbits.count_bit_errors(words, bpp, msg[:offset + m - 40], offset)


def test_numpy_bit_helpers_match_jax(rng):
    for bpp in (16, 32):
        b = rng.integers(0, 2, size=bpp * 9).astype(np.uint8)
        w = bits.pack_msb_first(b, bpp)
        assert np.array_equal(w, jbits.pack_msb_first(b, bpp))
        assert np.array_equal(bits.unpack_msb_first(w, bpp), b)


def test_popcount_swar():
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555, 0x0F0F0F0F,
                      0x12345678], dtype=torch.int64)
    want = [bin(int(v)).count("1") for v in x]
    assert bits._popcount32(x).tolist() == want


def test_channel_matches_jax_noiseless(rng):
    b = rng.integers(0, 2, size=500).astype(np.uint8)
    assert chain.snr_to_sigma(5.5) == jchain.snr_to_sigma(5.5)
    want = np.asarray(jchain.bpsk(jnp.asarray(b)))
    assert np.array_equal(chain.bpsk(torch.from_numpy(b)).numpy(), want)
    g = torch.Generator().manual_seed(0)
    for sigma in (0.0, math.inf):
        out = chain.add_awgn(g, torch.from_numpy(b), sigma)
        assert np.array_equal(out.numpy(), want)


def test_awgn_statistics():
    g = torch.Generator().manual_seed(0)
    b = torch.ones(200_000, dtype=torch.uint8)
    out = chain.add_awgn(g, b, 0.5)
    assert abs(float(out.mean()) - 1.0) < 0.01
    assert abs(float(out.std()) - 0.5) < 0.01


def test_rand_bit_gen_seeded_and_fresh():
    a = chain.RandBitGen(10_000, seed=5, device="cpu")
    b = chain.RandBitGen(10_000, seed=5, device="cpu")
    x1, x2 = a.process(None), a.process(None)
    assert torch.equal(x1, b.process(None))        # same seed, same bits
    assert not torch.equal(x1, x2)                 # each call draws anew
    assert x1.dtype == torch.uint8 and set(x1.unique().tolist()) == {0, 1}
    assert abs(float(x1.float().mean()) - 0.5) < 0.03


def test_pipeline_probe_and_timing():
    src = chain.RandBitGen(256, seed=1, device="cpu").probe()
    enc = chain.ConvolutionalEncoder()
    pipe = src | enc
    res = pipe.run()
    assert len(res.probed_outputs) == 1
    assert torch.equal(res.final_output,
                       chain.conv_encode(res.probed_outputs[0]))
    assert src.get_status("Elapsed run time") >= 0
    text = "\n".join(pipe.status_lines())
    assert "Element 1 (type: ConvolutionalEncoder):" in text
    with pytest.raises(NotImplementedError):
        chain.ConvolutionalEncoder(poly1=0o133)


def test_soft_decision_packer_element(rng):
    v = _soft_values(rng, 100)
    el = chain.SoftDecisionPacker(ChannelIn.SOFT8, scale=40000.0)
    assert torch.equal(el.process(torch.from_numpy(v)),
                       chain.quantize_and_pack(torch.from_numpy(v),
                                               ChannelIn.SOFT8, 40000.0))
