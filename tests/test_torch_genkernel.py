"""The port's fused workload generator (tpu_viterbi_torch.chain.genkernel)
against the JAX package's (tpu_viterbi.chain.genkernel): threefry2x32, the
Box-Muller pair, and the plain version of kernels K7/K8 against the Pallas
kernel run in interpret mode on the CPU, for every channel.

Both draw the same counter-mode streams, so the message-bit packs and the
noiseless channel streams must be equal bit for bit.  Under noise the two
stacks' f32 log/sin/cos may differ by an ulp, which can move a value across
a rounding boundary: tolerances are stated per test.  The CUDA kernels
themselves are held against this plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_viterbi.chain import genkernel as jgen
from tpu_viterbi.config import ChannelIn as JChannelIn
from tpu_viterbi_torch.chain import genkernel as gen
from tpu_viterbi_torch.chain.quantize import unpack_to_soft
from tpu_viterbi_torch.config import ChannelIn
from tpu_viterbi_torch.sharding.simulate import DEFAULT_SCALES

torch.set_num_threads(1)

N = 33 * 1024 + 13        # not a multiple of 32: the tail pack is masked
CHANNELS = list(ChannelIn)


@functools.lru_cache(maxsize=None)
def _pallas(channel: ChannelIn, snr_db: float, seed: int = 3):
    """packed_workload_pallas in interpret mode, as numpy (cached: one
    interpret-mode run per channel and SNR in this file)."""
    bits, stream = jgen.packed_workload_pallas(
        jax.random.PRNGKey(seed), N, JChannelIn(int(channel)), snr_db,
        DEFAULT_SCALES[channel], interpret=True)
    return np.array(bits), np.array(stream)


def _port(channel: ChannelIn, snr_db: float, seed: int = 3, base: int = 0):
    bits, stream = gen.packed_workload_cuda(
        seed, N, channel, snr_db, DEFAULT_SCALES[channel], device="cpu",
        base=base)
    return bits.numpy(), stream.numpy()


def _counters(rng, n):
    return (rng.integers(0, 2 ** 32, size=n, dtype=np.uint32),
            rng.integers(0, 2 ** 32, size=n, dtype=np.uint32))


def test_threefry_matches_jax_prng(rng):
    from jax._src.prng import threefry_2x32
    c0, c1 = _counters(rng, 1000)
    k = rng.integers(0, 2 ** 32, size=2, dtype=np.uint32)
    want = threefry_2x32(jnp.asarray(k), jnp.stack([jnp.asarray(c0),
                                                    jnp.asarray(c1)]))
    got = gen.threefry2x32(int(k[0]), int(k[1]),
                           torch.from_numpy(c0.view(np.int32)),
                           torch.from_numpy(c1.view(np.int32)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32), np.asarray(w))


@pytest.mark.parametrize("rounds", [5, 13, 20])
def test_threefry_matches_jax_kernel(rng, rounds):
    """The Pallas kernel's threefry at its 13 rounds and at group
    boundaries on either side (key injection after a short last group)."""
    c0, c1 = _counters(rng, 1000)
    k0, k1 = (int(x) for x in rng.integers(0, 2 ** 32, size=2))
    want = jgen.threefry2x32(
        jnp.uint32(k0).view(jnp.int32), jnp.uint32(k1).view(jnp.int32),
        jnp.asarray(c0).view(jnp.int32), jnp.asarray(c1).view(jnp.int32),
        rounds=rounds)
    got = gen.threefry2x32(k0, k1, torch.from_numpy(c0.astype(np.int64)),
                           torch.from_numpy(c1.astype(np.int64)), rounds)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.uint32),
                              np.asarray(w).view(np.uint32))


def test_normal_pair_matches_jax(rng):
    """atol 2e-4, the JAX package's own bound against the closed form
    (tests/test_genkernel.py:62): f32 log/cos/sin differ by ulps."""
    x0, x1 = _counters(rng, 1 << 16)
    want = jgen.normal_pair(jnp.asarray(x0).view(jnp.int32),
                            jnp.asarray(x1).view(jnp.int32))
    got = gen.normal_pair(torch.from_numpy(x0.astype(np.int64)),
                          torch.from_numpy(x1.astype(np.int64)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4)


@pytest.mark.parametrize("channel", CHANNELS, ids=lambda c: c.name)
def test_plain_generator_matches_pallas_noiseless(channel):
    """sigma = 0: bit packs and channel words (FP32: values) equal."""
    want_bits, want = _pallas(channel, math.inf)
    bits, got = _port(channel, math.inf)
    assert bits.dtype == np.int32 and got.dtype == want.dtype
    assert bits.shape == want_bits.shape == (-(-N // 32),)
    assert got.shape == want.shape
    assert np.array_equal(bits, want_bits)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("channel", [ChannelIn.SOFT8, ChannelIn.FP32],
                         ids=lambda c: c.name)
def test_plain_generator_matches_pallas_noisy(channel):
    """3 dB: the bit packs are equal.  SOFT8: at most 1e-4 of the fields
    differ, each by one quantization step (an ulp of z moved a value across
    a rint boundary).  FP32: each value within 4 ulp of the noise term
    scale*sigma*|z| plus 4 ulp of the value (the add's own rounding)."""
    want_bits, want = _pallas(channel, 3.0)
    bits, got = _port(channel, 3.0)
    assert np.array_equal(bits, want_bits)
    if channel == ChannelIn.FP32:
        noise = np.abs(np.abs(want) - DEFAULT_SCALES[channel])
        tol = 4 * (np.spacing(noise.astype(np.float32))
                   + np.spacing(np.abs(want)))
        assert np.all(np.abs(got - want) <= tol)
        assert np.std(want) > 0.5            # the noise is there
        return
    f_got = unpack_to_soft(torch.from_numpy(got), channel).numpy()
    f_want = unpack_to_soft(torch.from_numpy(want), channel).numpy()
    diff = np.abs(f_got.astype(np.int64) - f_want)
    assert np.count_nonzero(diff) <= 1e-4 * diff.size
    assert diff.max() <= 1
    assert np.count_nonzero(np.abs(f_want) != 32) > diff.size // 2


def test_ref_words_from_packs_matches_jax(rng):
    packs = rng.integers(-2 ** 31, 2 ** 31, size=100).astype(np.int32)
    for extra_l, m in ((26, 32 * 99), (26, 32 * 100), (26, 32 * 130),
                       (1, 64)):
        want = jgen.ref_words_from_packs(jnp.asarray(packs), extra_l, m)
        got = gen.ref_words_from_packs(torch.from_numpy(packs), extra_l, m)
        assert np.array_equal(got.numpy().astype(np.uint32),
                              np.asarray(want))


@pytest.mark.parametrize("channel", CHANNELS, ids=lambda c: c.name)
def test_base_generates_the_slice(channel):
    """Counter mode: the stream from word (value) ``base`` on is that slice
    of the base = 0 stream, noise included."""
    full_bits, full = _port(channel, 3.0)
    quantum = 64 if channel == ChannelIn.FP32 else \
        gen.word_format(channel)[2]
    base = quantum * (full.shape[0] // quantum // 3)
    bits, got = _port(channel, 3.0, base=base)
    assert np.array_equal(got, full[base:])
    assert np.array_equal(bits, full_bits[base // quantum:])


def test_key_data_matches_prng_key():
    for seed in (0, 7, 2 ** 31 - 1, -1, -2 ** 31, 2 ** 32 - 1):
        want = np.asarray(jax.random.PRNGKey(seed)).astype(np.uint32)
        assert gen.key_data(seed) == tuple(int(x) for x in want)


def test_wrappers_reject_bad_arguments():
    with pytest.raises(ValueError, match="K8 does"):
        gen.K7(0, 1, 1000, ChannelIn.FP32, 0.0, 4.0)
    with pytest.raises(ValueError, match="K7 does"):
        gen.K8(0, 1, 1000, ChannelIn.SOFT8, 0.0, 32.0)
    with pytest.raises(ValueError, match="multiple of 16"):
        gen.K7(0, 1, 1000, ChannelIn.SOFT8, 0.0, 32.0, base=8)
    with pytest.raises(ValueError, match="multiple of 64"):
        gen.K8(0, 1, 1000, ChannelIn.FP32, 0.0, 4.0, base=2048)
    with pytest.raises(ValueError, match="int32"):
        gen.K8(0, 1, 2 ** 30, ChannelIn.FP32, 0.0, 4.0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        gen.K7(0, 1, 1000, ChannelIn.HARD, 0.0, 1.0, device="meta")


def test_cpu_calls_run_the_plain_version_uncounted():
    before = (gen.K7.launches, gen.K8.launches)
    bits, words = gen.K7(0, 5, 1000, ChannelIn.SOFT4, 0.5, 4.0,
                         device="cpu")
    want = gen.gen_words_torch(0, 5, 1000, ChannelIn.SOFT4, 0.5, 4.0)
    assert torch.equal(bits, want[0]) and torch.equal(words, want[1])
    bits, vals = gen.K8(0, 5, 1000, ChannelIn.FP32, 0.5, 4.0, device="cpu")
    want = gen.gen_values_torch(0, 5, 1000, 0.5, 4.0)
    assert torch.equal(bits, want[0]) and torch.equal(vals, want[1])
    assert (gen.K7.launches, gen.K8.launches) == before


def _pack_table_words(spt):
    """The words of a CTA's shared pack table that csrc/genkernel.cu's
    PackTable<spt>::kWords allots: the packs its GEN_THREADS windows cover
    over every alignment of its first stage, rounded out to whole threefry
    calls."""
    return ((gen.GEN_THREADS - 1) * spt + 31) // 32 + 4


def _brute_calls(n, channel, base, shared, noisy=True):
    """threefry calls of a K7/K8 launch counted thread by thread: the
    distinct non-negative calls p >> 1 of the window packs p of each CTA's
    GEN_THREADS threads (shared), or two a thread of n_out, less the
    negative packs (the first design); plus spt noise calls a thread of
    n_out.  Also the largest table a CTA fills (2 words a call, negative
    calls included)."""
    if channel == ChannelIn.FP32:
        spt, first, n_out = 1, base // 2, n - base // 2
    else:
        vpw = gen.word_format(channel)[1]
        spt, first, n_out = vpw // 2, base * (vpw // 2), -(-2 * n // vpw) - base
    calls, table = 0, 0
    for cta in range(-(-n_out // gen.GEN_THREADS)):
        threads = range(cta * gen.GEN_THREADS, (cta + 1) * gen.GEN_THREADS)
        packs = set()
        for t in threads:
            if shared or t < n_out:
                pk = (first + spt * t - 6) >> 5
                packs |= {pk, pk + 1}
        if shared:
            qs = {p >> 1 for p in packs}
            calls += sum(q >= 0 for q in qs)
            table = max(table, 2 * (max(qs) - min(qs) + 1))
        else:
            for t in threads:
                if t < n_out:
                    pk = (first + spt * t - 6) >> 5
                    calls += (pk >= 0) + (pk + 1 >= 0)
    return calls + (n_out * spt if noisy else 0), table


@pytest.mark.parametrize("channel", CHANNELS, ids=lambda c: c.name)
@pytest.mark.parametrize("n", [300, N, 3 * 256 * 16 + 5])
def test_threefry_calls_and_table_match_a_brute_force_count(channel, n):
    """threefry_calls and the table's size against a thread-by-thread
    count of each CTA's window packs, from base 0 (the first CTA's pack -1),
    a base whose CTAs start on an even pack and one whose start on an odd
    pack; and each design's calls at the 32M-bit headline."""
    quantum = 64 if channel == ChannelIn.FP32 else \
        gen.word_format(channel)[2]
    spt = 1 if channel == ChannelIn.FP32 else \
        gen.word_format(channel)[1] // 2
    n_out = 2 * n if channel == ChannelIn.FP32 else \
        -(-2 * n // gen.word_format(channel)[1])
    for base in (0, quantum, 2 * quantum):
        if base >= n_out:
            continue
        for shared in (True, False):
            want, table = _brute_calls(n, channel, base, shared)
            assert gen.threefry_calls(n, channel, base, shared) == want
            assert gen.threefry_calls(n, channel, base, shared,
                                      noisy=False) == \
                _brute_calls(n, channel, base, shared, noisy=False)[0]
            if shared:
                assert table <= _pack_table_words(spt)
    # the bound is reached: some alignment fills the whole table
    assert max(_brute_calls(2 ** 16, channel, b * quantum, True)[1]
               for b in range(4)) >= _pack_table_words(spt) - 2


def test_threefry_calls_at_the_headline():
    """32M bits: the first design draws two window calls a thread (K7
    SOFT8 64M, K8 96M with the noise), the shared tables about one a CTA's
    pack pair: both under 33.6M."""
    n = 32_000_000
    assert gen.threefry_calls(n, ChannelIn.SOFT8, shared=False) == \
        2 * (n // 2) - 3 + n
    assert gen.threefry_calls(n, ChannelIn.FP32, shared=False) == \
        2 * n - 6 + n
    for channel in CHANNELS:
        assert n < gen.threefry_calls(n, channel) < 33_600_000
