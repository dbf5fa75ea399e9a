"""The port's host ops (tpu_viterbi_torch.utils.native, its own copy of
csrc/host_ops.cpp built with g++ into tpu_viterbi_torch/_build/) against
the port's quantizer, unpacker and BER counts, and against the JAX
package's quantizer on the CPU: all bit-exact.  The build lands in
_build/ and leaves the JAX package's tracked library untouched; a failed
build raises with the compiler's message (the JAX module returns None)."""

import hashlib
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_viterbi import chain as jchain
from tpu_viterbi.config import ChannelIn as JChannelIn
from tpu_viterbi_torch import library
from tpu_viterbi_torch.chain import (conv_encode_np, quantize_and_pack,
                                     unpack_to_soft)
from tpu_viterbi_torch.chain.genkernel import ref_words_from_packs
from tpu_viterbi_torch.config import ChannelIn
from tpu_viterbi_torch.sharding.simulate import DEFAULT_SCALES, count_errors
from tpu_viterbi_torch.utils import bits, native

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = {ChannelIn.HARD: 1, ChannelIn.SOFT4: 4, ChannelIn.SOFT8: 8,
          ChannelIn.SOFT16: 16}


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _full_range(rng, n):
    """Gaussian values of every scale, exact half-integer ties on both
    sides of zero and values past every field's saturation."""
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 7.5, -8.5, 126.5,
                     -127.5, 32766.5, -32767.5, 0.0, -0.0, 1e6, -1e6,
                     40000.5, -40000.5], np.float32)
    return np.concatenate([ties, (rng.standard_normal(n) * 3).astype(
        np.float32), (rng.standard_normal(n) * 4e4).astype(np.float32)])


@pytest.mark.parametrize("channel", list(WIDTHS), ids=lambda c: c.name)
def test_quantize_pack_matches_port_at_zero_noise(rng, channel):
    """sigma = 0: a coded message's +-1 symbols at the simulation's scale
    (a partial last word too) pack to the port quantizer's words."""
    sym = 2 * conv_encode_np(rng.integers(0, 2, 1001).astype(
        np.uint8)).astype(np.float32) - 1
    scale = DEFAULT_SCALES[channel]
    want = quantize_and_pack(torch.from_numpy(sym), channel, scale).numpy()
    got = native.native_quantize_pack(sym, WIDTHS[channel], scale)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("channel", list(WIDTHS), ids=lambda c: c.name)
@pytest.mark.parametrize("scale", [1.0, 2.5, 40000.0])
def test_quantize_pack_full_range_matches_port_and_jax(rng, channel, scale):
    v = _full_range(rng, 1000)                # 2018: not whole words
    got = native.native_quantize_pack(v, WIDTHS[channel], scale)
    port = quantize_and_pack(torch.from_numpy(v), channel, scale).numpy()
    jax = np.asarray(jchain.quantize_and_pack(
        jnp.asarray(v), JChannelIn(int(channel)), scale))
    assert np.array_equal(got, port)
    assert np.array_equal(got, jax)


@pytest.mark.parametrize("channel", list(WIDTHS), ids=lambda c: c.name)
def test_unpack_soft_inverts_quantize_pack(rng, channel):
    """The unpacked values are the quantized fields (HARD: +-1), equal to
    unpack_to_soft's; full-range words unpack alike too."""
    width = WIDTHS[channel]
    v = _full_range(rng, 500)
    words = native.native_quantize_pack(v, width, 1.0)
    got = native.native_unpack_soft(words, width)
    assert got.dtype == np.int32 and got.shape == (len(words) * 32 // width,)
    if channel == ChannelIn.HARD:
        want = np.where(v > 0, 1, -1)
    else:
        lim = 1 << (width - 1)
        want = np.clip(np.rint(v), -lim, lim - 1)
    assert np.array_equal(got[:len(v)], want)
    assert np.all(got[len(v):] == (-1 if width == 1 else 0))
    assert np.array_equal(got, unpack_to_soft(torch.from_numpy(words),
                                              channel).numpy())
    w = rng.integers(-2 ** 31, 2 ** 31, 257).astype(np.int32)
    assert np.array_equal(native.native_unpack_soft(w, width),
                          unpack_to_soft(torch.from_numpy(w),
                                         channel).numpy())


@pytest.mark.parametrize("bpp", [32, 16])
@pytest.mark.parametrize("n_words,short", [(100, 0), (100, 7), (1, 0),
                                           (3, 1), (64, 16)])
def test_count_bit_errors_matches_port(rng, bpp, n_words, short):
    """Random decoded packs against a message whose tail ends mid-pack:
    the count is utils.bits.count_bit_errors' at the same offset."""
    offset = 26
    words = rng.integers(0, 2 ** bpp, size=n_words).astype(
        np.uint32 if bpp == 32 else np.uint16)
    msg = rng.integers(0, 2, size=offset + n_words * bpp - short).astype(
        np.uint8)
    got = native.native_count_bit_errors(words, bpp, msg[offset:])
    want = bits.count_bit_errors(torch.from_numpy(words.astype(np.int64)),
                                 bpp, torch.from_numpy(msg), offset)
    assert got == want > 0
    msg[offset::37] ^= 1
    assert native.native_count_bit_errors(
        bits.pack_msb_first(msg[offset:offset + (len(msg) - offset) //
                                bpp * bpp], bpp), bpp, msg[offset:]) == 0


@pytest.mark.parametrize("bpp,m", [(32, 32 * 40), (16, 16 * 81)],
                         ids=["b32", "b16-odd-half"])
def test_count_bit_errors_matches_simulation_count(rng, bpp, m):
    """The in-graph simulation's count (sharding/simulate.count_errors),
    m % 32 == 16 at b16 included, equals the native count."""
    extra_l = 26
    msg = rng.integers(0, 2, size=m + 64).astype(np.uint8)
    packs = bits.pack_msb_first(np.concatenate(
        [msg, np.zeros((-len(msg)) % 32, np.uint8)]), 32).view(np.int32)
    ref32 = ref_words_from_packs(torch.from_numpy(packs), extra_l,
                                 -(-m // 32) * 32)
    out = bits.pack_msb_first(msg[extra_l:extra_l + m], bpp).astype(np.int64)
    out[rng.integers(0, len(out), 9)] ^= rng.integers(1, 2 ** bpp, 9)
    want = native.native_count_bit_errors(out, bpp, msg[extra_l:extra_l + m])
    got = int(count_errors(torch.from_numpy(out), ref32, bpp, m))
    assert got == want > 0


def test_library_builds_into_build_dir(tmp_path, monkeypatch):
    """A fresh build goes to the build directory, keyed by the source; the
    JAX package's tracked library and source keep their bytes."""
    tracked = [ROOT / "csrc" / "libviterbi_host.so",
               ROOT / "csrc" / "host_ops.cpp"]
    before = [_sha(p) for p in tracked]
    assert native.library_path().parent == library.BUILD_DIR == \
        ROOT / "tpu_viterbi_torch" / "_build"
    assert native.SOURCE == ROOT / "tpu_viterbi_torch" / "csrc" / \
        "host_ops.cpp"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.get_lib()
    assert native.get_lib() is lib
    built = list((tmp_path / "build").iterdir())
    assert built == [native.library_path()]
    assert built[0].name.startswith("libviterbi_host_")
    assert "-march=native" not in native.GXX_FLAGS
    assert [_sha(p) for p in tracked] == before
    v = np.linspace(-3, 3, 97, dtype=np.float32)
    assert np.array_equal(native.native_quantize_pack(v, 8, 10.0),
                          quantize_and_pack(torch.from_numpy(v),
                                            ChannelIn.SOFT8, 10.0).numpy())


def test_failed_build_raises_with_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("extern \"C\" int broken( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed building "
                       r"host_ops.cpp \(rc \d+\):\n.*error:"):
        native.get_lib()
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_compiler_and_bad_widths_raise(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="bits_per_pack must be 32 or 16"):
        native.native_count_bit_errors(np.zeros(2, np.uint32), 8,
                                       np.zeros(16, np.uint8))
    for fn in (lambda: native.native_quantize_pack(np.zeros(4), 2),
               lambda: native.native_unpack_soft(np.zeros(4, np.int32), 32)):
        with pytest.raises(ValueError, match="field width"):
            fn()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.find_gxx()


def test_count_is_zero_on_a_clean_decode(rng):
    msg = rng.integers(0, 2, size=320).astype(np.uint8)
    for bpp in (32, 16):
        words = bits.pack_msb_first(msg, bpp)
        assert native.native_count_bit_errors(words, bpp, msg) == 0
        flipped = msg.copy()
        flipped[::37] ^= 1
        assert native.native_count_bit_errors(words, bpp, flipped) == \
            math.ceil(320 / 37)
