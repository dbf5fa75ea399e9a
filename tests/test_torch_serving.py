"""File serving and streaming through the port against the JAX package:
the port's CLI decoding files that the JAX CLI emitted (one-shot, several
files, --stream-words) gives the JAX CLI's own .dec bytes, for every
channel at b32 and b16; StreamingViterbi and run_stream equal the JAX
package's on the same chunks and messages; the file-mode error strings
match; and three repairs of the JAX CLI (a too-short stream leaves no
.dec, a ragged file is refused, one decoder serves every streamed file)."""

import os

import numpy as np
import pytest
import torch

from tpu_viterbi import cli as jcli
from tpu_viterbi.config import (ChannelIn as JChannelIn,
                                DecodeOut as JDecodeOut,
                                DecoderConfig as JDecoderConfig)
from tpu_viterbi.decoder.api import ViterbiTPU
from tpu_viterbi.decoder.streaming import StreamingViterbi as JStreaming
from tpu_viterbi_torch import ViterbiGPU, cli
from tpu_viterbi_torch.config import from_reference
from tpu_viterbi_torch.decoder import streaming
from tpu_viterbi_torch.decoder.streaming import StreamingViterbi

torch.set_num_threads(1)

N = 20_000
SNR = "3"       # noisy enough that decodes err: equality is not trivial
FLAGS = {JChannelIn.HARD: "h", JChannelIn.SOFT4: "s4",
         JChannelIn.SOFT8: "s8", JChannelIn.SOFT16: "s16",
         JChannelIn.FP32: "f"}
CASES = [(ch, o) for ch in FLAGS for o in ("b32", "b16")]


def _ids(case):
    return f"{case[0].name}-{case[1]}"


@pytest.fixture(scope="module")
def emitted(tmp_path_factory):
    """Per (channel, output pack): a stream the JAX CLI emitted, and the
    JAX CLI's one-shot and --stream-words decodes of it."""
    d = tmp_path_factory.mktemp("serving")
    files = {}
    for ch, out in CASES:
        flags = ["-i", FLAGS[ch], "-o", out]
        src = str(d / f"{ch.name}-{out}.bin")
        assert jcli.main(["-n", str(N), "-s", SNR, "--seed", "7",
                          "--emit-file", src, *flags]) == 0
        jdec = src + ".jax.dec"
        assert jcli.main([*flags, "--decode-file", src, "--backend", "xla",
                          "--out-file", jdec]) == 0
        jstream = src + ".jax.stream.dec"
        assert jcli.main([*flags, "--decode-file", src, "--backend", "xla",
                          "--stream-words", "2048",
                          "--out-file", jstream]) == 0
        files[(ch, out)] = (src, jdec, jstream, flags)
    return files


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cli_decode_file_matches_jax(emitted, tmp_path, case, capsys):
    src, jdec, _, flags = emitted[case]
    out = str(tmp_path / "port.dec")
    assert cli.main([*flags, "--decode-file", src, "--out-file", out]) == 0
    assert _bytes(out) == _bytes(jdec)
    text = capsys.readouterr().out.splitlines()
    assert text[0] == "Decode executed."
    assert text[1].startswith("Final results -> ")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cli_stream_words_matches_jax(emitted, tmp_path, case):
    src, _, jstream, flags = emitted[case]
    out = str(tmp_path / "port.dec")
    assert cli.main([*flags, "--decode-file", src, "--stream-words", "2048",
                     "--out-file", out]) == 0
    assert _bytes(out) == _bytes(jstream)


@pytest.mark.parametrize("case", [(JChannelIn.SOFT8, "b32"),
                                  (JChannelIn.HARD, "b16"),
                                  (JChannelIn.FP32, "b32")], ids=_ids)
def test_cli_several_files_match_jax(emitted, tmp_path, case, capsys):
    """Equal-sized files queue through run_stream; a file of another size
    goes through run; each writes <file>.dec, equal to the JAX CLI's."""
    src, jdec, _, flags = emitted[case]
    raw = _bytes(src)
    word = 4
    paths = [str(tmp_path / f"f{i}.bin") for i in range(3)]
    for p, data in zip(paths, (raw, raw, raw[:len(raw) // 2 // word * word])):
        with open(p, "wb") as f:
            f.write(data)
    assert jcli.main([*flags, "--decode-file", paths[2], "--backend", "xla",
                      "--out-file", paths[2] + ".jax"]) == 0
    capsys.readouterr()
    assert cli.main([*flags, "--decode-file", *paths[:2], "-v"]) == 0
    text = capsys.readouterr().out
    assert "2 files queued back to back:" in text
    assert "credibility" not in text
    assert _bytes(paths[0] + ".dec") == _bytes(paths[1] + ".dec") \
        == _bytes(jdec)
    assert cli.main([*flags, "--decode-file", *paths, "-v"]) == 0
    assert "3 files, " in capsys.readouterr().out
    assert _bytes(paths[2] + ".dec") == _bytes(paths[2] + ".jax")


@pytest.mark.parametrize("jcfg", [
    JDecoderConfig(JChannelIn.SOFT8),
    JDecoderConfig(JChannelIn.HARD, decode_out=JDecodeOut.O_B16),
    JDecoderConfig(JChannelIn.SOFT16),
    JDecoderConfig(JChannelIn.FP32, decode_out=JDecodeOut.O_B16),
], ids=lambda c: f"{c.channel_in.name}-{c.decode_out.name}")
def test_streaming_matches_jax_streaming(rng, jcfg):
    """The same uneven chunks (one too short to decode alone) through both
    StreamingViterbis, and a second stream through the same instance."""
    n_words = jcfg.get_input_words(2 * 9_000)
    if jcfg.channel_in == JChannelIn.FP32:
        x = (rng.standard_normal(n_words) * 6).astype(np.float32)
    else:
        x = rng.integers(-2 ** 31, 2 ** 31, size=n_words).astype(np.int32)
    cuts = [0, 1024, 1024 + 8, 3 * 1024, n_words]
    ref = JStreaming(jcfg, dec_len=512, backend="xla")
    port = StreamingViterbi(from_reference(jcfg), dec_len=512,
                            device="cpu")
    for _ in range(2):
        for a, b in zip(cuts, cuts[1:]):
            want, got = ref.push(x[a:b]), port.push(x[a:b])
            assert got.dtype == want.dtype
            assert np.array_equal(got, want)
        want, got = ref.flush(), port.flush()
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert port.flush().size == 0


def test_run_stream_matches_jax(rng):
    jcfg = JDecoderConfig(JChannelIn.SOFT8)
    input_num = 2 * (5_000 + 64)
    xs = [rng.integers(-2 ** 31, 2 ** 31,
                       size=jcfg.get_input_words(input_num) + i)
          .astype(np.int32) for i in range(3)]
    want, _ = ViterbiTPU(jcfg, backend="xla").run_stream(xs, input_num)
    dec = ViterbiGPU(from_reference(jcfg), device="cpu")
    got, per = dec.run_stream(xs, input_num)
    assert per > 0
    assert len(got) == 3
    for g, w, x in zip(got, want, xs):
        assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.array_equal(g, dec.run(x, input_num)[0])
    assert dec.run_stream(xs, input_num, want_time=False)[1] is None
    for bad in ((xs, 100), ([xs[0][:10]], input_num)):
        with pytest.raises(ValueError) as e_port:
            dec.run_stream(*bad)
        with pytest.raises(ValueError) as e_ref:
            ViterbiTPU(jcfg, backend="xla").run_stream(*bad)
        assert str(e_port.value) == str(e_ref.value)


@pytest.mark.parametrize("args", [
    ["-n", "1000", "--decode-file", "x.bin"],
    ["-s", "3", "--decode-file", "x.bin"],
    ["--seed", "1", "--decode-file", "x.bin"],
    ["--emit-file", "y.bin", "--decode-file", "x.bin"],
    ["--decode-file", "x.bin", "z.bin", "--out-file", "o.dec"],
    ["--decode-file", "x.bin", "--stream-words", "1000"],
    ["--decode-file", "x.bin", "--stream-words", "0"],
    ["--stream-words", "1024"],
    ["--out-file", "o.dec"],
], ids=["num", "snr", "seed", "emit", "out-many", "stream-1000",
        "stream-0", "stream-alone", "out-alone"])
def test_file_mode_flag_errors_match_jax(capsys, args):
    rc = cli.main(args)
    got = capsys.readouterr().err
    jrc = jcli.main(args)
    want = capsys.readouterr().err
    assert rc == jrc == -1
    assert got == want and got.startswith("Error: ")


@pytest.mark.parametrize("stream", [[], ["--stream-words", "1024"]],
                         ids=["one-shot", "stream"])
def test_too_short_file_errors_match_jax(tmp_path, capsys, stream):
    p = str(tmp_path / "short.bin")
    np.zeros(20, np.int32).tofile(p)
    assert cli.main(["-i", "s8", "--decode-file", p, *stream]) == 1
    got = capsys.readouterr().err
    assert jcli.main(["-i", "s8", "--decode-file", p, "--backend", "xla",
                      *stream]) == 1
    want = capsys.readouterr().err
    assert got == want and "no decodable bits" in got
    missing = str(tmp_path / "missing.bin")
    assert cli.main(["-i", "s8", "--decode-file", missing, *stream]) == 1
    assert capsys.readouterr().err.startswith(f"Error: cannot read {missing}")


def test_too_short_stream_leaves_no_output(tmp_path, capsys):
    """Repair of the JAX CLI's cli.py:134: its stream mode opens <file>.dec
    before it knows the stream is decodable and leaves it empty."""
    p = str(tmp_path / "short.bin")
    np.zeros(20, np.int32).tofile(p)
    assert cli.main(["-i", "s8", "--decode-file", p,
                     "--stream-words", "1024"]) == 1
    assert "no decodable bits" in capsys.readouterr().err
    assert not os.path.exists(p + ".dec")


@pytest.mark.parametrize("stream", [[], ["--stream-words", "1024"]],
                         ids=["one-shot", "stream"])
def test_ragged_file_is_refused(emitted, tmp_path, capsys, stream):
    """Repair of the JAX CLI's cli.py:230: np.fromfile drops a trailing
    partial word without a word; the port refuses the file, before any
    file of the call is decoded."""
    src, _, _, flags = emitted[(JChannelIn.SOFT8, "b32")]
    good = str(tmp_path / "good.bin")
    ragged = str(tmp_path / "ragged.bin")
    raw = _bytes(src)
    for p, data in ((good, raw), (ragged, raw[:-1])):
        with open(p, "wb") as f:
            f.write(data)
    assert cli.main([*flags, "--decode-file", good, ragged, *stream]) == 1
    err = capsys.readouterr().err
    assert err == (f"Error: {ragged} holds {len(raw) - 1} bytes, not a "
                   f"whole number of 4-byte int32 words (truncated or "
                   f"corrupt channel file).\n")
    assert not os.path.exists(good + ".dec")
    assert not os.path.exists(ragged + ".dec")


def test_one_decoder_serves_every_streamed_file(emitted, tmp_path,
                                                monkeypatch):
    """Repair of the JAX CLI's cli.py:178: in --stream-words mode it builds
    a decoder per file (and one it never uses); the port builds one."""
    built = []

    class Counting(ViterbiGPU):
        def __init__(self, *a, **k):
            built.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(streaming, "ViterbiGPU", Counting)
    monkeypatch.setattr(cli, "ViterbiGPU", Counting)
    src, _, jstream, flags = emitted[(JChannelIn.SOFT4, "b32")]
    paths = []
    for i in range(3):
        p = str(tmp_path / f"s{i}.bin")
        with open(p, "wb") as f:
            f.write(_bytes(src))
        paths.append(p)
    assert cli.main([*flags, "--decode-file", *paths,
                     "--stream-words", "2048"]) == 0
    assert len(built) == 1
    for p in paths:
        assert _bytes(p + ".dec") == _bytes(jstream)


def test_emit_file_matches_jax_format(tmp_path):
    """--emit-file writes the packer's raw words: int32 for the word
    channels, float32 for FP32, sized by getInputSize; the port's CLI
    decodes its own emitted file to BEN 0 at high SNR."""
    from tpu_viterbi_torch.chain import RandBitGen
    from tpu_viterbi_torch.utils.bits import pack_msb_first
    for flag, dtype in (("s16", np.int32), ("f", np.float32)):
        emit = str(tmp_path / f"{flag}.bin")
        assert cli.main(["-n", str(N), "-s", "15", "-i", flag, "--seed", "3",
                         "--emit-file", emit]) == 0
        cfg = from_reference(JDecoderConfig(jcli._CHANNEL_NAMES[flag]))
        assert os.path.getsize(emit) == cfg.get_input_size(2 * N)
        assert np.fromfile(emit, dtype=dtype).shape[0] == \
            cfg.get_input_words(2 * N)
        assert cli.main(["-i", flag, "--decode-file", emit]) == 0
        bits = RandBitGen(N, seed=3).process(None).numpy()
        m = cfg.get_message_len(2 * N)
        assert np.array_equal(np.fromfile(emit + ".dec", np.uint32),
                              pack_msb_first(bits[26:26 + m], 32))
