"""The port's in-graph simulation (tpu_viterbi_torch.sharding.simulate) and
its CLI (--e2e-device, --generator) against the JAX package's, on the CPU:
both generators decode to zero errors without noise (b32, b16 with
m % 32 == 16, FP32); under noise the port counts, on the words JAX's
generator draws, exactly the errors JAX's one-device simulation counts; the
CLI's output lines and rejections match the JAX CLI's; dec_len 'auto' is
resolved from the size JAX's one-device simulation resolves it from."""

import math
import re

import jax
import numpy as np
import pytest
import torch

from tpu_viterbi import cli as jcli
from tpu_viterbi.chain.genkernel import packed_workload_pallas
from tpu_viterbi.chain.workload import packed_workload as jpacked_workload
from tpu_viterbi.config import (ChannelIn as JChannelIn,
                                DecodeOut as JDecodeOut,
                                DecoderConfig as JDecoderConfig)
from tpu_viterbi.decoder.core_xla import auto_dec_len as jauto_dec_len
from tpu_viterbi.sharding.blocks import sharded_stage_count
from tpu_viterbi.sharding.mesh import make_block_mesh
from tpu_viterbi.sharding.simulate import (build_sharded_simulation as
                                           jbuild_simulation,
                                           simulate_sharded as jsimulate)
from tpu_viterbi_torch import ViterbiGPU, cli
from tpu_viterbi_torch.chain.genkernel import ref_words_from_packs
from tpu_viterbi_torch.config import (ChannelIn, DecodeOut, DecoderConfig,
                                      from_reference)
from tpu_viterbi_torch.sharding import simulate as sim

torch.set_num_threads(1)


@pytest.mark.parametrize("generator", ["cuda", "torch"])
@pytest.mark.parametrize("cfg,n", [
    (DecoderConfig(ChannelIn.SOFT8), 8 * 1024 + 7),
    (DecoderConfig(ChannelIn.SOFT8, decode_out=DecodeOut.O_B16),
     8 * 1024 + 16),                             # m % 32 == 16
    (DecoderConfig(ChannelIn.HARD, decode_out=DecodeOut.O_B16), 5000),
    (DecoderConfig(ChannelIn.FP32), 8 * 1024 + 7),
], ids=["SOFT8-b32", "SOFT8-b16-odd-half", "HARD-b16", "FP32-b32"])
def test_noiseless_simulation_ben0(cfg, n, generator):
    fn, m = sim.build_sharded_simulation(cfg, n, snr_db=math.inf,
                                         dec_len=512, generator=generator,
                                         device="cpu", return_output=True)
    assert m == cfg.get_message_len(2 * n)
    if n == 8 * 1024 + 16:
        assert m % 32 == 16
    ben, out = fn(5)
    assert ben.dim() == 0 and int(ben) == 0
    assert out.shape == (m // cfg.bits_per_pack,)
    assert sim.simulate_sharded(cfg, n, snr_db=math.inf, seed=6, dec_len=512,
                                generator=generator, device="cpu") == (0, m)


NOISY_CONFIGS = [JDecoderConfig(JChannelIn.SOFT8),
                 JDecoderConfig(JChannelIn.FP32,
                                decode_out=JDecodeOut.O_B16)]


@pytest.mark.parametrize("jcfg", NOISY_CONFIGS,
                         ids=lambda c: f"{c.channel_in.name}-"
                                       f"b{c.bits_per_pack}")
def test_counts_jax_generated_words_like_jax(jcfg):
    """0.5 dB at the default scales: JAX's pallas-generated words (interpret
    mode), decoded and counted by the port's simulation, give the count
    JAX's one-device simulate_sharded gives, exactly; a flipped decoded bit
    adds one.  The port's own generator (its plain version here) draws the
    same streams up to an f32 ulp: its count is held within 1 %."""
    n, seed, snr = 65536, 5, 0.5
    want, m = jsimulate(jcfg, n, make_block_mesh(jax.devices()[:1]),
                        snr_db=snr, seed=seed, generator="pallas")
    cfg = from_reference(jcfg)
    bits, words = packed_workload_pallas(
        jax.random.PRNGKey(seed), n, jcfg.channel_in, snr,
        sim.DEFAULT_SCALES[cfg.channel_in], interpret=True)
    out, _ = ViterbiGPU(cfg, backend="torch", device="cpu").run_on_device(
        torch.from_numpy(np.array(words)), 2 * n)
    ref32 = ref_words_from_packs(torch.from_numpy(np.array(bits)),
                                 cfg.extra_l, -(-m // 32) * 32)
    got = int(sim.count_errors(out, ref32, cfg.bits_per_pack, m))
    assert 100 < want < m // 20                 # noisy, and decoding
    assert got == want
    out[0] ^= 1 << (cfg.bits_per_pack - 1)
    assert int(sim.count_errors(out, ref32, cfg.bits_per_pack, m)) in (
        want - 1, want + 1)
    own, m2 = sim.simulate_sharded(cfg, n, snr_db=snr, seed=seed,
                                   generator="cuda", device="cpu")
    assert m2 == m and abs(own - want) <= want // 100


def _jax_auto_dec_len(n: int, bpp: int) -> int:
    """JAX's one-device simulation's 'auto' (sharding/simulate.py:101-104)."""
    return jauto_dec_len(sharded_stage_count(n, 1, bpp), bpp)


@pytest.mark.parametrize("bpp", [32, 16])
def test_auto_dec_len_resolves_like_jax(bpp):
    """'auto' is JAX's dec_len at every message length of a sweep (the
    decoded length m, which ViterbiGPU's own 'auto' reads, gives another at
    thousands of them); a number passes through."""
    for n in (8200, 41024, *range(200, 1_100_000, 13)):
        assert sim.resolve_dec_len("auto", n, bpp) == \
            _jax_auto_dec_len(n, bpp), n
    assert sim.resolve_dec_len(512, 8200, bpp) == 512


@pytest.mark.parametrize("n,want", [(8200, 96), (41024, 352)])
def test_simulation_builds_the_decoder_with_jax_auto_dec_len(monkeypatch, n,
                                                             want):
    seen = []

    class Spy(sim.ViterbiGPU):
        def __init__(self, *args, **kwargs):
            seen.append(kwargs["dec_len"])
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(sim, "ViterbiGPU", Spy)
    sim.build_sharded_simulation(DecoderConfig(ChannelIn.SOFT8), n,
                                 dec_len="auto", device="cpu")
    assert seen == [want] == [_jax_auto_dec_len(n, 32)]


def test_auto_dec_len_counts_jax_xla_words_like_jax(monkeypatch):
    """SOFT8 at 0.5 dB, dec_len 'auto', n = 41024 (JAX's 352, the decoded
    length's 320): the port's simulation on the words JAX's xla generator
    draws counts what JAX's one-device simulation counts."""
    n, seed, snr = 41024, 1, 0.5
    jcfg = JDecoderConfig(JChannelIn.SOFT8)
    want, m = jsimulate(jcfg, n, make_block_mesh(jax.devices()[:1]),
                        snr_db=snr, seed=seed, generator="xla",
                        dec_len="auto")
    cfg = from_reference(jcfg)
    bits, words = jpacked_workload(jax.random.PRNGKey(seed), n,
                                   jcfg.channel_in, snr,
                                   sim.DEFAULT_SCALES[cfg.channel_in])
    monkeypatch.setattr(sim, "packed_workload", lambda *args: (
        torch.from_numpy(np.array(bits)), torch.from_numpy(np.array(words))))
    fn, m2 = sim.build_sharded_simulation(cfg, n, snr_db=snr,
                                          dec_len="auto", generator="torch",
                                          device="cpu")
    assert m2 == m and 100 < want < m // 20
    assert int(fn(seed)) == want


def test_generator_and_length_rejections_match_jax():
    cfg = DecoderConfig(ChannelIn.SOFT8)
    jcfg = JDecoderConfig(JChannelIn.SOFT8)
    mesh = make_block_mesh(jax.devices()[:1])
    with pytest.raises(ValueError) as want:
        jbuild_simulation(jcfg, 8 * 2048, mesh, generator="Pallas")
    with pytest.raises(ValueError) as got:
        sim.build_sharded_simulation(cfg, 8 * 2048, generator="Cuda",
                                     device="cpu")
    assert str(got.value).startswith("unknown generator 'Cuda'")
    assert str(got.value).replace("Cuda", "Pallas").replace(
        "'cuda' or 'torch'", "'pallas' or 'xla'") == str(want.value)
    with pytest.raises(ValueError) as want:
        jbuild_simulation(jcfg, 40, mesh)
    with pytest.raises(ValueError) as got:
        sim.build_sharded_simulation(cfg, 40, device="cpu")
    assert str(got.value) == str(want.value)


E2E_ARGS = ["-n", "20000", "-s", "15", "-i", "s8", "--seed", "3",
            "--e2e-device", "-v"]


def test_cli_e2e_output_lines_match_jax(capsys):
    assert cli.main(E2E_ARGS + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jcli.main(E2E_ARGS) == 0
    want = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 14
    assert got[:8] == want[:8]                   # config header, blank lines
    m = 19936
    assert re.fullmatch(rf"In-graph chain over \d+ device\(s\): {m} bits "
                        r"decoded", want[8])
    assert got[8] == f"In-graph chain over 1 device(s): {m} bits decoded"
    assert re.fullmatch(r"  - first call \(includes compile\): [\d.]+ s",
                        want[9])
    assert re.fullmatch(r"  - first call \(includes the kernel build\): "
                        r"[\d.]+ s", got[9])
    steady = (r"  - steady-state per call: [\d.]+ ms \([\d.e+-]+ Gb/s "
              r"e2e\)   \[BEN 0\]")
    assert re.fullmatch(steady, want[10]) and re.fullmatch(steady, got[10])
    assert got[11:] == want[11:] == ["", "Pipeline executed.",
                                     "Final results -> BEN: 0   BER: 0"]


@pytest.mark.parametrize("flags", [["--generator", "torch"],
                                   ["--survivor", "window"],
                                   ["-i", "f", "-o", "b16"],
                                   ["-i", "h", "--dec-len", "auto"]])
def test_cli_e2e_paths_decode_without_error(capsys, flags):
    assert cli.main(["-n", "6000", "-s", "15", "--seed", "4",
                     "--e2e-device", "--device", "cpu"] + flags) == 0
    assert capsys.readouterr().out.splitlines()[-2:] == [
        "Pipeline executed.", "Final results -> BEN: 0   BER: 0"]


def _errors(capsys, port_args, jax_args):
    rc = cli.main(port_args)
    got = capsys.readouterr().err
    jrc = jcli.main(jax_args)
    want = capsys.readouterr().err
    assert rc == jrc == -1
    return got, want


@pytest.mark.parametrize("port,jax_flag", [
    (["--generator", "cuda"], ["--generator", "pallas"]),
    (["--generator", "torch"], ["--generator", "xla"]),
])
def test_cli_generator_requires_e2e_matches_jax(capsys, port, jax_flag):
    base = ["-n", "40000", "-s", "15", "--seed", "5"]
    got, want = _errors(capsys, base + port, base + jax_flag)
    assert got == want
    assert got.startswith("Error: --generator requires --e2e-device")


@pytest.mark.parametrize("port,jax_flag", [
    (["--e2e-device"], ["--e2e-device"]),
    (["--generator", "cuda"], ["--generator", "pallas"]),
])
def test_cli_e2e_flags_refused_with_decode_file(tmp_path, capsys, port,
                                                jax_flag):
    f = tmp_path / "c.bin"
    np.zeros(1024, np.int32).tofile(f)
    base = ["-i", "s8", "--decode-file", str(f)]
    got, want = _errors(capsys, base + port, base + jax_flag)
    assert got == want
    assert "is not applicable with --decode-file" in got


@pytest.mark.parametrize("port", [["--backend", "torch"],
                                  ["--backend", "cuda"],
                                  ["--emit-file", "never_written.bin"]])
def test_cli_e2e_refusals_follow_jax_pattern(tmp_path, capsys, port):
    """--backend is refused as the JAX CLI refuses it (the reason names the
    GPU's memory fit where JAX's names VMEM); --emit-file, which the JAX
    CLI silently ignores under --e2e-device, is refused in the same
    pattern and writes nothing."""
    base = ["-n", "40000", "-s", "15", "--seed", "5", "--e2e-device"]
    port = [str(tmp_path / a) if a.endswith(".bin") else a for a in port]
    got, want = _errors(capsys, base + port, base + ["--backend", "xla"])
    pattern = r"Error: (\S+) is not applicable with --e2e-device \(.+\)\.\n"
    jflag = re.fullmatch(pattern, want)
    flag = re.fullmatch(pattern, got)
    assert jflag and jflag.group(1) == "--backend"
    assert flag and flag.group(1) == port[0]
    if port[0] == "--backend":
        assert got.split(" (")[0] == want.split(" (")[0]
    assert not (tmp_path / "never_written.bin").exists()


def test_cli_generator_cuda_without_gpu_refused(capsys):
    """--generator cuda on --device cpu is refused like --backend cuda."""
    base = ["-n", "40000", "-s", "15", "--seed", "5", "--device", "cpu"]
    assert cli.main(base + ["--e2e-device", "--generator", "cuda"]) == -1
    got = capsys.readouterr().err
    assert cli.main(base + ["--backend", "cuda"]) == -1
    backend = capsys.readouterr().err
    assert got.startswith("Error: generator='cuda' needs a CUDA device")
    assert backend.startswith("Error: backend='cuda' needs a CUDA device")
