"""The port's slice end to end against the JAX package: ViterbiGPU against
ViterbiTPU on the same packed streams, the whole chain fed the same bits
and noise, the CLI's output and error strings, and a jax-free import of
the port."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_viterbi import chain as jchain
from tpu_viterbi import cli as jcli
from tpu_viterbi.chain.decoder_element import ViterbiDecoder as JViterbiDecoder
from tpu_viterbi.chain.pipeline import ComputeElement as JElement
from tpu_viterbi.config import (ChannelIn as JChannelIn,
                                DecodeOut as JDecodeOut,
                                DecoderConfig as JDecoderConfig,
                                Metric as JMetric)
from tpu_viterbi.decoder.api import ViterbiTPU
from tpu_viterbi.utils.bits import count_bit_errors as jcount_bit_errors
from tpu_viterbi_torch import ConfigResolutionError, ViterbiGPU, chain, cli
from tpu_viterbi_torch.chain.decoder_element import ViterbiDecoder
from tpu_viterbi_torch.config import from_reference
from tpu_viterbi_torch.utils.bits import count_bit_errors

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_CONFIGS = [
    JDecoderConfig(JChannelIn.SOFT8, JMetric.M_B32, JDecodeOut.O_B32),
    JDecoderConfig(JChannelIn.HARD, JMetric.M_B16, JDecodeOut.O_B16),
    JDecoderConfig(JChannelIn.FP32, JMetric.M_B32, JDecodeOut.O_B32),
]


@pytest.mark.parametrize("jcfg", SLICE_CONFIGS,
                         ids=lambda c: f"{c.channel_in.name}-"
                                       f"{c.decode_out.name}")
def test_viterbi_gpu_torch_matches_viterbi_tpu_xla(rng, jcfg):
    input_num = 2 * (9_000 + 64) + 6        # 5 blocks, partial last one
    n_words = jcfg.get_input_words(input_num) + 3   # longer than needed
    if jcfg.channel_in == JChannelIn.FP32:
        x = (rng.standard_normal(n_words) * 6).astype(np.float32)
    else:
        x = rng.integers(-2 ** 31, 2 ** 31, size=n_words).astype(np.int32)
    want, _ = ViterbiTPU(jcfg, backend="xla").run(x, input_num)
    dec = ViterbiGPU(from_reference(jcfg), backend="torch", device="cpu")
    got, seconds = dec.run(x, input_num)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert seconds > 0
    # a tensor input decodes the same as the numpy array
    got_t, _ = dec.run_on_device(torch.from_numpy(x), input_num)
    assert np.array_equal(got_t.numpy().astype(np.int64)
                          & ((1 << jcfg.bits_per_pack) - 1),
                          want.astype(np.int64))


def test_run_rejections_match_viterbi_tpu():
    jcfg = SLICE_CONFIGS[0]
    port = ViterbiGPU(from_reference(jcfg), backend="torch", device="cpu")
    ref = ViterbiTPU(jcfg, backend="xla")
    for x, n in ((np.zeros(10, np.int32), 100),      # no message bits
                 (np.zeros(10, np.int32), 4000)):    # too few words
        with pytest.raises(ValueError) as want:
            ref.run(x, n)
        with pytest.raises(ValueError) as got:
            port.run(x, n)
        assert str(got.value) == str(want.value)


def test_backend_and_survivor_resolution():
    cfg = from_reference(SLICE_CONFIGS[0])
    with pytest.raises(ValueError, match="backend"):
        ViterbiGPU(cfg, backend="pallas")
    with pytest.raises(ValueError, match="survivor"):
        ViterbiGPU(cfg, survivor="ring")
    # the plain core decodes the window too; 'auto' on the CPU is the
    # full store
    assert ViterbiGPU(cfg, backend="torch", device="cpu",
                      survivor="window").window(40_000)
    auto_cpu = ViterbiGPU(cfg, device="cpu")
    assert not auto_cpu.use_kernel                 # auto on the CPU: torch
    assert not auto_cpu.window(40_000)
    assert ViterbiGPU(cfg, device="cpu", input_num=40_000).plan(
        40_000).dec_len == 2048


def test_backend_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: backend='cuda' resolves")
    cfg = from_reference(SLICE_CONFIGS[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViterbiGPU(cfg, backend="cuda")
    with pytest.raises(ConfigResolutionError, match="CUDA device"):
        ViterbiGPU(cfg, backend="cuda", device="cpu")


class _Const(JElement):
    """Emits a fixed value (JAX side)."""

    def __init__(self, value):
        super().__init__()
        self.value = value

    def process(self, data):
        return self.value


class _ConstT(chain.ComputeElement):
    def __init__(self, value):
        super().__init__()
        self.value = value

    def process(self, data):
        return self.value


class _NoiseT(chain.ComputeElement):
    def __init__(self, noise):
        super().__init__()
        self.noise = noise

    def process(self, coded):
        return chain.bpsk(coded) + self.noise


class _NoiseJ(JElement):
    def __init__(self, noise):
        super().__init__()
        self.noise = noise

    def process(self, coded):
        return jchain.bpsk(coded) + self.noise


@pytest.mark.parametrize("jcfg", SLICE_CONFIGS[:2],
                         ids=lambda c: c.channel_in.name)
def test_whole_slice_matches_jax_chain(rng, jcfg):
    """source -> encoder -> AWGN -> packer -> decoder -> BER on both stacks,
    fed the same message bits and the same noise (numpy): the decoded
    words and the error counts are identical."""
    m = 12_000
    msg = rng.integers(0, 2, size=m).astype(np.uint8)
    sigma = jchain.snr_to_sigma(1.125)
    noise = (rng.standard_normal(2 * m) * sigma).astype(np.float32)

    jpipe = (_Const(jnp.asarray(msg)).probe() | jchain.ConvolutionalEncoder()
             | _NoiseJ(jnp.asarray(noise))
             | jchain.SoftDecisionPacker(jcfg.channel_in, scale=40000.0)
             | JViterbiDecoder(jcfg, backend="xla"))
    jres = jpipe.run()
    want = np.asarray(jres.final_output)
    jben = jcount_bit_errors(want, jcfg.bits_per_pack, msg, jcfg.extra_l)

    cfg = from_reference(jcfg)
    pipe = (_ConstT(torch.from_numpy(msg)).probe()
            | chain.ConvolutionalEncoder() | _NoiseT(torch.from_numpy(noise))
            | chain.SoftDecisionPacker(cfg.channel_in, scale=40000.0)
            | ViterbiDecoder(cfg, backend="torch", device="cpu"))
    res = pipe.run()
    got = res.final_output.numpy().astype(np.int64) \
        & ((1 << cfg.bits_per_pack) - 1)
    ben = count_bit_errors(res.final_output, cfg.bits_per_pack,
                           res.probed_outputs[0], cfg.extra_l)
    assert np.array_equal(got, want.astype(np.int64))
    assert ben == jben
    assert 0 < ben < m // 20          # noisy enough to decide something
    status = "\n".join(pipe.status_lines())
    assert "kernel time:" in status and "Gb/s" in status


def test_cli_noiseless_run_prints_ben_zero(capsys):
    rc = cli.main(["-n", "20000", "-s", "15", "-i", "s8", "--seed", "3",
                   "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[-2] == "Pipeline executed."
    assert out[-1] == "Final results -> BEN: 0   BER: 0"


def test_cli_verbose_header_matches_jax(capsys):
    args = ["-n", "2000", "-s", "15", "-i", "s4", "-o", "b16", "--seed", "3",
            "-v"]
    assert cli.main(args + ["--backend", "torch", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jcli.main(args + ["--backend", "xla"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert got[:7] == want[:7]                 # the config header
    assert got[-2:] == want[-2:] == ["Pipeline executed.",
                                     "Final results -> BEN: 0   BER: 0"]


@pytest.mark.parametrize("flags", [["-i", "s16", "-m", "b16"],
                                   ["-i", "s16", "-m", "f16"],
                                   ["-i", "s8", "-m", "f16"],
                                   ["-i", "h", "-m", "f16", "-c", "dpx"]])
def test_cli_validity_errors_match_jax(capsys, flags):
    args = ["-n", "1000"] + flags
    rc = cli.main(args)
    got = capsys.readouterr().err
    jrc = jcli.main(args)
    want = capsys.readouterr().err
    assert rc == jrc == -1
    assert got == want and got.startswith("Error: ")


def test_cli_short_message_and_unported_kernel(capsys):
    """A too-short message is refused; --survivor window decodes (the
    plain windowed core on the CPU)."""
    assert cli.main(["-n", "40", "--device", "cpu"]) == 1
    assert "too short" in capsys.readouterr().err
    assert cli.main(["-n", "1000", "--survivor", "window", "--seed",
                     "3", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == \
        "Final results -> BEN: 0   BER: 0"


def test_port_imports_no_jax():
    """Every module of the package, found by walking it (so a module
    added later is covered), imports neither jax nor the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import tpu_viterbi_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    tpu_viterbi_torch.__path__, 'tpu_viterbi_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules\n"
            "       if m == 'jax' or m.startswith(('jax.', 'tpu_viterbi.'))\n"
            "       or m == 'tpu_viterbi']\n"
            "assert not bad, bad\n"
            "print(len(names), ' '.join(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    count, *names = res.stdout.split()
    assert int(count) == len(names) > 60
    for name in ("__main__", "cli", "decoder.core_cuda", "sharding.launch",
                 "scripts.sass_compare", "scripts.channel_throughput",
                 "scripts.small_msg_sweep", "scripts.scaling_curve",
                 "utils.native"):
        assert f"tpu_viterbi_torch.{name}" in names
