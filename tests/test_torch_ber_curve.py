"""The port's BER-curve harness (tpu_viterbi_torch/scripts/ber_curve.py)
against the JAX package's (bench/ber_curve.py) on the CPU.

Exact where the inputs are shared: the same noisy f32 values, made with
numpy from a seed, give the same packed words, decoded words and BEN
through JAX's quantizer, ``ViterbiTPU(backend="xla")`` and count as through
the port's ``values_point``, for each of the harness's 7 configurations;
the quantizer scales and the spec maps are JAX's.  Statistical where each
package draws its own bits and noise: both ``main``s at 100,000 bits, seed
123, agree point by point by ``ber_curve.agree`` at the spread L that
``event_bits`` measures over 8 draws of 20,000 bits (the error events of
the waterfall carry 5-20 bits, so the 4 of ``EVENT_BITS`` would understate
a count's spread), and ``b16`` counts ``b32``'s BEN in each run; the
golden column agrees with the decoder's.  The card's run is
tests/test_torch_cuda.py and chip_smoke.py phase 50.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import ber_curve as jbc
from tpu_viterbi.chain import conv_encode_np
from tpu_viterbi.chain import quantize_and_pack as jquantize_and_pack
from tpu_viterbi.config import ChannelIn as JChannelIn
from tpu_viterbi.config import DecoderConfig as JDecoderConfig
from tpu_viterbi.config import Metric as JMetric
from tpu_viterbi.decoder.api import ViterbiTPU
from tpu_viterbi.utils.bits import count_bit_errors as jcount_bit_errors
from tpu_viterbi_torch.config import ChannelIn
from tpu_viterbi_torch.decoder.api import ViterbiGPU
from tpu_viterbi_torch.scripts import ber_curve as bc

REPO = Path(__file__).resolve().parents[1]
SPECS = bc.CONFIGS.split(",")
JAX_KEYS = {"config", "snr_db", "ben", "bits", "ber"}
HARNESS_SPECS = ("h/b32", "s8/b32", "f/b32", "s8/b16")
HARNESS_SNRS = (0.0, 0.5, 1.0)
HARNESS_ARGS = ["--num", "100000", "--snrs", "0,0.5,1", "--configs",
                ",".join(HARNESS_SPECS), "--seed", "123"]
SPREAD_BITS, SPREAD_DRAWS = 20_000, 8
# JAX's spec maps, local to its main (bench/ber_curve.py:106-108)
JAX_CHANNELS = {"h": JChannelIn.HARD, "s4": JChannelIn.SOFT4,
                "s8": JChannelIn.SOFT8, "s16": JChannelIn.SOFT16,
                "f": JChannelIn.FP32}
JAX_METRICS = {"b32": JMetric.M_B32, "b16": JMetric.M_B16,
               "f16": JMetric.M_FP16}


def _jax_config(spec: str) -> JDecoderConfig:
    c, m = spec.split("/")
    return JDecoderConfig(channel_in=JAX_CHANNELS[c], metric=JAX_METRICS[m])


@pytest.fixture(scope="module")
def spread():
    """event_bits at SPREAD_BITS over SPREAD_DRAWS draws, once a channel
    and SNR (a channel's draws decode alike at either metric width)."""
    memo = {}

    def events(spec: str, snr_db: float) -> float:
        cfg = bc.spec_config(spec)
        key = (cfg.channel_in, snr_db)
        if key not in memo:
            memo[key] = bc.event_bits(cfg, SPREAD_BITS, snr_db,
                                      bc.SPREAD_SEEDS[:SPREAD_DRAWS], "cpu")
        return memo[key]
    return events


def _values(n: int, snr_db: float, seed: int):
    """(message bits, noisy f32 values) made with numpy."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    sym = 2 * conv_encode_np(bits).astype(np.float32) - 1
    noise = rng.normal(0, 10 ** (-snr_db / 5), sym.shape)
    return bits, (sym + noise).astype(np.float32)


@pytest.mark.parametrize("name", [c.name for c in ChannelIn])
def test_default_scale_is_jax_table(name):
    assert bc.default_scale(ChannelIn[name]) == \
        jbc._default_scale(JChannelIn[name])


@pytest.mark.parametrize("spec", SPECS)
def test_values_point_equals_jax(spec):
    """The same values at SNR 0.5 and 20,000 bits: JAX's quantizer at its
    scale, its XLA decoder at dec_len 2048 and its count give the port's
    packed words, decoded words, BEN and message length."""
    cfg, jcfg = bc.spec_config(spec), _jax_config(spec)
    assert cfg.options == jcfg.options
    n = 20_000
    bits, noisy = _values(n, 0.5, 2024)
    jpacked = np.asarray(jquantize_and_pack(
        jnp.asarray(noisy), jcfg.channel_in,
        jbc._default_scale(jcfg.channel_in)))
    jout, _ = ViterbiTPU(jcfg, backend="xla", dec_len=2048).run(
        jpacked, 2 * n, want_time=False)
    jben = jcount_bit_errors(jout, jcfg.bits_per_pack, bits, jcfg.extra_l)

    dec = ViterbiGPU(cfg, dec_len=bc.DEC_LEN, device="cpu")
    packed, out, _ = bc.decode_values(cfg, torch.from_numpy(noisy), dec)
    ben, m = bc.values_point(cfg, torch.from_numpy(bits),
                             torch.from_numpy(noisy), dec)
    np.testing.assert_array_equal(packed.numpy(), jpacked)
    assert out.dtype == jout.dtype
    np.testing.assert_array_equal(out, jout)
    assert (ben, m) == (jben, jcfg.get_message_len(2 * n))
    assert 0 < ben < m // 4


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """Both mains at the harness's 12 points: (JAX's rows, the port's)."""
    tmp = tmp_path_factory.mktemp("ber_curve")
    jbc.main([*HARNESS_ARGS, "--backend", "xla", "--out",
              str(tmp / "jax.json")])
    assert bc.main([*HARNESS_ARGS, "--device", "cpu", "--out",
                    str(tmp / "port.json")]) == 0
    return (json.loads((tmp / "jax.json").read_text()),
            json.loads((tmp / "port.json").read_text()))


def test_harness_rows_have_jax_keys(harness):
    jrows, rows = harness
    assert [(r["config"], r["snr_db"], r["bits"]) for r in rows] == \
        [(r["config"], r["snr_db"], r["bits"]) for r in jrows] == \
        [(s, snr, 99_936) for s in HARNESS_SPECS for snr in HARNESS_SNRS]
    for row in rows:
        assert JAX_KEYS <= row.keys() and "ms" not in row
        assert row["ber"] == row["ben"] / row["bits"]
        assert row["kernels"] == "plain versions"


@pytest.mark.parametrize("point", range(len(HARNESS_SPECS) *
                                        len(HARNESS_SNRS)))
def test_harness_point_agrees_with_jax(harness, spread, point):
    """A point's BEN against JAX's: both <= FEW, or z <= 4 at the spread
    measured over SPREAD_DRAWS other draws of the point."""
    jrow, row = harness[0][point], harness[1][point]
    counts = (row["ben"], row["bits"], jrow["ben"], jrow["bits"])
    if max(row["ben"], jrow["ben"]) > bc.FEW:
        events = spread(row["config"], row["snr_db"])
        assert events > 0
        assert bc.agree(*counts, events), (row, jrow, events,
                                           bc.z_score(*counts, events))


def test_harness_b16_counts_b32(harness):
    for rows in harness:
        got = {(r["config"], r["snr_db"]): r["ben"] for r in rows}
        for snr in HARNESS_SNRS:
            assert got[("s8/b16", snr)] == got[("s8/b32", snr)]


@pytest.mark.parametrize("spec", ["h/b32", "s8/b32", "f/b32"])
def test_golden_column_agrees_with_decoder(spec, spread, tmp_path, capsys):
    """--golden at 20,000 bits: the plain numpy decoder's BER (one block
    over the message) beside the decoder's, within the same statistic;
    the line carries JAX's golden column."""
    out = tmp_path / "g.json"
    assert bc.main(["--num", "20000", "--snrs", "0.5", "--configs", spec,
                    "--golden", "--device", "cpu", "--out", str(out)]) == 0
    (row,) = json.loads(out.read_text())
    assert row["golden_bits"] == row["bits"] and \
        row["golden_ber"] == row["golden_ben"] / row["golden_bits"]
    assert f"golden={row['golden_ber']:.3e}" in capsys.readouterr().out
    assert bc.agree(row["ben"], row["bits"], row["golden_ben"],
                    row["golden_bits"], spread(spec, 0.5))


def test_golden_point_counts_from_extra_l():
    """golden_point draws at most GOLDEN_MAX_BITS and counts the message
    from extra_l: noiselessly (SNR 30) it decodes every bit."""
    cfg = bc.spec_config("s8/b32")
    assert bc.golden_point(cfg, 3000, 30.0, 5, "cpu") == (
        0, cfg.get_message_len(6000))
    assert bc.run_point(cfg, 3000, 30.0, 5, "cpu") == (
        0, cfg.get_message_len(6000))


def test_recorded_jax_curves_agree_at_four_bits():
    """JAX's two recorded curves (TPU, 2M bits; CPU, 500,000 bits, one
    seed, draws of their own) agree at every point at L = EVENT_BITS, and
    each counts b32's BEN at b16."""
    tpu = json.loads((REPO / "bench" / "ber_curve_tpu.json").read_text())
    cpu = json.loads((REPO / "bench" / "ber_curve_cpu.json").read_text())
    assert [(r["config"], r["snr_db"]) for r in tpu] == \
        [(r["config"], r["snr_db"]) for r in cpu] == \
        [(s, float(snr)) for s in SPECS for snr in bc.SNRS.split(",")]
    worst = max(bc.z_score(a["ben"], a["bits"], b["ben"], b["bits"])
                for a, b in zip(tpu, cpu))
    assert 1.0 < worst < 1.1
    for rows in (tpu, cpu):
        got = {(r["config"], r["snr_db"]): r["ben"] for r in rows}
        for (spec, snr), ben in got.items():
            if spec.endswith("/b16"):
                assert ben == got[(spec.replace("b16", "b32"), snr)]


def test_z_score_and_agree():
    assert bc.z_score(0, 100, 0, 100) == 0.0
    assert bc.z_score(100, 10_000, 100, 10_000) == 0.0
    # 100 against 144 in 10,000 bits: 44 / sqrt(4 * 244) = 1.408...
    assert abs(bc.z_score(100, 10_000, 144, 10_000) - 44 / 976 ** 0.5) < \
        1e-12
    assert bc.z_score(9, 100, 0, 100, 0.0) == float("inf")
    assert bc.agree(5, 100, 0, 100) and not bc.agree(6, 100, 0, 100, 0.0)
    # 150 apart over sqrt(4 * 350) = 37.4 counts: z 4.009
    assert not bc.agree(100, 10_000, 250, 10_000)
    assert bc.agree(100, 10_000, 250, 10_000, 40.0)


def test_main_refuses_without_card(monkeypatch):
    """No fallback: without --device cpu the harness needs a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bc.main(["--num", "1000", "--snrs", "0", "--configs", "s8/b32"])


@pytest.mark.slow
def test_full_grid_against_jax_cpu_curve(spread, tmp_path):
    """The default grid at 500,000 bits (bench/ber_curve_cpu.json's size,
    JAX's CPU run with --golden) point by point, at the spread of each
    point's draws, golden beside it; b16 counts b32."""
    out = tmp_path / "full.json"
    assert bc.main(["--num", "500000", "--golden", "--device", "cpu",
                    "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    jrows = json.loads((REPO / "bench" / "ber_curve_cpu.json").read_text())
    assert [(r["config"], r["snr_db"], r["bits"]) for r in rows] == \
        [(r["config"], r["snr_db"], r["bits"]) for r in jrows]
    got = {(r["config"], r["snr_db"]): r["ben"] for r in rows}
    for row, jrow in zip(rows, jrows):
        if row["config"].endswith("/b16"):
            assert row["ben"] == got[(row["config"].replace("b16", "b32"),
                                      row["snr_db"])]
        events = spread(row["config"], row["snr_db"])
        assert bc.agree(row["ben"], row["bits"], jrow["ben"], jrow["bits"],
                        events), (row, jrow, events)
        assert bc.agree(row["ben"], row["bits"], row["golden_ben"],
                        row["golden_bits"], events), (row, events)
