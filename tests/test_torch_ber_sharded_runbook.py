"""The port's multi-rank checks and runbook on the CPU
(tpu_viterbi_torch/scripts/ber_sharded.py, pod_runbook.py,
pod_decode_example.py and tpu_viterbi_torch/sharding/launch.py):
ber_sharded at 8 ranks held in this process counts JAX's one-device BEN
and JAX's decode_sharded BEN on the same numpy words, with the split's
words bit-equal to JAX's; its words are those the JAX scripts draw; rank
processes over gloo give the in-process rows; the runbook's dry run
passes every step at 2 ranks; the decode example under 2 gloo ranks counts
the CLI's --e2e-device BEN; the scripts refuse to run without a card
unless given --device cpu."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_viterbi.chain.channel import snr_to_sigma as jsnr_to_sigma
from tpu_viterbi.chain.encode import conv_encode_np as jconv_encode_np
from tpu_viterbi.chain.quantize import quantize_and_pack as jquantize_and_pack
from tpu_viterbi.config import (ChannelIn as JChannelIn,
                                DecoderConfig as JDecoderConfig)
from tpu_viterbi.decoder.api import ViterbiTPU
from tpu_viterbi.sharding.blocks import decode_sharded as jdecode_sharded
from tpu_viterbi.sharding.mesh import make_block_mesh
from tpu_viterbi.utils.bits import count_bit_errors as jcount_bit_errors
from tpu_viterbi_torch.config import ChannelIn, DecoderConfig
from tpu_viterbi_torch.sharding import audit, launch
from tpu_viterbi_torch.scripts import (ber_sharded, pod_decode_example,
                                       pod_runbook)

torch.set_num_threads(1)
N_SMALL = 40_000                 # bits a point of the tier-1 comparison
SNRS_SMALL = (0.5, 1.5)
# the row's keys that say how the ranks were held, not what they decoded
HOLDING = ("processes", "backend", "launches_rank0")


def jax_rows(n: int, snrs, ranks: int = 8):
    """The JAX scripts' loop (scripts/ber_sharded.py:38-66) on JAX's own
    functions: (packed words, one-device BEN, m, split BEN, split m, split
    words) a point, ViterbiTPU on the XLA core and decode_sharded on an
    N-device CPU mesh."""
    mesh = make_block_mesh()
    assert mesh.shape["blocks"] == ranks
    rng = np.random.default_rng(99)
    out = []
    for ch, scale in [(JChannelIn.SOFT8, 32.0), (JChannelIn.HARD, 1.0)]:
        cfg = JDecoderConfig(channel_in=ch)
        dec = ViterbiTPU(cfg, dec_len=2048, backend="xla")
        for snr in snrs:
            bits = rng.integers(0, 2, n).astype(np.uint8)
            sym = 2 * jconv_encode_np(bits).astype(np.float32) - 1
            sym = sym + rng.normal(0, jsnr_to_sigma(snr),
                                   sym.shape).astype(np.float32)
            packed = np.asarray(jquantize_and_pack(jnp.asarray(sym), ch,
                                                   scale))
            out1, _ = dec.run(packed, 2 * n, want_time=False)
            m1 = cfg.get_message_len(2 * n)
            ben1 = jcount_bit_errors(out1, cfg.bits_per_pack,
                                     bits[cfg.extra_l:], 0)
            outs, ms = jdecode_sharded(packed, 2 * n, cfg, mesh,
                                       dec_len=2048)
            bens = jcount_bit_errors(outs, cfg.bits_per_pack,
                                     bits[cfg.extra_l:], 0)
            out.append((packed, int(ben1), int(m1), int(bens), int(ms),
                        np.asarray(outs)))
    return out


def assert_rows_are_jax(rows, want):
    assert len(rows) == len(want)
    for row, (_, ben1, m1, bens, ms, outs) in zip(rows, want):
        assert (row["ben_single"], row["bits"], row["ben_sharded"],
                row["sharded_bits"]) == (ben1, m1, bens, ms), row
        assert row["words_sharded"] == ber_sharded.sha(outs), row
        assert row["ber_single"] == ben1 / m1
        assert row["ber_sharded"] == bens / ms


@pytest.fixture(scope="module")
def small_rows():
    return (ber_sharded.run(N_SMALL, SNRS_SMALL, 8, "cpu", True),
            jax_rows(N_SMALL, SNRS_SMALL))


@pytest.mark.parametrize("point", range(4), ids=[
    f"{ch}-{snr}" for ch in ("SOFT8", "HARD") for snr in SNRS_SMALL])
def test_ber_sharded_counts_jax_at_8_ranks(small_rows, point):
    """At 8 ranks held in this process, each point's one-device BEN, its
    split BEN, bits and sharded_bits are JAX's exactly (ViterbiTPU on the
    XLA core, decode_sharded on an 8-device CPU mesh), and the split's
    words are bit-equal to JAX's."""
    rows, want = small_rows
    assert_rows_are_jax(rows[point: point + 1], want[point: point + 1])
    row = rows[point]
    assert (row["devices"], row["processes"], row["channel"]) == (
        8, 1, ("SOFT8", "HARD")[point // 2])


@pytest.mark.parametrize("n, snrs", [(3000, ber_sharded.SNRS),
                                     (2000, ber_sharded.MP_SNRS)],
                         ids=["ber_sharded", "ber_sharded_mp"])
def test_workloads_are_the_jax_scripts_words(n, snrs):
    """The rng order: every point's message bits and packed words are
    those the JAX scripts draw (one default_rng(99) stream, SOFT8 then
    HARD, the SNRs in order, bits then f32 noise, JAX's quantizer)."""
    rng = np.random.default_rng(99)
    got = list(ber_sharded.workloads(n, snrs))
    assert [(ch, scale, snr) for ch, scale, snr, _, _ in got] == [
        (ch, scale, snr) for ch, scale in ber_sharded.CHANNELS
        for snr in snrs]
    for ch, scale, snr, bits, packed in got:
        want_bits = rng.integers(0, 2, n).astype(np.uint8)
        sym = 2 * jconv_encode_np(want_bits).astype(np.float32) - 1
        sym = sym + rng.normal(0, jsnr_to_sigma(snr),
                               sym.shape).astype(np.float32)
        want = np.asarray(jquantize_and_pack(
            jnp.asarray(sym), JChannelIn[ch.name], scale))
        assert np.array_equal(bits, want_bits)
        assert packed.dtype == want.dtype and np.array_equal(packed, want)


def _rows_without_holding(rows):
    return [{k: v for k, v in r.items() if k not in HOLDING} for r in rows]


def _ranks_against_in_process(tmp_path, ranks: int, n: int, snrs):
    """ber_sharded as ``ranks`` gloo rank processes: rc 0 exactly when
    every row passed the 2 % check, and the rows those of the ranks held
    in this process."""
    out = tmp_path / "rows.json"
    rc = ber_sharded.main(["--device", "cpu", "--ranks", str(ranks), "-n",
                           str(n), "--snrs", ",".join(map(str, snrs)),
                           "--out", str(out)])
    rows = json.loads(out.read_text())
    want = ber_sharded.run(n, snrs, ranks, "cpu", True)
    assert rc == (0 if all(r["within_2pct"] for r in want) else 1)
    assert _rows_without_holding(rows) == _rows_without_holding(want)
    assert {(r["processes"], r["backend"]) for r in rows} == {
        (ranks, "gloo")}
    return rows


def test_ber_sharded_two_gloo_processes_equal_in_process(tmp_path):
    """Two rank processes over gloo give the rows of two ranks in one
    process, words and counts alike."""
    _ranks_against_in_process(tmp_path, 2, 12_000, (0.5, 1.0))


@pytest.mark.slow   # 8 rank processes; the two-process run stays tier-1
def test_ber_sharded_eight_gloo_processes_equal_in_process(tmp_path):
    _ranks_against_in_process(tmp_path, 8, N_SMALL, SNRS_SMALL)


@pytest.mark.slow   # the JAX scripts' full sizes: ~5 min on the CPU
@pytest.mark.parametrize("n, snrs", [(400_000, ber_sharded.SNRS),
                                     (200_000, ber_sharded.MP_SNRS)],
                         ids=["ber_sharded", "ber_sharded_mp"])
def test_ber_sharded_full_size_counts_jax(n, snrs):
    """At the JAX scripts' sizes (400,000 bits at 4 SNRs, and the _mp
    rows' 200,000 at 2), every count of the 8-rank rows is JAX's and
    every point passes the 2 % check."""
    rows = ber_sharded.run(n, snrs, 8, "cpu", True)
    assert_rows_are_jax(rows, jax_rows(n, snrs))
    assert all(r["within_2pct"] for r in rows)


def _runbook(tmp_path, ranks: int):
    out = tmp_path / "report.json"
    rc = pod_runbook.main(["--device", "cpu", "--ranks", str(ranks),
                           "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0 and report["ok"], report
    steps = report["steps"]
    assert list(steps) == ["bringup", "aligned_decode", "collective_census",
                           "linearity"]
    assert all(s["ok"] for s in steps.values())
    assert (steps["bringup"]["n_ranks"], steps["bringup"]["backend"],
            steps["bringup"]["devices"]) == (ranks, "gloo", ["cpu"] * ranks)
    aligned = steps["aligned_decode"]
    assert aligned["aligned"] and aligned["bit_equal"] and \
        aligned["ben"] <= aligned["message_bits"] // 10_000
    assert aligned["sd"] == 8192 and aligned["dec_len"] == 64
    cfg = DecoderConfig(ChannelIn.SOFT8)
    census = steps["collective_census"]
    assert [tuple(c) for c in census["decoder"]] == \
        audit.expected_census(cfg, simulate=False)
    assert [tuple(c) for c in census["simulation"]] == \
        audit.expected_census(cfg, simulate=True)
    assert steps["linearity"]["modeled"] is True
    assert not any(k.endswith(("_ms", "gbps")) for k in steps["linearity"])


def test_runbook_dry_run_two_ranks(tmp_path):
    """--device cpu --ranks 2: every step passes; the halo read in place,
    the split bit-equal to decode_all_ranks, the census exactly
    expected_census, linearity modeled (no time printed as scaling)."""
    _runbook(tmp_path, 2)


@pytest.mark.slow   # 8 rank processes; the two-rank dry run stays tier-1
def test_runbook_dry_run_eight_ranks(tmp_path):
    _runbook(tmp_path, 8)


@pytest.mark.parametrize("module, argv", [
    (pod_runbook, []), (pod_runbook, ["--ranks", "2"]),
    (ber_sharded, ["--in-process"]), (ber_sharded, []),
    (pod_decode_example, []), (pod_decode_example, ["--host-data"])],
    ids=["runbook", "runbook-ranks", "ber_sharded-in-process",
         "ber_sharded-ranks", "example", "example-host-data"])
def test_scripts_refuse_without_a_card(monkeypatch, module, argv):
    """Without a card and without --device cpu each script raises before
    it decodes or starts a rank: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["-n", "20000", *argv])


EXAMPLE = ["-n", "12000", "-s", "1", "-i", "h", "--seed", "3", "--device",
           "cpu"]


def test_decode_example_under_two_ranks_counts_the_cli(tmp_path):
    """pod_decode_example and the CLI's --e2e-device, each as two gloo
    ranks with torchrun's variables, on the same seed and message (HARD,
    whose decisions no scale changes): the same BEN, nonzero at 1 dB;
    only rank 0 prints."""
    out = tmp_path / "example.json"
    ex = launch.spawn_ranks(lambda r: [
        sys.executable, "-m", "tpu_viterbi_torch.scripts.pod_decode_example",
        *EXAMPLE, "--out", str(out)], 2, "cpu", 240)
    cli = launch.spawn_ranks(lambda r: [
        sys.executable, "-m", "tpu_viterbi_torch", "-n", "12000", "-s", "1",
        "-i", "h", "--seed", "3", "--e2e-device", "--device", "cpu"], 2,
        "cpu", 240)
    assert launch.failed(ex) == launch.failed(cli) == [], (ex, cli)
    assert ex[1].out == cli[1].out == ""
    got = json.loads(out.read_text())
    want = cli[0].out.splitlines()[-1]
    assert (got["ranks"], got["backend"], got["host_data"]) == (
        2, "gloo", False)
    assert got["ben"] > 0
    assert want == f"Final results -> BEN: {got['ben']}   BER: " \
        f"{got['ben'] / 12000:g}"
    assert ex[0].out.splitlines()[-1] == \
        f"BEN: {got['ben']}   BER: {got['ben'] / got['bits']:.3e}"
    assert ex[0].out.splitlines()[0] == "ranks: 2 (gloo), channel=HARD"


def test_decode_example_host_data(tmp_path, capsys):
    """--host-data: the numpy workload decoded through decode_sharded, BEN
    0 at 15 dB (exit 0); at 1 dB on HARD it counts errors and exits 0
    (below 3 dB a nonzero BEN is no failure)."""
    out = tmp_path / "host.json"
    assert pod_decode_example.main(["-n", "20000", "-s", "15", "--device",
                                    "cpu", "--host-data", "--out",
                                    str(out)]) == 0
    got = json.loads(out.read_text())
    assert (got["ben"], got["bits"], got["ranks"]) == (0, 19936, 1)
    assert pod_decode_example.main([*EXAMPLE, "--host-data"]) == 0
    assert "BEN: 0" not in capsys.readouterr().out.splitlines()[-1]


def test_spawn_ranks_variables_and_failure():
    """Each rank gets torchrun's variables; when one rank fails the others
    are killed at once, and report() says so with rc 1."""
    show = ("import os; print(*[os.environ[v] for v in ('MASTER_ADDR', "
            "'WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE')])")
    res = launch.spawn_ranks(lambda r: [sys.executable, "-c", show], 3,
                             "cpu", 60)
    assert [(r.rank, r.rc, r.out.split()) for r in res] == [
        (r, 0, ["localhost", "3", str(r), str(r), "3"]) for r in range(3)]
    assert launch.report(res, echo=lambda s: None) == 0
    res = launch.spawn_ranks(lambda r: [
        sys.executable, "-c",
        "import time; time.sleep(120)" if r == 0 else "raise SystemExit(3)"],
        2, "cpu", 60)
    assert res[1].rc == 3 and res[0].rc < 0
    assert launch.failed(res) == [0, 1]
    seen = []
    assert launch.report(res, echo=seen.append) == 1
    assert any("rank 1 failed (rc 3)" in s for s in seen)
