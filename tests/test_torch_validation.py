"""The port's validation modules against the JAX package's, on the CPU:

- ``--profile DIR`` (utils/profile.py) writes a Chrome trace that parses
  and names the run's ranges and ops, for the chain, ``--e2e-device`` and
  ``--decode-file``; an unwritable DIR is refused with an error line;
- the BER scripts (scripts/ber_deep.py, ber_deep_tail.py, check_gen_ber.py)
  run their plain path at 131,072 bits a call at a waterfall SNR: on the
  words JAX's generator draws (interpret mode), each counts exactly the
  errors JAX's one-device simulation counts at the script's seed and
  dec_len; on the words the port's own generator draws (K7/K8's plain
  version, the same streams up to an f32 ulp of the noise), within 1 %;
- the survivor each row passes is the one JAX resolved on the TPU;
- scripts/fuzz_gpu.py's trial inputs are the JAX script's and decode to
  decode_packed_xla's words.

One configuration of each script runs in the default tier; the others
are ``slow`` (--full)."""

import functools
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_viterbi.chain import genkernel as jgen
from tpu_viterbi.chain.encode import conv_encode_np as jconv_encode_np
from tpu_viterbi.chain.quantize import quantize_and_pack as jquantize
from tpu_viterbi.config import (ALL_VALID_CONFIGS as JALL_VALID_CONFIGS,
                                ChannelIn as JChannelIn,
                                CompMode as JCompMode,
                                DecodeOut as JDecodeOut,
                                DecoderConfig as JDecoderConfig)
from tpu_viterbi.decoder import core_pallas
from tpu_viterbi.decoder.core_xla import (decode_packed_xla,
                                          plan_blocks as jplan_blocks)
from tpu_viterbi.hardware import vmem_budget_bytes
from tpu_viterbi.sharding.mesh import make_block_mesh
from tpu_viterbi.sharding.simulate import simulate_sharded as jsimulate
from tpu_viterbi_torch import cli
from tpu_viterbi_torch.config import ALL_VALID_CONFIGS, CompMode
from tpu_viterbi_torch.decoder.core_cuda import decode_packed_cuda
from tpu_viterbi_torch.decoder.core_torch import decode_packed_torch
from tpu_viterbi_torch.scripts import (ber_common, ber_deep, ber_deep_tail,
                                       check_gen_ber, fuzz_gpu, ingraph_turns)
from tpu_viterbi_torch.sharding import simulate as sim
from tpu_viterbi_torch.utils import profile

torch.set_num_threads(1)

N = 131_072            # message bits a call of the scripts' plain path
WATERFALL_DB = 0.5     # soft channels: BER ~5e-3, hundreds of events
HARD_DB = 1.25         # HARD's knee (bench/ber_deep.json: BER 5.5e-4)


# --- --profile -------------------------------------------------------------

RUN = ["-n", "3000", "-s", "3", "-i", "s8", "--seed", "3", "--dec-len", "64",
       "--device", "cpu"]


def _trace(tmp_path, argv, capsys):
    d = tmp_path / "trace"
    assert cli.main(argv + ["--profile", str(d)]) == 0
    out = capsys.readouterr().out
    files = list(d.glob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert isinstance(json.load(f)["traceEvents"], list)
    return profile.summarize(files[0]), profile.load_events(files[0]), out


def test_profile_traces_the_chain(tmp_path, capsys):
    """Each element and the decode are named ranges, the decode's plain
    torch ops are in the trace, no device ran, and the run prints what it
    prints untraced."""
    s, events, out = _trace(tmp_path, RUN, capsys)
    assert {"RandBitGen", "ConvolutionalEncoder", "AddNoise",
            "SoftDecisionPacker", "ViterbiDecoder", "decode"} <= \
        set(s["annotations"])
    decode = next(e for e in events if e["name"] == "decode")
    ops = [e for e in events if e.get("cat") == "cpu_op" and
           decode["ts"] <= e["ts"] <= decode["ts"] + decode["dur"]]
    assert len(ops) > 100
    assert s["busy_ms"] == 0 and s["busy_share"] == 0
    assert s["window_ms"] > 0 and s["gap_ms"] == pytest.approx(s["window_ms"])
    assert s["gap_host"] and s["kernel_ms"] == {}
    assert cli.main(RUN) == 0
    assert capsys.readouterr().out == out


def test_profile_traces_e2e_device(tmp_path, capsys):
    """generate, ref, decode and count are ranges of each call, in that
    order: the reference words are built before the decode, whose wait
    for its end would otherwise idle the device while they are built."""
    s, events, out = _trace(tmp_path, RUN + ["--e2e-device", "-v"], capsys)
    names = ("generate", "ref", "decode", "count")
    assert [s["annotations"][n] for n in names] == [2] * 4  # first call, -v's
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] in names)
    assert [n for _, _, n in spans] == list(names) * 2
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert out.splitlines()[-1] == "Final results -> BEN: 0   BER: 0"


def test_profile_traces_a_file_decode(tmp_path, capsys):
    f = tmp_path / "c.bin"
    assert cli.main(RUN[:-2] + ["--emit-file", str(f), "--device",
                                "cpu"]) == 0
    capsys.readouterr()
    s, _, out = _trace(tmp_path, ["-i", "s8", "--decode-file", str(f),
                                  "--dec-len", "64", "--device", "cpu"],
                       capsys)
    assert s["annotations"] == {"decode": 1}
    assert out.splitlines()[0] == "Decode executed."


def test_profile_unwritable_dir_is_refused(tmp_path, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert cli.main(RUN + ["--profile", str(blocker / "sub")]) == -1
    cap = capsys.readouterr()
    assert cap.err.startswith(f"Error: cannot write a trace to "
                              f"{blocker / 'sub'}: ")
    assert cap.out == ""


def test_short_kernel_names():
    assert profile.short_name(
        "void viterbi_kernel<IntReader<8, false, false, false>, 32, false, "
        "true>(Source, unsigned int*, int*, int, int)") == "viterbi_kernel"
    assert profile.short_name(
        "void viterbi_gen::gen_words_kernel<8, true>(int*, int*)") == \
        "viterbi_gen::gen_words_kernel"
    assert profile.short_name("Memset (Device)") == "Memset"
    assert profile.short_name("kernel") == "kernel"


def test_span_is_free_outside_a_trace():
    assert not torch.autograd._profiler_enabled()
    with profile.span("x") as v:
        assert v is None


def test_summarize_merges_device_intervals(tmp_path):
    """Busy time is the union of overlapping device events; the longest
    gap and the host ranges in it are read off the host events."""
    ev = [{"ph": "X", "cat": "Trace", "name": "t", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 90,
           "dur": 5},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize",
           "ts": 45, "dur": 40},
          {"ph": "X", "cat": "user_annotation", "name": "count", "ts": 85,
           "dur": 20},
          {"ph": "i", "name": "marker", "ts": 3}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = profile.summarize(path)
    assert s["window_ms"] == pytest.approx(0.1)
    assert s["busy_ms"] == pytest.approx(0.035)
    assert s["busy_share"] == pytest.approx(0.35)
    assert s["gap_ms"] == pytest.approx(0.05) and \
        s["gap_at_ms"] == pytest.approx(0.04)
    assert s["gap_host"][0] == ("cudaEventSynchronize", pytest.approx(0.04))
    assert s["gap_host"][1] == ("count", pytest.approx(0.005))
    assert s["sync_ms"] == pytest.approx(0.04)
    assert s["kernel_ms"] == {"a": pytest.approx(0.02),
                              "b": pytest.approx(0.02),
                              "c": pytest.approx(0.005)}
    one = profile.summarize(path, between=("cudaEventSynchronize",
                                           "count"))
    assert one["window_ms"] == pytest.approx(0.06)
    assert one["busy_ms"] == pytest.approx(0.005)
    assert one["gap_ms"] == pytest.approx(0.045)


# --- the BER scripts' plain path against JAX's counts ---------------------

@functools.lru_cache(maxsize=None)
def _jax_words(channel: int, snr: float, seed: int):
    """JAX's fused generator in interpret mode at N bits: (packs, words)."""
    bits, words = jgen.packed_workload_pallas(
        jax.random.PRNGKey(seed), N, JChannelIn(channel), snr,
        sim.DEFAULT_SCALES[channel], interpret=True)
    return np.array(bits), np.array(words)


def _jax_count(ch: str, out: str, snr: float, seed: int, dec_len: int,
               survivor: str = "full"):
    """JAX's one-device simulation's (count, m) at N bits: its XLA core
    for the full store, its windowed kernel in interpret mode for the
    window (the two differ by a few events at a waterfall SNR)."""
    jcfg = JDecoderConfig(channel_in=JChannelIn[ch],
                          decode_out=JDecodeOut.O_B16 if out == "b16"
                          else JDecodeOut.O_B32)
    kw = {"survivor": "window", "backend": "pallas-interpret"} \
        if survivor == "window" else {}
    return jsimulate(jcfg, N, make_block_mesh(jax.devices()[:1]),
                     snr_db=snr, seed=seed, generator="pallas",
                     dec_len=dec_len, **kw)


def _with_jax_words(monkeypatch):
    """The simulation's generator 'cuda' draws JAX's words instead."""
    def words(seed, n, channel, snr_db, scale, device):
        assert n == N and scale == sim.DEFAULT_SCALES[channel]
        return tuple(torch.from_numpy(x).to(device)
                     for x in _jax_words(int(channel), snr_db, seed))
    monkeypatch.setattr(sim, "packed_workload_cuda", words)


def _held_to_jax(monkeypatch, run, want):
    """run() on JAX's words counts ``want`` exactly; on the port's own
    plain generator within 1 %: an ulp of f32 log/sin/cos can move a
    quantized value and with it a decision.  Returns the two rows."""
    with monkeypatch.context() as mp:
        _with_jax_words(mp)
        (on_jax,) = run()
    (own,) = run()
    assert on_jax["ben"] == want
    assert abs(own["ben"] - want) <= want // 100
    return on_jax, own


def _snr(ch: str) -> float:
    return HARD_DB if ch == "HARD" else WATERFALL_DB


DEEP = [pytest.param(name, marks=() if name == "s8/b32" else pytest.mark.slow)
        for name in ber_deep.CASES]


@pytest.mark.parametrize("name", DEEP)
def test_ber_deep_counts_like_jax(monkeypatch, name):
    ch, out, _ = ber_deep.CASES[name]
    snr = _snr(ch)
    survivor = ber_common.jax_survivor(ber_common.config(ch, out),
                                       ber_deep.DEC_LEN)
    want, m = _jax_count(ch, out, snr, ber_deep.SEED0, ber_deep.DEC_LEN,
                         survivor)
    assert 20 < want < m // 20                  # noisy, and decoding

    monkeypatch.setattr(ber_deep, "CASES", {name: (ch, out, (snr,))})

    def run():
        return ber_deep.run(N, device="cpu", call_bits=N)
    row, _ = _held_to_jax(monkeypatch, run, want)
    assert row["bits"] == m and row["ber"] == want / m
    assert row["kernels"] == "plain versions"
    assert row["survivor"] == survivor


TAIL = [pytest.param(name, marks=() if name == "s16/b32"
                     else pytest.mark.slow)
        for name in ber_deep_tail.CASES]


@pytest.mark.parametrize("name", TAIL)
def test_ber_deep_tail_counts_like_jax(monkeypatch, name):
    """One call a row (max_bits 1 stops the loop after it): the s16/b32
    row decodes with the window's plain version, held to JAX's windowed
    kernel in interpret mode, as JAX's run decoded it on the TPU."""
    ch, out, _, dec_len = ber_deep_tail.CASES[name]
    snr = _snr(ch)
    want, m = _jax_count(ch, out, snr, ber_deep_tail.SEED0, dec_len,
                         ber_deep_tail.row_survivor(name))
    assert 20 < want < m // 20

    survivor = ber_deep_tail.row_survivor(name)
    monkeypatch.setattr(ber_deep_tail, "CASES",
                        {name: (ch, out, snr, dec_len)})

    def run():
        return ber_deep_tail.run(1, device="cpu", call_bits=N)
    row, _ = _held_to_jax(monkeypatch, run, want)
    assert row["bits"] == m and row["dec_len"] == dec_len
    assert row["survivor"] == survivor


def test_tail_row_against_plain_on_cpu(monkeypatch):
    """The one-call check of a tail row that the card's test and the
    smoke run make: on the CPU both sides are plain versions, no kernel
    launches, and the window row (at a waterfall SNR, so that it counts
    errors at this size) reports its survivor and counts."""
    ch, out, _, dec_len = ber_deep_tail.CASES["s16/b32"]
    monkeypatch.setitem(ber_deep_tail.CASES, "s16/b32",
                        (ch, out, _snr(ch), dec_len))
    r = ber_deep_tail.row_against_plain("s16/b32", "cpu", call_bits=N // 2)
    assert r.window and r.launches == {}
    assert r.got.device.type == "cpu" and torch.equal(r.got, r.want)
    assert r.ben == r.plain_ben > 0
    assert r.plan.message_len == r.cfg.get_message_len(N)
    assert r.ref32.numel() * 32 >= r.plan.message_len


def test_check_gen_ber_counts_like_jax(monkeypatch):
    """Generator 'cuda' at seed 17 counts JAX's 'pallas' count.  The
    element chain's row ('torch', a torch.Generator's stream) is not JAX's
    'xla' stream; at 131k bits its bursty count is no test of the 25 %
    rule (595 against 841 at 0.5 dB), which the next test holds where the
    count is large."""
    want, m = _jax_count("SOFT8", "b32", WATERFALL_DB, check_gen_ber.SEED,
                         check_gen_ber.DEC_LEN)
    assert 100 < want < m // 20

    monkeypatch.setattr(check_gen_ber, "SNRS", (WATERFALL_DB,))

    def run():
        rows, _ = check_gen_ber.run("cpu", call_bits=N)
        assert [r["generator"] for r in rows] == ["cuda", "torch"]
        return rows[:1]
    _held_to_jax(monkeypatch, run, want)


def test_check_gen_ber_generators_agree_at_0db(monkeypatch):
    """0 dB, BER ~0.15: ~20,000 events a generator, where the 25 % rule
    reads a real disagreement."""
    monkeypatch.setattr(check_gen_ber, "SNRS", (0.0,))
    rows, ok = check_gen_ber.run("cpu", call_bits=N)
    assert ok and all(r["ben"] > 10_000 for r in rows)
    assert check_gen_ber.agree(rows[0]["ber"], rows[1]["ber"])[1] < 0.05


def test_check_gen_ber_rule_is_the_jax_scripts():
    assert check_gen_ber.agree(2e-3, 1.5e-3) == (True, pytest.approx(0.25))
    assert not check_gen_ber.agree(2e-3, 1.49e-3)[0]
    assert check_gen_ber.agree(1e-4, 1e-6) == (True, None)   # too few
    assert check_gen_ber.SNRS == (0.0, 0.5, 1.0)
    assert (check_gen_ber.SEED, check_gen_ber.DEC_LEN) == (17, 8192)


def test_scripts_keep_the_jax_tables():
    """The cases, seeds and sizes of scripts/ber_deep.py and
    ber_deep_tail.py."""
    assert ber_deep.CASES == {
        "h/b32": ("HARD", "b32", (1.25, 1.5, 1.75, 2.0)),
        "s4/b32": ("SOFT4", "b32", (0.875, 1.0, 1.125, 1.25)),
        "s8/b32": ("SOFT8", "b32", (0.875, 1.0, 1.125, 1.25)),
        "s16/b32": ("SOFT16", "b32", (0.875, 1.0, 1.125, 1.25)),
        "f/b32": ("FP32", "b32", (0.875, 1.0, 1.125, 1.25)),
        "s8/b16": ("SOFT8", "b16", (1.0, 1.125))}
    assert sum(len(s) for *_, s in ber_deep.CASES.values()) == 22
    assert (ber_deep.SEED0, ber_deep.SEED_STEP, ber_deep.DEC_LEN) == \
        (9000, 97, 8192)
    assert len(ber_deep_tail.CASES) == 9
    assert (ber_deep_tail.SEED0, ber_deep_tail.SEED_STEP,
            ber_deep_tail.TARGET_EVENTS, ber_deep_tail.MIN_BITS) == \
        (77_000, 131, 30, 512_000_000)
    assert ber_common.CALL_BITS == 32_000_000


# --- the survivor of each row: JAX's plan on the TPU -----------------------

def _jax_plan(ch: str, out: str, dec_len: int) -> str:
    """core_pallas.resolve_window('auto') at the TPU's VMEM budget on the
    plan of a 32M-bit call."""
    jcfg = JDecoderConfig(channel_in=JChannelIn[ch],
                          decode_out=JDecodeOut.O_B16 if out == "b16"
                          else JDecodeOut.O_B32)
    m = jcfg.get_message_len(2 * ber_common.CALL_BITS)
    plan = jplan_blocks(m, jcfg.bits_per_pack, dec_len)
    return "window" if core_pallas.resolve_window("auto", jcfg, plan) \
        else "full"


@pytest.fixture
def tpu_budget(monkeypatch):
    budget = vmem_budget_bytes("TPU v5 lite")
    assert budget == ber_common.TPU_VMEM_BUDGET
    monkeypatch.setenv("TPU_VITERBI_VMEM_BUDGET", str(budget))


def test_tail_rows_pass_jax_plan(tpu_budget):
    plans = {name: ber_deep_tail.row_survivor(name)
             for name in ber_deep_tail.CASES}
    assert plans == {name: _jax_plan(ch, out, dl) for name, (ch, out, _, dl)
                     in ber_deep_tail.CASES.items()}
    # the store overflows 16 MB at 8192 on SOFT16 and on b16 packs; FP32's
    # u/d words fit it as SOFT8's do
    assert {n for n, p in plans.items() if p == "window"} == \
        {"s16/b32", "s8/b16", "s8/b16/deep"}


def test_deep_and_generator_rows_pass_jax_plan(tpu_budget):
    for ch, out, _ in ber_deep.CASES.values():
        assert ber_common.jax_survivor(ber_common.config(ch, out), 8192) == \
            _jax_plan(ch, out, 8192)
    assert ber_common.jax_survivor(ber_common.config("SOFT8", "b32"),
                                   8192) == "full"


def test_tpu_footprint_is_jax_vmem_footprint():
    for jcfg in JALL_VALID_CONFIGS:
        cfg = ber_common.config(jcfg.channel_in.name,
                                "b16" if jcfg.bits_per_pack == 16 else "b32")
        for dl in (64, 96, 2048, 4096, 8192, 16384):
            plan = jplan_blocks(dl, jcfg.bits_per_pack, dl)
            for window in (False, True):
                assert ber_common.tpu_footprint(cfg, dl, window) == \
                    core_pallas.vmem_footprint_bytes(jcfg, plan,
                                                     window=window), \
                    (cfg, dl, window)


# --- fuzz_gpu: the JAX script's draws, decoded as JAX decodes them --------

def _u32(words) -> np.ndarray:
    """Decoded packs of either stack as their uint32 bit patterns."""
    return np.asarray(words).astype(np.int64) & 0xFFFFFFFF


def test_fuzz_configs_in_jax_order():
    port = [c for c in ALL_VALID_CONFIGS if c.comp_mode == CompMode.REG]
    jax_ = [c for c in JALL_VALID_CONFIGS if c.comp_mode == JCompMode.REG]
    assert [c.options for c in port] == [c.options for c in jax_]


@pytest.mark.parametrize("seed", [5000, 5001, 5002, 5003, 5004, 5005])
def test_fuzz_trial_inputs_decode_like_jax(seed):
    cfg, plan, words = fuzz_gpu.trial_case(seed)
    rng = np.random.default_rng(seed)          # the JAX script's draws
    jcfgs = [c for c in JALL_VALID_CONFIGS if c.comp_mode == JCompMode.REG]
    jcfg = jcfgs[rng.integers(len(jcfgs))]
    assert jcfg.options == cfg.options
    jplan = jplan_blocks(int(rng.integers(4, 200)) * jcfg.bits_per_pack,
                         jcfg.bits_per_pack,
                         int(rng.integers(1, 12)) * jcfg.bits_per_pack)
    assert (jplan.message_len, jplan.dec_len, jplan.num_blocks) == \
        (plan.message_len, plan.dec_len, plan.num_blocks)
    want = _u32(decode_packed_xla(jnp.asarray(words), jcfg, jplan))
    x = torch.from_numpy(words)
    assert np.array_equal(_u32(decode_packed_cuda(x, cfg, plan)), want)
    assert np.array_equal(_u32(decode_packed_torch(x, cfg, plan)), want)


@pytest.mark.parametrize("seed", [15000, 15001, 15002, 15003])
def test_fuzz_window_inputs_are_jax_scripts(seed):
    """wtrial's coded stream is the JAX script's (its draws and JAX's
    quantizer), and its full store decodes to decode_packed_xla's words."""
    cfg, plan, packed, sigma = fuzz_gpu.wtrial_case(seed)
    rng = np.random.default_rng(seed)
    channels = [JChannelIn.HARD, JChannelIn.SOFT4, JChannelIn.SOFT8,
                JChannelIn.SOFT16, JChannelIn.FP32]
    ch = channels[rng.integers(len(channels))]
    out = JDecodeOut.O_B16 if rng.integers(2) else JDecodeOut.O_B32
    jcfg = JDecoderConfig(channel_in=ch, decode_out=out)
    bpp = jcfg.bits_per_pack
    n = int(rng.integers(40, 400)) * bpp
    assert sigma == float(rng.uniform(0.0, 0.6))
    bits = rng.integers(0, 2, n).astype(np.uint8)
    sym = 2 * jconv_encode_np(bits).astype(np.float32) - 1
    if sigma:
        sym = sym + rng.normal(0, sigma, sym.shape).astype(np.float32)
    want = np.asarray(jquantize(jnp.asarray(sym), ch,
                                sim.DEFAULT_SCALES[int(ch)]))
    assert jcfg.options == cfg.options
    assert np.array_equal(packed.numpy(), want)
    m = jcfg.get_message_len(2 * n)
    jplan = jplan_blocks(m, bpp, int(rng.integers(max(2, 64 // bpp + 1), 12))
                         * bpp)
    assert jplan.dec_len == plan.dec_len >= 64
    assert np.array_equal(_u32(decode_packed_cuda(packed, cfg, plan)),
                          _u32(decode_packed_xla(jnp.asarray(want), jcfg,
                                                 jplan)))


def test_fuzz_plain_path_runs_the_jax_trials(capsys):
    """The script's trials on the CPU (plain versions both sides): every
    trial holds, and the counts are the JAX script's (24 + 12 by
    default)."""
    assert fuzz_gpu.run(4, 5000, 3, "cpu") == (7, 7)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 7 and all(line.endswith("-> OK") for line in lines)
    assert fuzz_gpu.main(["2", "5000", "1", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "3/3 trials OK"
    assert fuzz_gpu.run.__defaults__[:2] == (24, 5000)
    plain, window = fuzz_gpu.seeds()
    assert (plain, window) == (range(5000, 5024), range(15000, 15012))
    assert fuzz_gpu.seeds(4, 5000, 3) == (range(5000, 5004),
                                          range(15000, 15003))
    assert len(fuzz_gpu.seeds(20)[1]) == 10 and \
        len(fuzz_gpu.seeds(4)[1]) == 8


def test_scripts_write_json_only_to_out(tmp_path, monkeypatch, capsys):
    """Without --out a script only prints; with it the rows go there, and
    with a configuration list the other configurations' rows stay."""
    monkeypatch.setattr(ber_deep, "CALL_BITS", 4096)
    small = {"s8/b32": ("SOFT8", "b32", (math.inf,)),
             "h/b32": ("HARD", "b32", (math.inf,))}
    monkeypatch.setattr(ber_deep, "CASES", small)
    monkeypatch.chdir(tmp_path)
    assert ber_deep.main(["4096", "--device", "cpu"]) == 0
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "rows.json"
    assert ber_deep.main(["4096", "--device", "cpu", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [(r["config"], r["ben"]) for r in rows] == [("s8/b32", 0),
                                                       ("h/b32", 0)]
    assert ber_deep.main(["4096", "h/b32", "--device", "cpu", "--out",
                          str(out)]) == 0
    assert [r["config"] for r in json.loads(out.read_text())] == \
        ["s8/b32", "h/b32"]
    assert "wrote" in capsys.readouterr().out


def test_ingraph_turns_reports_a_failed_turn(tmp_path):
    """A turn is a process in the checkout's root: on a machine without a
    card its child fails (no fallback to the CPU), and the turn raises
    with the child's error rather than timing anything."""
    repo = Path(__file__).resolve().parents[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ingraph_turns.turn(str(repo), 4096, 5.5, 2, 7)
    with pytest.raises(RuntimeError, match="exited"):
        ingraph_turns.turn(str(tmp_path), 4096, 5.5, 2, 7)
