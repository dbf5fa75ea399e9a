"""The port's timing sweeps (tpu_viterbi_torch/scripts/channel_throughput.py,
small_msg_sweep.py, scaling_curve.py and what they share in
sweep_common.py) against the JAX package's scripts on the CPU: the tables
are the JAX scripts' (their module constants, the defaults of their
functions, and the lists local to their ``main``, restated here), JAX's
dec_len pick is its VMEM rule at the TPU's budget, every row's plan is
JAX's ``plan_blocks``/``auto_dec_len`` arithmetic, a row's decode equals
``decode_packed_xla`` word for word on numpy words from a seed, and each
script's ``main --device cpu`` writes rows with JAX's keys and no times,
and exits 1 on a miss.  The timed rows run only on a card
(tests/test_torch_cuda.py, chip_smoke.py phases 47-49)."""

import importlib.util
import inspect
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_viterbi.config import ChannelIn as JChannelIn
from tpu_viterbi.config import DecoderConfig as JDecoderConfig
from tpu_viterbi.decoder import api as japi
from tpu_viterbi.decoder import core_pallas, core_xla
from tpu_viterbi.hardware import vmem_budget_bytes
from tpu_viterbi_torch.config import ChannelIn, DecoderConfig
from tpu_viterbi_torch.decoder import api, core_cuda, core_torch
from tpu_viterbi_torch.scripts import ber_common
from tpu_viterbi_torch.scripts import channel_throughput as ct
from tpu_viterbi_torch.scripts import scaling_curve as sc
from tpu_viterbi_torch.scripts import small_msg_sweep as sm
from tpu_viterbi_torch.scripts import sweep_common
from tpu_viterbi_torch.utils.timing import queued_s

REPO = Path(__file__).resolve().parents[1]
CHANNELS = ("HARD", "SOFT4", "SOFT8", "SOFT16", "FP32")
torch.set_num_threads(1)


def _jax_script(name: str):
    """scripts/<name>.py loaded afresh, with scripts/ on the path only
    while it loads (the sweeps import timing_util from there)."""
    path = str(REPO / "scripts")
    sys.path.insert(0, path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", REPO / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(path)
    return mod


def _default(fn, arg: str):
    return inspect.signature(fn).parameters[arg].default


# --- the tables are JAX's ----------------------------------------------------

def test_channel_table_is_the_jax_scripts():
    jct = _jax_script("channel_throughput")
    assert ct.SCALES == jct.SCALES
    assert ct.SNR_DB == _default(jct.measure, "snr_db") == 5.5
    # local to the JAX script's measure() and main(): the seeds
    # PRNGKey(7 + i) of n_inputs = 6 workloads, the candidates, the 1e-2
    # rule, the channel order and the 32M-bit default
    assert (ct.SEED0, ct.N_INPUTS, ct.MAX_BER) == (7, 6, 1e-2)
    assert ct.CHANNELS == CHANNELS
    assert ct.MESSAGE_LEN == 32_000_000
    for name in CHANNELS:
        want = (2048, 8192, 4096, 1024) if name == "FP32" else \
            (8192, 4096, 2048, 1024)
        assert ct.candidates(DecoderConfig(ChannelIn[name])) == want


def test_small_msg_table_is_the_jax_scripts():
    jsm = _jax_script("small_msg_sweep")
    assert (_default(jsm.point, "reps"), _default(jsm.point, "target_s")) \
        == (sweep_common.REPS, sweep_common.TARGET_S) == (3, 0.04)
    assert sm.SIZES == (99_968, 249_984, 1_000_000, 3_999_872)
    assert sm.CANDIDATES == (8192, 4096, 2048, 1024, 512)
    assert (sm.ANCHOR, sm.ANCHOR_DEC_LEN, sm.ANCHOR_TARGET_S,
            sm.SEED_STEP) == (32_000_000, 8192, 0.06, 100)
    # JAX main()'s loop with its dl_eff dedup, then the anchor
    want = []
    for m in (99_968, 249_984, 1_000_000, 3_999_872):
        seen = set()
        for dl in (8192, 4096, 2048, 1024, 512, core_xla.auto_dec_len(m, 32)):
            eff = max(32, min(dl, m) - min(dl, m) % 32)
            if eff not in seen:
                seen.add(eff)
                want.append((m, dl))
    want.append((32_000_000, 8192))
    rows = sm.row_table()
    assert [(m, dl) for m, dl, card in rows if not card] == want
    card = [(m, dl) for m, dl, c in rows if c]
    assert {dl for _, dl in card} == set(sm.CARD_ONLY) == {256, 128, 64}
    assert len(card) == 3 * len(sm.SIZES)
    for m in sm.SIZES:
        theirs = {sm.dl_eff(dl, m) for mm, dl in want if mm == m}
        assert not theirs & {sm.dl_eff(dl, m) for mm, dl in card if mm == m}


def test_scaling_table_is_the_jax_scripts():
    jsc = _jax_script("scaling_curve")
    assert (_default(jsc.point, "reps"), _default(jsc.point, "target_s")) \
        == (sweep_common.REPS, sweep_common.TARGET_S)
    sizes = (99_968, 249_984, 1_000_000, 4_000_000, 16_000_000, 32_000_000,
             64_000_000, 128_000_000)
    assert sc.SIZES == sizes and sc.SEED0 == 17
    assert api.DEFAULT_DEC_LEN == japi.DEFAULT_DEC_LEN == 2048
    assert sc.row_table() == [
        (m, p, core_xla.auto_dec_len(m, 32) if p == "jax_auto" else 2048)
        for m in sizes for p in ("jax_auto", "default")]


@pytest.mark.parametrize("m", [99_968, 3_999_872, 32_000_000, 128_000_000])
@pytest.mark.parametrize("target_s", [0.04, 0.06])
def test_k_is_the_jax_scripts(m, target_s):
    """K decodes at JAX's 4.5 Gb/s estimate take target_s, at most 2048
    (small_msg_sweep.py:56-57, scaling_curve.py:46)."""
    assert sweep_common.amplify_k(m, target_s) == \
        max(2, min(2048, int(target_s / (m / 4.5e9)) + 1))


@pytest.fixture
def tpu_budget(monkeypatch):
    budget = vmem_budget_bytes("TPU v5 lite")
    assert budget == ber_common.TPU_VMEM_BUDGET
    monkeypatch.setenv("TPU_VITERBI_VMEM_BUDGET", str(budget))


def test_jax_pick_is_the_vmem_rule(tpu_budget):
    """The JAX script's first candidate whose fused kernel fits the TPU's
    VMEM (``pallas_supported`` past its backend test)."""
    picks = {}
    for name in CHANNELS:
        jcfg = JDecoderConfig(channel_in=JChannelIn[name])
        m = jcfg.get_message_len(2 * ct.MESSAGE_LEN)
        cfg = DecoderConfig(ChannelIn[name])
        for dl in ct.candidates(cfg):
            jplan = core_xla.plan_blocks(m, jcfg.bits_per_pack, dl)
            if core_pallas.vmem_footprint_bytes(jcfg, jplan) <= \
                    vmem_budget_bytes():
                break
        picks[name] = ct.jax_pick(cfg, m)
        assert picks[name] == jplan.dec_len
    assert picks == {"HARD": 8192, "SOFT4": 8192, "SOFT8": 8192,
                     "SOFT16": 4096, "FP32": 2048}


# --- the plans ---------------------------------------------------------------

def _plans(table: str):
    """[(m, dec_len)] of a sweep's rows at its full table."""
    if table == "small":
        return [(m, dl) for m, dl, _ in sm.row_table()]
    if table == "scaling":
        return [(m, dl) for m, _, dl in sc.row_table()]
    return [(DecoderConfig(ChannelIn[n]).get_message_len(2 * ct.MESSAGE_LEN),
             dl) for n in CHANNELS
            for dl in ct.candidates(DecoderConfig(ChannelIn[n]))]


@pytest.mark.parametrize("table", ["small", "scaling", "channel"])
def test_row_plans_are_jax_arithmetic(table):
    """dec_len, blocks, 128-block tiles and JAX's ns_per_stage stages."""
    for m, dl in _plans(table):
        plan = core_torch.plan_blocks(m, 32, dl)
        jplan = core_xla.plan_blocks(m, 32, dl)
        assert (plan.dec_len, plan.num_blocks, plan.n_packs) == \
            (jplan.dec_len, jplan.num_blocks, jplan.n_packs)
        tiles = -(-jplan.num_blocks // core_pallas.LANE_TILE)
        assert sweep_common.tiles_stages(plan) == \
            (tiles, tiles * jplan.n_packs * jplan.bits_per_pack)
    if table == "channel":
        got = [(p.message_len, p.dec_len) for n in CHANNELS for p in
               ct.row_plans(DecoderConfig(ChannelIn[n]),
                            DecoderConfig(ChannelIn[n]).get_message_len(
                                2 * ct.MESSAGE_LEN))]
        assert got == _plans("channel")


# --- a row's decode against the XLA core -------------------------------------

@pytest.mark.parametrize("dec_len", [1024, 2048])
@pytest.mark.parametrize("name", CHANNELS)
def test_row_decode_equals_xla(name, dec_len):
    """The sweeps' decode (``Decodes``, decode_packed_cuda: its plain
    version on CPU tensors) on about 16k bits of numpy words from a seed,
    word for word against ``decode_packed_xla``."""
    jcfg = JDecoderConfig(channel_in=JChannelIn[name])
    cfg = DecoderConfig(ChannelIn[name])
    m = cfg.get_message_len(2 * 16_448)
    assert m == jcfg.get_message_len(2 * 16_448) == 16_384
    n = cfg.get_input_words(2 * (m + 64))
    rng = np.random.default_rng(2200 + dec_len)
    x = (rng.standard_normal(n) * 6).astype(np.float32) if name == "FP32" \
        else rng.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int32)
    decode = sweep_common.Decodes()
    got = decode(torch.from_numpy(x), cfg, core_torch.plan_blocks(
        m, 32, dec_len)).numpy().astype(np.int64) & 0xFFFFFFFF
    want = np.asarray(core_xla.decode_packed_xla(
        jnp.asarray(x), jcfg, core_xla.plan_blocks(m, 32, dec_len)))
    assert decode.calls == 1
    np.testing.assert_array_equal(got, want.astype(np.int64) & 0xFFFFFFFF)


# --- main --device cpu -------------------------------------------------------

JAX_KEYS = {
    "channel": {"channel", "dec_len", "message_len", "ben_at_5p5dB",
                "kernel_seconds", "gbps", "ns_per_stage"},
    "small": {"message_len", "dec_len", "K", "decode_seconds", "gbps",
              "blocks", "tiles", "ns_per_stage"},
    "scaling": {"message_len", "dec_len", "decode_seconds", "gbps",
                "blocks"}}
ADDED = {
    "channel": {"kernel", "metrics", "decode_check_seconds", "bound_ms",
                "share_of_bound", "jax_pick"},
    "small": {"graph_seconds", "card_only", "fastest"},
    "scaling": {"dec_len_policy", "graph_seconds", "fastest"}}
TIMES = {"kernel_seconds", "decode_seconds", "graph_seconds",
         "decode_check_seconds", "gbps", "ns_per_stage", "bound_ms",
         "share_of_bound"}
MAINS = {"channel": (ct, "1088"), "small": (sm, "2048"),
         "scaling": (sc, "4096")}


@pytest.mark.parametrize("which", ["channel", "small", "scaling"])
def test_main_on_cpu_writes_rows_without_times(which, tmp_path):
    mod, size = MAINS[which]
    out = tmp_path / "rows.json"
    assert mod.main([size, "--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    if which == "channel":
        assert (doc["message_len"], doc["device"]) == (1088, "cpu")
        rows = doc["channels"]
        assert [r["channel"] for r in rows] == list(CHANNELS)
        assert all(r["jax_pick"] and r["ben_at_5p5dB"] == 0 for r in rows)
        assert [r["kernel"] for r in rows] == ["K1"] * 4 + ["K2"]
        assert [r["metrics"] for r in rows] == \
            ["int16x2"] * 3 + ["int32", "int16x2"]
    else:
        rows = doc
        m = int(size)
        want = [(m, core_torch.plan_blocks(m, 32, dl).dec_len)
                for m, dl, _ in sm.row_table([m], anchor=False)] \
            if which == "small" else [(m, dl) for m, _, dl in
                                      sc.row_table([m])]
        assert [(r["message_len"], r["dec_len"]) for r in rows] == want
        assert not any(r.get("fastest") for r in rows)
    for r in rows:
        assert JAX_KEYS[which] | ADDED[which] <= set(r)
        assert all(r[k] is None for k in TIMES & set(r))
        assert r["calls"] == 1


def test_channel_ber_miss_exits_1(monkeypatch, capsys):
    """JAX's rule: a row whose BER exceeds 1e-2 fails, named."""
    monkeypatch.setattr(ct, "SNR_DB", -3.0)
    assert ct.main(["1088", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL HARD dec_len 1024: BER" in out and "above 0.01" in out


@pytest.mark.parametrize("which", ["small", "scaling"])
def test_plain_miss_exits_1(which, monkeypatch, capsys):
    """A first call that differs from the plain decode fails, named."""
    real = core_cuda.decode_packed_cuda
    monkeypatch.setattr(core_cuda, "decode_packed_cuda",
                        lambda w, cfg, plan: real(w, cfg, plan) ^ 1)
    mod, size = MAINS[which]
    assert mod.main([size, "--device", "cpu"]) == 1
    assert f"FAIL m={size} dec_len " in capsys.readouterr().out


def test_queued_s_refuses_cpu_tensors():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        queued_s(lambda w: w, [x], 4)


def test_sweeps_never_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is here: the sweep would run on it")
    for mod, size in MAINS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([size])


@pytest.mark.parametrize("graphs", [True, False])
def test_mark_fastest_prefers_the_graph_time(graphs):
    """Each size's fastest row is read from graph_seconds where every row
    of the size has one (the queued slope of a short decode reads the
    host), else from decode_seconds."""
    def row(m, dl, queued, graph):
        return {"message_len": m, "dec_len": dl, "decode_seconds": queued,
                "graph_seconds": graph if graphs else None,
                "fastest": False}
    rows = [row(1000, 256, 0.8e-4, 0.5e-4), row(1000, 64, 0.9e-4, 0.3e-4),
            row(9000, 512, 2e-4, 1e-4), row(9000, 128, 3e-4, 0.9e-4)]
    lines = []
    sweep_common.mark_fastest(rows, lines.append)
    want = [64, 128] if graphs else [256, 512]
    assert [r["dec_len"] for r in rows if r["fastest"]] == want
    key = "graph_seconds" if graphs else "decode_seconds"
    assert all(f"by {key}" in line for line in lines) and len(lines) == 2
