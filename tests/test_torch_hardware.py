"""The port's hardware model (tpu_viterbi_torch.hardware), timing module
(utils.timing, with the canary K10's plan) and op-cost probe (K11's
scripts/op_cost_probe.py) against the JAX package's, on the CPU; and the
repair that took the CPU fallback out of the entry points.  Whether a card
is present is decided inside each test: the GPU-only cases live in
tests/test_torch_cuda.py."""

import ast
import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_viterbi import hardware as jhardware
from tpu_viterbi.config import ALL_VALID_CONFIGS
from tpu_viterbi.decoder import core_pallas
from tpu_viterbi.decoder.core_xla import plan_blocks as jplan_blocks
from tpu_viterbi_torch import ViterbiGPU, cli, hardware, library
from tpu_viterbi_torch.chain import AddNoise, RandBitGen, genkernel
from tpu_viterbi_torch.chain.decoder_element import ViterbiDecoder
from tpu_viterbi_torch.config import (ChannelIn, DecodeOut, DecoderConfig,
                                      from_reference)
from tpu_viterbi_torch.decoder import core_cuda, core_torch
from tpu_viterbi_torch.decoder.streaming import StreamingViterbi
from tpu_viterbi_torch.scripts import op_cost_probe
from tpu_viterbi_torch.sharding import simulate
from tpu_viterbi_torch.utils import timing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"
SOFT8 = DecoderConfig(ChannelIn.SOFT8)
SOFT8_B16 = DecoderConfig(ChannelIn.SOFT8, decode_out=DecodeOut.O_B16)


def _stub_card(monkeypatch, total_bytes):
    """A CUDA card as the planner sees it, on a machine without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("Props", (), {
                            "total_memory": total_bytes})())


def test_adaptive_smem_budget(monkeypatch):
    """Both hardware models resolve env override > measured per-kind table
    > the smallest measured value, each with its own numbers and variable
    (counterpart of tests/test_guards.py::test_adaptive_vmem_budget), and
    the planner's window decision flips with the port's budget."""
    monkeypatch.delenv("TPU_VITERBI_SMEM_BUDGET", raising=False)
    monkeypatch.delenv("TPU_VITERBI_VMEM_BUDGET", raising=False)
    assert hardware.smem_budget_bytes(kind=H100) == 232448
    assert hardware.smem_budget_bytes(kind="NVIDIA B9000") == 232448
    assert jhardware.vmem_budget_bytes(kind="TPU v5 lite") == 16 * 10 ** 6
    assert jhardware.vmem_budget_bytes(kind="TPU v9000") == 16 * 10 ** 6
    monkeypatch.setenv("TPU_VITERBI_SMEM_BUDGET", str(100_000))
    assert hardware.smem_budget_bytes(kind=H100) == 100_000
    assert jhardware.vmem_budget_bytes(kind="TPU v5 lite") == 16 * 10 ** 6
    monkeypatch.setenv("TPU_VITERBI_VMEM_BUDGET", str(128 * 10 ** 6))
    assert jhardware.vmem_budget_bytes() == 128 * 10 ** 6
    assert hardware.smem_budget_bytes() == 100_000

    # a card whose full store at dec_len 8192 exceeds half its memory:
    # window by necessity while the ring fits, refused when it does not
    plan = core_torch.plan_blocks(32_000_000 - 64, 32, 8192)
    store = plan.n_packs * 64 * plan.num_blocks * 4
    _stub_card(monkeypatch, store)
    ring = core_cuda.ring_bytes(SOFT8)
    monkeypatch.setenv("TPU_VITERBI_SMEM_BUDGET", str(ring))
    assert core_cuda.resolve_window("auto", SOFT8, plan, "cuda") is True
    core_cuda.check_smem(SOFT8)
    monkeypatch.setenv("TPU_VITERBI_SMEM_BUDGET", str(ring - 1))
    with pytest.raises(ValueError, match="neither survivor mode fits"):
        core_cuda.resolve_window("auto", SOFT8, plan, "cuda")
    with pytest.raises(ValueError, match="shared memory"):
        core_cuda.check_smem(SOFT8)
    _stub_card(monkeypatch, 4 * store)          # the store fits: full
    assert core_cuda.resolve_window("auto", SOFT8, plan, "cuda") is False


def test_resolve_window_policy(monkeypatch):
    """Counterpart of tests/test_guards.py::test_resolve_window_policy with
    the ring gate: explicit modes, 'auto' on the CPU and on a card, a bad
    knob, 'window' under a budget its ring exceeds, and the slot count
    equal to JAX's on every config."""
    monkeypatch.delenv("TPU_VITERBI_SMEM_BUDGET", raising=False)
    p8192 = core_torch.plan_blocks(32_000_000 - 64, 32, 8192)
    assert core_cuda.resolve_window("full", SOFT8, p8192) is False
    assert core_cuda.resolve_window("window", SOFT8, p8192) is True
    assert core_cuda.resolve_window("auto", SOFT8, p8192, "cpu") is False
    with pytest.raises(ValueError, match="survivor"):
        core_cuda.resolve_window("circular", SOFT8, p8192)
    _stub_card(monkeypatch, 80 * 10 ** 9)           # an H100's memory
    assert core_cuda.resolve_window("auto", SOFT8, p8192, "cuda") is False
    assert core_cuda.ring_bytes(SOFT8) == 4 * 64 * 64 * 4      # 64 KB
    assert core_cuda.ring_bytes(SOFT8_B16) == 6 * 64 * 64 * 4  # 96 KB
    for cfg in (SOFT8, SOFT8_B16):
        monkeypatch.setenv("TPU_VITERBI_SMEM_BUDGET",
                           str(core_cuda.ring_bytes(cfg) - 1))
        assert core_cuda.resolve_window("window", cfg, p8192, "cuda")
        with pytest.raises(ValueError, match="shared memory") as e:
            core_cuda.check_smem(cfg)
        assert f"budget {core_cuda.ring_bytes(cfg) - 1} bytes" in str(e.value)
    for jcfg in ALL_VALID_CONFIGS:
        assert core_torch.survivor_window_slots(from_reference(jcfg)) == \
            core_pallas.survivor_window_slots(jcfg)


def test_window_wrappers_gate_before_launch_on_cuda(monkeypatch, rng):
    """The ring gate sits in the launch path of every window kernel (K3,
    K4 and K5 with window): a CUDA tensor over budget raises before the
    library is even built.  The tensor is stubbed as a CUDA one."""
    monkeypatch.setenv("TPU_VITERBI_SMEM_BUDGET", "1000")
    plan = core_torch.plan_blocks(32 * 10, 32, 64)

    def never_built(*a, **k):
        raise AssertionError("the library was built before the gate")

    monkeypatch.setattr(library, "load_library", never_built)
    for kernel in (core_cuda.K3, core_cuda.K4, core_cuda.K5):
        before = kernel.launches
        with pytest.raises(ValueError, match="shared memory"):
            kernel._decode(torch.device("cuda"), 0, None, 1, 1, SOFT8, plan,
                           8, True)
        assert kernel.launches == before


@pytest.mark.parametrize("threshold", [48 * 1024 + 1, 99_999, 232448,
                                       (1 << 20) - 1])
def test_probe_smem_budget_finds_the_threshold(threshold):
    """The binary search against an injected predicate: exact at the
    threshold, in about 20 probes of the default range."""
    calls = []

    def fits(nbytes):
        calls.append(nbytes)
        return nbytes <= threshold

    assert hardware.probe_smem_budget(fits=fits) == threshold
    assert len(calls) <= 22
    if threshold < 300_000:
        assert hardware.probe_smem_budget(1000, 300_000, fits) == threshold
    else:
        with pytest.raises(RuntimeError, match="ceiling"):
            hardware.probe_smem_budget(1000, 300_000, fits)


def test_probe_smem_budget_refusals():
    with pytest.raises(RuntimeError, match="floor"):
        hardware.probe_smem_budget(fits=lambda n: False)
    with pytest.raises(RuntimeError, match="ceiling"):
        hardware.probe_smem_budget(fits=lambda n: True)
    with pytest.raises(ValueError, match="lo < hi"):
        hardware.probe_smem_budget(5000, 5000, fits=lambda n: True)

    def broken(nbytes):
        raise RuntimeError("K9 launch failed for a reason other than the "
                           "shared-memory limit")

    with pytest.raises(RuntimeError, match="other than"):
        hardware.probe_smem_budget(fits=broken)


@pytest.mark.parametrize("err,want", [(0, True), (1, False), (2, None),
                                      (9, None), (700, None)])
def test_k9_fits_reads_only_the_limit_as_over_budget(monkeypatch, err,
                                                     want):
    """k9_fits: launched -> True, cudaErrorInvalidValue -> False, any other
    cudaError_t raises (the JAX probe's code-review rule, :131-144)."""
    monkeypatch.setattr(hardware, "K9", lambda nbytes, out: err)
    fits = hardware.k9_fits(torch.zeros((8, 128), dtype=torch.int32))
    if want is None:
        with pytest.raises(RuntimeError, match=f"cudaError_t {err}"):
            fits(65536)
    else:
        assert fits(65536) is want


def test_k9_runs_its_plain_version_on_cpu():
    out = torch.full((8, 128), 7, dtype=torch.int32)
    before = hardware.K9.launches
    assert hardware.K9(48 * 1024, out) == 0
    assert not out.any() and hardware.K9.launches == before
    with pytest.raises(ValueError, match="4096 bytes"):
        hardware.K9(4095, out)
    with pytest.raises(ValueError, match=r"\(8, 128\) int32"):
        hardware.K9(48 * 1024, torch.zeros((8, 64), dtype=torch.int32))


def test_hardware_model_queries_without_card(monkeypatch):
    """device_kind is '' without a card (a query, not a fallback); the ALU
    table holds only measured kinds, each floor the quotient of its
    instructions and instruction rate, a rate below the issue limit (128
    lane-instructions a clock on each of the H100's 132 SMs at 1.98 GHz);
    the store budget is half the card's memory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hardware._device_kind_cached.cache_clear()
    try:
        assert hardware.device_kind() == ""
    finally:
        hardware._device_kind_cached.cache_clear()
    assert hardware.alu_model("NVIDIA B9000") is None
    for _, (floor, ops, rate) in hardware._ALU_MODEL_BY_KIND:
        assert ops == 256 and math.isclose(floor, ops / rate)
    assert hardware.alu_model(H100)[2] < 128 * 132 * 1.98
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hardware.probe_smem_budget()
    _stub_card(monkeypatch, 80 * 10 ** 9)
    assert hardware.survivor_store_budget_bytes("cuda") == 40 * 10 ** 9


@pytest.mark.parametrize("tiles,n_packs", [(16, 256), (2, 64)])
def test_canary_plan_gives_jax_static_arguments(tiles, n_packs):
    """K10's plan: the JAX canary's static arguments (bench.py:73-77:
    n_conv 1, n_emit n_packs - 2, 16 words a pack a block, tiles x 128
    blocks) and JAX's plan for the same message."""
    cfg, plan = timing.canary_plan(tiles, n_packs)
    assert cfg.channel_in == ChannelIn.SOFT8 and cfg.bits_per_pack == 32
    assert core_torch.traceback_shape(cfg, plan) == (1, n_packs - 2)
    assert sum(core_torch.words_per_block(cfg, plan)) == 16 * n_packs
    assert plan.num_blocks == tiles * 128 and plan.n_packs == n_packs
    assert plan.dec_len == 32 * n_packs - 64
    assert plan == core_torch.plan_from_reference(
        jplan_blocks(plan.message_len, 32, plan.dec_len))
    assert not core_torch.needs_int32_renorm(cfg, plan)


def test_canary_words_are_seeded_and_staged(monkeypatch):
    cfg, plan = timing.canary_plan(1, 16)
    a = timing.canary_words(cfg, plan, "cpu")
    assert a.shape == (16 * 16, 128) and a.dtype == torch.int32
    assert torch.equal(a, timing.canary_words(cfg, plan, "cpu"))
    assert not torch.equal(a, timing.canary_words(cfg, plan, "cpu", seed=1))
    # the plain decode of the canary's words: what K4 is held against
    packs = core_cuda.K4(a, cfg, plan)
    assert torch.equal(packs, core_torch.decode_staged_torch(a, cfg, plan))


def test_timing_needs_a_card(monkeypatch):
    with pytest.raises(ValueError, match="CUDA tensor"):
        timing.time_in_graph(lambda x: x + 1, torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        timing.canary_ns(tiles=1, n_packs=16, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.canary_ns()


def _jax_op_cost_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_op_cost_probe", REPO / "scripts" / "op_cost_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", op_cost_probe.VARIANTS)
def test_op_cost_plain_matches_jax_interpret(variant):
    """Each ported variant's plain version after `steps` steps equals the
    JAX probe's make_kernel(variant, steps) run in interpret mode on the
    same (32, 128) numpy input; so does K11's wrapper on a CPU tensor."""
    jprobe = _jax_op_cost_probe()
    assert op_cost_probe.N_OPS[variant] == jprobe.N_OPS[variant]
    assert (op_cost_probe.UNROLL, op_cost_probe.STEPS_LO,
            op_cost_probe.STEPS_HI) == (jprobe.UNROLL, jprobe.STEPS_LO,
                                        jprobe.STEPS_HI)
    steps = 3
    x = np.random.default_rng(5).integers(-2 ** 31, 2 ** 31, (32, 128),
                                          dtype=np.int64).astype(np.int32)
    call = pl.pallas_call(
        jprobe.make_kernel(variant, steps), grid=(1,),
        in_specs=[pl.BlockSpec((32, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((32, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((32, 128), jnp.int32),
        interpret=True)
    want = np.asarray(call(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    assert np.array_equal(op_cost_probe.op_cost_torch(variant, xt,
                                                      steps).numpy(), want)
    before = op_cost_probe.K11.launches
    got = op_cost_probe.K11(variant, xt, steps, 3)
    assert op_cost_probe.K11.launches == before
    assert got.shape == (3, 32, 128)
    assert all(np.array_equal(t.numpy(), want) for t in got)


def test_op_cost_probe_rejections():
    x = op_cost_probe.probe_input("cpu")
    assert x.dtype == torch.int32 and int(x.min()) >= 0 and int(x.max()) <= 6
    with pytest.raises(ValueError, match="unknown variant"):
        op_cost_probe.op_cost_torch("merge", x, 1)
    with pytest.raises(ValueError, match="unknown variant"):
        op_cost_probe.K11("rollsub", x, 1, 1)
    with pytest.raises(ValueError, match="int32 tile"):
        op_cost_probe.K11("add", x.T, 1, 1)
    with pytest.raises(ValueError, match="tiles > 0"):
        op_cost_probe.K11("add", x, 1, 0)


def test_sass_loop_parser():
    """The step loop's SASS count: the shortest backward branch's span,
    with hex or label targets; a branch to itself is no loop."""
    sass = """
        Function : _ZN15viterbi_op_cost14op_cost_kernelILi1EEEvPKiPii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
                                            /* 0x000fe20000000800 */
        /*0010*/                   IADD3 R5, R5, R2, RZ ;
        /*0020*/                   IADD3 R5, R5, R2, RZ ;
        /*0030*/                   ISETP.NE.AND P0, PT, R4, RZ, PT ;
        /*0040*/               @P0 BRA 0x10 ;
        /*0050*/                   EXIT ;
        /*0060*/                   BRA 0x60;
        Function : _ZN15viterbi_op_cost14op_cost_kernelILi0EEEvPKiPii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   IADD3 R5, R5, R2, RZ ;
        /*0020*/               @P0 BRA `(.L_x_0) ;
        /*0030*/                   EXIT ;
"""
    counts = op_cost_probe.loop_instructions(sass)
    assert counts == {
        "_ZN15viterbi_op_cost14op_cost_kernelILi1EEEvPKiPii": 4,
        "_ZN15viterbi_op_cost14op_cost_kernelILi0EEEvPKiPii": 2}


# --- the repair: no entry point runs on the CPU unless asked ---

def _entry_points():
    cfg = SOFT8
    return {
        "ViterbiGPU": lambda: ViterbiGPU(cfg),
        "StreamingViterbi": lambda: StreamingViterbi(cfg),
        "ViterbiDecoder": lambda: ViterbiDecoder(cfg),
        "run_pipeline": lambda: cli.run_pipeline(4000, 15.0, cfg, seed=1),
        "build_sharded_simulation":
            lambda: simulate.build_sharded_simulation(cfg, 4000),
        "simulate_sharded": lambda: simulate.simulate_sharded(cfg, 4000),
        "packed_workload_cuda":
            lambda: genkernel.packed_workload_cuda(1, 4000, ChannelIn.SOFT8,
                                                   5.5, 32.0),
        "RandBitGen": lambda: RandBitGen(4000),
        "AddNoise": lambda: AddNoise(0.5),
    }


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_point_raises_without_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_cli_refuses_without_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["-n", "4000", "-s", "15", "--seed", "3"]
    for extra in ([], ["--e2e-device"], ["--survivor", "window"]):
        assert cli.main(args + extra) == -1
        err = capsys.readouterr().err
        assert err.startswith("Error: no CUDA device") and \
            "--device cpu" in err
    assert cli.main(args + ["--backend", "cuda", "--device", "cpu"]) == -1
    assert capsys.readouterr().err.startswith(
        "Error: backend='cuda' needs a CUDA device (device='cpu')")
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == \
        "Final results -> BEN: 0   BER: 0"


def test_python_m_exits_255_without_device_cpu(tmp_path):
    """`python -m tpu_viterbi_torch` with no visible card and no --device
    cpu exits 255 with an Error line and runs nothing."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = [sys.executable, "-m", "tpu_viterbi_torch", "-n", "4000", "-s",
           "15", "--seed", "3", "--emit-file", str(tmp_path / "c.bin")]
    res = subprocess.run(run, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 255, res.stderr
    assert res.stderr.startswith("Error: no CUDA device")
    assert res.stdout == "" and not (tmp_path / "c.bin").exists()
    res = subprocess.run(run + ["--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[-1] == "Final results -> BEN: 0   BER: 0"


def test_no_cuda_or_cpu_default_left_in_the_port():
    """No module picks the CPU when the card is missing, and no function
    but a plain ``*_torch`` version defaults its ``device`` to the CPU."""
    for path in (REPO / "tpu_viterbi_torch").rglob("*.py"):
        text = path.read_text()
        assert "is_available() else" not in text, path
        for node in ast.walk(ast.parse(text)):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            a = node.args
            pos = a.posonlyargs + a.args
            pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults))
            pairs += [(k, d) for k, d in zip(a.kwonlyargs, a.kw_defaults)
                      if d is not None]
            for arg, default in pairs:
                if arg.arg == "device" and isinstance(default, ast.Constant) \
                        and default.value == "cpu":
                    assert node.name.endswith("_torch"), \
                        f"{path}:{node.lineno} {node.name}(device='cpu')"


@pytest.mark.parametrize("kernel", [genkernel.K7, genkernel.K8])
def test_generator_wrappers_default_to_the_card(monkeypatch, kernel):
    """K7/K8 called without ``device`` run on the card, and raise without
    one instead of running the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    channel = ChannelIn.FP32 if kernel is genkernel.K8 else ChannelIn.SOFT8
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel(0, 1, 1000, channel, 0.0, 32.0)


def test_constants_match_the_cuda_sources():
    """The numbers Python passes to or assumes of the kernels are the
    sources' own: K3's ring size uses viterbi.cu's threads a CUDA block,
    and the attribute numbers hardware.py passes are hardware.cu's
    static_asserts."""
    csrc = REPO / "tpu_viterbi_torch" / "csrc"
    threads = re.findall(r"constexpr int kThreads = (\d+);",
                         (csrc / "viterbi.cu").read_text())
    assert threads == [str(core_cuda.K_THREADS)]
    asserts = dict(re.findall(r"static_assert\((cudaDevAttr\w+) == (\d+)",
                              (csrc / "hardware.cu").read_text()))
    assert asserts == {
        "cudaDevAttrClockRate": str(hardware.ATTR_CLOCK_RATE),
        "cudaDevAttrMaxSharedMemoryPerBlockOptin":
            str(hardware.ATTR_MAX_SMEM_PER_BLOCK_OPTIN)}
    assert core_cuda.SOURCE.parent == library.CSRC == csrc
    assert genkernel.SOURCE.parent == op_cost_probe.K11.source.parent == csrc
