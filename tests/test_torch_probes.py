"""The port's layout probe (K12), ACS variants (K14) and ILP probe (K15)
against the JAX package's probe scripts, on the CPU: each variant's plain
version, and its kernel's wrapper on a CPU tensor, is bit-equal to the
script's Pallas kernel run in interpret mode on the same numpy input, at
reduced stage and step counts set on the loaded script module; the
wrappers refuse what their kernels do not take; the SASS readers parse
cuobjdump's listings.  The kernels themselves run only on a card
(tests/test_torch_cuda.py)."""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_viterbi_torch.scripts import acs_variants_bench as acs
from tpu_viterbi_torch.scripts import common, ilp_probe, layout_probe

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _jax_script(name: str):
    """scripts/<name>.py loaded afresh as a module of its own (a test sets
    its reduced sizes on it); scripts/ is on the path only while it loads
    (kernel_ablation imports layout_probe)."""
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


def _interpret(kernel, x: np.ndarray, out_shape, in_index, out_index):
    call = pl.pallas_call(
        kernel, grid=(1,),
        in_specs=[pl.BlockSpec(x.shape, in_index)],
        out_specs=pl.BlockSpec(out_shape, out_index),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int32),
        interpret=True)
    return np.asarray(call(jnp.asarray(x)))


# --- K12: the layout probe ---

LAYOUT_STAGES = 64


@pytest.mark.parametrize("variant", layout_probe.VARIANTS)
def test_layout_plain_matches_jax_interpret(variant):
    """One JAX program (two tiles for dual) at 64 stages on values
    0..7999: the port's last program equals the JAX kernel's output."""
    jprobe = _jax_script("layout_probe")
    assert (layout_probe.STAGES, layout_probe.GRID, layout_probe.ROWS) == \
        (jprobe.STAGES, jprobe.GRID, 192)
    kernel = dict(real=jprobe._real_kernel, dual=jprobe._dual_kernel,
                  lanes=jprobe._lanes_kernel)[variant]
    rows = layout_probe.ROWS * layout_probe.TILES_A_PROGRAM[variant]
    x = np.random.default_rng(11).integers(0, 8000, (rows, 128)) \
        .astype(np.int32)
    want = _interpret(functools.partial(kernel, stages=LAYOUT_STAGES), x,
                      (64, 128), lambda i: (i, 0), lambda i: (0, 0))
    xt = torch.from_numpy(x)
    got = layout_probe.layout_torch(variant, xt, LAYOUT_STAGES)
    assert got.shape == (1, 64, 128) and got.dtype == torch.int32
    assert np.array_equal(got[-1].numpy(), want)
    before = layout_probe.K12.launches
    assert torch.equal(layout_probe.K12(variant, xt, LAYOUT_STAGES), got)
    assert layout_probe.K12.launches == before


def test_layout_programs_are_independent():
    """Several programs: each is the plain version of its own tile, and
    dual's program g is the sum of real's programs 2g and 2g + 1."""
    x = layout_probe.probe_input(4, "cpu", seed=3)
    real = layout_probe.layout_torch("real", x, 32)
    for g in range(4):
        one = layout_probe.layout_torch("real", x[g * 192:(g + 1) * 192], 32)
        assert torch.equal(real[g], one[0])
    dual = layout_probe.layout_torch("dual", x, 32)
    assert torch.equal(dual, real[0::2] + real[1::2])
    assert layout_probe.layout_torch("lanes", x, 32).shape == (4, 64, 128)


def test_layout_rejections():
    x = layout_probe.probe_input(1, "cpu")
    assert x.dtype == torch.int32 and int(x.min()) >= 0 and \
        int(x.max()) < 8000
    with pytest.raises(ValueError, match="unknown variant"):
        layout_probe.K12("rotating", x, 32)
    with pytest.raises(ValueError, match="int32 tile"):
        layout_probe.K12("dual", x, 32)         # one tile: half a program
    with pytest.raises(ValueError, match="int32 tile"):
        layout_probe.K12("real", x.to(torch.int64), 32)
    with pytest.raises(ValueError, match="int32 tile"):
        layout_probe.K12("real", x[:100], 32)
    with pytest.raises(ValueError, match="multiple of 32"):
        layout_probe.K12("lanes", x, 48)
    with pytest.raises(ValueError, match="contiguous"):
        layout_probe.K12("real", x.t().contiguous().t(), 32)


# --- K14: the ACS variants ---

ACS_PACKS = 2


@pytest.mark.parametrize("variant", acs.VARIANTS)
def test_acs_variants_plain_match_jax_interpret(variant):
    """N_PACKS = 2 (64 stages) on one 128-array tile of values -100..100."""
    jbench = _jax_script("acs_variants_bench")
    assert (acs.N_PACKS, acs.BPP, acs.N_TILES) == \
        (jbench.N_PACKS, jbench.BPP, jbench.N_TILES)
    jbench.N_PACKS, jbench.STAGES = ACS_PACKS, ACS_PACKS * acs.BPP
    kernel = jbench.make_tb_kernel() if variant == "bit_tb" else \
        jbench.make_fwd_kernel(variant)
    x = np.random.default_rng(12).integers(-100, 101,
                                           (ACS_PACKS, 32, 2, 128)) \
        .astype(np.int32)
    want = _interpret(kernel, x, (64, 128), lambda i: (0, 0, 0, i),
                      lambda i: (0, i))
    xt = torch.from_numpy(x)
    got = acs.acs_variants_torch(variant, xt)
    assert np.array_equal(got.numpy(), want)
    before = acs.K14.launches
    assert torch.equal(acs.K14(variant, xt), got)
    assert acs.K14.launches == before


def test_acs_variants_columns_are_independent():
    rs = acs.probe_input(2, 300, "cpu", seed=4)
    for v in acs.VARIANTS:
        whole = acs.acs_variants_torch(v, rs)
        part = acs.acs_variants_torch(v, rs[..., 128:256].contiguous())
        assert torch.equal(whole[:, 128:256], part)


def test_acs_variants_rejections():
    rs = acs.probe_input(1, 128, "cpu")
    assert int(rs.min()) >= -100 and int(rs.max()) <= 100
    with pytest.raises(ValueError, match="unknown variant"):
        acs.K14("rep2", rs)
    with pytest.raises(ValueError, match="int32"):
        acs.K14("full", rs[:, :16].contiguous())
    with pytest.raises(ValueError, match="int32"):
        acs.K14("eo", rs.to(torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        acs.K14("decbits", rs[..., ::2])


# --- K15: the ILP probe ---

ILP_STEPS = 5


@pytest.mark.parametrize("chains", ilp_probe.CHAINS)
def test_ilp_plain_matches_jax_interpret(chains):
    """STEPS = 5 on a full-range tile (the sums wrap): the plain version,
    and the wrapper's every element at its tile position, equal the JAX
    kernel's output."""
    jilp = _jax_script("ilp_probe")
    assert (ilp_probe.UNROLL, ilp_probe.STEPS, ilp_probe.ROWS) == \
        (jilp.UNROLL, jilp.STEPS, jilp.ROWS)
    jilp.STEPS = ILP_STEPS
    x = np.random.default_rng(13).integers(-2 ** 31, 2 ** 31, (32, 128),
                                           dtype=np.int64).astype(np.int32)
    want = _interpret(jilp.make_kernel(chains), x, (32, 128),
                      lambda i: (0, 0), lambda i: (0, 0))
    xt = torch.from_numpy(x)
    assert np.array_equal(ilp_probe.ilp_torch(chains, xt, ILP_STEPS).numpy(),
                          want)
    before = ilp_probe.K15.launches
    got = ilp_probe.K15(chains, xt, ILP_STEPS, 40, 128)
    assert ilp_probe.K15.launches == before
    assert got.shape == (40 * 128,)
    flat = want.reshape(-1)
    assert np.array_equal(got.numpy(), flat[np.arange(got.numel()) % 4096])


def test_ilp_rejections(monkeypatch):
    x = ilp_probe.probe_input("cpu")
    assert int(x.min()) >= 0 and int(x.max()) <= 6
    with pytest.raises(ValueError, match="unknown chain count"):
        ilp_probe.K15(3, x, 1, 1, 32)
    with pytest.raises(ValueError, match="int32"):
        ilp_probe.K15(1, x.T, 1, 1, 32)
    with pytest.raises(ValueError, match="multiple of 32"):
        ilp_probe.K15(2, x, 1, 1, 48)
    with pytest.raises(ValueError, match="multiple of 32"):
        ilp_probe.K15(2, x, 1, 0, 32)
    with pytest.raises(ValueError, match="steps"):
        ilp_probe.K15(4, x, -1, 1, 32)
    with pytest.raises(ValueError, match="unknown occupancy"):
        ilp_probe.grid("half")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ilp_probe.grid("sched")


# --- what the SASS says ---

SASS = """
        Function : _ZN16viterbi_ablation15ablation_kernelILi3EEEvPKiPjPiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   IADD3 R5, R5, R2, RZ ;
.L_x_1:
        /*0020*/                   IADD3 R5, R5, R2, RZ ;
        /*0030*/                   IADD3 R5, R5, R2, RZ ;
        /*0040*/                   IADD3 R5, R5, R2, RZ ;
        /*0050*/               @P0 BRA `(.L_x_1) ;
        /*0060*/                   STG.E [R2.64], R5 ;
        /*0070*/               @P1 BRA `(.L_x_0) ;
.L_x_2:
        /*0080*/                   LDG.E R4, [R2.64] ;
        /*0090*/               @P2 BRA `(.L_x_2) ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
"""


def test_stage_loop_is_the_longest_innermost_loop():
    """The stage loop (4 instructions) is taken, not the pack loop around
    it (7) nor the traceback loop beside it (2); loop_instructions keeps
    the shortest, as op_cost_probe reads it."""
    name = "_ZN16viterbi_ablation15ablation_kernelILi3EEEvPKiPjPiii"
    assert common.stage_loop_instructions(SASS) == {name: 4}
    assert common.loop_instructions(SASS) == {name: 2}
    assert sorted(n for _, _, n in common.loop_spans(SASS)[name]) == [2, 4, 7]
    assert common.pick({name: 4, "_Z3fooILi2E": 1}, "ablation", "ILi3E") == 4
    with pytest.raises(RuntimeError, match="0 kernels"):
        common.pick({name: 4}, "ILi2E")


def test_resource_usage_parser():
    text = """
Resource usage:
 Common:
  GLOBAL:0
 Function _ZN14viterbi_layout18layout_dual_kernelEPKiPiii:
  REG:255 STACK:1024 SHARED:0 LOCAL:0 CONSTANT[0]:920 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN14viterbi_layout18layout_real_kernelEPKiPiii:
  REG:168 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:920 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
    usage = common.resource_usage(text)
    dual = usage["_ZN14viterbi_layout18layout_dual_kernelEPKiPiii"]
    assert (dual["REG"], dual["STACK"], dual["LOCAL"]) == (255, 1024, 0)
    assert dual["CONSTANT[0]"] == 920
    assert common.pick(usage, "layout_real_kernel")["REG"] == 168


def test_branch_signs_are_the_tap_parities():
    """s0, s1 of predecessor q: 2 parity(2q & tap mask) - 1 (the JAX
    probes' _TAP_MASK0/1, core_pallas.py:92-93)."""
    from tpu_viterbi.decoder.core_pallas import _TAP_MASK0, _TAP_MASK1
    s0, s1 = common.branch_signs()
    for q in range(32):
        assert s0[q] == 2 * (bin(2 * q & _TAP_MASK0).count("1") % 2) - 1
        assert s1[q] == 2 * (bin(2 * q & _TAP_MASK1).count("1") % 2) - 1
