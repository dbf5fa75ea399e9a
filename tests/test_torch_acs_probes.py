"""The port's ACS-arithmetic probes against the JAX package's probe
scripts, on the CPU: the construct microbenchmark (K16), the dtype
throughput probe (K17), the int16x2 SWAR ACS (K18) and the 16-bit ACS
variants (K19).  Each variant's plain version, and its kernel's wrapper on
a CPU tensor, is bit-equal (tolerance 0) to the script's Pallas kernel run
in interpret mode on the same numpy input, at reduced pack, stage and step
counts set on the loaded script module; cases on inputs near the int16 and
int8 limits reach the wraps, and one reaches bf16's rounding; the wrappers
refuse what their kernels do not take.  The kernels themselves run only on
a card (tests/test_torch_cuda.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_probes import _interpret, _jax_script
from tpu_viterbi_torch.scripts import (acs_variants_bench, dtype_throughput,
                                       kernel_microbench, opt_bench,
                                       swar_probe)

torch.set_num_threads(1)


def _rs(seed: int, n_packs: int, width: int, lim: int = 100) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -lim, lim + 1, (n_packs, 32, 2, width)).astype(np.int32)


# --- K16: the construct microbenchmark ---

MICRO_PACKS = 2


@pytest.mark.parametrize("variant", kernel_microbench.VARIANTS)
def test_microbench_plain_matches_jax_interpret(variant):
    """N_PACKS = 2 (64 stages) on one 128-array tile of values -100..100:
    the plain version and the CPU wrapper equal the JAX kernel's output."""
    jmb = _jax_script("kernel_microbench")
    km = kernel_microbench
    assert (km.N_PACKS, km.BPP, km.N_TILES) == \
        (jmb.N_PACKS, jmb.BPP, jmb.N_TILES)
    jmb.N_PACKS = MICRO_PACKS
    x = _rs(21, MICRO_PACKS, 128)
    want = _interpret(jmb.make_kernel(variant), x, (64, 128),
                      lambda i: (0, 0, 0, i), lambda i: (0, i))
    xt = torch.from_numpy(x)
    got = km.microbench_torch(variant, xt)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    before = km.K16.launches
    assert torch.equal(km.K16(variant, xt), got)
    assert km.K16.launches == before


def test_microbench_relayouts():
    """pltpu_repeat is concat ([x; x]).  Every state starts at zero and
    sees the one bm of its stage, so all 64 rows stay equal and bcast's
    output is concat's too: the variants differ in the registers they
    read, not in the function.  Columns are independent."""
    rs = kernel_microbench.probe_input(2, 300, "cpu", seed=5)
    f = kernel_microbench.microbench_torch
    assert torch.equal(f("pltpu_repeat", rs), f("concat", rs))
    bcast = f("bcast", rs)
    assert torch.equal(bcast, f("concat", rs))
    assert torch.equal(bcast, bcast[:1].expand_as(bcast))
    assert not torch.equal(f("no_pp", rs), bcast)
    for v in kernel_microbench.VARIANTS:
        part = f(v, rs[..., 128:256].contiguous())
        assert torch.equal(f(v, rs)[:, 128:256], part)


_PLAIN = {kernel_microbench: kernel_microbench.microbench_torch,
          acs_variants_bench: acs_variants_bench.acs_variants_torch,
          opt_bench: opt_bench.opt_bench_torch}


@pytest.mark.parametrize("mod, variant, rows", [
    *((kernel_microbench, v, 1) for v in kernel_microbench.VARIANTS),
    (acs_variants_bench, "full", 1), (acs_variants_bench, "pp_noshuf", 1),
    (acs_variants_bench, "decbits", 2), (acs_variants_bench, "eo", 64),
    *((opt_bench, v, 64) for v in opt_bench.VARIANTS)],
    ids=lambda p: p.__name__.rsplit(".", 1)[1] if hasattr(p, "__name__")
    else str(p))
def test_stage_pair_bounds_count_distinct_rows(mod, variant, rows):
    """The bounds of K14, K16 and K19 (their OPS) count one state's metric
    update a stage, since all 64 path metrics start at zero and see one bm
    a stage, plus an update for each of ``rows`` survivor rows: no array's
    output (pm + pp) has more distinct rows, and some array has that many
    (the butterflies' rows merge where a recent stage's bm is 0)."""
    out = _PLAIN[mod](variant, mod.probe_input(2, 40, "cpu", seed=13))
    assert max(len(set(out[:, c].tolist()))
               for c in range(out.shape[1])) == rows


def test_microbench_rejections():
    rs = kernel_microbench.probe_input(1, 128, "cpu")
    assert rs.dtype == torch.int32 and int(rs.min()) >= -100 and \
        int(rs.max()) <= 100
    K16 = kernel_microbench.K16
    with pytest.raises(ValueError, match="unknown variant"):
        K16("rep2", rs)
    with pytest.raises(ValueError, match="int32"):
        K16("bcast", rs[:, :16].contiguous())
    with pytest.raises(ValueError, match="int32"):
        K16("concat", rs.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        K16("no_pp", rs[..., ::2])


# --- K17: the dtype throughput probe ---

DTYPE_STEPS = 3


def _jax_dtype(dtype: str, x: np.ndarray, steps: int) -> np.ndarray:
    jdt = _jax_script("dtype_throughput")
    assert (dtype_throughput.UNROLL, dtype_throughput.STEPS,
            dtype_throughput.ROWS) == (jdt.UNROLL, jdt.STEPS, jdt.ROWS)
    jdt.STEPS = steps
    d = dict(int32=jnp.int32, int16=jnp.int16, bf16=jnp.bfloat16,
             fp16=jnp.float16, fp32=jnp.float32, int8=jnp.int8)[dtype]
    call = pl.pallas_call(jdt.make_kernel(d),
                          out_shape=jax.ShapeDtypeStruct((32, 128),
                                                         jnp.int32),
                          interpret=True)
    return np.asarray(call(jnp.asarray(x)))


def _check_dtype(dtype: str, x: np.ndarray, steps: int) -> torch.Tensor:
    """The plain version and every element of the CPU wrapper's output at
    its tile position equal the JAX kernel's output; returns the plain
    result."""
    want = _jax_dtype(dtype, x, steps)
    xt = torch.from_numpy(x)
    got = dtype_throughput.dtype_torch(dtype, xt, steps)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    K17 = dtype_throughput.K17
    before = K17.launches
    flat = K17(dtype, xt, steps, 20, 128)
    assert K17.launches == before
    assert flat.shape == (20 * 128 * dtype_throughput.PACK[dtype],)
    assert np.array_equal(flat.numpy(), want.reshape(-1)[
        np.arange(flat.numel()) % 4096])
    return got


@pytest.mark.parametrize("dtype", dtype_throughput.DTYPES)
def test_dtype_plain_matches_jax_interpret(dtype):
    """STEPS = 3 on the probe's values 0..6 (bf16 rounds past 256)."""
    x = np.random.default_rng(1).integers(0, 7, (32, 128)).astype(np.int32)
    _check_dtype(dtype, x, DTYPE_STEPS)


def test_dtype_bf16_rounding_shows():
    """At 3 steps on 0..6 the sums pass 256, where bf16 keeps 8 bits: its
    result differs from int32's at some element (JAX's does the same)."""
    x = dtype_throughput.probe_input("cpu").numpy()
    bf16 = _check_dtype("bf16", x, DTYPE_STEPS)
    i32 = dtype_throughput.dtype_torch("int32", torch.from_numpy(x),
                                       DTYPE_STEPS)
    assert not torch.equal(bf16, i32)
    assert int((bf16 - i32).abs().max()) <= 4


@pytest.mark.parametrize("dtype,lim", [("int16", 16000), ("int8", 100)])
def test_dtype_narrow_types_wrap(dtype, lim):
    """Inputs near the type's limits: the narrow sums wrap, so the result
    differs from int32's, and still equals JAX's."""
    x = np.random.default_rng(2).integers(-lim, lim + 1, (32, 128)) \
        .astype(np.int32)
    got = _check_dtype(dtype, x, 2)
    i32 = dtype_throughput.dtype_torch("int32", torch.from_numpy(x), 2)
    assert not torch.equal(got, i32)


def test_dtype_float_conversion_saturates():
    """fp16 runs past its range to inf; a.astype(int32) saturates as XLA's
    conversion does."""
    x = np.full((32, 128), 30000, np.int32)
    got = _check_dtype("fp16", x, 1)
    assert int(got.max()) == 2 ** 31 - 1


def test_dtype_rejections(monkeypatch):
    x = dtype_throughput.probe_input("cpu")
    assert int(x.min()) >= 0 and int(x.max()) <= 6
    K17 = dtype_throughput.K17
    with pytest.raises(ValueError, match="unknown dtype"):
        K17("fp8", x, 1, 1, 32)
    with pytest.raises(ValueError, match="int32"):
        K17("int16", x.T, 1, 1, 32)
    with pytest.raises(ValueError, match="multiple of 32"):
        K17("int8", x, 1, 1, 48)
    with pytest.raises(ValueError, match="multiple of 32"):
        K17("bf16", x, 1, 0, 32)
    with pytest.raises(ValueError, match="steps"):
        K17("fp16", x, -1, 1, 32)
    with pytest.raises(ValueError, match="unknown occupancy"):
        dtype_throughput.grid("int16", "half")
    assert dtype_throughput.grid("int8", "tile", "cpu") == (8, 128)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dtype_throughput.grid("int16", "full")


# --- K18: the int16x2 SWAR ACS ---

SWAR_STAGES = 16
SWAR_KERNEL = {"baseline": ("_baseline_kernel", {}),
               "swar/stage": ("_swar_kernel", {"repack_every": 1}),
               "swar/4stages": ("_swar_kernel", {"repack_every": 4})}


@pytest.mark.parametrize("variant", swar_probe.VARIANTS)
def test_swar_plain_matches_jax_interpret(variant):
    """One JAX program at 16 stages on values 0..7999 (the 16-bit halves
    wrap past 32767): the port's last program equals the JAX kernel's
    output."""
    jsw = _jax_script("swar_probe")
    assert (swar_probe.STAGES, swar_probe.GRID) == (jsw.STAGES, jsw.GRID)
    name, kw = SWAR_KERNEL[variant]
    rows = swar_probe.ROWS_IN[variant]
    x = np.random.default_rng(22).integers(0, 8000, (rows, 128)) \
        .astype(np.int32)
    want = _interpret(functools.partial(getattr(jsw, name),
                                        stages=SWAR_STAGES, **kw),
                      x, (64, 128), lambda i: (i, 0), lambda i: (0, 0))
    xt = torch.from_numpy(x)
    got = swar_probe.swar_torch(variant, xt, SWAR_STAGES)
    assert got.shape == (1, 64, 128) and got.dtype == torch.int32
    assert np.array_equal(got[-1].numpy(), want)
    before = swar_probe.K18.launches
    assert torch.equal(swar_probe.K18(variant, xt, SWAR_STAGES), got)
    assert swar_probe.K18.launches == before


def test_swar_programs_are_independent():
    """Several programs: each is the plain version of its own block."""
    for v in swar_probe.VARIANTS:
        x = swar_probe.probe_input(v, 3, "cpu", seed=3)
        rows = swar_probe.ROWS_IN[v]
        whole = swar_probe.swar_torch(v, x, 8)
        for g in range(3):
            one = swar_probe.swar_torch(v, x[g * rows:(g + 1) * rows], 8)
            assert torch.equal(whole[g], one[0])


def test_swar_rejections():
    x = swar_probe.probe_input("baseline", 1, "cpu")
    assert int(x.min()) >= 0 and int(x.max()) < 8000
    K18 = swar_probe.K18
    with pytest.raises(ValueError, match="unknown variant"):
        K18("swar", x, 8)
    with pytest.raises(ValueError, match="int32 block"):
        K18("swar/stage", x, 8)         # 160 rows: not a multiple of 128
    with pytest.raises(ValueError, match="int32 block"):
        K18("baseline", x.to(torch.int16), 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        K18("baseline", x, 6)
    with pytest.raises(ValueError, match="contiguous"):
        K18("baseline", x.t().contiguous().t(), 8)


# --- K19: the 16-bit ACS variants ---

OPT_PACKS = 2


@pytest.mark.parametrize("lt", opt_bench.LTS)
@pytest.mark.parametrize("variant", opt_bench.VARIANTS)
def test_opt_bench_plain_matches_jax_interpret(variant, lt):
    """N_PACKS = 2 (64 stages) on one program of lt arrays: the plain
    version and the CPU wrapper at that lt equal the JAX kernel's output,
    on values -100..100 and on values near +-16,000 (bm up to +-32,000),
    where the int16 metrics wrap and the result differs from
    i32_split's."""
    job = _jax_script("opt_bench")
    assert (opt_bench.N_PACKS, opt_bench.BPP) == (job.N_PACKS, job.BPP)
    job.N_PACKS = OPT_PACKS
    call = pl.pallas_call(
        job.make_kernel(variant, lt), grid=(1,),
        in_specs=[pl.BlockSpec((OPT_PACKS, 32, 2, lt),
                               lambda i: (0, 0, 0, i))],
        out_specs=pl.BlockSpec((64, lt), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((64, lt), jnp.int32),
        interpret=True)
    for lim in (100, 16000):
        x = _rs(23, OPT_PACKS, lt, lim)
        want = np.asarray(call(jnp.asarray(x)))
        xt = torch.from_numpy(x)
        got = opt_bench.opt_bench_torch(variant, xt)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        before = opt_bench.K19.launches
        assert torch.equal(opt_bench.K19(variant, xt, lt), got)
        assert opt_bench.K19.launches == before
        if lim > 100 and variant != "i32_split":
            assert not torch.equal(
                got, opt_bench.opt_bench_torch("i32_split", xt))


def test_opt_bench_columns_are_independent():
    rs = opt_bench.probe_input(2, 300, "cpu", seed=4)
    for v in opt_bench.VARIANTS:
        whole = opt_bench.opt_bench_torch(v, rs)
        part = opt_bench.opt_bench_torch(v, rs[..., 128:256].contiguous())
        assert torch.equal(whole[:, 128:256], part)


def test_opt_bench_rejections():
    rs = opt_bench.probe_input(1, 128, "cpu")
    assert int(rs.min()) >= -100 and int(rs.max()) <= 100
    K19 = opt_bench.K19
    with pytest.raises(ValueError, match="unknown variant"):
        K19("i32", rs)
    with pytest.raises(ValueError, match="unknown lane tile"):
        K19("i16", rs, 64)
    with pytest.raises(ValueError, match="int32"):
        K19("i16_pm", rs[:, :16].contiguous())
    with pytest.raises(ValueError, match="int32"):
        K19("i16", rs.to(torch.int16))
    with pytest.raises(ValueError, match="contiguous"):
        K19("i32_split", rs[..., ::2])


# --- what the SASS says ---

SASS = """
        Function : _ZN12viterbi_swar11swar_kernelILi1EEEvPKiPiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   VIADD.16x2 R5, R5, R2 ;       /* 0x000fe20000000f00 */
        /*0020*/                   PRMT R6, R5, 0x5410, R7 ;
        /*0030*/                   VIMNMX.S16x2 R6, P0, P1, R6, R8, !PT ;
        /*0040*/                   VIADD.16x2 R7, R7, R2 ;
        /*0050*/               @P0 SEL R9, R9, R10, P1 ;
        /*0060*/               @P2 BRA `(.L_x_0) ;
        /*0070*/                   STG.E [R2.64], R5 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90;
"""


def test_stage_loop_opcodes():
    """The stage loop's opcodes with their modifiers, predicates dropped,
    most frequent first; they sum to the loop's instructions."""
    from tpu_viterbi_torch.scripts import common
    name = "_ZN12viterbi_swar11swar_kernelILi1EEEvPKiPiii"
    mix = common.stage_loop_opcodes(SASS)[name]
    assert mix == {"VIADD.16x2": 2, "PRMT": 1, "VIMNMX.S16x2": 1, "SEL": 1,
                   "BRA": 1}
    assert list(mix)[0] == "VIADD.16x2"
    assert sum(mix.values()) == common.stage_loop_instructions(SASS)[name]
    assert common.describe_mix(mix, 2) == "VIADD.16x2 2, PRMT 1"


def test_kernel_opcodes():
    """Every instruction of a kernel, predicates dropped and the NOPs that
    pad it left out: the static SASS of a kernel without a stage loop (the
    generator kernels K7 and K8)."""
    from tpu_viterbi_torch.scripts import common
    name = "_ZN12viterbi_swar11swar_kernelILi1EEEvPKiPiii"
    listing = SASS + "        /*00a0*/                   NOP ;\n"
    mix = common.kernel_opcodes(listing)[name]
    assert mix == {"VIADD.16x2": 2, "BRA": 2, "LDC": 1, "PRMT": 1,
                   "VIMNMX.S16x2": 1, "SEL": 1, "STG.E": 1, "EXIT": 1}
    assert list(mix)[:2] == ["VIADD.16x2", "BRA"]
