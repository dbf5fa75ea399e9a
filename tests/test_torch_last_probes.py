"""The port's last probes against the JAX package's scripts, on the CPU,
bit for bit (every value is an integer or exact): K25
(scripts/soft16_ablation.py), K26 (scripts/transpose_bench.py) and K28
(scripts/interleave_bench.py), each plain version and its kernel's wrapper
on a CPU tensor against the script's Pallas kernels in interpret mode at
reduced sizes set on the loaded module; and K27's pieces: the u/d-word
staging ``fp32_ud_words_torch`` against ``core_xla.fp32_ud_words``, and the
u/d route (K1's ``ud`` reader, K3's with the window) against K2's plain
version and ``decode_packed_xla``.  The kernels run only on a card
(tests/test_torch_cuda.py)."""

import functools
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_viterbi.chain.encode import conv_encode_np
from tpu_viterbi.chain.quantize import quantize_and_pack
from tpu_viterbi.config import ChannelIn as JChannelIn
from tpu_viterbi.config import DecodeOut as JDecodeOut
from tpu_viterbi.config import DecoderConfig as JDecoderConfig
from tpu_viterbi.decoder.core_xla import (decode_packed_xla, fp32_ud_words,
                                          plan_blocks)
from tpu_viterbi.sharding.simulate import DEFAULT_SCALES
from tpu_viterbi_torch import ConfigResolutionError
from tpu_viterbi_torch.config import (ChannelIn, DecoderConfig,
                                      from_reference)
from tpu_viterbi_torch.decoder import core_cuda, core_torch
from tpu_viterbi_torch.scripts import (fp32_fused_value_probe,
                                       interleave_bench, soft16_ablation,
                                       transpose_bench)

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _load(name: str):
    """scripts/<name>.py loaded afresh, with scripts/ on the path only while
    it loads (soft16_ablation imports layout_probe and kernel_ablation from
    there)."""
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


# --- K25: scripts/soft16_ablation.py ---

K25_PACKS = 4


@pytest.mark.parametrize("variant", soft16_ablation.VARIANTS)
def test_soft16_ablation_plain_matches_jax_interpret(variant):
    """Full-range words, N_PACKS 4 and GRID 1 set on the loaded script: the
    plain version's one program equals ``_kernel`` in interpret mode, and
    so does K25's wrapper on a CPU tensor."""
    mod = _load("soft16_ablation")
    assert (mod.N_PACKS, mod.GRID) == (soft16_ablation.N_PACKS,
                                       soft16_ablation.GRID)
    mod.N_PACKS, mod.GRID = K25_PACKS, 1
    wpp = soft16_ablation.WPP[variant]
    words = np.random.default_rng(25).integers(
        -2 ** 31, 2 ** 31, (K25_PACKS, wpp, 128), dtype=np.int64) \
        .astype(np.int32)
    call = pl.pallas_call(
        functools.partial(mod._kernel, wpp=wpp,
                          unpack=variant.endswith("unpack")),
        grid=(1,),
        in_specs=[pl.BlockSpec((K25_PACKS, wpp, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 128), jnp.int32),
        interpret=True)
    want = np.asarray(call(jnp.asarray(words)))
    x = torch.from_numpy(words)
    got = soft16_ablation.soft16_ablation_torch(variant, x, 1)
    assert got.shape == (1, 1, 128) and got.dtype == torch.int32
    assert np.array_equal(got[0].numpy(), want)
    before = soft16_ablation.K25.launches
    assert torch.equal(soft16_ablation.K25(variant, x, 1), got)
    assert soft16_ablation.K25.launches == before


def test_soft16_ablation_programs_and_rejections():
    """Two programs are two independent columns of 128 arrays; a wrong
    block width, dtype or program split raises."""
    words = soft16_ablation.probe_input(2, 2, 32, "cpu", seed=3)
    out = soft16_ablation.K25("s16/unpack", words, 2)
    for g in range(2):
        one = soft16_ablation.soft16_ablation_torch(
            "s16/unpack", words[2 * g:2 * g + 2], 1)
        assert torch.equal(out[g], one[0])
    with pytest.raises(ValueError, match="int32 words"):
        soft16_ablation.K25("s8/noup", words, 2)          # 32 rows, not 16
    with pytest.raises(ValueError, match="int32 words"):
        soft16_ablation.K25("s16/noup", words.to(torch.int64), 2)
    with pytest.raises(ValueError, match="programs"):
        soft16_ablation.K25("s16/noup", words, 3)
    with pytest.raises(ValueError, match="unknown variant"):
        soft16_ablation.K25("nope", words, 2)


def test_soft16_ablation_decomposition_line():
    line = soft16_ablation.decomposition(
        {"s8/noup": 1.0, "s16/noup": 1.5, "s8/unpack": 3.0,
         "s16/unpack": 3.25})
    assert line == ("DMA cost of 2x words: +0.5000 ns/stage | s8 unpack "
                    "+2.0000 | s16 unpack +1.7500 | format gap (unpacked) "
                    "+0.2500")


# --- K26: scripts/transpose_bench.py ---

def _interpreting(mod):
    """``mod`` with its ``pl`` swapped for one whose pallas_call runs in
    interpret mode (the script's functions call pl.pallas_call)."""
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id, when=pl.when)
    return mod


def test_transpose_plain_matches_jax_interpret():
    """A 96 x 80 array through ``pallas_transpose`` at the script's three
    tiles: the port's transpose (plain, and every tiling of K26's wrapper
    on a CPU tensor) is the JAX output without its padding, which is zero;
    the consumer on each padded JAX output equals ``_sum_kernel``'s (1,
    128) row and ``pallas_consume``'s sum of it."""
    mod = _interpreting(_load("transpose_bench"))
    assert (mod.B, mod.LW) == (transpose_bench.B, transpose_bench.LW)
    x = np.random.default_rng(26).integers(-2 ** 31, 2 ** 31, (96, 80),
                                           dtype=np.int64).astype(np.int32)
    xt = torch.from_numpy(x)
    plain = transpose_bench.transpose_torch(xt)
    assert plain.shape == (80, 96)
    before = transpose_bench.K26.launches
    for tiling in transpose_bench.TILINGS:
        tb, tw = transpose_bench.JAX_TILE[tiling]
        want = np.asarray(mod.pallas_transpose(jnp.asarray(x), tb, tw))
        assert np.array_equal(plain.numpy(), want[:80, :96])
        assert not want[80:].any() and not want[:, 96:].any()
        assert torch.equal(transpose_bench.K26.transpose(tiling, xt), plain)
        sums = pl.pallas_call(
            mod._sum_kernel, grid=(want.shape[0] // 128,),
            in_specs=[pl.BlockSpec((128, want.shape[1]), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((1, 128), lambda i: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((1, 128), jnp.int32),
            interpret=True)(jnp.asarray(want))
        t = torch.from_numpy(want.copy())
        got = transpose_bench.consume_torch(t)
        assert np.array_equal(got.numpy(), np.asarray(sums)[0])
        assert int(got.sum(dtype=torch.int32)) == \
            int(mod.pallas_consume(jnp.asarray(want)))
        assert torch.equal(transpose_bench.K26.consume(t), got)
    assert transpose_bench.K26.launches == before


def test_transpose_rejections():
    x = transpose_bench.probe_input("cpu", 40, 24)
    with pytest.raises(ValueError, match="unknown tiling"):
        transpose_bench.K26.transpose("256x256", x)
    with pytest.raises(ValueError, match="2-D int32"):
        transpose_bench.K26.transpose("32x32", x.to(torch.int64))
    with pytest.raises(ValueError, match="sums 128 columns"):
        transpose_bench.K26.consume(x)
    with pytest.raises(ValueError, match="does not fit"):
        transpose_bench.K26.transpose(
            "slab", torch.zeros((2, 2000), dtype=torch.int32))


# --- K28: scripts/interleave_bench.py ---

K28_REPS = 3


@pytest.mark.parametrize("variant", interleave_bench.VARIANTS)
def test_interleave_plain_matches_jax_interpret(variant):
    """REPS 3 set on the loaded script, its full grid of 8 tiles: the plain
    version and K28's wrapper on a CPU tensor equal ``make_kernel`` of the
    JAX variant the port's stands for (shfl and regs both for bcast) in
    interpret mode."""
    mod = _load("interleave_bench")
    assert (mod.REPS, mod.N_TILES) == (interleave_bench.REPS,
                                       interleave_bench.N_TILES)
    mod.REPS = K28_REPS
    jname = interleave_bench.JAX_NAME[variant] or "bcast"
    x = interleave_bench.probe_input(mod.N_TILES, "cpu", seed=28)
    call = pl.pallas_call(
        mod.make_kernel(jname), grid=(mod.N_TILES,),
        in_specs=[pl.BlockSpec((64, 128), lambda i: (0, i))],
        out_specs=pl.BlockSpec((64, 128), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct(tuple(x.shape), jnp.int32),
        scratch_shapes=[pltpu.VMEM((64, 128), jnp.int32)],
        interpret=True)
    want = np.asarray(call(jnp.asarray(x.numpy())))
    got = interleave_bench.interleave_torch(variant, x, K28_REPS)
    assert np.array_equal(got.numpy(), want)
    before = interleave_bench.K28.launches
    assert torch.equal(interleave_bench.K28(variant, x, K28_REPS), got)
    assert interleave_bench.K28.launches == before


def test_interleave_check_and_order():
    """The script's check: one bare merge is the interleave for every
    variant but concat; the shuffle has order 6 (regs' unroll)."""
    x = interleave_bench.check_input("cpu")
    xn = x.numpy()
    want = np.empty_like(xn)
    want[0::2], want[1::2] = xn[:32], xn[32:]
    for v in interleave_bench.VARIANTS:
        got = interleave_bench.interleave_torch(v, x, 1, 0).numpy()
        assert np.array_equal(got, want) == (v != "concat")
    assert torch.equal(interleave_bench.interleave_torch("regs", x, 6, 0), x)
    assert not any(torch.equal(interleave_bench.interleave_torch(
        "regs", x, k, 0), x) for k in range(1, 6))
    with pytest.raises(ValueError, match="unknown variant"):
        interleave_bench.K28("bcast", x, 1)
    with pytest.raises(ValueError, match=r"\(64, cols\)"):
        interleave_bench.K28("regs", x[:32], 1)


# --- K27: the u/d staging and the u/d route ---

def _ud_values(seed: int, n: int) -> np.ndarray:
    """N(0, 25) values with NaN, +-inf and values past the clamp."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * 5).astype(np.float32)
    v[rng.random(n) < 0.002] = np.nan
    v[rng.random(n) < 0.01] = np.inf
    v[rng.random(n) < 0.01] = -np.inf
    v[rng.random(n) < 0.01] = 3e9
    return v


@pytest.mark.parametrize("n", [5000, 256, 1])
def test_fp32_ud_words_match_xla(n):
    """Bit-equal to ``core_xla.fp32_ud_words``: the clamp, the truncation,
    the 8-bit fields and the padding to 256 values; +-inf saturate, and a
    NaN zeroes its whole 128-value row, as XLA's one-hot deinterleave
    spreads it."""
    v = _ud_values(27 + n, n)
    want = np.asarray(fp32_ud_words(jnp.asarray(v)))
    got = core_torch.fp32_ud_words_torch(torch.from_numpy(v))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_fp32_ud_words_nan_row():
    v = np.ones(512, np.float32)
    v[3] = np.nan
    got = core_torch.fp32_ud_words_torch(torch.from_numpy(v)).numpy()
    assert not got[:32].any() and (got[32:] == 0x02000200).all()


def _coded_fp32(n: int, seed: int) -> np.ndarray:
    """The FP32 wire of n random bits, coded, at sigma 0.6, the chain's
    FP32 scale."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).astype(np.uint8)
    sym = 2 * conv_encode_np(bits).astype(np.float32) - 1
    sym = sym + rng.normal(0, 0.6, sym.shape).astype(np.float32)
    return np.asarray(quantize_and_pack(jnp.asarray(sym), JChannelIn.FP32,
                                        DEFAULT_SCALES[JChannelIn.FP32]))


@pytest.mark.parametrize("dec_len,window", [(2048, False), (4096, True),
                                            (8192, False)])
@pytest.mark.parametrize("out", [JDecodeOut.O_B32, JDecodeOut.O_B16],
                         ids=lambda o: o.name)
def test_ud_route_matches_k2_and_xla(dec_len, window, out):
    """20,000 coded bits: ``decode_ud_words_cuda(fp32_ud_words_torch(v))``
    on CPU tensors (the plain version of K1-``ud``, K3-``ud`` with the
    window) == K2's plain version (K3's) on v == ``decode_packed_xla`` on
    v; no launch."""
    jcfg = JDecoderConfig(JChannelIn.FP32, decode_out=out)
    bpp = jcfg.bits_per_pack
    jplan = plan_blocks(jcfg.get_message_len(40_000), bpp, dec_len)
    cfg, plan = from_reference(jcfg), core_torch.plan_from_reference(jplan)
    v = _coded_fp32(20_000, 40 + dec_len)
    x = torch.from_numpy(v)
    before = (core_cuda.K1.launches, core_cuda.K3.launches)
    got = core_cuda.decode_ud_words_cuda(core_torch.fp32_ud_words_torch(x),
                                         cfg, plan, window)
    k2 = core_torch.decode_packed_torch(x, cfg, plan, window)
    want = np.asarray(decode_packed_xla(jnp.asarray(v), jcfg, jplan))
    mask = (1 << bpp) - 1
    assert torch.equal(got, k2)
    assert np.array_equal(got.numpy().astype(np.int64) & mask,
                          want.astype(np.int64) & mask)
    assert (core_cuda.K1.launches, core_cuda.K3.launches) == before


@pytest.mark.parametrize("dec_len", [32, 96, 2048])
def test_ud_route_equals_k2_on_random_wire(dec_len):
    """On N(0, 25) values with +-inf (no NaN: the XLA staging zeroes a NaN's
    row, K2 a NaN's stage), full store and window: the u/d route decodes
    exactly as K2 and K3 on the wire, at dec_len below the halo too."""
    cfg = DecoderConfig(ChannelIn.FP32)
    plan = core_torch.plan_blocks(32 * 300 - 32 if dec_len < 2048 else
                                  dec_len * 5, 32, dec_len)
    v = _ud_values(dec_len, cfg.get_input_words(2 * (plan.message_len + 64)))
    v[np.isnan(v)] = 0.0
    x = torch.from_numpy(v)
    udw = core_torch.fp32_ud_words_torch(x)
    for window in (False, True):
        assert torch.equal(
            core_cuda.decode_ud_words_cuda(udw, cfg, plan, window),
            core_torch.decode_packed_torch(x, cfg, plan, window))


def test_ud_route_rejections():
    cfg = DecoderConfig(ChannelIn.SOFT8)
    plan = core_torch.plan_blocks(2048, 32, 2048)
    udw = torch.zeros(600, dtype=torch.int32)
    with pytest.raises(ConfigResolutionError, match="FP32"):
        core_cuda.decode_ud_words_cuda(udw, cfg, plan)
    assert core_torch.ud_words_per_block(plan) == (1024, 32)


def test_fp32_probe_routes_on_cpu():
    """The probe's routes as plain versions at a small size: the value and
    u/d routes give the same words; the staging gives the words the
    ud-kernel route decodes."""
    n = 4096
    x = fp32_fused_value_probe.check_values(n, "cpu")[:fp32_fused_value_probe
                                                      .CFG.get_input_words(
                                                          2 * n)]
    udw = core_torch.fp32_ud_words_torch(x)
    outs = {}
    for label, dec_len, window, kind in fp32_fused_value_probe.ROUTES:
        plan = fp32_fused_value_probe.make_plan(n, dec_len)
        res = fp32_fused_value_probe.route(kind, x, plan, window, udw)()
        outs[label] = res
    assert torch.equal(outs["ud staging alone"], udw)
    assert torch.equal(outs["shipped ud-words dl=8192 (K1-ud)"],
                       outs["K1-ud alone dl=8192"])
    assert torch.equal(outs["fused-value dl=2048 win=False (K2)"],
                       outs["K1-ud alone dl=2048"])
