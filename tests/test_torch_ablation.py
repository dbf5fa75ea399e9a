"""The port's ablation probe (K13) against the JAX package's
scripts/kernel_ablation.py, on the CPU: each variant's output and survivor
store, from the plain version and from the kernel's wrapper on a CPU
tensor, are bit-equal to the script's Pallas kernel run in interpret mode
(its survivor scratch taken out as a second output) on the same numpy
words, at N_PACKS = 4 set on the loaded script module.  The kernel itself
runs only on a card (tests/test_torch_cuda.py)."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_viterbi_torch.scripts import kernel_ablation

REPO = Path(__file__).resolve().parents[1]
N_PACKS = 4
FLAGS = {"body": (False, False, False), "+unpack": (True, False, False),
         "+dump": (True, True, False), "+traceback": (True, True, True),
         "+tb(bisect)": (True, True, True, True)}
torch.set_num_threads(1)


def _jax_ablation():
    """scripts/kernel_ablation.py loaded afresh, with scripts/ on the path
    only while it loads (it imports layout_probe from there), N_PACKS
    reduced on the module."""
    path = str(REPO / "scripts")
    sys.path.insert(0, path)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_kernel_ablation", REPO / "scripts" / "kernel_ablation.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(path)
    assert (mod.N_PACKS, mod.WPP, mod.GRID) == (
        kernel_ablation.N_PACKS, kernel_ablation.WPP, kernel_ablation.GRID)
    mod.N_PACKS = N_PACKS
    return mod


def _run_jax(mod, words: np.ndarray, unpack, dump, traceback,
             bisect_tb=False):
    """(output, survivor scratch) of one JAX program in interpret mode."""
    n_emit = N_PACKS - 1 if traceback else 1

    def kernel(words_ref, out_ref, surv_ref):
        mod._kernel(words_ref, out_ref, surv_ref, unpack=unpack, dump=dump,
                    traceback=traceback, bisect_tb=bisect_tb)

    call = pl.pallas_call(
        kernel, grid=(1,),
        in_specs=[pl.BlockSpec(words.shape, lambda i: (i, 0, 0))],
        out_specs=[pl.BlockSpec((n_emit, 128), lambda i: (0, 0)),
                   pl.BlockSpec((N_PACKS, 64, 128), lambda i: (0, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((n_emit, 128), jnp.int32),
                   jax.ShapeDtypeStruct((N_PACKS, 64, 128), jnp.int32)],
        interpret=True)
    out, surv = call(jnp.asarray(words))
    return np.asarray(out), np.asarray(surv)


def _words(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, (N_PACKS, 16, 128), dtype=np.int64) \
        .astype(np.int32)


@pytest.mark.parametrize("variant", kernel_ablation.VARIANTS)
def test_ablation_plain_matches_jax_interpret(variant):
    """Full-range words: the output, and with the dump the survivor store,
    equal JAX's.  With the traceback only rows 0 .. N_PACKS - 3 are held:
    the JAX kernel never writes row N_PACKS - 2 (its tb_body writes row kp
    - 1 for k >= 1 only); the port writes 0 there."""
    mod = _jax_ablation()
    x = _words(21)
    want, want_surv = _run_jax(mod, x, *FLAGS[variant])
    xt = torch.from_numpy(x)
    got, surv = kernel_ablation.ablation_torch(variant, xt, 1)
    n_emit = kernel_ablation.n_emit(variant, N_PACKS)
    assert got.shape == (1, n_emit, 128) and got.dtype == torch.int32
    if variant in kernel_ablation.TRACEBACKS:
        assert np.array_equal(got[0, :N_PACKS - 2].numpy(),
                              want[:N_PACKS - 2])
        assert not got[0, N_PACKS - 2].any()
    else:
        assert np.array_equal(got[0].numpy(), want)
    if FLAGS[variant][1]:
        assert np.array_equal(surv.numpy(), want_surv)
    else:
        assert surv is None
    before = kernel_ablation.K13.launches
    k_out, k_surv = kernel_ablation.K13(variant, xt, 1)
    assert kernel_ablation.K13.launches == before
    assert torch.equal(k_out, got)
    assert (k_surv is None) == (surv is None)
    if surv is not None:
        assert torch.equal(k_surv, surv)


def test_ablation_bisect_traceback_equals_onehot():
    """The JAX probe's +tb(bisect) reads the store through a select tree
    and +traceback through a one-hot sum: the two JAX outputs are equal, and
    so are the port's two variants (its own select tree and its gather)."""
    mod = _jax_ablation()
    x = _words(22)
    onehot, _ = _run_jax(mod, x, True, True, True)
    bisect, _ = _run_jax(mod, x, True, True, True, bisect_tb=True)
    assert np.array_equal(onehot[:N_PACKS - 2], bisect[:N_PACKS - 2])
    xt = torch.from_numpy(x)
    tb, tb_store = kernel_ablation.ablation_torch("+traceback", xt, 1)
    bs, bs_store = kernel_ablation.ablation_torch("+tb(bisect)", xt, 1)
    assert torch.equal(tb, bs) and torch.equal(tb_store, bs_store)


def test_ablation_programs_are_independent():
    """Three programs: each one's output and store columns are those of
    the plain version on its own words."""
    words = kernel_ablation.probe_input(3, N_PACKS, "cpu", seed=5)
    out, surv = kernel_ablation.ablation_torch("+traceback", words, 3)
    assert out.shape == (3, N_PACKS - 1, 128)
    assert surv.shape == (N_PACKS, 64, 3 * 128)
    for g in range(3):
        one, one_surv = kernel_ablation.ablation_torch(
            "+traceback", words[g * N_PACKS:(g + 1) * N_PACKS], 1)
        assert torch.equal(out[g], one[0])
        assert torch.equal(surv[:, :, g * 128:(g + 1) * 128], one_surv)


def test_ablation_rejections():
    words = kernel_ablation.probe_input(2, N_PACKS, "cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        kernel_ablation.K13("nope", words, 2)
    with pytest.raises(ValueError, match="int32 words"):
        kernel_ablation.K13("body", words[:, :8].contiguous(), 2)
    with pytest.raises(ValueError, match="int32 words"):
        kernel_ablation.K13("body", words.to(torch.int64), 2)
    with pytest.raises(ValueError, match="at least 4"):
        kernel_ablation.K13("+dump", words, 3)        # 8 packs, 3 programs
    with pytest.raises(ValueError, match="at least 4"):
        kernel_ablation.K13("+dump", words, 4)        # 2 packs a program
    with pytest.raises(ValueError, match="at least 4"):
        kernel_ablation.ablation_torch("+unpack", words, 0)
