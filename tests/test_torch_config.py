"""The port's contract (tpu_viterbi_torch.config / trellis / block planning)
against the JAX package's: every valid config has the same option word,
framing constants and size functions on both sides, the trellis tables are
equal, and configs and plans cross over through from_reference /
plan_from_reference."""

import types

import numpy as np
import pytest
import torch

from tpu_viterbi import config as jconfig
from tpu_viterbi import trellis as jtrellis
from tpu_viterbi.decoder import core_xla
from tpu_viterbi_torch import config as tconfig
from tpu_viterbi_torch import trellis as ttrellis
from tpu_viterbi_torch.decoder import core_torch

torch.set_num_threads(1)

_CONSTANTS = ("options", "bits_per_metric", "bits_per_pack", "extra_l",
              "extra_r", "slide_size", "forward_len", "warmup",
              "enc_data_per_pack", "enc_data_width", "pm_norm_stride")
_SIZE_FNS = ("get_input_size", "get_input_words", "get_message_len",
             "get_output_size", "get_output_words")
_INPUT_NUMS = (0, 1, 127, 128, 129, 4096, 64_000_002, 2 * 32_000_064)


def test_same_valid_configs():
    assert len(tconfig.ALL_VALID_CONFIGS) == len(jconfig.ALL_VALID_CONFIGS) == 42
    assert [c.options for c in tconfig.ALL_VALID_CONFIGS] == \
        [c.options for c in jconfig.ALL_VALID_CONFIGS]


@pytest.mark.parametrize("jcfg", jconfig.ALL_VALID_CONFIGS,
                         ids=lambda c: f"opt{c.options:04x}")
def test_config_constants_and_sizes_equal(jcfg):
    cfg = tconfig.from_reference(jcfg)
    assert cfg.channel_in.name == jcfg.channel_in.name
    assert cfg.metric.name == jcfg.metric.name
    assert cfg.decode_out.name == jcfg.decode_out.name
    assert cfg.comp_mode.name == jcfg.comp_mode.name
    for name in _CONSTANTS:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    for name in _SIZE_FNS:
        for n in _INPUT_NUMS:
            assert getattr(cfg, name)(n) == getattr(jcfg, name)(n), (name, n)


def test_from_reference_round_trips():
    for cfg in tconfig.ALL_VALID_CONFIGS:
        assert tconfig.from_reference(cfg) == cfg
        # duck-typed: anything carrying the reference option word
        assert tconfig.from_reference(
            types.SimpleNamespace(options=cfg.options)) == cfg
        assert tconfig.DecoderConfig.from_options(cfg.options) == cfg


def test_validity_table_equal():
    for c in jconfig.ChannelIn:
        for m in jconfig.Metric:
            for o in jconfig.DecodeOut:
                for p in jconfig.CompMode:
                    want = jconfig.options_valid(c, m, o, p)
                    got = tconfig.options_valid(
                        tconfig.ChannelIn(int(c)), tconfig.Metric(int(m)),
                        tconfig.DecodeOut(int(o)), tconfig.CompMode(int(p)))
                    assert got == want
    with pytest.raises(ValueError, match="invalid option combination"):
        tconfig.DecoderConfig(tconfig.ChannelIn.SOFT16, tconfig.Metric.M_B16)


def test_trellis_tables_equal():
    assert ttrellis.POLY1_REV == jtrellis.POLY1_REV == 0o117
    assert ttrellis.POLY2_REV == jtrellis.POLY2_REV == 0o155
    for name in ("branch_code_table", "branch_sign_table",
                 "encode_output_table"):
        assert np.array_equal(getattr(ttrellis, name)(),
                              getattr(jtrellis, name)()), name
    assert np.array_equal(ttrellis.BRANCH_CODE_J0, jtrellis.BRANCH_CODE_J0)
    assert np.array_equal(ttrellis.BRANCH_CODE_J1, jtrellis.BRANCH_CODE_J1)


@pytest.mark.parametrize("bpp", [16, 32])
def test_block_plans_equal(bpp):
    cfgs = [(tconfig.from_reference(j), j) for j in jconfig.ALL_VALID_CONFIGS
            if j.bits_per_pack == bpp and j.comp_mode == jconfig.CompMode.REG]
    for m in (bpp, 3 * bpp, 1008 if bpp == 16 else 1024, 40_000 - 40_000 % bpp,
              16_320, 16_288, 31_999_872):
        for dl in (16, 32, 96, 2048, 8192, 16_320, 32_768):
            jp = core_xla.plan_blocks(m, bpp, dl)
            tp = core_torch.plan_blocks(m, bpp, dl)
            assert core_torch.plan_from_reference(jp) == tp
            for name in ("block_len", "n_packs", "overlap_bits"):
                assert getattr(tp, name) == getattr(jp, name), name
            assert np.array_equal(tp.offsets(), jp.offsets())
            for cfg, jcfg in cfgs:
                assert core_torch.needs_int32_renorm(cfg, tp) == \
                    core_xla.needs_int32_renorm(jcfg, jp)
        assert core_torch.auto_dec_len(m, bpp) == core_xla.auto_dec_len(m, bpp)
    with pytest.raises(ValueError, match="multiple of bits_per_pack"):
        core_torch.plan_blocks(bpp + 8, bpp)
