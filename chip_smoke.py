"""Smoke run of the PyTorch/CUDA port on one GPU: builds kernels K1-K6
(decode and staging), K7, K8 (workload generator), K9 (the hardware
model's shared-memory probe), K11 (the op-cost probe), K12-K15 (K1's
design probes: layout, ablation, ACS variants, ILP) and K16-K19 (the
ACS-arithmetic probes: constructs, dtype rates, int16x2 SWAR, 16-bit ACS),
K20 (the generator probe), K23 (the roll-halo decode of the staging-cost
probe), K25 (the SOFT16 ablation), K26 (the staging transpose and its
consumer) and K28 (the interleave) from the checkout into one library (one
nvcc per source, started together, one link), holds
each against its plain PyTorch version, drives the hardware model (the
probe of `python -m tpu_viterbi_torch.hardware`, K3's shared-memory gate,
the canary K10 through K4 and the op-cost probe), the simulation chain, the
file-serving paths (one-shot, windowed, streamed, FP32, several files) and
the in-graph simulation (--e2e-device: SOFT8, FP32, windowed, and a noisy
run) through the port's CLI at the reference's default size, drives the
staged-input decode paths (decode_packed_cuda with fused=False and
fp32_words=False, the values-in entry decode_blocks_cuda) at that size, and
times each kernel against its plain version, its bound and, where one
PyTorch call computes the same function, that call; and the in-graph
simulation end to end.  Phases 26-30 drive the generator probe and the
decode-attribution probes (K21 bench pieces, K22 values-in split, K23
staging cost, K24 SOFT16 pieces: launches of K1, K3, K4 and K6 beside K23)
after holding their kernels against their plain versions.  Phases 31-35
hold K1's and K3's u/d-word reader against its plain version and K2, and
drive the last probes (K25 SOFT16 ablation, K26 transpose, K27 FP32
routes: launches of K1, K2 and K3, K28 interleave); phases 16 and 19 cover
K11's relayouts and K13's bisect traceback; phases 18-20, 22, 24, 25 and
32 hold K12, K13, K14, K16, K18, K19 and K25 at every lane count an array
(1 to 32, csrc/lanes.cuh) and time each in turn with one lane, with the
lanes the wrapper picks (common.lanes_for), and K19 and K25 at the counts
between, where the rule's threshold lies; phases 20 and 22 print the
digests of K14's and K16's one-lane kernels' SASS and each variant's
share of its own construct's issue bound beside the row's.  Phase 14
times K6 on the headline's words and values and on HARD's thinnest window
(dec_len 32) with the route (load width, tile rows) that ran, and K4 in
word mode (int16x2 metrics) in turns with K1 and K1_I32 and K5 in turns
with K2 and K2_I32 at the headline, K4's value modes beside them, each held
against its int32 and int16 plain versions, with the SASS a stage, F2I a
stage and registers of each b32 instance.  Phase 5b times K1's int16x2
path metrics against K1_I32, its int32 instances kept for that A/B (never
launched by a main path), in turns on the same words, with the SASS a
stage and the registers of each; phases 5c and 5d do the same for K2 (the
FP32 wire) and K3 (the window) against K2_I32 and K3_I32, and time the
in-graph FP32 and window calls decoding with each in turns; phase 11b
holds K7 and K8 against
K7_OLD/K8_OLD, the first design's draws (every thread drawing its window's
two bit packs; kept for that A/B, never launched by a main path), and
times them in turns at the headline with the threefry calls each design
draws by its count, the SASS a pair and the registers; phase 26 reads
K20's many by queued launches and by CUDA-graph replay, its loop's SASS
by pipe, and prices K7's and K8's draws at the graph rate; phase 33
holds K26's tilings on the bulk route (the JAX shape, its SASS free of
word loads and of stores under 16 bytes) and the element route, reads
each tiling, x.t().contiguous() and copy_ one call at a time and by graph
replay, and checks that K26's consumer is one launch and writes its
output.  Phases 36-38 drive the multi-rank split
(tpu_viterbi_torch/sharding/): K1 and K3 reading a tail halo, held against
their plain version and themselves on the appended stream and timed at
the one-rank split's shape (the rows "K1 tail_halo" and "K3 tail_halo");
decode_sharded and the sharded simulation over one rank with nccl, the
simulation timed in turns with the one-device one; and two worker
processes sharing the card with gloo (scripts/distributed_worker.py),
equal to the one rank (they are time-sliced on the card: no time of
theirs is reported).  Phases 39-42 run the JAX package's decoder checks
at their sizes (tpu_viterbi_torch/scripts/): ber_deep (22 points of 128M
bits), ber_deep_tail (9 rows to 30 events, at least 512M bits), each row
on JAX's survivor plan and one 32M-bit call a tail row held against the
plain versions (40b), check_gen_ber (K7 against the element chain) and
fuzz_gpu (36 trials); phase 43 runs --e2e-device at the headline under
--profile and reads the trace: the device-busy share, the longest idle
gap and the host's ranges in it.  Phases 44-46 run the multi-rank checks
through their entry points (tpu_viterbi_torch/scripts/, the ranks started
by sharding/launch.py): ber_sharded as 8 rank processes sharing the card
(gloo) at the JAX rows' 12 points, every decode held to the plain
versions; pod_runbook at one rank with nccl and --probe-smem (its
linearity step timed) and at two ranks sharing the card (the census,
linearity modeled); pod_decode_example's 32M-bit message on one and two
ranks.  Phases 47-49 run the timing sweeps' ``run`` at the JAX tables
(tpu_viterbi_torch/scripts/): every channel format at every candidate
dec_len at 32M bits (K1, K2 on FP32, on K7's and K8's words), dec_len
against small message sizes (queued and replayed from a CUDA graph), and
the scaling curve to 128M bits at JAX's auto_dec_len and at 2048; each
row's first call held to the plain decode (BEN 0 at 64M and 128M), a row
a line.

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and nvcc
from the CUDA toolkit.  Each phase prints one line and raises on failure;
the last three lines are a JSON object of per-kernel results, the card's
name and power limit, and the JSON status line {"ok": true, "device":
{...}}.  Without a GPU, or run outside a checkout of the repository, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
if not (ROOT / "tpu_viterbi_torch" / "csrc" / "viterbi.cu").is_file():
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(tpu_viterbi_torch/ is not beside it)")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from tpu_viterbi_torch import ViterbiGPU, cli, hardware, library  # noqa: E402
from tpu_viterbi_torch.hardware import (  # noqa: E402
    ACS_OPS, bound_ms as bound)
from tpu_viterbi_torch.chain import (AddNoise, ConvolutionalEncoder,  # noqa: E402
                                     RandBitGen, SoftDecisionPacker,
                                     genkernel, snr_to_sigma,
                                     unpack_to_soft)
from tpu_viterbi_torch.chain.genkernel import (  # noqa: E402
    packed_workload_cuda, ref_words_from_packs)
from tpu_viterbi_torch.chain.decoder_element import ViterbiDecoder  # noqa: E402
from tpu_viterbi_torch.chain.encode import conv_encode  # noqa: E402
from tpu_viterbi_torch.chain.quantize import quantize_and_pack  # noqa: E402
from tpu_viterbi_torch.config import (ChannelIn, DecodeOut,  # noqa: E402
                                      DecoderConfig)
from tpu_viterbi_torch.decoder import core_cuda  # noqa: E402
from tpu_viterbi_torch.decoder.core_cuda import (  # noqa: E402
    decode_bound_ms as decode_bound, runs_pm16)
from tpu_viterbi_torch.decoder.core_torch import (  # noqa: E402
    PM16_MAX_ABS_BM, assemble_output, clamp_split, decode_blocks,
    decode_blocks_i16_torch, decode_blocks_torch, decode_packed_torch,
    decode_planes_i16_torch, decode_planes_torch, decode_staged_i16_torch,
    decode_staged_torch,
    decode_ud_words_torch, fp32_ud_words_torch, gather_blocks,
    needs_int32_renorm, plan_blocks, pm16_bound, pm16_input,
    stage_transpose, stage_words, words_per_block)
from tpu_viterbi_torch.scripts import (  # noqa: E402
    acs_variants_bench, bench_profile, bench_split, dtype_throughput,
    fp32_fused_value_probe, genkernel_probe, ilp_probe, interleave_bench,
    kernel_ablation, kernel_microbench, layout_probe, op_cost_probe,
    opt_bench, soft16_ablation, soft16_pieces, staging_cost, swar_probe,
    transpose_bench)
from tpu_viterbi_torch.scripts import (  # noqa: E402
    ber_common, ber_deep, ber_deep_tail, ber_sharded, check_gen_ber,
    fuzz_gpu, pod_decode_example, pod_runbook)
from tpu_viterbi_torch.scripts import (  # noqa: E402
    channel_throughput, scaling_curve, small_msg_sweep)
from tpu_viterbi_torch.scripts.common import (  # noqa: E402
    LANES, PIECE_RUNS, TURNS, cubin_listings, describe_mix, kernel_opcodes,
    lanes_for, loop_opcodes, pick, sass_digests, sass_table)
from tpu_viterbi_torch.sharding.simulate import (  # noqa: E402
    DEFAULT_SCALES, build_sharded_simulation, count_errors)
from tpu_viterbi_torch.sharding import (  # noqa: E402
    blocks as split_blocks, launch, mesh as split_mesh)
from tpu_viterbi_torch.sharding.certify import coded_workload  # noqa: E402
from tpu_viterbi_torch.utils import timing  # noqa: E402
from tpu_viterbi_torch.utils import profile as trace  # noqa: E402
from tpu_viterbi_torch.utils.bits import (count_bit_errors,  # noqa: E402
                                          extreme_field_words,
                                          extreme_wire, pack_msb_first)
from tpu_viterbi_torch.utils.timing import (ab_ms, cuda_ms,  # noqa: E402
                                            graph_ms, turns_ms)

HEADLINE_BITS = 32_000_000          # the reference's default -n (main.cpp:176)
HEADLINE = DecoderConfig(ChannelIn.SOFT8)   # SOFT8, int32 metrics, b32 packs
FP32 = DecoderConfig(ChannelIn.FP32)
HARD = DecoderConfig(ChannelIn.HARD)
DEC_LEN = 2048                      # ViterbiGPU.DEFAULT_DEC_LEN
THIN_DEC_LEN = 32                   # HARD's thinnest K6 window: stride 2, win 6
SEED = 7
K1, K2, K3 = core_cuda.K1, core_cuda.K2, core_cuda.K3
# K1's, K2's and K3's int32 metrics: the other sides of the int16x2 A/Bs
K1_I32, K2_I32, K3_I32 = core_cuda.K1_I32, core_cuda.K2_I32, core_cuda.K3_I32
K4, K5, K6 = core_cuda.K4, core_cuda.K5, core_cuda.K6
K6_TILE_WORDS, transpose_route = core_cuda.K6_TILE_WORDS, \
    core_cuda.transpose_route
K7, K8 = genkernel.K7, genkernel.K8
K7_OLD, K8_OLD = genkernel.K7_OLD, genkernel.K8_OLD  # K7/K8's first design
K9, K11 = hardware.K9, op_cost_probe.K11
K12, K13 = layout_probe.K12, kernel_ablation.K13
K14, K15 = acs_variants_bench.K14, ilp_probe.K15
K16, K17 = kernel_microbench.K16, dtype_throughput.K17
K18, K19 = swar_probe.K18, opt_bench.K19
K20, K23 = genkernel_probe.K20, staging_cost.K23
K25, K26 = soft16_ablation.K25, transpose_bench.K26
K28 = interleave_bench.K28
# the A/Bs' other sides, no main path's
AB_ONLY = (K1_I32, K2_I32, K3_I32, K7_OLD, K8_OLD)
KERNELS = core_cuda.KERNELS + genkernel.KERNELS + AB_ONLY + (
    K9, K11, K12, K13, K14, K15, K16, K17, K18, K19, K20, K23, K25, K26, K28)
GEN_ROUNDS_K7 = genkernel.GEN_ROUNDS
REPLACES = {"K1": "tpu_viterbi/decoder/core_pallas.py:638",
            "K2": "tpu_viterbi/decoder/core_pallas.py:683",
            "K3": "tpu_viterbi/decoder/core_pallas.py:440",
            "K4": "tpu_viterbi/decoder/core_pallas.py:503",
            "K5": "tpu_viterbi/decoder/core_pallas.py:617",
            "K6": "tpu_viterbi/decoder/core_pallas.py:1061",
            "K7": "tpu_viterbi/chain/genkernel.py:157",
            "K8": "tpu_viterbi/chain/genkernel.py:294",
            "K9": "tpu_viterbi/hardware.py:123",
            "K10": "bench.py:78",
            "K11": "scripts/op_cost_probe.py:129",
            "K12": "scripts/layout_probe.py:216",
            "K13": "scripts/kernel_ablation.py:162",
            "K14": "scripts/acs_variants_bench.py:132",
            "K15": "scripts/ilp_probe.py:48",
            "K16": "scripts/kernel_microbench.py:85",
            "K17": "scripts/dtype_throughput.py:50",
            "K18": "scripts/swar_probe.py:168",
            "K19": "scripts/opt_bench.py:73",
            "K20": "scripts/genkernel_probe.py:59",
            "K21": "scripts/bench_profile.py:104",
            "K22": "scripts/bench_split.py:60",
            "K23": "scripts/staging_cost.py:241",
            "K24": "scripts/soft16_pieces.py:107",
            "K25": "scripts/soft16_ablation.py:87",
            "K26": "scripts/transpose_bench.py:68",
            "K27": "scripts/fp32_fused_value_probe.py:95",
            "K28": "scripts/interleave_bench.py:76",
            # decode_packed_pallas's tail_halo (:1128), placed by
            # _body_and_edge into the last tile's edge row
            "K1 tail_halo": "tpu_viterbi/decoder/core_pallas.py:857",
            "K3 tail_halo": "tpu_viterbi/decoder/core_pallas.py:857"}
HALO_ROWS = ("K1 tail_halo", "K3 tail_halo")
CLI_SCALE = 40000.0                 # the CLI's channel scale (main.cpp:137)

# the generator's bound (gen_bound): its operations and special-function
# work; every other bound is hardware.bound_ms's and
# core_cuda.decode_bound_ms's
THREEFRY_OPS = 49       # threefry2x32-13: 13 x (add, rotl, xor), 5 x 2 key adds
BOX_MULLER_SFU = 4      # log, sqrt, sin, cos per normal pair


T0 = time.perf_counter()


def gen_bound(n: int, bits, out):
    """A generator's bound at message length n, noisy: its bit packs and
    stream written, ceil(n / 64) threefry calls for the message bits and
    one per stage for the noise, one Box-Muller per stage."""
    return bound((bits.numel() + out.numel()) * 4,
                 THREEFRY_OPS * (-(-n // 64) + n), BOX_MULLER_SFU * n)


def say(phase: str, msg: str) -> None:
    """One phase line, with the seconds since the script started."""
    print(f"[{phase} @{time.perf_counter() - T0:.1f} s] {msg}", flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the smoke "
                           "run needs a CUDA GPU and never falls back to "
                           "the CPU")
    card = hardware.smi_cards()[0]
    say("1 device", f"{torch.cuda.get_device_name(0)} x "
                    f"{torch.cuda.device_count()}; torch {torch.__version__} "
                    f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    return card


def build_phase():
    """One nvcc per source (and build part), all started together, and one
    link build the library of every kernel; each binds its entry point."""
    t0 = time.perf_counter()
    for k in KERNELS:
        k.build()
    secs = time.perf_counter() - t0
    log = library.build_log or ""
    regs = sorted(set(re.findall(r"Used (\d+) registers", log)), key=int)
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
    sources = sorted({str(k.source.relative_to(ROOT)) for k in KERNELS})
    slowest = sorted(library.build_seconds.items(), key=lambda kv: -kv[1])
    say("2 build", f"{', '.join(k.name for k in KERNELS)} built from "
                   f"{' + '.join(sources)} and bound in {secs:.2f} s "
                   f"(registers per thread {regs or 'cached'}, spill stores "
                   f"{spills or '-'}; slowest nvcc jobs " + ", ".join(
                       f"{job} {sec:.1f} s" for job, sec in slowest[:6]) +
        ")")


def seeded_rng(gen) -> np.random.Generator:
    """A numpy generator seeded from the torch generator ``gen``."""
    return np.random.default_rng(int(torch.randint(
        0, 2 ** 31, (1,), generator=gen, device=gen.device)))


def extreme_words(cfg, plan, gen):
    """Integer channel words for the plan whose fields all sit at their
    extremes (utils.bits.extreme_field_words, seeded from ``gen``), on the
    card."""
    n = cfg.get_input_words(2 * (plan.message_len + 64))
    return torch.from_numpy(extreme_field_words(
        seeded_rng(gen), n, cfg.enc_data_width)).to(gen.device)


def extreme_wire_values(cfg, plan, gen):
    """An FP32 wire for the plan at and past the [-8, 7] clamp, NaN and
    +-inf among it (utils.bits.extreme_wire, seeded from ``gen``), on the
    card."""
    n = cfg.get_input_words(2 * (plan.message_len + 64))
    return torch.from_numpy(extreme_wire(seeded_rng(gen), n)).to(gen.device)


def noiseless_words(plan, gen):
    """SOFT8 words of a noiseless coded message at full amplitude (fields
    +-127): the best path metric grows by 254 a stage, the worst case of
    K1's int16 metrics."""
    bits = torch.randint(0, 2, (plan.message_len + 64,), generator=gen,
                         device=gen.device)
    coded = conv_encode(bits).to(torch.float32) * 254.0 - 127.0
    return quantize_and_pack(coded, ChannelIn.SOFT8)


def random_words(cfg, plan, gen):
    """Full-range random channel words for the plan (more than the stream
    needs is not required: the kernels and the plain version zero-fill
    alike).  For FP32: values of scale 9, so that many pass the [-8, 7]
    clamp, with 5 % NaN, 2 % +inf and 2 % -inf."""
    n = cfg.get_input_words(2 * (plan.message_len + 64))
    if cfg.channel_in != ChannelIn.FP32:
        return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                             device="cuda", dtype=torch.int64
                             ).to(torch.int32)
    x = torch.randn(n, generator=gen, device="cuda") * 9
    for frac, v in ((0.05, float("nan")), (0.02, float("inf")),
                    (0.02, float("-inf"))):
        x[torch.rand(n, generator=gen, device="cuda") < frac] = v
    return x


def max_abs_diff(a, b) -> int:
    mask = 0xFFFFFFFF
    return int(((a.to(torch.int64) & mask) - (b.to(torch.int64) & mask))
               .abs().max())


def compare_phase(gen, tally) -> int:
    """K1 against decode_blocks_torch on the same CUDA tensors, and the
    staged paths of the same words (staged_checks) against the same plain
    result: random words on every plan, extreme fields (extreme_words) at
    dec_len 2048 and 16384, and the SOFT8 headline (32M bits, dec_len
    2048) on extreme fields and on noiseless full-amplitude words, where
    K1's int16 metrics renormalise every pack; on SOFT8 the int32 K1
    (K1_I32) too."""
    cases = []
    for ch in (ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT8,
               ChannelIn.SOFT16):
        for out in (DecodeOut.O_B32, DecodeOut.O_B16):
            cfg = DecoderConfig(ch, decode_out=out)
            bpp = cfg.bits_per_pack
            for dl in (32, 96, 2048):       # below 64, overlap > 0, default
                cases.append((cfg, plan_blocks(dl * 300 - bpp, bpp, dl),
                              random_words))
            cases.append((cfg, plan_blocks(DEC_LEN, bpp, DEC_LEN),  # 1 block
                          random_words))
            if ch != ChannelIn.SOFT16:
                for dl in (2048, 16384):
                    cases.append((cfg, plan_blocks(dl * 40 - bpp, bpp, dl),
                                  extreme_words))
    soft16 = DecoderConfig(ChannelIn.SOFT16)
    cases.append((soft16, plan_blocks(16384 * 40, 32, 16384),      # renorm
                  random_words))
    headline = plan_blocks(HEADLINE_BITS, 32, DEC_LEN)
    cases.append((HEADLINE, headline, extreme_words))
    cases.append((HEADLINE, headline,
                  lambda cfg, plan, gen: noiseless_words(plan, gen)))
    worst, n_renorm, n_single, n_overlap, n_i32 = 0, 0, 0, 0, 0
    for cfg, plan, words in cases:
        x = words(cfg, plan, gen)
        got = K1(x, cfg, plan)
        torch.cuda.synchronize()
        want = decode_blocks_torch(x, cfg, plan)
        err = max_abs_diff(got, want)
        if cfg.channel_in == ChannelIn.SOFT8:
            err = max(err, max_abs_diff(K1_I32(x, cfg, plan), want))
            n_i32 += 1
        if got.shape != want.shape or err:
            raise AssertionError(
                f"K1 disagrees with its plain version: {cfg.channel_in.name}"
                f" b{cfg.bits_per_pack} dec_len {plan.dec_len} blocks "
                f"{plan.num_blocks}: max |diff| {err}")
        worst = max(worst, err)
        staged_checks(tally, x, cfg, plan, False, want)
        n_renorm += needs_int32_renorm(cfg, plan)
        n_single += plan.num_blocks == 1
        n_overlap += plan.overlap_bits > 0
    if not (n_renorm and n_single and n_overlap):
        raise AssertionError("comparison cases miss a framing edge")
    say("3 kernel vs plain", f"K1 bit-equal to core_torch on {len(cases)} "
        f"plans (HARD/SOFT4/SOFT8/SOFT16 x b32/b16 x dec_len 32/96/2048, "
        f"{n_single} single-block, {n_overlap} with overlap, {n_renorm} "
        f"with int32 renorm at dec_len 16384; extreme fields on HARD/SOFT4/"
        f"SOFT8 x b32/b16 x dec_len 2048/16384 and on the {HEADLINE_BITS}-bit "
        f"SOFT8 headline, and the headline's noiseless +-127 words); K1_I32 "
        f"equal too on the {n_i32} SOFT8 plans; max |diff| {worst}")
    return worst


def reset_counts() -> None:
    """Every kernel's launch count, and K1's and K3's tail-halo counts,
    set to 0."""
    for k in KERNELS:
        k.launches = 0
    K1.halo_launches = K3.halo_launches = 0


def read_counts() -> dict:
    """{kernel name: launches} after a synchronize, the tail-halo launches
    of K1 and K3 under HALO_ROWS' names."""
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in KERNELS}
    counts.update({HALO_ROWS[0]: K1.halo_launches,
                   HALO_ROWS[1]: K3.halo_launches})
    return counts


def drive(argv, main=None):
    """Run the port's CLI (or another entry point ``main``, called with no
    argument) in this process with every kernel's launch count set to 0
    just before, and read the counts just after.  Returns (rc, stdout,
    {kernel name: launches})."""
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv) if main is None else main()
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in KERNELS}
    for k in AB_ONLY:
        if counts[k.name]:
            raise AssertionError(f"a main path launched {k.name}, kept for "
                                 f"an A/B only")
    text = buf.getvalue()
    for line in text.splitlines():
        if line.strip():
            print(f"    | {line}")
    return rc, text, counts


def record(runs: dict, counts: dict, calls: int, kernels, what: str):
    """Note in ``runs`` the launches of each of ``kernels`` in one run of a
    main path that made ``calls`` calls of its entry point (a decode, a
    generation, a probe), the counts set to 0 just before the run and read
    just after: each kernel must have launched, a whole number of times a
    call."""
    for k in kernels:
        n = counts[k]
        if n < calls or n % calls:
            raise AssertionError(f"{what}: {k} launched {n} times in "
                                 f"{calls} calls")
        runs.setdefault(k, []).append((what, n, calls))


def launches_per_call(runs: dict, name: str, want=None):
    """(launches, launches a call) of ``name`` over its recorded runs: the
    launches summed, and the one quotient every run gave, which must be
    ``want`` where the design fixes it."""
    per = {n // calls for _, n, calls in runs[name]}
    if len(per) != 1 or (want is not None and per != {want}):
        raise AssertionError(f"{name}: launches a call {sorted(per)} over "
                             f"{runs[name]}, expected {want}")
    return sum(n for _, n, _ in runs[name]), per.pop()


def main_path_phase(runs: dict):
    """The port's CLI at the reference's default size, in this process:
    one decode."""
    rc, text, counts = drive(["-n", str(HEADLINE_BITS), "-s", "5.5", "-i",
                              "s8", "-m", "b32", "--seed", str(SEED), "-v"])
    m = re.search(r"Final results -> BEN: (\d+)\s+BER: (\S+)", text)
    if rc != 0 or m is None:
        raise AssertionError(f"CLI main path failed: rc {rc}")
    if int(m.group(1)) != 0:
        raise AssertionError(f"BEN {m.group(1)} at 5.5 dB (expected 0)")
    record(runs, counts, 1, ["K1"], "main path")
    say("4 main path", f"cli.main -n {HEADLINE_BITS} -s 5.5 -i s8 -m b32 "
        f"--seed {SEED}: rc 0, BEN 0, K1 launches {counts['K1']} in one "
        f"decode")


def noisy_chain_phase():
    """A noisy 4M-bit SOFT8 chain: K1 and core_torch decode its packed
    stream bit-identically, and the BER is in the decoder's band."""
    n = 4_000_000
    packer = SoftDecisionPacker(HEADLINE.channel_in, scale=40000.0).probe()
    dec = ViterbiDecoder(HEADLINE, backend="cuda", device="cuda")
    pipe = (RandBitGen(n, seed=11, device="cuda").probe()
            | ConvolutionalEncoder()
            | AddNoise(snr_to_sigma(1.125), seed=12, device="cuda")
            | packer | dec)
    res = pipe.run()
    bits, packed = res.probed_outputs
    plan = dec.viterbi.plan(packed.shape[0] * HEADLINE.enc_data_per_pack)
    want = decode_packed_torch(packed, HEADLINE, plan)
    err = max_abs_diff(res.final_output, want)
    if res.final_output.shape != want.shape or err:
        raise AssertionError(f"noisy chain: K1 and core_torch differ "
                             f"(max |diff| {err})")
    ben = count_bit_errors(res.final_output, 32, bits, HEADLINE.extra_l)
    ber = ben / n
    # the CLI's scale 40000 saturates SOFT8 to hard decisions: the JAX
    # package's CLI decodes 400k bits at 1.125 dB to BER 1.6e-3 .. 2.1e-3
    # (seeds 7, 8); undecoded hard decisions err at ~4.7 %, a broken
    # decode near 0.5
    if not 5e-4 < ber < 5e-3:
        raise AssertionError(f"noisy chain BER {ber:g} out of band")
    say("4b noisy chain", f"SOFT8 b32 {n} bits at 1.125 dB: K1 == core_torch "
        f"on {want.shape[0]} words; BEN {ben} BER {ber:g}")
    return err


def timing_phase(card: str):
    """K1 and core_torch at the headline shape, CUDA events, on a real
    coded stream from the port's chain."""
    pipe = (RandBitGen(HEADLINE_BITS, seed=21, device="cuda")
            | ConvolutionalEncoder()
            | AddNoise(snr_to_sigma(5.5), seed=22, device="cuda")
            | SoftDecisionPacker(HEADLINE.channel_in, scale=40000.0))
    packed = pipe.run().final_output
    input_num = packed.shape[0] * HEADLINE.enc_data_per_pack
    plan = plan_blocks(HEADLINE.get_message_len(input_num), 32, DEC_LEN)
    K1(packed, HEADLINE, plan)                               # warm-up
    k1_ms, k1_all, k1_out = cuda_ms(
        lambda: K1(packed, HEADLINE, plan), 5)
    decode_blocks_torch(packed, HEADLINE, plan)              # warm-up
    plain_ms, plain_all, plain_out = cuda_ms(
        lambda: decode_blocks_torch(packed, HEADLINE, plan), 3)
    err = max_abs_diff(k1_out, plain_out)
    if err:
        raise AssertionError(f"headline shape: K1 and core_torch differ "
                             f"(max |diff| {err})")
    threads = plan.num_blocks
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bnd = decode_bound(packed.numel() * 4, HEADLINE, plan,
                       runs_pm16(K1, HEADLINE))
    say("5 times", f"{card}: headline {plan.message_len} bits SOFT8 b32 "
        f"dec_len {plan.dec_len} ({threads} blocks = threads, "
        f"{-(-threads // 64)} CUDA blocks of 64 on {sms} SMs): K1 median "
        f"{k1_ms:.4f} ms of {[round(t, 4) for t in k1_all]} = "
        f"{plan.message_len / k1_ms / 1e6:.2f} Gb/s decoded; core_torch "
        f"median {plain_ms:.1f} ms of {[round(t, 1) for t in plain_all]} "
        f"({plain_ms / k1_ms:.0f}x); outputs bit-equal; bound {bnd[0]:.4f} "
        f"ms by {bnd[1]} ({bnd[0] / k1_ms:.0%} of it)")
    return k1_ms, plain_ms, bnd


AB_RUNS = 10                        # CUDA-event samples a side of the A/B
K6_RUNS = 30                        # K6's samples a staging (0.03-0.3 ms each)
# The readers of the A/Bs' b32 instances in viterbi.cu's cubin, as mangled
# template arguments (IntReader<8, false, false, false>, FloatReader)
READERS = {ChannelIn.SOFT8: "9IntReaderILi8ELb0ELb0ELb0EEE",
           ChannelIn.FP32: "11FloatReaderE"}
HALO_READER = "9IntReaderILi8ELb0ELb0ELb1EEE"   # HaloReader<8>


def decode_instance(cfg, window: bool, pm16: bool) -> str:
    """The mangled name of viterbi_kernel<reader of cfg, 32, window, pm16>
    (the int16x2 stage where pm16, the int32 one else)."""
    return (f"viterbi_kernelINS_{READERS[cfg.channel_in]}Li32ELb{int(window)}"
            f"ELb{int(pm16)}E")


def halo_sass(window: bool) -> tuple:
    """(SASS a stage, registers) of K1's (K3's with ``window``) b32 SOFT8
    tail-halo instance, HaloReader<8>, from its own build part's cubin."""
    name = (f"viterbi_kernelINS_{HALO_READER}Li32ELb{int(window)}ELb1E")
    loop, res, _ = sass_table(name, {"halo": (name,)})["halo"]
    return loop / 2, res.get("REG")


def int16_sass(cfg, window: bool) -> dict:
    """{side: (SASS a stage, registers, stack bytes, the stage loop's
    opcode mix)} of the b32 int16x2 and int32 instances of cfg's reader in
    one survivor mode, each kernel's and its int32 A/B entry's (built in
    one part, so one cubin): the stage loop runs two stages a pass."""
    names = {side: decode_instance(cfg, window, side == "int16x2")
             for side in ("int16x2", "int32")}
    table = sass_table(names["int16x2"],
                       {side: (name,) for side, name in names.items()})
    return {side: (loop / 2, res.get("REG"), res.get("STACK"), mix)
            for side, (loop, res, mix) in table.items()}


@contextlib.contextmanager
def swapped(module, **kernels):
    """The module's attributes named in ``kernels`` set to them inside the
    block: the in-graph A/Bs' other side (the simulation looks its kernels
    up in the module at each call; in_graph_ab checks the launch counts)."""
    saved = {name: getattr(module, name) for name in kernels}
    for name, k in kernels.items():
        setattr(module, name, k)
    try:
        yield
    finally:
        for name, k in saved.items():
            setattr(module, name, k)


def in_graph_ab(cfg, survivor: str, swap, new, old, watched):
    """The in-graph simulation at the headline (32M bits, 5.5 dB, the CLI's
    scale, K7/K8 generating) as it stands and, in turns, inside ``swap()``
    (a ``swapped`` block), AB_RUNS CUDA-event samples a side, BEN 0 on
    both; of the kernels ``watched``, ``new`` and ``old`` each launched
    once a call and no other: (median ms, the swapped side's median ms,
    all ms, all the swapped side's ms, message bits)."""
    fn, m = build_sharded_simulation(cfg, HEADLINE_BITS, snr_db=5.5,
                                     scale=CLI_SCALE, generator="cuda",
                                     survivor=survivor, device="cuda")

    def swapped_call():
        with swap():
            return fn(SEED + 1)
    fn(SEED)                                                 # warm-up
    swapped_call()
    for k in watched:
        k.launches = 0
    ms, o_ms, all_ms, o_all, ben, o_ben = ab_ms(lambda: fn(SEED + 1),
                                                swapped_call, AB_RUNS)
    launched = [k.launches for k in watched]
    if (new.launches, old.launches, sum(launched)) != (
            AB_RUNS, AB_RUNS, 2 * AB_RUNS):
        raise AssertionError(
            f"in-graph A/B: {AB_RUNS} calls a side launched "
            f"{', '.join(k.name for k in watched)} {launched} times, not "
            f"{new.name} and {old.name} once a call each")
    if int(ben) or int(o_ben):
        raise AssertionError(f"in-graph A/B: BEN {int(ben)} ({new.name}), "
                             f"{int(o_ben)} ({old.name})")
    return ms, o_ms, all_ms, o_all, m


def int16_ab_phase(tag: str, card: str, gen, new, old, cfg, window: bool,
                   extreme, survivor: str = None) -> dict:
    """``new`` with int16x2 metrics against ``old``, its int32 instances,
    on the same input in the same call: the 32M-bit transmission at 5.5 dB
    and extreme input of the same plan (``extreme(cfg, plan, gen)``),
    AB_RUNS CUDA-event samples each in turns (a, b, b, a, ...), outputs
    equal to each other, to the int32 plain version (decode_blocks_torch)
    and to the int16 one (decode_blocks_i16_torch), whose largest candidate
    metric stays under the input's bound; SASS a stage and registers of
    each; on DECODE_CHECK_BITS of extreme input at dec_len 2048, ``new``
    equal to the int16 plain version under the bound; with ``survivor``,
    the in-graph simulation decoding with each in turns (in_graph_ab).
    Returns ``new``'s extra keys of the kernels line."""
    packed, plan, _ = headline_packed(cfg, 21)
    bound16 = pm16_bound(PM16_MAX_ABS_BM[pm16_input(cfg)], cfg.bits_per_pack)
    what = f"{cfg.channel_in.name} b32 dec_len {plan.dec_len}" + \
        (" window" if window else "")
    sass = int16_sass(cfg, window)
    res, peaks = {}, []
    for label, x in (("coded 5.5 dB", packed),
                     ("extreme", extreme(cfg, plan, gen))):
        new(x, cfg, plan)                                    # warm-up
        old(x, cfg, plan)
        a_ms, b_ms, a_all, b_all, a_out, b_out = ab_ms(
            lambda: new(x, cfg, plan), lambda: old(x, cfg, plan), AB_RUNS)
        if not torch.equal(a_out, b_out):
            raise AssertionError(f"{new.name} A/B on {label}: int16x2 and "
                                 f"int32 outputs differ")
        plain16, peak = decode_blocks_i16_torch(x, cfg, plan, window=window,
                                                return_peak=True)
        held(f"{new.name} on {label} against decode_blocks_i16_torch", a_out,
             plain16)
        held(f"{new.name} on {label} against decode_blocks_torch", a_out,
             decode_blocks_torch(x, cfg, plan, window))
        peaks.append(peak)
        res[label] = (a_ms, b_ms)
        gbps = plan.message_len / 1e6
        say(tag, f"{card}: {plan.message_len} bits {what}, {label}: int16x2 "
            f"median {a_ms:.4f} ms of {[round(t, 4) for t in a_all]} = "
            f"{gbps / a_ms:.2f} Gb/s; int32 ({old.name}) median {b_ms:.4f} ms "
            f"of {[round(t, 4) for t in b_all]} = {gbps / b_ms:.2f} Gb/s; "
            f"ratio {a_ms / b_ms:.3f}; outputs bit-equal to each other and to "
            f"both plain versions; largest |candidate metric| {peak}")
    say(tag, "SASS a stage (stage loop / 2), registers, stack, the loop's "
        "opcodes (two stages): " +
        "; ".join(f"{side} {n:g}, {regs} registers, stack {stack} B "
                  f"({describe_mix(mix, 12)})"
                  for side, (n, regs, stack, mix) in sass.items()))
    small = plan_blocks(DECODE_CHECK_BITS, 32, DEC_LEN)
    x = extreme(cfg, small, gen)
    plain16, peak = decode_blocks_i16_torch(x, cfg, small, window=window,
                                            return_peak=True)
    held(f"{new.name} on extreme input against decode_blocks_i16_torch",
         new(x, cfg, small), plain16)
    held("decode_blocks_i16_torch against decode_blocks_torch", plain16,
         decode_blocks_torch(x, cfg, small, window))
    peaks.append(peak)
    if max(peaks) > bound16:
        raise AssertionError(f"int16 candidate metric {max(peaks)} over the "
                             f"bound {bound16}")
    say(tag, f"{new.name} == decode_blocks_i16_torch == decode_blocks_torch "
        f"on {DECODE_CHECK_BITS} bits of extreme {cfg.channel_in.name} input"
        f" at dec_len {DEC_LEN}; largest |candidate metric| {peak}, over the "
        f"phase {max(peaks)} <= {bound16}")
    a_ms, b_ms = res["coded 5.5 dB"]
    extra = {"int32_ms": b_ms, "ab_ms": a_ms,
             "ab_extreme_ms": list(res["extreme"]),
             "sass_per_stage": sass["int16x2"][0],
             "int32_sass_per_stage": sass["int32"][0],
             "registers": sass["int16x2"][1],
             "int32_registers": sass["int32"][1], "pm16_peak": max(peaks)}
    if survivor is not None:
        ms, o_ms, all_ms, o_all, _ = in_graph_ab(
            cfg, survivor, lambda: swapped(core_cuda, K2=K2_I32, K3=K3_I32),
            new, old, (K1, K2, K3, K1_I32, K2_I32, K3_I32))
        extra.update(in_graph_ms=ms, int32_in_graph_ms=o_ms)
        say(tag, f"{card}: in-graph simulation, {cfg.channel_in.name} b32 "
            f"{HEADLINE_BITS} bits 5.5 dB, survivor {survivor}: {new.name} "
            f"median {ms:.4f} ms of {[round(t, 4) for t in all_ms]}; in turns "
            f"with {old.name} decoding {o_ms:.4f} ms of "
            f"{[round(t, 4) for t in o_all]}; ratio {ms / o_ms:.3f}; BEN 0, "
            f"one launch a call each")
    return extra


def window_compare_phase(gen, tally) -> dict:
    """K2 (FP32, full store) and K3 (every channel, window) against
    decode_blocks_torch on the same CUDA tensors (K2_I32 and K3_I32, their
    int32 instances, too where they have one), and the staged paths of
    the same words against the same plain result (staged_checks; K4 on
    unclamped f32 values against its own).  Random words: the windowed
    decode is held against the plain windowed core, not against the full
    store, from which it legitimately differs on noise."""
    cases = []
    for out in (DecodeOut.O_B32, DecodeOut.O_B16):
        cfg = DecoderConfig(ChannelIn.FP32, decode_out=out)
        bpp = cfg.bits_per_pack
        for dl in (32, 96, 2048):
            cases.append((cfg, plan_blocks(dl * 300 - bpp, bpp, dl), False))
        cases.append((cfg, plan_blocks(DEC_LEN, bpp, DEC_LEN), False))
    for ch in (ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT8,
               ChannelIn.SOFT16, ChannelIn.FP32):
        for out in (DecodeOut.O_B32, DecodeOut.O_B16):
            cfg = DecoderConfig(ch, decode_out=out)
            bpp = cfg.bits_per_pack
            for dl in (32, 96, 224, 2048):   # post-loop only .. in-loop
                cases.append((cfg, plan_blocks(dl * 300 - bpp, bpp, dl),
                              True))
    worst = {"K2": 0, "K3": 0}
    n_plans = {"K2": 0, "K3": 0}
    n_i32 = 0
    for cfg, plan, window in cases:
        x = random_words(cfg, plan, gen)
        k = core_cuda.kernel_for(cfg, window)
        got = k(x, cfg, plan)
        torch.cuda.synchronize()
        want = decode_blocks_torch(x, cfg, plan, window)
        err = max_abs_diff(got, want)
        i32 = K3_I32 if window else K2_I32
        if cfg.channel_in in i32.channels:
            err = max(err, max_abs_diff(i32(x, cfg, plan), want))
            n_i32 += 1
        if got.shape != want.shape or err:
            raise AssertionError(
                f"{k.name} disagrees with its plain version: "
                f"{cfg.channel_in.name} b{cfg.bits_per_pack} dec_len "
                f"{plan.dec_len} blocks {plan.num_blocks}: max |diff| {err}")
        worst[k.name] = max(worst[k.name], err)
        n_plans[k.name] += 1
        staged_checks(tally, x, cfg, plan, window, want)
        if cfg.channel_in == ChannelIn.FP32:
            unclamped_checks(tally, cfg, plan, window, gen)
    say("3b kernel vs plain", f"K2 bit-equal to core_torch on "
        f"{n_plans['K2']} FP32 plans (b32/b16 x dec_len 32/96/2048 with "
        f"overlap, and a single block; wire of N(0, 81) values with 5 % NaN "
        f"and 2 % each of +-inf); max |diff| {worst['K2']}")
    say("3c kernel vs plain", f"K3 bit-equal to the plain windowed core on "
        f"{n_plans['K3']} plans (HARD/SOFT4/SOFT8/SOFT16/FP32 x b32/b16 x "
        f"dec_len 32/96/224/2048, random words); K2_I32 and K3_I32 equal "
        f"too on the {n_i32} FP32 and SOFT8 plans; max |diff| "
        f"{worst['K3']}")
    say("3d kernel vs plain", f"staged paths bit-equal to the plain "
        f"decodes of phases 3-3c on the same words, full store (phase 3's "
        f"plans, renorm included, and the FP32 plans of 3b) and window "
        f"(3c's plans): K4 words and int32 values (K6 -> K4), K5 (K6 -> "
        f"clamp and split -> K5), K4 on unclamped f32 values (NaN, +-inf, "
        f"+-3e9, +-2^31, +-(2^31 - 128)) against its own plain version; "
        f"checks {tally['n']}; max "
        f"|diff| {tally['worst']}")
    worst.update(tally["worst"])
    return worst


def source_words(cfg, n_bits: int, seed: int) -> np.ndarray:
    """The words a decode without error gives for the CLI's message of
    n_bits drawn from ``seed``: message bits extra_l .. extra_l + m packed
    MSB first (the source is the chain's own RandBitGen)."""
    bits = RandBitGen(n_bits, seed=seed, device="cuda").process(None)
    m = cfg.get_message_len(2 * n_bits)
    return pack_msb_first(bits[cfg.extra_l: cfg.extra_l + m].cpu().numpy(),
                          cfg.bits_per_pack)


def serve_phase(tmp: Path, flag: str, cfg, decodes, tag: str, runs: dict):
    """Emit the headline stream through cli.main, then decode it back with
    --decode-file once per ``decodes`` entry (extra flags, the kernel that
    must carry it); every .dec must equal the source's words.  A file is
    one decode call, a streamed file one a chunk (StreamingViterbi.push;
    the flush decodes nothing past the last chunk's halo)."""
    emit = tmp / f"{tag}.bin"
    rc, text, counts = drive(["-n", str(HEADLINE_BITS), "-s", "5.5", "-i",
                              flag, "--seed", str(SEED), "--emit-file",
                              str(emit)])
    if rc != 0 or "BEN: 0 " not in text:
        raise AssertionError(f"{tag}: the emitting run failed (rc {rc})")
    want = source_words(cfg, HEADLINE_BITS, SEED)
    for i, (extra, kernel) in enumerate(decodes):
        out = tmp / f"{tag}_{i}.dec"
        rc, text, counts = drive(["-i", flag, "--decode-file", str(emit),
                                  "--out-file", str(out), "-v", *extra])
        got = np.fromfile(out, dtype=np.uint32)
        if rc != 0 or not np.array_equal(got, want):
            raise AssertionError(f"{tag} {extra}: rc {rc}, .dec differs from "
                                 f"the source's words")
        chunks = re.search(r"in (\d+) chunks of", text)
        calls = int(chunks.group(1)) if chunks else 1
        record(runs, counts, calls, [kernel], f"serve {tag} {extra}")
        say(f"6 serve {tag}", f"--decode-file {' '.join(extra) or '(full)'}"
            f": rc 0, {got.size} words byte-equal to the source's, BEN 0; "
            f"{calls} decode calls; launches {counts}")
    emit.unlink()


def multi_file_phase(tmp: Path, card: str, runs: dict):
    """Four equal 8M-bit files through one run_stream (the CLI's several-
    file path); each output equal to the per-file ViterbiGPU.run."""
    n = 8_000_000
    paths = []
    for i in range(4):
        p = tmp / f"multi{i}.bin"
        rc, _, _ = drive(["-n", str(n), "-s", "5.5", "-i", "s8", "--seed",
                          str(SEED + i), "--emit-file", str(p)])
        if rc != 0:
            raise AssertionError(f"multi-file: emitting {p.name} failed")
        paths.append(str(p))
    rc, text, counts = drive(["-i", "s8", "--decode-file", *paths, "-v"])
    m = re.search(r"([\d.]+) ms/file sustained \(([\d.]+) Gb/s\)", text)
    if rc != 0 or m is None:
        raise AssertionError(f"multi-file decode failed: rc {rc}, {counts}")
    record(runs, counts, len(paths), ["K1"], "multi-file")
    dec = ViterbiGPU(HEADLINE)
    for i, p in enumerate(paths):
        raw = np.fromfile(p, dtype=np.int32)
        want, _ = dec.run(raw, raw.shape[0] * HEADLINE.enc_data_per_pack)
        got = np.fromfile(p + ".dec", dtype=np.uint32)
        if not np.array_equal(got, want) or not np.array_equal(
                got, source_words(HEADLINE, n, SEED + i)):
            raise AssertionError(f"multi-file: {p} differs from run()")
    say("7 multi-file", f"{card}: 4 files of {n} bits SOFT8 b32 through "
        f"run_stream: {m.group(1)} ms/file sustained = {m.group(2)} Gb/s; "
        f"outputs equal to per-file run() and to the sources; launches "
        f"{counts}")


def headline_packed(cfg, seed: int):
    """The 32M-bit transmission at 5.5 dB on the card: (packed channel
    stream, its plan, the source bits)."""
    pipe = (RandBitGen(HEADLINE_BITS, seed=seed, device="cuda").probe()
            | ConvolutionalEncoder()
            | AddNoise(snr_to_sigma(5.5), seed=seed + 1, device="cuda")
            | SoftDecisionPacker(cfg.channel_in, scale=40000.0))
    res = pipe.run()
    packed = res.final_output
    input_num = packed.shape[0] * cfg.enc_data_per_pack
    return packed, plan_blocks(cfg.get_message_len(input_num),
                               cfg.bits_per_pack, DEC_LEN), \
        res.probed_outputs[0]


def kernel_times_phase(card: str):
    """K2 at the 32M-bit FP32 headline and K3 at the SOFT8 headline, CUDA
    events, each beside its plain version on the same stream."""
    times = {}
    for kernel, cfg, window in ((K2, FP32, False), (K3, HEADLINE, True)):
        packed, plan, _ = headline_packed(cfg, 21)
        kernel(packed, cfg, plan)                            # warm-up
        k_ms, k_all, k_out = cuda_ms(lambda: kernel(packed, cfg, plan), 5)
        decode_blocks_torch(packed, cfg, plan, window)       # warm-up
        p_ms, p_all, p_out = cuda_ms(
            lambda: decode_blocks_torch(packed, cfg, plan, window), 3)
        err = max_abs_diff(k_out, p_out)
        if err:
            raise AssertionError(f"headline shape: {kernel.name} and its "
                                 f"plain version differ (max |diff| {err})")
        bnd = decode_bound(packed.numel() * 4, cfg, plan,
                           runs_pm16(kernel, cfg))
        times[kernel.name] = (k_ms, p_ms, err, bnd)
        say("8 times", f"{card}: {kernel.name} at {plan.message_len} bits "
            f"{cfg.channel_in.name} b32 dec_len {plan.dec_len}"
            f"{' window' if window else ''}: median {k_ms:.4f} ms of "
            f"{[round(t, 4) for t in k_all]} = "
            f"{plan.message_len / k_ms / 1e6:.2f} Gb/s decoded; plain median "
            f"{p_ms:.1f} ms of {[round(t, 1) for t in p_all]} "
            f"({p_ms / k_ms:.0f}x); outputs bit-equal; bound {bnd[0]:.4f} "
            f"ms by {bnd[1]}")
    return times


GEN_SMALL = 33 * 1024 + 13          # not a multiple of 32: the tail mask


def generate(kernel, plain: bool, n: int, channel, sigma: float,
             scale: float, base: int = 0):
    """K7/K8, or their plain version, on the card for seed SEED."""
    k0, k1 = genkernel.key_data(SEED)
    if not plain:
        return kernel(k0, k1, n, channel, sigma, scale, base, "cuda")
    if channel == ChannelIn.FP32:
        return genkernel.gen_values_torch(k0, k1, n, sigma, scale, base,
                                          "cuda")
    return genkernel.gen_words_torch(k0, k1, n, channel, sigma, scale, base,
                                     "cuda")


def generated_diff(channel, scale: float, got, want):
    """(largest difference, elements out of tolerance) of two noisy streams
    of a generator: integer channels in quantization steps of a field, out
    of tolerance if it differs at all (the allowance is 1e-4 of the fields,
    one step each: an ulp of a libm result moved a value across a rounding
    boundary); FP32 in value units, out of tolerance beyond 4 ulp of the
    noise term scale*sigma*|z| plus 4 ulp of the value."""
    if channel == ChannelIn.FP32:
        def ulp(x):
            return torch.nextafter(x, torch.full_like(x, math.inf)) - x
        noise = (want.abs() - scale).abs()
        diff = (got - want).abs()
        bad = diff > 4 * (ulp(noise) + ulp(want.abs()))
        return float(diff.max()), int(bad.count_nonzero())
    diff = (unpack_to_soft(got, channel).to(torch.int64)
            - unpack_to_soft(want, channel)).abs()
    return int(diff.max()), int(diff.count_nonzero())


def check_generated(kernel, channel, scale, sigma, got, want, what):
    """Bit packs equal; the stream equal at sigma 0, else within tolerance.
    Returns the largest difference."""
    (kb, kout), (pb, pout) = got, want
    if kout.shape != pout.shape or not torch.equal(kb, pb):
        raise AssertionError(f"{kernel.name} {what}: bit packs or stream "
                             f"shape differ from the plain version")
    if not sigma:
        if not torch.equal(kout, pout):
            raise AssertionError(f"{kernel.name} {what}: noiseless stream "
                                 f"differs from the plain version")
        return 0
    worst, n_bad = generated_diff(channel, scale, kout, pout)
    fields = kout.numel() * (1 if channel == ChannelIn.FP32
                             else 32 // genkernel.word_format(channel)[0])
    if channel == ChannelIn.FP32 and n_bad:
        raise AssertionError(f"K8 {what}: {n_bad} values beyond 4 ulp")
    if channel != ChannelIn.FP32 and (worst > 1 or n_bad > 1e-4 * fields):
        raise AssertionError(f"K7 {what}: {n_bad} of {fields} fields differ, "
                             f"by up to {worst} steps")
    return worst


def generator_compare_phase():
    """K7 (HARD/SOFT4/SOFT8/SOFT16) and K8 (FP32) against their plain
    version on the same card at the default scales: bit packs equal,
    noiseless streams equal at a ragged size and at the headline, noisy
    ones (5.5 and 1.125 dB) within tolerance, and a launch at a non-zero
    base equal to that slice of the base-0 stream."""
    worst = {"K7": 0, "K8": 0.0}
    n_cases = 0
    for ch in ChannelIn:
        kernel = genkernel.kernel_for(ch)
        scale = DEFAULT_SCALES[ch]
        for n, snr in ((GEN_SMALL, math.inf), (HEADLINE_BITS, math.inf),
                       (GEN_SMALL, 5.5), (GEN_SMALL, 1.125),
                       (4_000_000, 5.5), (4_000_000, 1.125)):
            sigma = 0.0 if math.isinf(snr) else snr_to_sigma(snr)
            got = generate(kernel, False, n, ch, sigma, scale)
            torch.cuda.synchronize()
            want = generate(kernel, True, n, ch, sigma, scale)
            worst[kernel.name] = max(worst[kernel.name], check_generated(
                kernel, ch, scale, sigma, got, want,
                f"{ch.name} n {n} at {snr} dB"))
            n_cases += 1
        quantum = 64 if ch == ChannelIn.FP32 else \
            genkernel.word_format(ch)[2]
        sigma = snr_to_sigma(1.125)
        bits, full = generate(kernel, False, GEN_SMALL, ch, sigma, scale)
        base = quantum * (full.shape[0] // quantum // 3)
        bits_b, part = generate(kernel, False, GEN_SMALL, ch, sigma, scale,
                                base)
        if not (torch.equal(part, full[base:])
                and torch.equal(bits_b, bits[base // quantum:])):
            raise AssertionError(f"{kernel.name} {ch.name}: base {base} is "
                                 f"not that slice of the base-0 stream")
    say("9 generator vs plain", f"K7 (HARD/SOFT4/SOFT8/SOFT16) and K8 (FP32)"
        f" against their plain version on {n_cases} cases: bit packs equal; "
        f"noiseless streams equal at n {GEN_SMALL} and {HEADLINE_BITS}; noisy"
        f" (5.5, 1.125 dB at n {GEN_SMALL}, 4000000) within tolerance, "
        f"largest K7 field step {worst['K7']}, K8 |diff| {worst['K8']:g}; "
        f"a non-zero base gives that slice")
    return worst


def e2e_phase(runs: dict):
    """--e2e-device through cli.main at the reference's default size:
    SOFT8 (K7 + K1), FP32 (K8 + K2), --survivor window (K7 + K3), each BEN 0
    at 5.5 dB; then a noisy 4M-bit run whose BER must lie in the decoder's
    band.  Each run calls simulate() once, and once more for the -v
    steady-state line.  Returns {run: (steady-state ms, Gb/s) of the CLI's
    -v line}."""
    steady = {}
    for tag, extra, gk, dk in (("SOFT8", ["-i", "s8"], "K7", "K1"),
                               ("FP32", ["-i", "f"], "K8", "K2"),
                               ("SOFT8 window", ["-i", "s8", "--survivor",
                                                 "window"], "K7", "K3")):
        rc, text, counts = drive(["-n", str(HEADLINE_BITS), "-s", "5.5",
                                  "--seed", str(SEED), "-v", "--e2e-device",
                                  *extra])
        m = re.search(r"Final results -> BEN: (\d+)\s", text)
        st = re.search(r"steady-state per call: ([\d.]+) ms \(([\d.e+-]+) "
                       r"Gb/s e2e\)   \[BEN 0\]", text)
        if rc != 0 or m is None or int(m.group(1)) != 0 or st is None:
            raise AssertionError(f"--e2e-device {tag} failed: rc {rc}")
        record(runs, counts, 2, [gk, dk], f"--e2e-device {tag}")
        steady[tag] = (float(st.group(1)), float(st.group(2)))
        say("10 e2e", f"cli.main -n {HEADLINE_BITS} -s 5.5 --seed {SEED} "
            f"--e2e-device {' '.join(extra)}: rc 0, BEN 0; launches {counts}")
    n = 4_000_000
    rc, text, counts = drive(["-n", str(n), "-s", "1.125", "-i", "s8",
                              "--seed", str(SEED), "--e2e-device"])
    m = re.search(r"Final results -> BEN: (\d+)\s", text)
    if rc != 0 or m is None:
        raise AssertionError(f"noisy --e2e-device failed: rc {rc}, {counts}")
    record(runs, counts, 1, ["K7", "K1"], "noisy --e2e-device")
    ber = int(m.group(1)) / n
    # the band of phase 4b: scale 40000 saturates SOFT8 to hard decisions;
    # a generator that forgets the noise gives 0, a broken decode ~0.5
    if not 5e-4 < ber < 5e-3:
        raise AssertionError(f"noisy --e2e-device BER {ber:g} out of band")
    say("10b noisy e2e", f"--e2e-device -n {n} -s 1.125 -i s8: BEN "
        f"{m.group(1)} BER {ber:g}; launches {counts}")
    return steady


def generator_times_phase(card: str):
    """K7 (SOFT8) and K8 at the headline (32M bits, 5.5 dB, the CLI's scale)
    beside their plain version, CUDA events; then the in-graph simulation
    end to end per call: SOFT8 and FP32 generated by K7/K8, each in turns
    with their first design (AB_RUNS samples a side), and SOFT8 generated
    by the element chain."""
    times = {}
    sigma = snr_to_sigma(5.5)
    for kernel, cfg in ((K7, HEADLINE), (K8, FP32)):
        ch = cfg.channel_in
        generate(kernel, False, HEADLINE_BITS, ch, sigma, CLI_SCALE)
        k_ms, k_all, got = cuda_ms(lambda: generate(
            kernel, False, HEADLINE_BITS, ch, sigma, CLI_SCALE), 5)
        generate(kernel, True, HEADLINE_BITS, ch, sigma, CLI_SCALE)
        p_ms, p_all, want = cuda_ms(lambda: generate(
            kernel, True, HEADLINE_BITS, ch, sigma, CLI_SCALE), 3)
        err = check_generated(kernel, ch, CLI_SCALE, sigma, got, want,
                              "headline")
        bnd = gen_bound(HEADLINE_BITS, *got)
        times[kernel.name] = (k_ms, p_ms, err, bnd)
        n_out = got[1].numel()
        say("11 times", f"{card}: {kernel.name} at {HEADLINE_BITS} bits "
            f"{ch.name} 5.5 dB ({n_out} {'values' if cfg is FP32 else 'words'}"
            f", {got[0].numel()} bit packs): median {k_ms:.4f} ms of "
            f"{[round(t, 4) for t in k_all]} = "
            f"{HEADLINE_BITS / k_ms / 1e6:.2f} Gb/s generated; plain median "
            f"{p_ms:.1f} ms of {[round(t, 1) for t in p_all]} "
            f"({p_ms / k_ms:.0f}x); bound {bnd[0]:.4f} ms by {bnd[1]}")
    e2e = {}
    for cfg, new, old in ((HEADLINE, K7, K7_OLD), (FP32, K8, K8_OLD)):
        ms, o_ms, all_ms, o_all, m = in_graph_ab(
            cfg, "auto", lambda: swapped(genkernel, K7=K7_OLD, K8=K8_OLD),
            new, old, (K7, K8, K7_OLD, K8_OLD))
        tag = f"{cfg.channel_in.name} cuda"
        e2e[tag], e2e[f"{tag} first design"] = ms, o_ms
        say("11 e2e", f"{card}: in-graph simulation, generator cuda, "
            f"{cfg.channel_in.name} b32 {HEADLINE_BITS} bits 5.5 dB: median "
            f"{ms:.4f} ms of {[round(t, 4) for t in all_ms]} per call = "
            f"{m / ms / 1e6:.3f} Gb/s e2e; BEN 0; in turns with {old.name} "
            f"generating (one launch a call each): median {o_ms:.4f} ms of "
            f"{[round(t, 4) for t in o_all]}, ratio {ms / o_ms:.3f}")
    fn, m = build_sharded_simulation(HEADLINE, HEADLINE_BITS, snr_db=5.5,
                                     scale=CLI_SCALE, generator="torch",
                                     device="cuda")
    fn(SEED)
    ms, all_ms, ben = cuda_ms(lambda: fn(SEED + 1), 5)
    if int(ben) != 0:
        raise AssertionError(f"e2e SOFT8 torch: BEN {int(ben)}")
    e2e["SOFT8 torch"] = ms
    say("11 e2e", f"{card}: in-graph simulation, generator torch, SOFT8 b32 "
        f"{HEADLINE_BITS} bits 5.5 dB: median {ms:.4f} ms of "
        f"{[round(t, 4) for t in all_ms]} per call = {m / ms / 1e6:.3f} "
        f"Gb/s e2e; BEN 0")
    return times, e2e


def gen_sass() -> dict:
    """{(channel, shared): (SASS a pair, registers, stack bytes, opcode
    mix)} of csrc/genkernel.cu's instances (K7 a width, K8; shared = the
    pack-table design, else the first design's draws): a kernel's static
    instructions, padding NOPs left out, over the noise pairs a thread
    draws (K7: its word's stages; K8: 1)."""
    sass, res = cubin_listings("gen_words_kernel")
    mixes = kernel_opcodes(sass)
    table = {}
    for ch in ChannelIn:
        for shared in (True, False):
            if ch == ChannelIn.FP32:
                part, pairs = f"gen_values_kernelILb{int(shared)}E", 1
            else:
                width, vpw, _ = genkernel.word_format(ch)
                part = f"gen_words_kernelILi{width}ELb{int(shared)}E"
                pairs = vpw // 2
            mix, use = pick(mixes, part), pick(res, part)
            table[ch, shared] = (sum(mix.values()) / pairs, use.get("REG"),
                                 use.get("STACK"), mix)
    return table


def gen_ab_phase(card: str) -> dict:
    """K7 (every width) and K8 against K7_OLD / K8_OLD, the first design's
    draws, on the same card: bit packs and noiseless streams equal, noisy
    streams equal or within phase 9's tolerance, at the ragged size from
    base 0, one pack and two packs (a CTA span starting on pack -1, an
    even and an odd pack) and at the headline; then K7 (SOFT8) and K8 at
    the headline
    (32M bits, 5.5 dB, the CLI's scale) timed in turns, AB_RUNS CUDA-event
    samples a side, with the threefry calls each design draws by its count
    (genkernel.threefry_calls, not a measurement), SASS a pair, registers
    and share of bound.  Returns K7's and K8's extra keys of the kernels
    line."""
    cases = identical = 0
    for ch in ChannelIn:
        new, old = (K8, K8_OLD) if ch == ChannelIn.FP32 else (K7, K7_OLD)
        scale = DEFAULT_SCALES[ch]
        quantum = 64 if ch == ChannelIn.FP32 else \
            genkernel.word_format(ch)[2]
        for n, snr, base in ((GEN_SMALL, math.inf, 0),
                             (GEN_SMALL, 1.125, quantum),
                             (GEN_SMALL, 5.5, 2 * quantum),
                             (HEADLINE_BITS, math.inf, 0),
                             (HEADLINE_BITS, 5.5, 0)):
            sigma = 0.0 if math.isinf(snr) else snr_to_sigma(snr)
            got = generate(new, False, n, ch, sigma, scale, base)
            want = generate(old, False, n, ch, sigma, scale, base)
            check_generated(new, ch, scale, sigma, got, want,
                            f"{ch.name} n {n} at {snr} dB from base {base} "
                            f"against {old.name}")
            identical += torch.equal(got[1], want[1])
            cases += 1
    say("11b generator A/B", f"K7 (HARD/SOFT4/SOFT8/SOFT16) and K8 against "
        f"K7_OLD/K8_OLD on {cases} cases (n {GEN_SMALL} from base 0, one and "
        f"two packs; n {HEADLINE_BITS}; noiseless, 5.5 and 1.125 dB): bit "
        f"packs and noiseless streams equal; streams bit-identical in "
        f"{identical} of {cases} cases, the rest within phase 9's tolerance")
    sass = gen_sass()
    sigma = snr_to_sigma(5.5)
    extra = {}
    for new, old, cfg in ((K7, K7_OLD, HEADLINE), (K8, K8_OLD, FP32)):
        ch = cfg.channel_in

        def run(kernel):
            return generate(kernel, False, HEADLINE_BITS, ch, sigma,
                            CLI_SCALE)
        run(new)                                             # warm-up
        run(old)
        a_ms, b_ms, a_all, b_all, a_out, b_out = ab_ms(
            lambda: run(new), lambda: run(old), AB_RUNS)
        check_generated(new, ch, CLI_SCALE, sigma, a_out, b_out,
                        f"headline against {old.name}")
        bnd = gen_bound(HEADLINE_BITS, *a_out)
        calls = {d: genkernel.threefry_calls(HEADLINE_BITS, ch, shared=d)
                 for d in (True, False)}
        (pair, regs, stack, mix), (o_pair, o_regs, o_stack, o_mix) = \
            sass[ch, True], sass[ch, False]
        say("11b generator A/B", f"{card}: {new.name} at {HEADLINE_BITS} bits "
            f"{ch.name} 5.5 dB: median {a_ms:.4f} ms of "
            f"{[round(t, 4) for t in a_all]}; {old.name} median {b_ms:.4f} ms "
            f"of {[round(t, 4) for t in b_all]}; ratio {a_ms / b_ms:.3f}; "
            f"threefry-{GEN_ROUNDS_K7} calls by the designs' count "
            f"{calls[True]} against {calls[False]}; {share(bnd, a_ms)} "
            f"against {bnd[0] / b_ms:.0%} of it for {old.name}")
        say("11b generator A/B", f"{new.name} static SASS a pair {pair:g}, "
            f"{regs} registers, stack {stack} B ({describe_mix(mix)}); "
            f"{old.name} {o_pair:g}, {o_regs} registers, stack {o_stack} B "
            f"({describe_mix(o_mix)})")
        extra[new.name] = {
            "old_ms": b_ms, "ab_ms": a_ms, "sass_per_pair": pair,
            "old_sass_per_pair": o_pair, "registers": regs,
            "old_registers": o_regs}
    say("11b generator A/B", "static SASS a pair, registers, stack by width: "
        + "; ".join(f"{ch.name} {sass[ch, True][0]:g} / {sass[ch, True][1]} / "
                    f"{sass[ch, True][2]} B (first design "
                    f"{sass[ch, False][0]:g} / {sass[ch, False][1]} / "
                    f"{sass[ch, False][2]} B)" for ch in ChannelIn))
    return extra


def random_values(cfg, plan, gen):
    """(S, 2) soft values for the values-in entry, S a little short of the
    plan's stages (the last block reads zero fill): integer channels within
    their field range (the contract of decode_blocks_cuda); FP32 values of
    scale 30, NOT clamped, with 4 % NaN, 2 % each of +-inf and 2 % each of
    +-3e9 (past the int32 range), and 1 % each of +-2^31 and +-(2^31 - 128)
    (the float below 2^31), the edges of K4's conversion."""
    shape = (plan.message_len + 57, 2)
    if cfg.channel_in == ChannelIn.FP32:
        x = torch.randn(shape, generator=gen, device="cuda") * 30
        for frac, v in ((0.04, float("nan")), (0.02, float("inf")),
                        (0.02, float("-inf")), (0.02, 3e9), (0.02, -3e9),
                        (0.01, 2.0 ** 31), (0.01, -2.0 ** 31),
                        (0.01, 2.0 ** 31 - 128), (0.01, 128 - 2.0 ** 31)):
            x[torch.rand(shape, generator=gen, device="cuda") < frac] = v
        return x
    if cfg.channel_in == ChannelIn.HARD:
        return torch.randint(0, 2, shape, generator=gen, device="cuda",
                             dtype=torch.int32) * 2 - 1
    half = 1 << (cfg.enc_data_width - 1)
    return torch.randint(-half, half, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def bits_diff(a, b) -> int:
    """max |diff| of two tensors' 32-bit patterns (f32 read as int32, so a
    NaN equals the same NaN)."""
    return max_abs_diff(a.view(torch.int32), b.view(torch.int32))


def new_tally():
    """Worst |diff| per staged kernel and the number of checks per path."""
    return {"worst": {"K4": 0, "K5": 0, "K6": 0},
            "n": {"K4 words": 0, "K4 int32 values": 0, "K4 f32 values": 0,
                  "K5": 0, "K6": 0}}


def check_staged(tally, kernel, what, cfg, plan, got, want):
    """Raise unless a staged kernel's output equals ``want`` bit for bit;
    count it in ``tally``."""
    torch.cuda.synchronize()
    err = bits_diff(got, want)
    if got.shape != want.shape or err:
        raise AssertionError(
            f"{kernel.name} ({what}) disagrees with its plain version: "
            f"{cfg.channel_in.name} b{cfg.bits_per_pack} dec_len "
            f"{plan.dec_len} blocks {plan.num_blocks}: max |diff| {err}")
    tally["worst"][kernel.name] = max(tally["worst"][kernel.name], err)
    tally["n"][what] += 1


def staged_checks(tally, x, cfg, plan, window: bool, want):
    """The staged paths on the words (FP32 wire) ``x`` that K1/K2/K3 were
    just held against: ``want`` is their plain decode, and decode_staged_
    torch / decode_planes_torch on the staged forms equal it by
    construction (tests/test_torch_staged.py), so the staged kernels are
    held against the same plain result.  K6 stages the words, K4 decodes
    them (word mode), and K6 -> K4 decodes the words' int32 soft values
    (value mode; the stream padded with zero words first, as K1 reads it);
    for FP32, K6 -> clamp and split -> K5.  Each K6 output is held against
    stage_transpose."""
    b = plan.num_blocks

    def staged(v, stride, win):
        st = K6(v, stride, win, b)
        check_staged(tally, K6, "K6", cfg, plan, st,
                     stage_transpose(v, stride, win, b))
        return st

    wpb, wph = words_per_block(cfg, plan)
    wt = staged(x, wpb, wpb + wph)
    if cfg.channel_in == ChannelIn.FP32:
        check_staged(tally, K5, "K5", cfg, plan,
                     K5(*clamp_split(wt, plan), cfg, plan, window), want)
        return
    check_staged(tally, K4, "K4 words", cfg, plan,
                 K4(wt, cfg, plan, window), want)
    need = (b - 1) * wpb + wpb + wph
    padded = torch.cat([x, x.new_zeros(max(0, need - x.numel()))])[:need]
    st = staged(unpack_to_soft(padded, cfg.channel_in), 2 * plan.dec_len,
                2 * plan.block_len)
    check_staged(tally, K4, "K4 int32 values", cfg, plan,
                 K4(st, cfg, plan, window), want)


def unclamped_checks(tally, cfg, plan, window: bool, gen):
    """K4 in value mode on unclamped f32 (S, 2) values (``random_values``:
    NaN, +-inf, +-3e9, +-2^31, +-(2^31 - 128)) against its plain version,
    and K6 on them against its."""
    r = random_values(cfg, plan, gen).reshape(-1)
    args = (2 * plan.dec_len, 2 * plan.block_len, plan.num_blocks)
    st = K6(r, *args)
    check_staged(tally, K6, "K6", cfg, plan, st, stage_transpose(r, *args))
    check_staged(tally, K4, "K4 f32 values", cfg, plan,
                 K4(st, cfg, plan, window),
                 decode_staged_torch(st, cfg, plan, window))


def counted(fn):
    """fn() with every kernel's launch count set to 0 just before it and
    read just after: (result, {kernel name: launches})."""
    for k in KERNELS:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in KERNELS}


def staged_path_phase(runs: dict):
    """The staged-input paths at full width on the 32M-bit transmission at
    5.5 dB: decode_packed_cuda(fused=False) (K6 -> K4) equal to the K1
    decode word for word, the values-in entry decode_blocks_cuda (K6 -> K4)
    on the transmission's (S, 2) soft values equal to it too, and on the
    FP32 wire fp32_words=False (K6 -> K5) equal to K2; BEN 0 for each;
    each run one call."""
    for cfg, tag in ((HEADLINE, "SOFT8"), (FP32, "FP32")):
        packed, plan, bits = headline_packed(cfg, SEED)
        ref, ref_counts = counted(lambda: core_cuda.decode_packed_cuda(
            packed, cfg, plan))
        ref_kernel = "K2" if cfg is FP32 else "K1"
        staged = [("fp32_words=False", "K5",
                   lambda: core_cuda.decode_packed_cuda(
                       packed, cfg, plan, fp32_words=False))] \
            if cfg is FP32 else [
            ("fused=False", "K4", lambda: core_cuda.decode_packed_cuda(
                packed, cfg, plan, fused=False)),
            ("decode_blocks_cuda", "K4", lambda: core_cuda.decode_blocks_cuda(
                unpack_to_soft(packed, cfg.channel_in).reshape(-1, 2), cfg,
                plan))]
        ben = count_bit_errors(ref, 32, bits, cfg.extra_l)
        if ref_counts[ref_kernel] != 1 or ben:
            raise AssertionError(f"{tag}: the {ref_kernel} decode failed "
                                 f"(BEN {ben}, {ref_counts})")
        record(runs, ref_counts, 1, [ref_kernel],
               f"{tag} decode_packed_cuda")
        for what, kernel, fn in staged:
            got, counts = counted(fn)
            ben = count_bit_errors(got, 32, bits, cfg.extra_l)
            want = {"K6": 1, kernel: 1}
            if not torch.equal(got, ref) or ben or any(
                    counts[k] != want.get(k, 0) for k in counts):
                raise AssertionError(
                    f"{tag} {what}: {'equal' if torch.equal(got, ref) else 'differs from'}"
                    f" the {ref_kernel} decode, BEN {ben}, launches {counts}")
            record(runs, counts, 1, list(want), f"{tag} {what}")
            say("13 staged path", f"{tag} {HEADLINE_BITS} bits 5.5 dB "
                f"{what}: {got.shape[0]} words equal to the {ref_kernel} "
                f"decode, BEN 0; launches {want}")


# K4's and K5's b32 full-store instances in viterbi.cu's cubin: each
# mode's reader as mangled template arguments (StagedIntReader<8>,
# PlaneReader<int>, UnclampedReader = PlaneReader<float, true>,
# PlaneReader<float>) and whether it runs int16x2 metrics; word mode is in
# one build part, the value modes and K5 in another
STAGED_READERS = {"K4 words": ("9IntReaderILi8ELb1ELb0ELb0EEE", True),
                  "K4 values": ("11PlaneReaderIiLb0EEE", True),
                  "K4 f32 values": ("11PlaneReaderIfLb1EEE", False),
                  "K5": ("11PlaneReaderIfLb0EEE", True)}


def loop_stages(mix: dict) -> float:
    """The ACS stages a stage loop's opcode mix runs: 64 maxima a stage,
    VIMNMX one (int32) or VIMNMX.S16x2 two (int16x2) of them."""
    return mix.get("VIMNMX", 0) / 64 + mix.get("VIMNMX.S16x2", 0) / 32


def staged_sass() -> dict:
    """{mode: (SASS a stage, registers, stack bytes, F2I a stage, the stage
    loop's opcode mix)} of K4's and K5's b32 full-store instances (a pass
    of the stage loop runs the reader's kStep stages, loop_stages)."""
    out = {}
    for modes in (("K4 words",), ("K4 values", "K4 f32 values", "K5")):
        names = {m: f"viterbi_kernelINS_{STAGED_READERS[m][0]}Li32ELb0E"
                    f"Lb{int(STAGED_READERS[m][1])}E" for m in modes}
        table = sass_table(names[modes[0]],
                           {m: (name,) for m, name in names.items()})
        for m, (loop, res, mix) in table.items():
            n = loop_stages(mix)
            f2i = sum(k for op, k in mix.items() if op.startswith("F2I"))
            out[m] = (loop / n, res.get("REG"), res.get("STACK"), f2i / n,
                      mix)
    return out


def staged_times_phase(card: str):
    """K6 on words, on values and on HARD's words at dec_len 32 (stride 2,
    win 6), each with the route that ran; K4 in word mode in turns with K1
    (the same int16x2 ACS on the flat stream: the coalescing A/B) and
    K1_I32 (the int32 ACS), K5 in turns with K2 and K2_I32 likewise, K4 in
    value mode (integer values; f32 values, the staged FP32 wire
    unclamped, in turns with K4 on the same wire clamped as K5's planes
    are, which must decode as K5): CUDA-event medians of AB_RUNS at the
    headline, each plain version's median of 3, outputs equal to each
    other, to the int32 plain version and, where the mode runs int16x2, to
    the int16 one, whose largest candidate metric stays under the input's
    bound; SASS a stage, registers and F2I of each b32 instance, the bound
    at the int16x2 count where it applies.  Returns the rows K4, K5 and K6
    (K4's value modes and each yardstick's time in K4's and K5's extra
    keys, K6's values and HARD times in K6's)."""
    times = {}
    packed, plan, _ = headline_packed(HEADLINE, 21)
    b = plan.num_blocks
    wpb, wph = words_per_block(HEADLINE, plan)
    vals = unpack_to_soft(packed, HEADLINE.channel_in)
    # HARD at dec_len 32: the thinnest window (stride 2, win 6)
    hard, hplan, _ = headline_packed(HARD, 21)
    hplan = plan_blocks(hplan.message_len, HARD.bits_per_pack, THIN_DEC_LEN)
    hw, hh = words_per_block(HARD, hplan)
    stagings = (("words", packed, wpb, wpb + wph, b),
                ("values", vals, 2 * plan.dec_len, 2 * plan.block_len, b),
                ("hard32", hard, hw, hw + hh, hplan.num_blocks))
    staged, k6_extra = {}, {}
    for what, x, stride, win, num in stagings:
        K6(x, stride, win, num)                              # warm-up
        before = Counter(K6.route_launches)
        k_ms, k_all, got = cuda_ms(lambda: K6(x, stride, win, num), K6_RUNS)
        ran = sorted(Counter(K6.route_launches) - before)
        if ran != [transpose_route(x.data_ptr(), stride, win)]:
            raise AssertionError(f"K6 on {what} ran the routes {ran}")
        p_ms, p_all, want = cuda_ms(
            lambda: stage_transpose(x, stride, win, num), 3)
        err = bits_diff(got, want)
        if err:
            raise AssertionError(f"K6 on {what} differs from its plain "
                                 f"version (max |diff| {err})")
        staged[what] = got
        mb = (x.numel() + got.numel()) * 4 / 1e6
        need = (num - 1) * stride + win        # the pad is not timed
        padded = torch.cat([x, x.new_zeros(max(0, need - x.numel()))])
        lib_ms, _, lib = cuda_ms(lambda: torch.as_strided(
            padded, (win, num), (1, stride)).contiguous(), 5)
        if bits_diff(lib, want):
            raise AssertionError(f"as_strided on {what} differs from K6")
        bnd = bound(mb * 1e6)
        times[f"K6 {what}"] = (k_ms, p_ms, err, bnd, lib_ms)
        vec, ti = ran[0]
        k6_extra.update({f"{what}_ms": k_ms, f"{what}_bound_ms": bnd[0],
                         f"{what}_library_ms": lib_ms,
                         f"{what}_route": f"{4 * vec}-byte loads, "
                                          f"{ti}-row tiles"})
        say("14 times", f"{card}: K6 on the {what} (stride {stride}, win "
            f"{win}, {x.numel()} words -> {tuple(got.shape)}), route "
            f"{4 * vec}-byte loads, {ti} x {K6_TILE_WORDS // ti} tiles: "
            f"median {k_ms:.4f} ms of {[round(t, 4) for t in k_all]} = "
            f"{mb / k_ms / 1e3:.3f} TB/s of {mb:.1f} MB moved ("
            f"{bnd[0] / k_ms:.1%} of the bound {bnd[0]:.4f} ms by {bnd[1]});"
            f" plain median {p_ms:.3f} ms of {[round(t, 3) for t in p_all]};"
            f" as_strided(...).contiguous() median {lib_ms:.4f} ms")
    wire, fplan, _ = headline_packed(FP32, 21)
    fw, fh = words_per_block(FP32, fplan)
    wire_staged = K6(wire, fw, fw + fh, fplan.num_blocks)
    planes = clamp_split(wire_staged, fplan)
    # the same values clamped to [-8, 7], K5's planes interleaved again:
    # K4's f32 reader and ACS on K5's input, which it decodes as K5 does
    clamped = torch.stack(planes, dim=2).reshape(wire_staged.shape)
    k5_out = K5(*planes, FP32, fplan)

    def beside(k, x, cfg, pl, want=None):
        """A yardstick timed in turns: (label, call, the output it must
        give; None: the timed kernel's own)."""
        return k.name, (lambda: k(x, cfg, pl)), want
    cases = (("K4 words", K4, (staged["words"],), HEADLINE, plan,
              (beside(K1, packed, HEADLINE, plan),
               beside(K1_I32, packed, HEADLINE, plan))),
             ("K4 values", K4, (staged["values"],), HEADLINE, plan, ()),
             ("K4 f32 values", K4, (wire_staged,), FP32, fplan,
              (("K4 on the clamped wire",
                lambda: K4(clamped, FP32, fplan), k5_out),)),
             ("K5", K5, planes, FP32, fplan,
              (beside(K2, wire, FP32, fplan),
               beside(K2_I32, wire, FP32, fplan))))
    sass = staged_sass()
    extra = {"K4": {}, "K5": {}}
    for name, kernel, args, cfg, pl, others in cases:
        fns = [lambda: kernel(*args, cfg, pl)] + [fn for _, fn, _ in others]
        for fn in fns:                                       # warm-up
            fn()
        meds, all_ms, outs = turns_ms(fns, AB_RUNS)
        got, k_ms = outs[0], meds[0]
        line = ""
        for (label, _, want), o_ms, o_all, o_out in zip(
                others, meds[1:], all_ms[1:], outs[1:]):
            if not torch.equal(got if want is None else want, o_out):
                raise AssertionError(f"{label} beside {name}: its output "
                                     f"differs at the headline")
            extra[kernel.name][
                f"{label.lower().replace(' ', '_')}_ms"] = o_ms
            line += (f"; {label} in turns with it: median {o_ms:.4f} ms of "
                     f"{[round(t, 4) for t in o_all]} ({name} / {label} = "
                     f"{k_ms / o_ms:.3f})")
        plain = (lambda: decode_planes_torch(*args, cfg, pl)) \
            if kernel is K5 else (lambda: decode_staged_torch(*args, cfg, pl))
        plain()                                              # warm-up
        p_ms, p_all, want = cuda_ms(plain, 3)
        err = max_abs_diff(got, want)
        if err:
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"the headline (max |diff| {err})")
        pm16 = STAGED_READERS[name][1]
        if pm16 != runs_pm16(kernel, cfg):
            raise AssertionError(f"{name}: the metrics' width of its reader "
                                 f"and of runs_pm16 differ")
        held16 = ""
        if pm16:
            i16 = decode_planes_i16_torch if kernel is K5 else \
                decode_staged_i16_torch
            plain16, peak = i16(*args, cfg, pl, return_peak=True)
            held(f"{name} against its int16 plain version", got, plain16)
            bound16 = pm16_bound(PM16_MAX_ABS_BM[pm16_input(cfg)],
                                 cfg.bits_per_pack)
            if peak > bound16:
                raise AssertionError(f"{name}: int16 candidate metric {peak} "
                                     f"over the bound {bound16}")
            held16 = (f" and its int16 plain version (largest |candidate "
                      f"metric| {peak} <= {bound16})")
        bnd = decode_bound(sum(a.numel() for a in args) * 4, cfg, pl, pm16)
        times[name] = (k_ms, p_ms, err, bnd)
        n, regs, stack, f2i, mix = sass[name]
        key = name.lower().replace(" ", "_")
        extra[kernel.name].update({
            f"{key}_ms": k_ms, f"{key}_bound_ms": bnd[0],
            f"{key}_sass_per_stage": n, f"{key}_registers": regs,
            f"{key}_f2i_per_stage": f2i})
        say("14 times", f"{card}: {name} at {pl.message_len} bits "
            f"{cfg.channel_in.name} b32 dec_len {pl.dec_len}, "
            f"{'int16x2' if pm16 else 'int32'} metrics: median {k_ms:.4f} ms "
            f"of {[round(t, 4) for t in all_ms[0]]} = "
            f"{pl.message_len / k_ms / 1e6:.2f} Gb/s decoded{line}; plain "
            f"median {p_ms:.1f} ms of {[round(t, 1) for t in p_all]} "
            f"({p_ms / k_ms:.0f}x); outputs bit-equal to the int32 plain "
            f"version{held16}; bound {bnd[0]:.4f} ms by {bnd[1]}; b32 "
            f"instance: {n:g} SASS a stage, {f2i:g} F2I a stage, {regs} "
            f"registers, stack {stack} B ({describe_mix(mix, 12)})")
    times["K4"] = (*times["K4 words"], None, extra["K4"])
    times["K5"] = (*times["K5"], None, extra["K5"])
    times["K6"] = (*times["K6 words"], k6_extra)
    return times


def hardware_phase(card: str, gen, runs: dict):
    """The hardware model on the card.  Its path, `python -m
    tpu_viterbi_torch.hardware`, driven with the counts set to 0: K9's
    binary search must find the CUDA opt-in attribute, which the per-kind
    table must hold.  K9's output against its plain version; K3's gate
    refusing a ring one byte over the budget before any launch; 'auto'
    keeping the full store at the headline.  Returns K9's row; its
    launches in the path's run (one probe) go into ``runs``."""
    hardware.optin_smem_bytes()                  # binds the entry
    t0 = time.perf_counter()
    optin = hardware.optin_smem_bytes()
    attr_ms = (time.perf_counter() - t0) * 1e3
    rc, text, counts = drive([], hardware.main)
    m = re.search(r"probed budget: (\d+) bytes", text)
    if rc != 0 or m is None:
        raise AssertionError(f"python -m tpu_viterbi_torch.hardware failed "
                             f"(rc {rc})")
    probed = int(m.group(1))
    if probed != optin or hardware.smem_budget_bytes() != probed:
        raise AssertionError(f"K9 probed {probed} bytes, the opt-in "
                             f"attribute is {optin}, the table "
                             f"{hardware.smem_budget_bytes()}")
    if counts["K9"] < 3:
        raise AssertionError(f"the probe launched K9 {counts['K9']} times")
    record(runs, counts, 1, ["K9"], "python -m tpu_viterbi_torch.hardware")
    out = torch.full((8, 128), -1, dtype=torch.int32, device="cuda")
    k_ms, k_all, err = cuda_ms(lambda: K9(48 * 1024, out), 20)
    if err != 0 or bool(out.any()):
        raise AssertionError(f"K9 at 48 KB: cudaError_t {err}, output not "
                             f"its plain version's zeros")
    over = K9(optin + 1, out)
    if over != hardware.CUDA_ERROR_INVALID_VALUE:
        raise AssertionError(f"K9 one byte over the limit: cudaError_t "
                             f"{over}, expected cudaErrorInvalidValue")

    # K3's gate: the ring one byte over the budget is refused before a launch
    plan = plan_blocks(2048 * 40, 32, 2048)
    x = random_words(HEADLINE, plan, gen)
    ring = core_cuda.ring_bytes(HEADLINE)
    before = K3.launches
    os.environ["TPU_VITERBI_SMEM_BUDGET"] = str(ring - 1)
    try:
        with contextlib.suppress(ValueError):
            K3(x, HEADLINE, plan)
            raise AssertionError("K3 launched a ring over the budget")
        refused = K3.launches == before
        os.environ["TPU_VITERBI_SMEM_BUDGET"] = str(ring)
        got = K3(x, HEADLINE, plan)
    finally:
        del os.environ["TPU_VITERBI_SMEM_BUDGET"]
    torch.cuda.synchronize()
    if not refused or K3.launches != before + 1 or not torch.equal(
            got, decode_blocks_torch(x, HEADLINE, plan, True)):
        raise AssertionError("K3's shared-memory gate: a refused ring "
                             "launched, or the ring at the budget failed")
    hplan = plan_blocks(HEADLINE.get_message_len(2 * HEADLINE_BITS), 32,
                        DEC_LEN)
    store = hplan.n_packs * 64 * hplan.num_blocks * 4
    if core_cuda.resolve_window("auto", HEADLINE, hplan, "cuda") or \
            ViterbiGPU(HEADLINE).window(2 * HEADLINE_BITS):
        raise AssertionError("'auto' does not keep the full store at the "
                             "headline")
    bnd = bound(out.numel() * 4)
    say("15 hardware", f"{card}; kind {hardware.device_kind()!r}: K9 probed "
        f"{probed} bytes in {counts['K9']} launches = the opt-in attribute "
        f"(read in {attr_ms:.4f} ms) = the table's budget; K9 at 48 KB "
        f"median {k_ms:.4f} ms of 20, output equal to its plain version, "
        f"one byte over refused; K3's ring of {ring} bytes refused with "
        f"ValueError and no launch under a budget of {ring - 1}, launched "
        f"and bit-equal at {ring}; 'auto' keeps the full store at the "
        f"headline ({store} bytes against "
        f"{hardware.survivor_store_budget_bytes('cuda')}); bound "
        f"{bnd[0]:.6f} ms by {bnd[1]}")
    return k_ms, attr_ms, 0, bnd


OP_COST_CHECK_STEPS = 256
# The integer-ALU pipe's opcodes (64 lanes a clock an SM, half the issue
# rate): a loop of them alone runs at most at that pipe's rate.  Uniform
# datapath opcodes (U...) issue off it; other opcodes count only in the
# issue bound.
INT_ALU_OPS = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "IMNMX", "LEA",
               "PRMT", "PLOP3", "MOV")
INT_ALU_PER_SM_CLOCK = 64


def pipe_classes(mix: dict) -> dict:
    """A loop's opcode mix in {"alu": integer-ALU pipe, "uniform": U...,
    "other": the rest} instructions."""
    out = Counter()
    for op, n in mix.items():
        base = op.split(".")[0]
        out["uniform" if base.startswith("U") else
            "alu" if base in INT_ALU_OPS else "other"] += n
    return {k: out[k] for k in ("alu", "uniform", "other")}


def op_cost_phase(card: str, runs: dict):
    """K11's op-cost kernels against their plain version after the same
    steps (every tile of the grid), and the probe's path (`python -m
    tpu_viterbi_torch.scripts.op_cost_probe`, all variants: one probe
    call) with the counts set to 0.  Returns K11's row: add4 at
    OP_COST_CHECK_STEPS, its bound counted in the SASS instructions of
    add4's step loop that the probe read (ptxas fuses add4's 32 adds a
    step into fewer instructions)."""
    x = op_cost_probe.probe_input("cuda")
    tiles = op_cost_probe.grid_tiles()
    steps = OP_COST_CHECK_STEPS
    for v in op_cost_probe.VARIANTS:
        got = K11(v, x, steps, tiles)
        torch.cuda.synchronize()
        want = op_cost_probe.op_cost_torch(v, x, steps)
        if not torch.equal(got, want.expand_as(got)):
            raise AssertionError(f"K11 {v} differs from its plain version "
                                 f"after {steps} steps")
    k_ms, _, _ = cuda_ms(lambda: K11("add4", x, steps, tiles), 5)
    p_ms, _, _ = cuda_ms(
        lambda: op_cost_probe.op_cost_torch("add4", x, steps), 1)
    say("16 op cost", f"K11 bit-equal to its plain version on all "
        f"{len(op_cost_probe.VARIANTS)} variants after {steps} steps, "
        f"{tiles} tiles; add4 at {steps} steps: median {k_ms:.4f} ms, plain "
        f"{p_ms:.1f} ms")
    results, counts = probe_run(op_cost_probe.probe)
    record(runs, counts, 1, ["K11"], "op-cost probe")
    add4 = next(r for r in results if r["variant"] == "add4")
    lanes = tiles * x.numel()
    bnd = bound(x.numel() * 4 + lanes * 4, lanes * steps * add4["sass_loop"])
    rate = add4["sass_per_ns"]
    say("16 op cost", f"{card}: the probe's {counts['K11']} launches; add4 "
        f"at {steps} steps: bound {bnd[0]:.4f} ms by {bnd[1]} ({lanes} lanes"
        f" x {steps} steps x {add4['sass_loop']} SASS instructions; "
        f"{k_ms:.4f} ms is {bnd[0] / k_ms:.0%} of it); ALU model of this "
        f"card in issued instructions: ({ACS_OPS / rate:.6f} ns a "
        f"block-stage, {ACS_OPS} instructions, {rate:.1f} lane-instructions"
        f"/ns; semantic add4 {add4['lane_ops_per_ns']:.1f} lane-ops/ns); "
        f"table: {hardware.alu_model()}")
    mix = op_cost_probe.sass_loop_mixes()["add4"]
    cls = pipe_classes(mix)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pipe_ms = lanes * steps * cls["alu"] / (
        sms * INT_ALU_PER_SM_CLOCK * hardware.sm_clock_hz()) * 1e3
    say("16 op cost", f"{card}: add4's step loop ({add4['sass_loop']} SASS:"
        f" {describe_mix(mix, 12)}): {cls['alu']} on the integer-ALU pipe, "
        f"{cls['uniform']} uniform, {cls['other']} other; the issue bound "
        f"{bnd[0]:.4f} ms ({bnd[0] / k_ms:.0%} of {k_ms:.4f}), the ALU "
        f"pipe's bound at {INT_ALU_PER_SM_CLOCK} lanes a clock an SM "
        f"{pipe_ms:.4f} ms ({pipe_ms / k_ms:.0%})")
    extra = dict(add4_loop_mix=mix, add4_pipe_classes=cls,
                 alu_pipe_bound_ms=pipe_ms)
    by = {r["variant"]: r for r in results}
    n_ops = op_cost_probe.N_OPS
    say("16 op cost", f"{card}: relayouts, a warp a column (constructs a "
        f"clock per SM, SASS a step loop of {op_cost_probe.UNROLL}): " +
        ", ".join(f"{v} {by[v]['ops_per_clock_per_sm'] / n_ops[v]:.2f} "
                  f"({by[v]['sass_loop']})"
                  for v in op_cost_probe.RELAYOUTS) +
        f"; add {by['add']['ops_per_clock_per_sm']:.2f} "
        f"({by['add']['sass_loop']})")
    return k_ms, p_ms, 0, bnd, None, extra


CANARY_CALLS = 3
CANARY_REPS = 5


def canary_phase(card: str, runs: dict):
    """K10: K4's packs at the canary shape (SOFT8 words: int16x2 metrics)
    bit-equal to the plain decode_staged_torch and to its int16 version
    decode_staged_i16_torch on the same words, then `utils.timing.canary_ns`
    CANARY_CALLS times with the counts set to 0 (each call stages fresh
    words and times K4 between CUDA events, one untimed launch and
    CANARY_REPS timed).  Returns K10's row; K4's launches in those calls
    go into ``runs`` as K10's."""
    cfg, plan = timing.canary_plan()
    words = timing.canary_words(cfg, plan)
    K4(words, cfg, plan)                                     # warm-up
    k_ms, _, got = cuda_ms(lambda: K4(words, cfg, plan), 3)
    p_ms, _, want = cuda_ms(lambda: decode_staged_torch(words, cfg, plan), 1)
    err = max_abs_diff(got, want)
    if got.shape != want.shape or err:
        raise AssertionError(f"K4 at the canary shape differs from "
                             f"decode_staged_torch (max |diff| {err})")
    held("K4 at the canary shape against decode_staged_i16_torch", got,
         decode_staged_i16_torch(words, cfg, plan))
    for k in KERNELS:
        k.launches = 0
    ns = [timing.canary_ns(reps=CANARY_REPS) for _ in range(CANARY_CALLS)]
    torch.cuda.synchronize()
    launches = K4.launches
    record(runs, {"K10": launches}, CANARY_CALLS, ["K10"], "canary_ns")
    bnd = decode_bound(words.numel() * 4, cfg, plan, runs_pm16(K4, cfg))
    say("17 canary", f"{card}: K10 (K4 word mode on int16x2 metrics, "
        f"{plan.num_blocks} blocks "
        f"= {-(-plan.num_blocks // core_cuda.K_THREADS)} CUDA blocks of "
        f"{core_cuda.K_THREADS}, dec_len {plan.dec_len}, {plan.n_packs} "
        f"packs): packs bit-equal to decode_staged_torch (plain {p_ms:.1f} "
        f"ms) and decode_staged_i16_torch; canary_ns x {CANARY_CALLS}: median "
        f"{statistics.median(ns):.4f} ns/stage/tile of "
        f"{[round(v, 4) for v in ns]} (spread {max(ns) - min(ns):.4f}); "
        f"K4 median {k_ms:.4f} ms; launches {launches}; bound "
        f"{bnd[0]:.4f} ms by {bnd[1]}")
    return k_ms, p_ms, err, bnd


PROBE_CHECK_STAGES = 64             # K12, K14, K16, K18, K19's checks
ABLATION_CHECK_PACKS = 8
ILP_CHECK_STEPS = 256
LT_BYTES = 128 * 4                  # a 128-lane int32 row


def probe_run(probe):
    """Run a probe's entry point (its ``probe()``, all variants: one call)
    through ``drive``: (its result, {kernel name: launches})."""
    out = []
    _, _, counts = drive([], lambda: out.append(probe()) or 0)
    return out[0], counts


def share(bnd, ms: float) -> str:
    return f"bound {bnd[0]:.4f} ms by {bnd[1]} ({bnd[0] / ms:.0%} of it)"


def probe_results(tag: str, card: str, runs: dict, mod, name: str,
                  what: str, bound_of):
    """A stage-loop probe's path: its ``probe()`` through ``probe_run``
    with kernel ``name``'s launches recorded, each result's bound
    (``bound_of(result)``) and one line each.  Returns the results."""
    results, counts = probe_run(mod.probe)
    record(runs, counts, 1, [name], what)
    for r in results:
        r["bound"] = bound_of(r)
        say(tag, f"{card}: {mod.describe(r)}; {share(r['bound'], r['ms'])}")
    return results


def held(what: str, got, want) -> None:
    """Raise unless ``got`` equals ``want`` (shapes and values)."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what} differs from its plain version")


def held_to_plain(what: str, got, plain) -> float:
    """The ms of one CUDA-event run of ``plain``; raises unless its result
    equals ``got``."""
    torch.cuda.synchronize()
    p_ms, _, want = cuda_ms(plain, 1)
    held(what, got, want)
    return p_ms


def lane_turns(tag: str, card: str, results: list, extra: dict,
               label: str, key: str, picked_as: str = None,
               per: str = "stage") -> None:
    """Print ``results`` (one variant at one count, each lane count in turn
    with one lane, ``TURNS``) as a lane_line after ``label``, and store each
    time in ``extra`` under ``key`` + lanes<n>_ms (one lane's second turn
    under ..._again_ms).  With ``picked_as``, a key holding ``{}``, the
    picked row's lanes, SASS and SHFL a stage, registers and stack (where
    the row has it) go in too, each under picked_as with its name in the
    braces."""
    for n, r in zip(TURNS, results):
        k = f"{key}_lanes{n}_ms"
        extra[k if k not in extra else f"{key}_lanes{n}_again_ms"] = r["ms"]
    say(tag, f"{card}: {label} by lanes in turn: "
        f"{lane_line(results, per=per)}")
    if picked_as:
        p = next(r for r in results if r["picked"])
        for name, field in (("lanes", "lanes"),
                            (f"sass_per_{per}", f"sass_per_{per}"),
                            (f"shfl_per_{per}", f"shfl_per_{per}"),
                            ("registers", "regs"), ("stack", "stack")):
            if field in p:
                extra[picked_as.format(name)] = p[field]


def layout_phase(card: str, runs: dict):
    """K12: every variant at every lane count (A and B at LANES, C at its
    32) bit-equal to its plain version on every program of both grids
    (2048 and 15,872 arrays) at 32, 64 and 96 stages (tails of 2, 4 and 0
    stages after the lane-split loop's six-stage passes), then `python -m
    tpu_viterbi_torch.scripts.layout_probe` (A and B at each lane count in
    turn with one lane, C, at both grids, STAGES stages) with the counts
    set to 0, and each run's bound (layout_probe.OPS lane-operations an
    array-stage, whatever the lanes).  Prints each variant by lanes and A
    at each lane count against C at each grid.  Returns K12's row: A at
    the JAX shape at the picked lanes beside its plain version there,
    which must agree; each lane count's times in the extra keys."""
    lp = layout_probe
    x = lp.probe_input(lp.HEADLINE_TILES, "cuda", seed=SEED)
    for tiles in (lp.GRID, lp.HEADLINE_TILES):
        xv = x[:tiles * lp.ROWS]
        for stages in (32, 64, 96):
            for v in lp.VARIANTS:
                want = lp.layout_torch(v, xv, stages)
                for n in lp.variant_lanes(v):
                    held(f"K12 {v} at {tiles} tiles, {stages} stages, {n} "
                         f"lanes", K12(v, xv, stages, n), want)
    say("18 layout", f"K12 bit-equal to its plain version on all "
        f"{len(lp.VARIANTS)} variants ({', '.join(lp.SPLIT)} at lanes "
        f"{list(LANES)}, lanes at {lp.C_LANES}), every program of {lp.GRID} "
        f"and {lp.HEADLINE_TILES} tiles, 32, 64 and 96 stages")
    results, counts = probe_run(lp.probe)
    record(runs, counts, 1, ["K12"], "layout probe")
    for r in results:
        r["bound"] = bound(r["tiles"] * lp.ROWS * LT_BYTES + r["tiles"] * 64 *
                           LT_BYTES,
                           lp.OPS[r["variant"]] * r["arrays"] * lp.STAGES)
        say("18 layout", f"{card}: {r['variant']} at {r['arrays']} arrays, "
            f"{r['lanes']} lanes: {r['ms']:.4f} ms = "
            f"{r['ns_per_stage_tile']:.4f} ns/stage/tile; SASS "
            f"{r['sass_per_stage']:g} and SHFL {r['shfl_per_stage']:g} a "
            f"stage a thread ({describe_mix(r['mix'], 12)}), "
            f"{r['lane_instr_per_array_stage']:g} lane-instructions an "
            f"array-stage = {r['lane_instr_per_ns']:.1f} a ns; registers "
            f"{r['regs']}, stack {r['stack']} B; {share(r['bound'], r['ms'])}")
    extra = {}
    for tiles in (lp.GRID, lp.HEADLINE_TILES):
        arrays = tiles * 128
        mine = [r for r in results if r["tiles"] == tiles]
        c = next(r for r in mine if r["variant"] == "lanes")
        extra[f"lanes_{arrays}_ms"] = c["ms"]
        for v in lp.SPLIT:
            turns = [r for r in mine if r["variant"] == v]
            lane_turns("18 layout", card, turns, extra, f"{arrays} arrays, "
                       f"{v}", f"{v}_{arrays}", f"{v}_{{}}_at_{arrays}")
        first = {}
        for r in mine:
            if r["variant"] == "real":
                first.setdefault(r["lanes"], r)
        c_instr = c["lane_instr_per_array_stage"]
        say("18 layout", f"{card}: A at each lane count against C at "
            f"{arrays} arrays (C {c['ms']:.4f} ms, {c['sass_per_stage']:g} "
            f"SASS a stage a thread, {c_instr:g} lane-instructions an "
            f"array-stage): " + ", ".join(
                f"{n}: {a['ms']:.4f} ms = {a['ms'] / c['ms']:.3f} C, "
                f"{a['lane_instr_per_array_stage']:g} lane-instructions "
                f"({a['lane_instr_per_array_stage'] / c_instr:.3f} C)"
                for n, a in first.items()))
    xs = x[:lp.GRID * lp.ROWS]
    got = K12("real", xs, lp.STAGES)
    p_ms, _, want = cuda_ms(lambda: lp.layout_torch("real", xs, lp.STAGES),
                            1)
    held("K12 real at the JAX shape", got, want)
    a = next(r for r in results if r["variant"] == "real" and
             r["tiles"] == lp.GRID and r["picked"])
    return a["ms"], p_ms, 0, a["bound"], None, extra


def lane_line(results: list, key=lambda r: r["lanes"],
              per: str = "stage") -> str:
    """'1: 3.3021 ms (394.5 SASS, 0 SHFL a stage, 40 registers), ...' of
    ``results`` in their order (SASS and SHFL a ``per``: a stage, or K28's
    rep), the stack where it is not 0."""
    return ", ".join(f"{key(r)}: {r['ms']:.4f} ms ({r[f'sass_per_{per}']:g} "
                     f"SASS, {r[f'shfl_per_{per}']:g} SHFL a {per}, "
                     f"{r['regs']} registers"
                     f"{', stack %d B' % r['stack'] if r['stack'] else ''})"
                     for r in results)


def ablation_phase(card: str, runs: dict, k10_ms: float):
    """K13: every variant at every lane count, output and survivor store
    bit-equal to its plain version on all programs of both counts (GRID
    and HEADLINE_TILES) at ABLATION_CHECK_PACKS packs (pack ends in all
    three phases of the lane-split pass), then `python -m
    tpu_viterbi_torch.scripts.kernel_ablation` (every variant at both
    counts at every lane count in turn with one lane) with the counts set
    to 0, and each run's bound, beside K10 (K4 with every piece, at the
    same 2048 blocks x 8192 stages, ``k10_ms`` in this run; K4 runs the
    int16x2 ACS there, K13's pieces the int32 one).  Prints, at each count,
    each variant by lanes and what the dump (+dump - +unpack) and the chase
    (+traceback - +dump) cost at each lane count.  Returns K13's row:
    +traceback at the JAX shape at the picked lanes beside its plain
    version there, output and store equal; each lane count's times in the
    extra keys."""
    ka = kernel_ablation
    for programs in (ka.GRID, ka.HEADLINE_TILES):
        words = ka.probe_input(programs, ABLATION_CHECK_PACKS, "cuda",
                               seed=SEED)
        for v in ka.VARIANTS:
            want, want_store = ka.ablation_torch(v, words, programs)
            for n in LANES:
                what = f"K13 {v} at {programs} programs, {n} lanes"
                out, store = K13(v, words, programs, n)
                held(what, out, want)
                if (store is None) != (want_store is None):
                    raise AssertionError(f"{what}: a store where none was "
                                         f"due, or none where one was")
                if store is not None:
                    held(f"{what}, survivor store", store, want_store)
    say("19 ablation", f"K13 bit-equal to its plain version on all "
        f"{len(ka.VARIANTS)} variants at lanes {list(LANES)}, output and "
        f"survivor store, every program of {ka.GRID} and "
        f"{ka.HEADLINE_TILES} programs of {ABLATION_CHECK_PACKS} packs")
    results, counts = probe_run(ka.probe)
    record(runs, counts, 1, ["K13"], "ablation probe")
    stages = ka.N_PACKS * 32
    for r in results:
        v, arrays = r["variant"], r["arrays"]
        read = 4 * ka.WPP if v == "body" else ka.N_PACKS * ka.WPP
        store = ka.N_PACKS * 64 if v in ("+dump",) + ka.TRACEBACKS else 0
        out_rows = ka.n_emit(v, ka.N_PACKS)
        bnd = bound((read + store + out_rows) * arrays * 4,
                    ka.OPS[v] * arrays * stages)
        r["bound"] = bnd
        say("19 ablation", f"{card}: {v} at {arrays} arrays x {stages} "
            f"stages, {r['lanes']} lanes: {r['ms']:.4f} ms = "
            f"{r['ns_per_stage_tile']:.4f} ns/stage/tile; SASS "
            f"{r['sass_per_stage']:g} and SHFL {r['shfl_per_stage']:g} a "
            f"stage; registers {r['regs']}, stack {r['stack']} B; "
            f"{share(bnd, r['ms'])}")
    extra = {}
    for programs in (ka.GRID, ka.HEADLINE_TILES):
        arrays = programs * 128
        picked = lanes_for(arrays)
        mine = [r for r in results if r["programs"] == programs]
        # the first run at each lane count (one lane's second turn apart)
        first = {}
        for r in mine:
            first.setdefault((r["variant"], r["lanes"]), r)
        for v in ka.VARIANTS:
            turns = [r for r in mine if r["variant"] == v]
            lane_turns("19 ablation", card, turns, extra, f"{arrays} arrays, "
                       f"{v}", f"{v}_{arrays}")
        for n in LANES:
            dump = first["+dump", n]["ms"] - first["+unpack", n]["ms"]
            chase = first["+traceback", n]["ms"] - first["+dump", n]["ms"]
            bisect = first["+tb(bisect)", n]["ms"] - first["+dump", n]["ms"]
            extra.update({f"dump_{arrays}_lanes{n}_ms": dump,
                          f"chase_{arrays}_lanes{n}_ms": chase})
            say("19 ablation", f"{card}: {arrays} arrays, {n} lanes"
                f"{' (picked)' if n == picked else ''}: the dump (+dump - "
                f"+unpack) {dump:+.4f} ms, the chase (+traceback - +dump) "
                f"{chase:+.4f} ms, the bisect's (+tb(bisect) - +dump) "
                f"{bisect:+.4f} ms")
        tb = first["+traceback", picked]
        extra.update({f"lanes_at_{arrays}": picked,
                      f"sass_per_stage_at_{arrays}": tb["sass_per_stage"],
                      f"shfl_per_stage_at_{arrays}": tb["shfl_per_stage"],
                      f"registers_at_{arrays}": tb["regs"]})
    by = {r["variant"]: r["ns_per_stage_tile"] for r in results
          if r["programs"] == ka.GRID and r["lanes"] == 1}
    say("19 ablation", f"K10 in this run, K4 with every piece at the same "
        f"shape on int16x2 metrics (K13's pieces run the int32 ACS): "
        f"{k10_ms:.4f} ms = {k10_ms * 1e6 / (stages * ka.GRID):.4f} "
        f"ns/stage/tile; at one lane over +dump: +traceback "
        f"{by['+traceback'] - by['+dump']:+.4f}, +tb(bisect) "
        f"{by['+tb(bisect)'] - by['+dump']:+.4f} ns/stage/tile")
    full = ka.probe_input(ka.GRID, ka.N_PACKS, "cuda", seed=SEED)
    out, store = K13("+traceback", full, ka.GRID)
    p_ms, _, (want, want_store) = cuda_ms(
        lambda: ka.ablation_torch("+traceback", full, ka.GRID), 1)
    if not (torch.equal(out, want) and torch.equal(store, want_store)):
        raise AssertionError("K13 +traceback differs from its plain version "
                             "at the JAX shape")
    tb = next(r for r in results if r["variant"] == "+traceback" and
              r["programs"] == ka.GRID and
              r["lanes"] == lanes_for(ka.GRID * 128))
    return tb["ms"], p_ms, 0, tb["bound"], None, extra


def split_checks(tag: str, kernel, mod, plain, widths) -> dict:
    """Every variant of K14 or K16 (``kernel``, its module ``mod``) at every
    lane count bit-equal to its plain version ``plain`` at one pack (32
    stages), PROBE_CHECK_STAGES and the probe's N_PACKS x 32 stages on each
    width of ``widths``: tails of 2, 4 and 0 stages after the split loop's
    six-stage passes.  Returns {(variant, width): the plain version's ms at
    the full stages}."""
    plain_ms = {}
    packs = (1, PROBE_CHECK_STAGES // mod.BPP, mod.N_PACKS)
    for width in widths:
        for n_packs in packs:
            rs = mod.probe_input(n_packs, width, "cuda", seed=SEED)
            for v in mod.VARIANTS:
                p_ms, _, want = cuda_ms(lambda: plain(v, rs), 1)
                plain_ms[v, width] = p_ms
                for n in LANES:
                    held(f"{kernel.name} {v} at {width} arrays, "
                         f"{n_packs * mod.BPP} stages, {n} lanes",
                         kernel(v, rs, n), want)
            del rs
    say(tag, f"{kernel.name} bit-equal to its plain version on all "
        f"{len(mod.VARIANTS)} variants at lanes {list(LANES)}, "
        f"{' and '.join(map(str, widths))} arrays, "
        f"{', '.join(str(n * mod.BPP) for n in packs)} stages")
    digests = mod.one_lane_digests()
    say(tag, f"{kernel.name}'s one-lane kernels (SASS instructions, their "
        f"digest, registers, stack B): " + "; ".join(
            f"{v} {n} {d} {reg} {stack}"
            for v, (n, d, reg, stack) in digests.items()))
    return plain_ms


def split_results(tag: str, card: str, runs: dict, mod, name: str,
                  what: str, nbytes) -> tuple:
    """K14's or K16's probe (``mod.probe()``: every variant at each lane
    count in turn with one lane) through ``probe_results``, each run's
    bound the function's (mod.OPS, what the row counts) and its construct's
    (mod.CONSTRUCT_OPS, the 64 states' update as the variant defines it,
    unfolded: no bound where ptxas folds the variant, so a share over 100 %
    there says folded, not miscounted),
    the input's and output's bytes ``nbytes(r)``.  Prints each variant by
    lanes, its fastest lane count beside lanes_for's pick and both shares
    at each.  Returns the results and the extra keys (each lane count's
    times; the picked row's lanes, SASS, SHFL, registers and stack)."""
    stages = mod.N_PACKS * mod.BPP
    results = probe_results(
        tag, card, runs, mod, name, what,
        lambda r: bound(nbytes(r), mod.OPS[r["variant"]] * r["arrays"] *
                        stages))
    extra = {}
    for r in results:
        r["construct_bound"] = bound(nbytes(r), mod.CONSTRUCT_OPS[
            r["variant"]] * r["arrays"] * stages)
    for arrays in dict.fromkeys(r["arrays"] for r in results):
        for v in mod.VARIANTS:
            turns = [r for r in results
                     if r["arrays"] == arrays and r["variant"] == v]
            lane_turns(tag, card, turns, extra, f"{arrays} arrays, {v}",
                       f"{v}_{arrays}", f"{v}_{{}}_at_{arrays}")
            best = min(turns, key=lambda r: r["ms"])
            pick = next(r for r in turns if r["picked"])
            extra[f"{v}_fastest_lanes_at_{arrays}"] = best["lanes"]
            say(tag, f"{card}: {arrays} arrays, {v}: fastest at "
                f"{best['lanes']} lanes ({best['ms']:.4f} ms), lanes_for "
                f"picks {pick['lanes']} ({pick['ms']:.4f} ms); at the pick "
                f"{share(pick['bound'], pick['ms'])}, construct's "
                f"{share(pick['construct_bound'], pick['ms'])}; fastest "
                f"{share(best['construct_bound'], best['ms'])} of the "
                f"construct's (its unfolded update: over 100 % where ptxas "
                f"folds it)")
    return results, extra


def acs_variants_phase(card: str, runs: dict):
    """K14: every variant at every lane count bit-equal to its plain version
    on the JAX width (2048 arrays) at 32 stages, PROBE_CHECK_STAGES and the
    full N_PACKS x 32 stages, the one-lane kernels' SASS digests, then
    `python -m tpu_viterbi_torch.scripts.acs_variants_bench` (every variant
    at each lane count in turn with one lane) with the counts set to 0, and
    each run's bounds (``split_results``).  Returns K14's row: eo (the true
    even/odd ACS) at the JAX shape at the picked lanes beside its plain
    version there; each lane count's times in the extra keys."""
    av = acs_variants_bench
    width = av.N_TILES * 128
    stages = av.N_PACKS * av.BPP
    plain_ms = split_checks("20 acs variants", K14, av,
                            av.acs_variants_torch, (width,))
    results, extra = split_results(
        "20 acs variants", card, runs, av, "K14", "ACS variants probe",
        lambda r: ((stages if r["variant"] == "bit_tb" else 2 * stages) +
                   64) * r["arrays"] * 4)
    eo = next(r for r in results if r["variant"] == "eo" and r["picked"])
    return eo["ms"], plain_ms["eo", width], 0, eo["bound"], None, extra


def ilp_phase(card: str, runs: dict):
    """K15: every chain count at both occupancies equal to its plain
    version at each element's tile position after ILP_CHECK_STEPS steps,
    then `python -m tpu_viterbi_torch.scripts.ilp_probe` with the counts
    set to 0, and each run's bound over its slope.  Returns K15's row: 4
    chains at the SM's 2048 threads and ILP_CHECK_STEPS steps, beside the
    plain version there (as K11's row)."""
    ip = ilp_probe
    x = ip.probe_input("cuda")
    steps = ILP_CHECK_STEPS
    plain = {n: ip.ilp_torch(n, x, steps).reshape(-1) for n in ip.CHAINS}
    for occupancy in ip.OCCUPANCIES:
        blocks, threads = ip.grid(occupancy)
        idx = torch.arange(blocks * threads, device="cuda") % ip.TILE
        for n in ip.CHAINS:
            got = K15(n, x, steps, blocks, threads)
            torch.cuda.synchronize()
            if not torch.equal(got, plain[n][idx]):
                raise AssertionError(f"K15 {n} chains {occupancy} differs "
                                     f"from its plain version")
    say("21 ilp", f"K15 bit-equal to its plain version on 1, 2 and 4 "
        f"chains at both occupancies, {steps} steps")
    results, counts = probe_run(ip.probe)
    record(runs, counts, 1, ["K15"], "ILP probe")
    for r in results:
        lanes = r["blocks"] * r["threads"]
        dt = r["ms_hi"] - r["ms_lo"]
        bnd = bound(0, lanes * (ip.STEPS_HI - ip.STEPS_LO) * ip.UNROLL *
                    r["chains"] * ip.OPS_A_PAIR)
        say("21 ilp", f"{card}: {r['chains']} chains, {r['occupancy']} "
            f"({r['blocks']} x {r['threads']}): slope {dt:.4f} ms = "
            f"{r['ns_per_pair']:.4f} ns a dependent pair; "
            f"{r['sass_per_clock_per_sm']:.2f} SASS lane-instructions a "
            f"clock per SM ({r['sass_loop']} a step); {share(bnd, dt)}")
    blocks, threads = ip.grid("full")
    k_ms, _, _ = cuda_ms(lambda: K15(4, x, steps, blocks, threads), 5)
    p_ms, _, _ = cuda_ms(lambda: ip.ilp_torch(4, x, steps), 1)
    lanes = blocks * threads
    bnd = bound(x.numel() * 4 + lanes * 4,
                lanes * steps * ip.UNROLL * 4 * ip.OPS_A_PAIR)
    say("21 ilp", f"{card}: 4 chains, full, {steps} steps: median "
        f"{k_ms:.4f} ms, plain {p_ms:.1f} ms; {share(bnd, k_ms)}")
    return k_ms, p_ms, 0, bnd


DTYPE_CHECK_STEPS = 256
# K17's bound: the packed operations one pair a = a + c, a = max(a, c - a)
# needs (the add, the subtract, the max; ptxas issues 4 on sm_90), where
# dtype_throughput.OPS_A_PAIR keeps the JAX probe's 2 for its rate
K17_OPS_A_PAIR = 3


def microbench_phase(card: str, runs: dict):
    """K16: every variant at every lane count bit-equal to its plain version
    at 32 stages, PROBE_CHECK_STAGES and the full N_PACKS x 32 stages at
    both array counts (2048 and 15,872), the one-lane kernels' SASS
    digests, then `python -m tpu_viterbi_torch.scripts.kernel_microbench`
    (every variant at each lane count in turn with one lane, at both
    counts) with the counts set to 0, and each run's bounds (``split_results``; OPS: one
    state's work a stage, the 64 states being equal).  Returns K16's row:
    concat (its 32 distinct children computed, not folded) at the JAX shape
    at the picked lanes beside its plain version there; each lane count's
    times in the extra keys."""
    km = kernel_microbench
    stages = km.N_PACKS * km.BPP
    width = km.N_TILES * 128
    plain_ms = split_checks("22 microbench", K16, km, km.microbench_torch,
                            (width, km.HEADLINE_TILES * 128))
    results, extra = split_results(
        "22 microbench", card, runs, km, "K16", "construct microbenchmark",
        lambda r: (stages * 2 + 64) * r["arrays"] * 4)
    row = next(r for r in results if r["variant"] == "concat" and
               r["arrays"] == width and r["picked"])
    return row["ms"], plain_ms["concat", width], 0, row["bound"], None, extra


def dtype_phase(card: str, runs: dict):
    """K17: every dtype at both occupancies equal to its plain version at
    each element's tile position, after DTYPE_CHECK_STEPS steps on the
    probe's tile and after 3 steps on values near +-16,000 (the narrow
    types wrap), then `python -m tpu_viterbi_torch.scripts.dtype_throughput`
    with the counts set to 0, and each run's bound over its slope
    (K17_OPS_A_PAIR packed lane-instructions a pair: two 16-bit or four
    8-bit elements each).  Returns
    K17's row: int16 at the SM's 2048 threads and DTYPE_CHECK_STEPS steps,
    beside the plain version there (as K15's row)."""
    dt = dtype_throughput
    x = dt.probe_input("cuda")
    g = torch.Generator().manual_seed(SEED)
    wide = torch.randint(-16000, 16001, (32, 128), generator=g,
                         dtype=torch.int32).cuda()
    for xx, steps in ((x, DTYPE_CHECK_STEPS), (wide, 3)):
        for d in dt.DTYPES:
            plain = dt.dtype_torch(d, xx, steps).reshape(-1)
            for occupancy in dt.OCCUPANCIES:
                blocks, threads = dt.grid(d, occupancy)
                got = K17(d, xx, steps, blocks, threads)
                torch.cuda.synchronize()
                idx = torch.arange(got.numel(), device="cuda") % dt.TILE
                if not torch.equal(got, plain[idx]):
                    raise AssertionError(f"K17 {d} {occupancy} differs from "
                                         f"its plain version ({steps} "
                                         f"steps)")
    say("23 dtype", f"K17 bit-equal to its plain version on all "
        f"{len(dt.DTYPES)} dtypes at both occupancies, {DTYPE_CHECK_STEPS} "
        f"steps on 0..6 and 3 steps on +-16,000")
    results, counts = probe_run(dt.probe)
    record(runs, counts, 1, ["K17"], "dtype throughput probe")
    for r in results:
        lanes = r["blocks"] * r["threads"]
        slope = r["ms_hi"] - r["ms_lo"]
        bnd = bound(0, lanes * (dt.STEPS_HI - dt.STEPS_LO) * dt.UNROLL *
                    K17_OPS_A_PAIR)
        say("23 dtype", f"{card}: {r['dtype']} {r['occupancy']} "
            f"({r['blocks']} x {r['threads']} x {r['pack']}): slope "
            f"{slope:.4f} ms; {r['element_ops_per_ns']:.1f} element-ops/ns, "
            f"{r['sass_per_clock_per_sm']:.2f} SASS lane-instructions a "
            f"clock per SM ({r['sass_loop']} a step); {share(bnd, slope)}")
    blocks, threads = dt.grid("int16", "full")
    steps = DTYPE_CHECK_STEPS
    k_ms, _, _ = cuda_ms(lambda: K17("int16", x, steps, blocks, threads), 5)
    p_ms, _, _ = cuda_ms(lambda: dt.dtype_torch("int16", x, steps), 1)
    lanes = blocks * threads
    bnd = bound(x.numel() * 4 + lanes * dt.PACK["int16"] * 4,
                lanes * steps * dt.UNROLL * K17_OPS_A_PAIR)
    say("23 dtype", f"{card}: int16, full, {steps} steps: median "
        f"{k_ms:.4f} ms, plain {p_ms:.1f} ms; {share(bnd, k_ms)}")
    return k_ms, p_ms, 0, bnd


def swar_phase(card: str, runs: dict):
    """K18: every variant at every lane count bit-equal to its plain
    version at PROBE_CHECK_STAGES on every program of both grids (2048 and
    15,872 arrays), then `python -m tpu_viterbi_torch.scripts.swar_probe`
    (every variant at each lane count in turn with one lane, at both
    grids) with the counts set to 0, and each run's bound (swar_probe.OPS,
    whatever the lanes).  Prints each variant by lanes at each grid.
    Returns K18's row: swar/stage at the JAX shape at the picked lanes
    beside its plain version there; each lane count's times in the extra
    keys."""
    sp = swar_probe
    for programs in (sp.GRID, sp.HEADLINE_TILES):
        for v in sp.VARIANTS:
            x = sp.probe_input(v, programs, "cuda", seed=SEED)
            want = sp.swar_torch(v, x, PROBE_CHECK_STAGES)
            for n in LANES:
                held(f"K18 {v} at {programs} programs, {n} lanes",
                     K18(v, x, PROBE_CHECK_STAGES, n), want)
    say("24 swar", f"K18 bit-equal to its plain version on all "
        f"{len(sp.VARIANTS)} variants at lanes {list(LANES)}, every program "
        f"of {sp.GRID} and {sp.HEADLINE_TILES} programs, "
        f"{PROBE_CHECK_STAGES} stages")
    results = probe_results(
        "24 swar", card, runs, sp, "K18", "SWAR probe",
        lambda r: bound(r["programs"] * (sp.ROWS_IN[r["variant"]] + 64) *
                        LT_BYTES,
                        sp.OPS[r["variant"]] * r["arrays"] * sp.STAGES))
    extra = {}
    for programs in (sp.GRID, sp.HEADLINE_TILES):
        arrays = programs * 128
        for v in sp.VARIANTS:
            turns = [r for r in results
                     if r["programs"] == programs and r["variant"] == v]
            lane_turns("24 swar", card, turns, extra, f"{arrays} arrays, {v}",
                       f"{v}_{arrays}", f"{v}_{{}}_at_{arrays}")
    x = sp.probe_input("swar/stage", sp.GRID, "cuda", seed=SEED)
    p_ms = held_to_plain("K18 swar/stage at the JAX shape",
                         K18("swar/stage", x, sp.STAGES),
                         lambda: sp.swar_torch("swar/stage", x, sp.STAGES))
    row = next(r for r in results if r["variant"] == "swar/stage" and
               r["programs"] == sp.GRID and r["picked"])
    return row["ms"], p_ms, 0, row["bound"], None, extra


def opt_bench_phase(card: str, runs: dict):
    """K19: every variant at every lt and every lane count bit-equal to its
    plain version at two packs over both array counts (4096 and 15,872),
    then `python -m tpu_viterbi_torch.scripts.opt_bench` (every variant at
    every lt at every lane count in turn with one lane, at both counts,
    then i16 at lt 128 at every lane count at the counts between) with the
    counts set to 0, and each run's bound.  Returns K19's row: i16 at lt
    128 at the JAX shape at the picked lanes beside its plain version
    there; each lane count's times in the extra keys."""
    ob = opt_bench
    for width in (ob.LANES, ob.HEADLINE_ARRAYS):
        rs = ob.probe_input(PROBE_CHECK_STAGES // ob.BPP, width, "cuda",
                            seed=SEED)
        for v in ob.VARIANTS:
            want = ob.opt_bench_torch(v, rs)
            for lt in ob.LTS:
                for n in LANES:
                    held(f"K19 {v} lt {lt} at {width} arrays, {n} lanes",
                         K19(v, rs, lt, n), want)
    say("25 opt bench", f"K19 bit-equal to its plain version on all "
        f"{len(ob.VARIANTS)} variants x lt {ob.LTS} x lanes {list(LANES)} "
        f"at {ob.LANES} and {ob.HEADLINE_ARRAYS} arrays, "
        f"{PROBE_CHECK_STAGES} stages")
    stages = ob.N_PACKS * ob.BPP
    results = probe_results(
        "25 opt bench", card, runs, ob, "K19", "16-bit ACS probe",
        lambda r: bound((stages * 2 + 64) * r["arrays"] * 4,
                        ob.OPS[r["variant"]] * r["arrays"] * stages))
    extra = {}
    for width in (ob.LANES, ob.HEADLINE_ARRAYS):
        for lt in ob.LTS:
            for v in ob.VARIANTS:
                turns = [r for r in results if r["arrays"] == width and
                         r["lt"] == lt and r["variant"] == v]
                lane_turns("25 opt bench", card, turns, extra,
                           f"{width} arrays, {v} lt {lt}",
                           f"{v}_lt{lt}_{width}")
    for width in ob.CROSSOVER_ARRAYS:
        mine = [r for r in results if r["arrays"] == width]
        for r in mine:
            extra[f"i16_lt128_{width}_lanes{r['lanes']}_ms"] = r["ms"]
        best = min(mine, key=lambda r: r["ms"])
        extra[f"fastest_lanes_at_{width}"] = best["lanes"]
        say("25 opt bench", f"{card}: {width} arrays, i16 lt 128 by lanes: "
            f"{lane_line(mine)}; fastest {best['lanes']}, lanes_for picks "
            f"{lanes_for(width)}")
    full = ob.probe_input(ob.N_PACKS, ob.LANES, "cuda", seed=SEED)
    p_ms = held_to_plain("K19 i16 at the JAX shape", K19("i16", full, 128),
                         lambda: ob.opt_bench_torch("i16", full))
    picked = lanes_for(ob.LANES)
    row = next(r for r in results if r["variant"] == "i16" and
               r["lt"] == 128 and r["arrays"] == ob.LANES and
               r["lanes"] == picked)
    extra.update(lanes_at_4096=picked,
                 sass_per_stage_at_4096=row["sass_per_stage"],
                 shfl_per_stage_at_4096=row["shfl_per_stage"],
                 registers_at_4096=row["regs"])
    return row["ms"], p_ms, 0, row["bound"], None, extra


def genkernel_probe_phase(card: str, runs: dict):
    """K20: tf and many at 20 and 13 rounds bit-equal to their plain
    versions over the full JAX grid (64 x 256 x 128 counter pairs, reps 4
    and 8), log_sqrt within 2 ulp of the larger term of torch's, then
    `python -m tpu_viterbi_torch.scripts.genkernel_probe` with the counts
    set to 0: every (rounds, reps) queued and replayed from a CUDA graph,
    K7's and K8's draws priced at the 13-round graph rate, and the SASS
    digests of K7's and K8's kernels.  Returns K20's row: many at 20
    rounds, reps 8, queued, with the graph readings beside it."""
    gp = genkernel_probe
    c = gp.many_input("cuda")
    t = gp.tf_input("cuda")
    for rounds in gp.ROUNDS_LIST:
        for got, want in zip(K20.tf(t, *gp.KEY, rounds=rounds),
                             gp.tf_torch(t, *gp.KEY, rounds=rounds)):
            held(f"K20 tf at {rounds} rounds", got, want)
        for reps in gp.REPS_LIST:
            held(f"K20 many at {rounds} rounds, reps {reps}",
                 K20.many(c, *gp.MANY_KEY, reps, rounds),
                 gp.many_torch(c, *gp.MANY_KEY, reps, rounds))
    x = gp.log_input("cuda")
    ulps = gp.term_ulps(K20.log_sqrt(x), gp.log_sqrt_torch(x), x)
    if ulps > 2:
        raise AssertionError(f"K20 log_sqrt {ulps} ulp from torch's")
    say("26 genkernel probe", f"K20 tf and many bit-equal to their plain "
        f"versions at {gp.ROUNDS_LIST} rounds over the {gp.G} x {gp.RB} x "
        f"{gp.L} grid, reps {gp.REPS_LIST}; log_sqrt {ulps:g} ulp of the "
        f"larger term from torch.log + torch.sqrt")
    res, counts = probe_run(gp.probe)
    record(runs, counts, 1, ["K20"], "generator probe")
    n = c[0].numel()
    for r in res["rates"]:
        r["bound"] = bound(3 * n * 4, n * r["reps"] * (
            gp.threefry_ops(r["rounds"]) + gp.MANY_OPS))
        say("26 genkernel probe", f"{card}: many at {r['rounds']} rounds, "
            f"reps {r['reps']}: queued best {r['best_ms']:.4f} ms, median "
            f"{r['ms']:.4f} = {r['calls_per_ns']:.1f} threefry calls/ns "
            f"({share(r['bound'], r['ms'])}); replayed from a graph of "
            f"{gp.GRAPH_CALLS} {r['graph_ms']:.4f} ms = "
            f"{r['graph_calls_per_ns']:.1f} calls/ns "
            f"({share(r['bound'], r['graph_ms'])})")
    # a threefry call in SASS: many's shortest loop is its remainder loop,
    # one call a pass (the call, the counter add, the XORs, the loop's own)
    loops = loop_opcodes(cubin_listings("viterbi_gen_probe")[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pipes = []
    for rounds in gp.ROUNDS_LIST:
        mix = pick(loops, f"many_kernelILi{rounds}E")
        alu = pipe_classes(mix)["alu"]
        fma = sum(k for op, k in mix.items() if op.startswith("IMAD"))
        r4 = next(r for r in res["rates"] if r["rounds"] == rounds
                  and r["reps"] == min(gp.REPS_LIST))
        floor = r4["calls"] * alu / (sms * INT_ALU_PER_SM_CLOCK *
                                     hardware.sm_clock_hz()) * 1e3
        pipes.append(f"{rounds} rounds {sum(mix.values())} SASS a call "
                     f"(threefry_ops {gp.threefry_ops(rounds)} + "
                     f"{gp.MANY_OPS} and the loop's): integer-ALU pipe {alu}, "
                     f"IMAD {fma}, other {sum(mix.values()) - alu - fma} "
                     f"({describe_mix(mix, 6)}); the ALU pipe's floor at "
                     f"reps {r4['reps']} {floor:.4f} ms, "
                     f"{floor / r4['graph_ms']:.0%} of the graph time")
    say("26 genkernel probe", f"{card}: many's loop: {'; '.join(pipes)}")
    k13 = next(r for r in res["rates"] if r["rounds"] == GEN_ROUNDS_K7
               and r["reps"] == max(gp.REPS_LIST))
    rate = k13["graph_calls_per_ns"] * 1e6      # calls a ms, card's clock
    queued = k13["calls_per_ns"] * 1e6
    drawn = []
    for ch in ChannelIn:
        new, old = (genkernel.threefry_calls(HEADLINE_BITS, ch, shared=d)
                    for d in (True, False))
        drawn.append(f"{'K8' if ch == ChannelIn.FP32 else 'K7'} {ch.name} "
                     f"{new} = {new / rate:.4f} ms [{new / queued:.4f}] "
                     f"(first design {old} = {old / rate:.4f} ms)")
    say("26 genkernel probe", f"{card}: threefry-{GEN_ROUNDS_K7} calls each "
        f"generator design draws at the {HEADLINE_BITS}-bit headline, by the "
        f"designs' count (genkernel.threefry_calls), and their ms at the "
        f"graph-replayed rate of many at reps {k13['reps']} [at the queued "
        f"rate]: {'; '.join(drawn)}")
    digests = sass_digests("gen_words_kernel")
    say("26 genkernel probe", f"K7's and K8's SASS, {len(digests)} kernels "
        f"(instructions, digest, registers, stack): " + "; ".join(
            f"{k} {v}" for k, v in sorted(digests.items())))
    row = next(r for r in res["rates"] if r["rounds"] == gp.ROUNDS
               and r["reps"] == max(gp.REPS_LIST))
    p_ms, _, _ = cuda_ms(lambda: gp.many_torch(c, *gp.MANY_KEY, row["reps"],
                                               row["rounds"]), 1)
    return row["ms"], p_ms, 0, row["bound"], None, {
        "graph_ms": row["graph_ms"],
        "rates": [{"rounds": r["rounds"], "reps": r["reps"],
                   "queued_ms": r["ms"], "graph_ms": r["graph_ms"],
                   "bound_ms": r["bound"][0]} for r in res["rates"]],
        "k7_soft8_draw_graph_ms": genkernel.threefry_calls(
            HEADLINE_BITS, ChannelIn.SOFT8, shared=True) / rate}


DECODE_CHECK_BITS = 2_000_000     # the decode probes' reduced checks


def popcount_np(words: np.ndarray) -> int:
    return int(np.unpackbits(words.astype(np.uint32).view(np.uint8)).sum())


def bench_profile_phase(card: str, runs: dict):
    """K21: at DECODE_CHECK_BITS and each dec_len, the pieces against their
    plain versions (K6's staging, K1 alone, the decode, the count and
    decode + count against numpy), then `python -m
    tpu_viterbi_torch.scripts.bench_profile` at 32M bits with the counts
    set to 0.  Returns K21's row: K1 alone at dec_len 8192."""
    bp = bench_profile
    for dl in bp.DEC_LENS:
        plan = bp.make_plan(DECODE_CHECK_BITS, dl)
        inp = bp.make_inputs(DECODE_CHECK_BITS, plan, "cuda", seed=SEED)
        f = bp.pieces(inp, plan)
        x = inp["x"]
        held(f"K21 stage (K6) at dec_len {dl}", f["stage"](),
             stage_words(x, bp.CFG, plan))
        held(f"K21 kraw (K1) at dec_len {dl}", f["kraw"](),
             decode_blocks_torch(x, bp.CFG, plan))
        want = decode_packed_torch(x, bp.CFG, plan)
        held(f"K21 decode at dec_len {dl}", f["decode"](), want)
        y = inp["y"].cpu().numpy()
        ref = inp["ref"].cpu().numpy()
        n = plan.message_len // 32
        w = want.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
        if int(f["check"]()) != popcount_np(y[0] ^ y[1]) or \
                int(f["d+c"]()) != popcount_np(w[:n] ^ ref[:n]):
            raise AssertionError(f"K21 check or d+c at dec_len {dl} differs "
                                 f"from numpy's popcount")
    say("27 bench profile", f"K21's pieces (K6, K1, decode, count, d+c) equal "
        f"their plain versions at {DECODE_CHECK_BITS} bits, dec_len "
        f"{bp.DEC_LENS}")
    res, counts = probe_run(bp.probe)
    record(runs, {"K21": counts["K1"] + counts["K6"]}, 1, ["K21"],
           "bench profile")
    for dl, t in res.items():
        say("27 bench profile", f"{card}: dec_len {dl}: K6 stage "
            f"{t['stage']:.4f}, K1 {t['kraw']:.4f}, assemble "
            f"{t['decode'] - t['kraw']:.4f}, check {t['check']:.4f}, "
            f"decode {t['decode']:.4f}, d+c {t['d+c']:.4f} ms; K1 launches "
            f"{counts['K1']}, K6 {counts['K6']}")
    dl = bp.DEC_LENS[0]
    plan = bp.make_plan(HEADLINE_BITS, dl)
    x = bp.make_inputs(HEADLINE_BITS, plan, "cuda")["x"]
    p_ms, _, _ = cuda_ms(lambda: decode_blocks_torch(x, bp.CFG, plan), 1)
    return res[dl]["kraw"], p_ms, 0, decode_bound(
        x.numel() * 4, bp.CFG, plan, runs_pm16(K1, bp.CFG))


def bench_split_phase(card: str, runs: dict):
    """K22: at DECODE_CHECK_BITS, K6 on the values, K4 in value mode and
    decode_blocks_cuda against their plain versions, then `python -m
    tpu_viterbi_torch.scripts.bench_split` at 32M bits with the counts set
    to 0.  Returns K22's row: K4 in value mode."""
    bs = bench_split
    plan = bs.make_plan(DECODE_CHECK_BITS)
    r = bs.make_values(DECODE_CHECK_BITS, "cuda", seed=SEED)
    f = bs.pieces(r, plan)
    args = (2 * plan.dec_len, 2 * plan.block_len, plan.num_blocks)
    staged = stage_transpose(r.reshape(-1), *args)
    held("K22 staging (K6)", f["staging"](), staged)
    held("K22 kernel (K4 values)", f["kernel"](),
         decode_staged_torch(staged, bs.CFG, plan))
    held("K22 full", f["full"](),
         decode_blocks(gather_blocks(r, plan), bs.CFG, plan))
    say("28 bench split", f"K22's pieces (K6, K4 values, decode_blocks_cuda) "
        f"equal their plain versions at {DECODE_CHECK_BITS} bits")
    t, counts = probe_run(bs.probe)
    record(runs, {"K22": counts["K4"] + counts["K6"]}, 1, ["K22"],
           "bench split")
    m = bs.N_BITS
    say("28 bench split", f"{card}: staging {t['staging']:.4f}, kernel "
        f"{t['kernel']:.4f} ({m / t['kernel'] / 1e6:.2f} Gb/s), full "
        f"{t['full']:.4f} ms ({m / t['full'] / 1e6:.2f} Gb/s); K4 launches "
        f"{counts['K4']}, K6 {counts['K6']}")
    plan = bs.make_plan(m)
    staged = bs.stage_values(bs.make_values(m, "cuda"), plan)
    p_ms, _, _ = cuda_ms(lambda: decode_staged_torch(staged, bs.CFG, plan), 1)
    return t["kernel"], p_ms, 0, decode_bound(staged.numel() * 4, bs.CFG,
                                              plan, runs_pm16(K4, bs.CFG))


K23_CHECK_DEC_LENS = (64, 96)    # 128 and 160 stages: tails 2 and 4


def lane_pick_line(tag: str, card: str, rows: list, label: str,
                   extra: dict, key: str) -> None:
    """Print ``rows``' (one case at each lane count in turn) fastest lane
    count beside the pick, each with its share of ``r['bound']``, and keep
    the fastest's lanes in ``extra`` under ``key``."""
    best = min(rows, key=lambda r: r["ms"])
    pick = next(r for r in rows if r["picked"])
    extra[key] = best["lanes"]
    say(tag, f"{card}: {label}: fastest at {best['lanes']} lanes "
        f"({best['ms']:.4f} ms, {share(best['bound'], best['ms'])}), the "
        f"pick {pick['lanes']} ({pick['ms']:.4f} ms, "
        f"{share(pick['bound'], pick['ms'])})")


def staging_cost_phase(card: str, runs: dict):
    """K23: every lane count bit-equal to one plain decode over the full
    grid at the script's shape (32M bits, dec_len 8192: every block of
    every tile, the split's clusters and their halo exchange; 8,256
    stages, a tail of 0 after the split's six-stage passes) and at dec_len
    64 and 96 (tails of 2 and 4) on 300-block plans, then `python -m
    tpu_viterbi_torch.scripts.staging_cost` (roll at each lane count in
    turn with one lane) with the counts set to 0.  Prints K23's lane table
    (ms, SASS, SHFL and registers a stage), the fastest lane count beside
    the pick and their shares of the bound (body bytes, int32 ACS).
    Returns K23's row: roll at the pick beside its plain version; each
    lane count's times in the extra keys."""
    sc = staging_cost
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def words(plan):
        return torch.randint(-2 ** 31, 2 ** 31, (sc.need_words(sc.CFG, plan),),
                             generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)

    plan, _ = sc.make_plans(sc.N_BITS)
    xp = words(plan)
    p_ms, _, want = cuda_ms(lambda: sc.roll_decode_torch(xp, sc.CFG, plan), 1)
    for n in LANES:
        held(f"K23 over the full grid at {n} lanes", K23(xp, sc.CFG, plan, n),
             want)
    del want
    for dec_len in K23_CHECK_DEC_LENS:
        splan = plan_blocks(dec_len * 300 - 32, 32, dec_len)
        xs = words(splan)
        ws = sc.roll_decode_torch(xs, sc.CFG, splan)
        for n in LANES:
            held(f"K23 at dec_len {dec_len}, {n} lanes",
                 K23(xs, sc.CFG, splan, n), ws)
    pplan = sc.padded_plan(plan)
    say("29 staging cost", f"K23 bit-equal to its plain version at lanes "
        f"{list(LANES)} over {pplan.num_blocks} blocks "
        f"({pplan.num_blocks // 128} tiles, the last block of each "
        f"wrapping) at dec_len {plan.dec_len},"
        f" and over 384 blocks at dec_len "
        f"{' and '.join(map(str, K23_CHECK_DEC_LENS))}")
    res, counts = probe_run(sc.probe)
    record(runs, counts, 1, ["K23"], "staging cost")
    t, rows = res["ms"], res["roll"]
    wpb, _ = words_per_block(sc.CFG, plan)
    bnd = decode_bound(pplan.num_blocks * wpb * 4, sc.CFG, pplan)
    for r in rows:
        r["bound"] = bnd
    say("29 staging cost", f"{card}: " + ", ".join(
        f"{v} {t[v]:.4f}" for v in sc.VARIANTS) + f" ms; views - pre "
        f"{t['views'] - t['pre']:.4f}, roll - views "
        f"{t['roll'] - t['views']:.4f} ms; K23 {share(bnd, t['roll'])}")
    extra = {}
    lane_turns("29 staging cost", card, rows, extra,
               f"K23 roll at {pplan.num_blocks} blocks x "
               f"{pplan.n_packs * 32} stages", "roll", "roll_{}")
    lane_pick_line("29 staging cost", card, rows, "K23 roll", extra,
                   "roll_fastest_lanes")
    return t["roll"], p_ms, 0, bnd, None, extra


def soft16_pieces_phase(card: str, runs: dict):
    """K24: at DECODE_CHECK_BITS, each configuration's kernel-only piece (K1
    or K3) against its plain version and its full piece's BEN 0, then
    `python -m tpu_viterbi_torch.scripts.soft16_pieces` at 32M bits with
    the counts set to 0: BEN 0 for every configuration.  Returns K24's
    row: K1 on SOFT16, dec_len 4096."""
    sp = soft16_pieces
    for ch, dl, survivor in sp.CONFIGS:
        case = sp.make_case(ch, dl, survivor, DECODE_CHECK_BITS, "cuda")
        f = sp.pieces(case)
        held(f"K24 {case['label']} kernel-only", f["kernel-only"](),
             decode_blocks_torch(case["words"], case["cfg"], case["plan"],
                                 case["window"]))
        if int(f["full"]()):
            raise AssertionError(f"K24 {case['label']}: BEN != 0")
    say("30 soft16 pieces", f"K24's kernel-only pieces (K1, K3) equal their "
        f"plain versions and the full decodes count BEN 0 at "
        f"{DECODE_CHECK_BITS} bits, 5.5 dB")
    res, counts = probe_run(sp.probe)
    record(runs, {"K24": counts["K1"] + counts["K3"]}, 1, ["K24"],
           "SOFT16 pieces")
    for label, row in res.items():
        if row["ben"]:
            raise AssertionError(f"K24 {label} at 32M bits: BEN {row['ben']}")
        say("30 soft16 pieces", f"{card}: {label}: kernel-only "
            f"{row['kernel-only']:.4f} ms, full {row['full']:.4f} ms, BEN 0")
    case = sp.make_case(ChannelIn.SOFT16, 4096, "full", sp.N_BITS, "cuda")
    cfg, plan, words = case["cfg"], case["plan"], case["words"]
    p_ms, _, _ = cuda_ms(lambda: decode_blocks_torch(words, cfg, plan), 1)
    return res["soft16/4096"]["kernel-only"], p_ms, 0, decode_bound(
        words.numel() * 4, cfg, plan, runs_pm16(K1, cfg))


def ud_reader_phase(gen, runs: dict) -> int:
    """K1's and K3's u/d-word reader: on random FP32 wires (NaN, +-inf)
    staged by fp32_ud_words_torch, bit-equal to decode_ud_words_torch
    (b32/b16 x dec_len 32/96/2048, full store and window); on
    fp32_fused_value_probe's 2M-bit check wire, decode_ud_words_cuda equal
    to K2 at 2048 and 8192 and to K3 at 4096 windowed.  Each decode is one
    call of one kernel.  Returns the largest |diff| (0)."""
    n_plans = 0
    for out in (DecodeOut.O_B32, DecodeOut.O_B16):
        cfg = DecoderConfig(ChannelIn.FP32, decode_out=out)
        bpp = cfg.bits_per_pack
        for dl in (32, 96, 2048):
            plan = plan_blocks(dl * 300 - bpp, bpp, dl)
            udw = fp32_ud_words_torch(random_words(cfg, plan, gen))
            for window in (False, True):
                held(f"K{3 if window else 1}-ud b{bpp} dec_len {dl}",
                     core_cuda.decode_ud_words_cuda(udw, cfg, plan, window),
                     assemble_output(decode_ud_words_torch(
                         udw, cfg, plan, window), cfg, plan))
                n_plans += 1
    fp = fp32_fused_value_probe
    v = fp.check_values(DECODE_CHECK_BITS, "cuda")
    udw = fp32_ud_words_torch(v)
    for dl, window in ((2048, False), (4096, True), (8192, False)):
        plan = fp.make_plan(DECODE_CHECK_BITS, dl)
        got, counts = counted(lambda: core_cuda.decode_ud_words_cuda(
            udw, FP32, plan, window))
        kernel = "K3" if window else "K1"
        record(runs, counts, 1, [kernel], f"u/d words at {dl}")
        if not torch.equal(got, core_cuda.decode_packed_cuda(
                v, FP32, plan, window=window)):
            raise AssertionError(f"the u/d route differs from "
                                 f"{'K3' if window else 'K2'} at {dl}")
    say("31 ud reader", f"K1-ud and K3-ud bit-equal to decode_ud_words_torch "
        f"on {n_plans} plans (b32/b16 x dec_len 32/96/2048 x full/window, "
        f"wires with NaN and +-inf); decode_ud_words_cuda(fp32_ud_words_"
        f"torch(v)) == K2 at 2048 and 8192, == K3 at 4096 windowed on "
        f"{DECODE_CHECK_BITS} bits of standard_normal x 5")
    return 0


def soft16_ablation_phase(card: str, runs: dict):
    """K25: every variant at every lane count bit-equal to its plain version
    on every program of both grids (2048 and 15,872 arrays) at
    ABLATION_CHECK_PACKS packs, then `python -m
    tpu_viterbi_torch.scripts.soft16_ablation` (every variant at every lane
    count at both grids) with the counts set to 0, and each run's bound (its
    words read once, OPS lane-operations an array-stage, whatever the
    lanes).  Prints, at each grid, the lanes the wrapper picks and each lane
    count's s16/unpack line.  Returns K25's row: s16/unpack at the JAX shape
    at the picked lanes beside its plain version there, each lane count's
    times in the extra keys."""
    sa = soft16_ablation
    for programs in (sa.GRID, sa.HEADLINE_TILES):
        for v in sa.VARIANTS:
            w = sa.probe_input(programs, ABLATION_CHECK_PACKS, sa.WPP[v],
                               "cuda", seed=SEED)
            want = sa.soft16_ablation_torch(v, w, programs)
            for n in LANES:
                held(f"K25 {v} at {programs} programs, {n} lanes",
                     K25(v, w, programs, n), want)
    say("32 soft16 ablation", f"K25 bit-equal to its plain version on all "
        f"{len(sa.VARIANTS)} variants at lanes {list(LANES)}, every "
        f"program of {sa.GRID} and {sa.HEADLINE_TILES} programs, "
        f"{ABLATION_CHECK_PACKS} packs")
    stages = sa.N_PACKS * 32
    results = probe_results(
        "32 soft16 ablation", card, runs, sa, "K25", "SOFT16 ablation",
        lambda r: bound(r["programs"] * (sa.N_PACKS * sa.WPP[r["variant"]] + 1)
                        * LT_BYTES, sa.OPS[r["variant"]] * r["arrays"] *
                        stages))
    extra = {}
    for programs in (sa.GRID, sa.HEADLINE_TILES):
        arrays = programs * 128
        picked = sa.lanes_for(arrays)
        mine = [r for r in results if r["programs"] == programs]
        by = {r["variant"]: r["ns_per_stage_tile"] for r in mine
              if r["lanes"] == picked}
        unpack = {r["lanes"]: r for r in mine if r["variant"] == "s16/unpack"}
        for n, r in unpack.items():
            extra[f"s16_unpack_{arrays}_lanes{n}_ms"] = r["ms"]
        p = unpack[picked]
        extra.update({f"lanes_at_{arrays}": picked,
                      f"sass_per_stage_at_{arrays}": p["sass_per_stage"],
                      f"shfl_per_stage_at_{arrays}": p["shfl_per_stage"],
                      f"registers_at_{arrays}": p["regs"],
                      f"warp_pace_ns_at_{arrays}": sa.warp_pace(p)})
        say("32 soft16 ablation", f"{card}: {arrays} arrays: the wrapper "
            f"picks {picked} lanes (s16/unpack {p['ms']:.4f} ms, "
            f"{p['sass_per_stage']:g} SASS and {p['shfl_per_stage']:g} SHFL "
            f"a stage, {p['regs']} registers, warp pace "
            f"{sa.warp_pace(p):.4f} ns/stage); s16/unpack by lanes: " +
            ", ".join(f"{n}: {r['ms']:.4f} ms ({r['sass_per_stage']:g} SASS,"
                      f" {r['shfl_per_stage']:g} SHFL a stage, {r['regs']} "
                      f"registers, pace {sa.warp_pace(r):.4f} ns)"
                      for n, r in sorted(unpack.items())) +
            f"; {sa.decomposition(by)}; LDG a loop pass " + ", ".join(
                f"{r['variant']} {r['ldg']}" for r in mine
                if r["lanes"] == picked))
    for programs in sa.CROSSOVER_PROGRAMS:
        arrays = programs * 128
        mine = [r for r in results if r["programs"] == programs]
        for r in mine:
            extra[f"s16_unpack_{arrays}_lanes{r['lanes']}_ms"] = r["ms"]
        extra[f"fastest_lanes_at_{arrays}"] = sa.fastest(mine)
        say("32 soft16 ablation", f"{card}: {arrays} arrays, s16/unpack by "
            f"lanes: {lane_line(mine)}; fastest {sa.fastest(mine)}, "
            f"lanes_for picks {lanes_for(arrays)}")
    w = sa.probe_input(sa.GRID, sa.N_PACKS, 32, "cuda", seed=SEED)
    p_ms = held_to_plain("K25 s16/unpack at the JAX shape",
                         K25("s16/unpack", w, sa.GRID),
                         lambda: sa.soft16_ablation_torch("s16/unpack", w,
                                                          sa.GRID))
    row = next(r for r in results if r["variant"] == "s16/unpack" and
               r["programs"] == sa.GRID and
               r["lanes"] == sa.lanes_for(sa.GRID * 128))
    return row["ms"], p_ms, 0, row["bound"], None, extra


GRAPH_CALLS = 100                   # calls a CUDA graph replays (graph_ms)


def bulk_sass() -> dict:
    """{kernel: its global-memory opcodes and counts} of K26's bulk-route
    kernels; raises if one loads a word from global memory itself or
    stores less than 16 bytes, or issues no bulk copy."""
    sass, _ = cubin_listings("viterbi_transpose")
    mem = {}
    for name, mix in kernel_opcodes(sass).items():
        if "bulk_" not in name:
            continue
        ops = {op: k for op, k in mix.items()
               if op.startswith(("LDG", "STG", "UBLKCP", "UTMA", "SYNCS"))}
        bad = [op for op in ops if op.startswith("LDG") or (
            op.startswith("STG") and ".128" not in op)]
        if bad or not any(op.startswith("UBLKCP") for op in ops):
            raise AssertionError(f"K26 {name}: global accesses {ops}")
        mem[name] = ops
    if len(mem) != 3:
        raise AssertionError(f"K26's bulk kernels: {sorted(mem)}")
    return mem


def transpose_phase(card: str, runs: dict):
    """K26: every tiling's transpose of the JAX shape (15,744 x 1,056
    int32, the bulk route) and of a shape one row and one column short (the
    element route) bit-equal to x.t(), each launch counted on its route; the
    bulk kernels' SASS (no global load, 16-byte stores only, bulk copies);
    the consumer on its output to its plain version, then `python -m
    tpu_viterbi_torch.scripts.transpose_bench` with the counts set to 0
    (each tiling, x.t().contiguous() and copy_ one call at a time and
    replayed from a CUDA graph).  Returns K26's row: the 32x32 tiling
    (K6's tile) beside transpose_torch, bound by its bytes, with
    x.t().contiguous() as the library call, and the graph readings."""
    tb = transpose_bench
    x = tb.probe_input("cuda", seed=SEED)
    want = x.t().contiguous()
    short = x[:-1, :-1].contiguous()
    for what, arr, route in (("JAX shape", x, "bulk"),
                             ("one short", short, "element")):
        ref = arr.t().contiguous()
        for tiling in tb.TILINGS:
            if K26.route(tiling, arr) != route:
                raise AssertionError(f"K26 {tiling} on the {what}: route "
                                     f"{K26.route(tiling, arr)}")
            before = K26.route_launches[route]
            held(f"K26 {tiling} on the {what}", K26.transpose(tiling, arr),
                 ref)
            if K26.route_launches[route] != before + 1:
                raise AssertionError(f"K26 {tiling}: not one {route} launch")
    del short
    mem = bulk_sass()
    say("33 transpose", "K26's bulk kernels' global accesses (SASS): " +
        "; ".join(f"{k} {v}" for k, v in sorted(mem.items())))
    # the consumer writes its output: the caching allocator hands it a
    # block that a freed tensor of junk left dirty
    junk = torch.full((tb.SUM_COLS,), -1, dtype=torch.int32, device="cuda")
    del junk
    got, counts = counted(lambda: K26.consume(want))
    if counts["K26"] != 1:
        raise AssertionError(f"K26's consumer: {counts['K26']} launches")
    held("K26 consume", got, tb.consume_torch(want))
    held("K26 consume against .sum(0)", got,
         want[:, :tb.SUM_COLS].sum(0, dtype=torch.int32))
    say("33 transpose", f"K26 bit-equal to its plain version: "
        f"{', '.join(tb.TILINGS)} on ({tb.B}, {tb.LW}) int32 (bulk route) "
        f"and ({tb.B - 1}, {tb.LW - 1}) (element route), the consumer (one "
        f"launch, on reused memory) on the ({tb.LW}, {tb.B}) result, equal "
        f"to .sum(0) too")
    before = K26.route_launches["bulk"]
    res, counts = probe_run(tb.probe)
    record(runs, counts, 1, ["K26"], "transpose bench")
    bulk = K26.route_launches["bulk"] - before
    if bulk != counts["K26"] - 2 * (tb.REPS + 1):   # the consumer's
        raise AssertionError(f"K26's probe run: {bulk} bulk launches of "
                             f"{counts['K26']}")
    bnd = bound(2 * x.numel() * 4)
    c_bnd = bound(want.shape[0] * tb.SUM_COLS * 4 + tb.SUM_COLS * 4)
    say("33 transpose", f"{card}: one call at a time / replayed from a graph "
        f"of {tb.GRAPH_CALLS}: " + ", ".join(
            f"{k} {res[k]:.4f} / {res[k + ' graph']:.4f}"
            for k in ("torch", "copy", *tb.TILINGS)) +
        f" ms; {share(bnd, res['32x32'])} (32x32), by graph "
        f"{bnd[0] / res['32x32 graph']:.0%}; the card's copy_ "
        f"{2 * x.numel() * 4 / res['copy graph'] / 1e6:.0f} GB/s by graph; "
        f"torch+consume {res['torch+consume']:.4f}; consumer (one launch) "
        f"{res['consume']:.4f} ms against x[:, :128].sum(0) "
        f"{res['torch consume']:.4f} ms, {share(c_bnd, res['consume'])}")
    # the consumer on the card's clock alone: GRAPH_CALLS calls replayed
    # from a CUDA graph (their capture launches K26 outside the counts)
    g_ms, g_all, g_out = graph_ms(lambda: K26.consume(want), GRAPH_CALLS,
                                  tb.REPS)
    gl_ms, gl_all, gl_out = graph_ms(
        lambda: want[:, :tb.SUM_COLS].sum(0, dtype=torch.int32),
        GRAPH_CALLS, tb.REPS)
    held("K26 consume replayed from a graph", g_out, gl_out)
    say("33 transpose", f"{card}: replayed from a CUDA graph of "
        f"{GRAPH_CALLS} calls: consumer {g_ms:.4f} ms a call of "
        f"{[round(t, 4) for t in g_all]}, x[:, :128].sum(0) {gl_ms:.4f} ms "
        f"of {[round(t, 4) for t in gl_all]}; {share(c_bnd, g_ms)}")
    p_ms, _, _ = cuda_ms(lambda: tb.transpose_torch(x), 1)
    c_ms, _, _ = cuda_ms(lambda: tb.consume_torch(want), 1)
    return res["32x32"], p_ms, 0, bnd, res["torch"], {
        "transpose_route": "bulk", "graph_ms": res["32x32 graph"],
        "library_graph_ms": res["torch graph"],
        **{f"{t}_ms": res[t] for t in tb.TILINGS[1:]},
        **{f"{t}_graph_ms": res[f"{t} graph"] for t in tb.TILINGS[1:]},
        "copy_ms": res["copy"], "copy_graph_ms": res["copy graph"],
        "consume_ms": res["consume"], "consume_plain_ms": c_ms,
        "consume_library_ms": res["torch consume"],
        "consume_graph_ms": g_ms, "consume_library_graph_ms": gl_ms,
        "consume_bound_ms": c_bnd[0], "consume_launches_per_call": 1}


def fp32_routes_phase(card: str, runs: dict):
    """K27: the FP32 routes on K8's 32M-bit wire at 5.5 dB (the CLI's
    --e2e-device generator and scale, seed SEED): K2 at 2048, K3 at 4096
    windowed and the u/d route at 8192 each BEN 0; then `python -m
    tpu_viterbi_torch.scripts.fp32_fused_value_probe` (its check, then
    every route at 32M bits) with the counts set to 0: K1, K2 and K3 are
    its launches.  Returns K27's row: K2 at 2048 on the probe's wire,
    beside its plain version."""
    fp = fp32_fused_value_probe
    packs, wire = packed_workload_cuda(SEED, HEADLINE_BITS, ChannelIn.FP32,
                                       5.5, CLI_SCALE)
    m = FP32.get_message_len(2 * HEADLINE_BITS)
    ref = ref_words_from_packs(packs, FP32.extra_l, m)
    bens = {}
    for label, dl, window in (("K2 2048", 2048, False),
                              ("K3 4096 window", 4096, True),
                              ("u/d 8192", 8192, False)):
        plan = fp.make_plan(HEADLINE_BITS, dl)
        out = core_cuda.decode_ud_words_cuda(fp32_ud_words_torch(wire), FP32,
                                             plan, window) \
            if label.startswith("u/d") else \
            core_cuda.decode_packed_cuda(wire, FP32, plan, window=window)
        bens[label] = int(count_errors(out, ref, 32, plan.message_len))
    if any(bens.values()):
        raise AssertionError(f"FP32 routes on K8's wire: BEN {bens}")
    say("34 fp32 routes", f"K8's {HEADLINE_BITS}-bit FP32 wire at 5.5 dB "
        f"(seed {SEED}, scale {CLI_SCALE:g}): BEN {bens}")
    res, counts = probe_run(fp.probe)
    if not all(res["check"].values()):
        raise AssertionError(f"fp32_fused_value_probe's check: "
                             f"{res['check']}")
    record(runs, {"K27": counts["K1"] + counts["K2"] + counts["K3"]}, 1,
           ["K27"], "FP32 routes")
    x = fp.wire(HEADLINE_BITS, "cuda")
    plan = fp.make_plan(HEADLINE_BITS, 2048)
    label = "fused-value dl=2048 win=False (K2)"
    bnd = decode_bound(x.numel() * 4, FP32, plan, runs_pm16(K2, FP32))
    udw = fp32_ud_words_torch(x)
    say("34 fp32 routes", f"{card}: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in res.items() if k != "check") +
        f"; launches K1 {counts['K1']}, K2 {counts['K2']}, K3 "
        f"{counts['K3']}; K2 {share(bnd, res[label])}; the u/d staging's "
        f"bound {bound((x.numel() + udw.numel()) * 4)[0]:.4f} ms by bytes")
    p_ms, _, _ = cuda_ms(lambda: decode_blocks_torch(x, FP32, plan), 1)
    return res[label], p_ms, 0, bnd


INTERLEAVE_CHECK_REPS = 13          # two passes of 6 and a tail rep


def interleave_phase(card: str, runs: dict):
    """K28: every variant at every lane count it is built for bit-equal to
    its plain version after INTERLEAVE_CHECK_REPS reps at the JAX shape and
    the full grid, and after the probe's REPS at the JAX shape, then
    `python -m tpu_viterbi_torch.scripts.interleave_bench` (its check, then
    regs, smem and concat at each lane count in turn with one lane at the
    JAX shape, shfl at its 32, and each at its pick on the full grid) with
    the counts set to 0, and each run's bound (OPS lane-operations a
    column-rep).  Prints each split variant by lanes, its fastest lane
    count beside the pick and their shares.  Returns K28's row: regs at the
    JAX shape at the pick beside its plain version there; each lane
    count's times in the extra keys."""
    ib = interleave_bench
    full = ib.full_tiles("cuda")
    for tiles, check_reps in ((ib.N_TILES, (INTERLEAVE_CHECK_REPS, ib.REPS)),
                              (full, (INTERLEAVE_CHECK_REPS,))):
        x = ib.probe_input(tiles, "cuda", seed=SEED)
        for reps in check_reps:
            for v in ib.VARIANTS:
                want = ib.interleave_torch(v, x, reps)
                for n in ib.variant_lanes(v):
                    held(f"K28 {v} at {tiles} tiles, {reps} reps, {n} lanes",
                         K28(v, x, reps, lanes=n), want)
        del x
    say("35 interleave", f"K28 bit-equal to its plain version on all "
        f"{len(ib.VARIANTS)} variants ({', '.join(ib.SPLIT)} at lanes "
        f"{list(LANES)}, shfl at {ib.SHFL_LANES}) at {ib.N_TILES} tiles, "
        f"{INTERLEAVE_CHECK_REPS} and {ib.REPS} reps, and {full} tiles, "
        f"{INTERLEAVE_CHECK_REPS} reps")
    res, counts = probe_run(ib.probe)
    if res["correct"] != {v: v != "concat" for v in ib.VARIANTS}:
        raise AssertionError(f"the interleave check: {res['correct']}")
    record(runs, counts, 1, ["K28"], "interleave bench")
    for r in res["runs"]:
        r["bound"] = bound(2 * ib.ROWS * r["columns"] * 4,
                           ib.OPS[r["variant"]] * r["columns"] * ib.REPS)
        say("35 interleave", f"{card}: {ib.describe(r)}; "
            f"{share(r['bound'], r['ms'])}")
    extra = {}
    jax_shape = [r for r in res["runs"] if r["tiles"] == ib.N_TILES]
    for v in ib.SPLIT:
        turns = [r for r in jax_shape if r["variant"] == v]
        lane_turns("35 interleave", card, turns, extra,
                   f"{v} at {ib.N_TILES * 128} columns", v, f"{v}_{{}}",
                   per="rep")
        lane_pick_line("35 interleave", card, turns, v, extra,
                       f"{v}_fastest_lanes")
    x = ib.probe_input(ib.N_TILES, "cuda", seed=SEED)
    p_ms = held_to_plain("K28 regs at the JAX shape", K28("regs", x, ib.REPS),
                         lambda: ib.interleave_torch("regs", x, ib.REPS))
    row = next(r for r in jax_shape if r["variant"] == "regs" and
               r["picked"])
    return row["ms"], p_ms, 0, row["bound"], None, extra


# ---- the multi-rank split (sharding/): K1's and K3's tail halo ----------

SPLIT_SIGMA = snr_to_sigma(5.5)      # the split's noisy 32M-bit message
WORKER_WAIT_S = 600                   # each worker's own wait


def halo_split(x, cfg, plan, ragged: int = 0):
    """(stream, tail halo): the first num_blocks * wpb - ragged words of x
    (a view) and the wph words after them (a copy)."""
    wpb, wph = words_per_block(cfg, plan)
    n = plan.num_blocks * wpb - ragged
    return x[:n], x[n: n + wph].contiguous()


def halo_check(tag: str, kernel, cfg, plan, words, halo, window: bool):
    """``kernel`` with the tail halo against its plain version with it and
    the same kernel on the appended stream; -> max |diff|."""
    got = kernel(words, cfg, plan, tail_halo=halo)
    cat = kernel(torch.cat([words, halo]), cfg, plan)
    torch.cuda.synchronize()
    plain = decode_blocks_torch(words, cfg, plan, window, tail_halo=halo)
    err = max(max_abs_diff(got, cat), max_abs_diff(got, plain))
    if got.shape != plain.shape or err:
        raise AssertionError(f"{tag}: {kernel.name} with tail_halo differs "
                             f"(max |diff| {err})")
    return err


def tail_halo_phase(card: str, gen):
    """K1 and K3 reading a tail halo on the card: at the 32M-bit SOFT8
    headline (5.5 dB) cut as two ranks cut it (rank 0's words and rank 1's
    first wph words; dec_len 2048, b32 and b16, full store and window), and
    HARD, SOFT4 and SOFT16 at 409,600 stages (b32, b16, full, window, a
    ragged stream), each bit-equal to its plain version with the halo and
    to the same kernel on the appended stream.  Then each timed at the
    one-rank split's shape (the shard padded to 32,243,712 stages, its own
    first words as the halo) in turns with the kernel on the appended
    stream, and its plain version.  Returns the rows of HALO_ROWS."""
    packed, _, _ = headline_packed(HEADLINE, 21)
    worst, n_checks = 0, 0
    for out in (DecodeOut.O_B32, DecodeOut.O_B16):
        cfg = DecoderConfig(ChannelIn.SOFT8, decode_out=out)
        sd, dl = split_blocks.shard_stages(cfg, 2 * HEADLINE_BITS, 2,
                                           DEC_LEN)
        plan = plan_blocks(sd, cfg.bits_per_pack, dl)
        words, halo = halo_split(packed, cfg, plan)
        for kernel, window in ((K1, False), (K3, True)):
            worst = max(worst, halo_check("headline", kernel, cfg, plan,
                                          words, halo, window))
            n_checks += 1
    for ch in (ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT16):
        for out in (DecodeOut.O_B32, DecodeOut.O_B16):
            cfg = DecoderConfig(ch, decode_out=out)
            plan = plan_blocks(DEC_LEN * 200, cfg.bits_per_pack, DEC_LEN)
            x = random_words(cfg, plan, gen)
            for ragged in (0, 3):
                words, halo = halo_split(x, cfg, plan, ragged)
                for kernel, window in ((K1, False), (K3, True)):
                    worst = max(worst, halo_check(
                        f"{ch.name} b{cfg.bits_per_pack}", kernel, cfg,
                        plan, words, halo, window))
                    n_checks += 1
    say("36 tail halo", f"K1 and K3 with tail_halo bit-equal to their plain "
        f"version and to themselves on the appended stream in {n_checks} "
        f"cases: the {HEADLINE_BITS}-bit SOFT8 headline as rank 0 of 2 "
        f"(b32, b16, full, window), HARD/SOFT4/SOFT16 x b32/b16 x aligned/"
        f"ragged x full/window; max |diff| {worst}")
    rows = {}
    sd, dl = split_blocks.shard_stages(HEADLINE, 2 * HEADLINE_BITS, 1,
                                       DEC_LEN)
    plan = plan_blocks(sd, 32, dl)
    lw = sd * 2 // HEADLINE.enc_data_per_pack
    words = torch.cat([packed, packed.new_zeros(lw - packed.shape[0])])
    halo = words[: split_blocks.halo_words(HEADLINE)].contiguous()
    appended = torch.cat([words, halo])
    for name, kernel, window in ((HALO_ROWS[0], K1, False),
                                 (HALO_ROWS[1], K3, True)):
        kernel(words, HEADLINE, plan, tail_halo=halo)        # warm-up
        ms, app_ms, all_ms, app_all, k_out, a_out = ab_ms(
            lambda: kernel(words, HEADLINE, plan, tail_halo=halo),
            lambda: kernel(appended, HEADLINE, plan), AB_RUNS)
        p_ms, p_all, p_out = cuda_ms(lambda: decode_blocks_torch(
            words, HEADLINE, plan, window, tail_halo=halo), 3)
        err = max(max_abs_diff(k_out, a_out), max_abs_diff(k_out, p_out))
        if err:
            raise AssertionError(f"{name} at the one-rank split differs "
                                 f"(max |diff| {err})")
        bnd = decode_bound((words.numel() + halo.numel()) * 4, HEADLINE,
                           plan, runs_pm16(kernel, HEADLINE))
        sass, regs = halo_sass(window)
        base = int16_sass(HEADLINE, window)["int16x2"]
        rows[name] = (ms, p_ms, worst, bnd, None, {
            "appended_ms": app_ms, "all_ms": [round(t, 4) for t in all_ms],
            "appended_all_ms": [round(t, 4) for t in app_all],
            "sass_per_stage": sass, "registers": regs,
            "no_halo_sass_per_stage": base[0], "no_halo_registers": base[1]})
        say("36b tail halo times", f"{card}: {name} at the one-rank split "
            f"({sd} stages, dec_len {dl}, {plan.num_blocks} blocks): median "
            f"{ms:.4f} ms of {[round(t, 4) for t in all_ms]}, in turns with "
            f"{kernel.name} on the appended stream {app_ms:.4f} ms of "
            f"{[round(t, 4) for t in app_all]}; plain median {p_ms:.1f} ms; "
            f"bit-equal; bound {bnd[0]:.4f} ms by {bnd[1]} "
            f"({bnd[0] / ms:.0%} of it); SOFT8 b32 halo instance {sass} "
            f"SASS a stage, {regs} registers (without the halo {base[0]}, "
            f"{base[1]})")
    return rows


def source_packs(bits: np.ndarray, cfg, m: int) -> np.ndarray:
    """The words a decode without error gives: message bits extra_l ..
    extra_l + m packed MSB first, uint32."""
    return np.packbits(bits[cfg.extra_l: cfg.extra_l + m]).view(
        ">u4").astype(np.uint32)


def one_rank_split_phase(card: str, runs: dict):
    """The split at one rank on the card (world size 1, nccl):
    decode_sharded of the 32M-bit SOFT8 message (certify.coded_workload,
    scale 32), noiseless byte-equal to the source and BEN 0 at 5.5 dB; the
    sharded simulation (K7 at its base offset, K1 with the tail halo, the
    all-reduce) BEN 0 at 5.5 dB, FP32 (K8, K2 on [local, halo]) and the
    window (K3 with the tail halo) too; each run with the counts set to 0
    just before and read just after.  Then the split's simulate in turns
    with the one-device simulate, CUDA events.  Returns (the 5.5 dB
    decode, the in-graph medians)."""
    backend = split_mesh.initialize_distributed(
        f"localhost:{launch.free_port()}", 1, 0, device="cuda")
    try:
        mesh = split_mesh.make_block_mesh("cuda")
        if (backend, mesh.size, mesh.device.type) != ("nccl", 1, "cuda"):
            raise AssertionError(f"one-rank split: backend {backend}, "
                                 f"{mesh.size} ranks on {mesh.device}")
        decoded = {}
        for tag, sigma, seed in (("noiseless", 0.0, SEED),
                                 ("5.5 dB", SPLIT_SIGMA, SEED + 1)):
            bits, packed = coded_workload(HEADLINE_BITS, sigma, seed,
                                          ChannelIn.SOFT8, 32.0)
            reset_counts()
            out, m = split_blocks.decode_sharded(packed, 2 * HEADLINE_BITS,
                                                 HEADLINE, mesh, DEC_LEN)
            counts = read_counts()
            want = source_packs(bits, HEADLINE, m)
            ben = popcount_np(out ^ want)
            if out.shape != want.shape or ben:
                raise AssertionError(f"one-rank decode_sharded {tag}: BEN "
                                     f"{ben}")
            record(runs, counts, 1, ["K1", HALO_ROWS[0]],
                   f"one-rank decode_sharded {tag}")
            decoded[tag] = out
        say("37 one-rank split", f"{card}: decode_sharded of {HEADLINE_BITS}"
            f" bits SOFT8 b32 over 1 rank ({backend}): noiseless output "
            f"byte-equal to the source, 5.5 dB BEN 0; K1 with tail_halo "
            f"once a decode ({counts[HALO_ROWS[0]]}), no copy of the shard")
        sims = {}
        for tag, cfg, survivor, kernels in (
                ("SOFT8", HEADLINE, "auto", ["K7", "K1", HALO_ROWS[0]]),
                ("FP32", FP32, "auto", ["K8", "K2"]),
                ("SOFT8 window", HEADLINE, "window",
                 ["K7", "K3", HALO_ROWS[1]])):
            fn, m = build_sharded_simulation(
                cfg, HEADLINE_BITS, snr_db=5.5, scale=CLI_SCALE,
                dec_len=DEC_LEN, generator="cuda", survivor=survivor,
                mesh=mesh)
            fn(SEED)                                         # warm-up
            reset_counts()
            mesh.census.clear()
            ben = int(fn(SEED))
            counts = read_counts()
            if ben or mesh.census != [("all_reduce", "int64", 1)]:
                raise AssertionError(f"one-rank split simulate {tag}: BEN "
                                     f"{ben}, census {mesh.census}")
            record(runs, counts, 1, kernels, f"one-rank simulate {tag}")
            sims[tag] = fn
            launched = {k: counts[k] for k in kernels}
            say("37b one-rank simulate", f"{tag}: BEN 0 at 5.5 dB over "
                f"{m} bits, shard {fn.sd} stages; census {mesh.census}; "
                f"launches {launched}")
        today, _ = build_sharded_simulation(
            HEADLINE, HEADLINE_BITS, snr_db=5.5, scale=CLI_SCALE,
            dec_len=DEC_LEN, generator="cuda", device="cuda")
        today(SEED)                                          # warm-up
        ms, t_ms, all_ms, t_all, ben, t_ben = ab_ms(
            lambda: sims["SOFT8"](SEED + 1), lambda: today(SEED + 1),
            AB_RUNS)
        if int(ben) or int(t_ben):
            raise AssertionError(f"in-graph A/B: BEN {int(ben)} (split), "
                                 f"{int(t_ben)} (one device)")
        say("37c split vs one device", f"{card}: simulate() at "
            f"{HEADLINE_BITS} bits SOFT8 5.5 dB, {AB_RUNS} samples a side in "
            f"turns: the one-rank split {ms:.4f} ms of "
            f"{[round(t, 4) for t in all_ms]}, the one-device simulate "
            f"{t_ms:.4f} ms of {[round(t, 4) for t in t_all]} (ratio "
            f"{ms / t_ms:.3f})")
        return decoded["5.5 dB"], {"split_in_graph_ms": ms,
                                   "one_device_in_graph_ms": t_ms}
    finally:
        torch.distributed.destroy_process_group()


def two_rank_phase(card: str, one_rank_out: np.ndarray) -> None:
    """Two ranks sharing the one card (gloo, two worker processes of
    tpu_viterbi_torch/scripts/distributed_worker.py started by
    sharding/launch.spawn_ranks): the same 32M-bit 5.5 dB message through
    decode_sharded equal to the one-rank output on the valid prefix, the
    sharded simulation (BEN 0 at
    5.5 dB and without noise, equal to the ranks held in one process),
    each rank's generated slab equal to the one-rank stream.  The two
    processes are time-sliced on the card: their time is no scaling
    number, and none is reported."""
    with tempfile.TemporaryDirectory() as tmp:
        results = launch.spawn_ranks(lambda r: [
            sys.executable, "-m",
            "tpu_viterbi_torch.scripts.distributed_worker", "--device",
            "cuda", "-n", str(HEADLINE_BITS), "-i", "s8", "--dec-len",
            str(DEC_LEN), "--sigma", repr(SPLIT_SIGMA), "--snr", "5.5",
            "--seed", str(SEED + 1), "--out-dir", tmp], 2, "cuda",
            WORKER_WAIT_S)
        for r in results:
            for line in r.out.splitlines():
                if line.startswith("DIST_OK"):
                    print(f"    | rank {r.rank}: {line}")
            if r.rc != 0:
                raise AssertionError(f"worker rank {r.rank} failed (rc "
                                     f"{r.rc}):\n{r.out[-3000:]}"
                                     f"{r.err[-3000:]}")
        res = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
               for r in range(2)]
        got = np.load(Path(tmp) / "rank0_decode.npy")
    if any((x["backend"], x["device"], x["ben"], x["noiseless_ben"]) !=
           ("gloo", "cuda:0", 0, 0) for x in res):
        raise AssertionError(f"two ranks: {res}")
    if not np.array_equal(got, one_rank_out):
        raise AssertionError("two-rank decode_sharded differs from the "
                             "one-rank output on the valid prefix")
    say("38 two ranks on one card", f"{card}: 2 worker processes (gloo, "
        f"both on cuda:0; time-sliced on the one card, so no time of theirs "
        f"is a scaling number): decode_sharded of the {HEADLINE_BITS}-bit "
        f"5.5 dB message equal to the one-rank output on its {got.shape[0]} "
        f"valid words; sharded simulate BEN 0 at 5.5 dB and without noise, "
        f"equal to the ranks in one process; each rank's slab equal to the "
        f"one-rank stream; census {res[0]['census']}")


# --- phases 39-43: the validation scripts (the JAX package's
# scripts/ber_deep.py, ber_deep_tail.py, check_gen_ber.py, fuzz_tpu.py)
# at their sizes, and the in-graph headline under --profile

CALL_BITS = ber_common.CALL_BITS
TURNS_UNTRACED = 20                 # untraced simulate() calls timed


def call_kernels(cfg, survivor: str):
    """(generator, decoder) a simulate() call of ``cfg`` launches."""
    return (genkernel.kernel_for(cfg.channel_in).name,
            core_cuda.kernel_for(cfg, survivor == "window").name)


def record_calls(runs: dict, counts: dict, calls: Counter, what: str):
    """record() each kernel of ``calls`` at its number of calls, one
    launch a call; no other kernel may have launched."""
    stray = {k: n for k, n in counts.items() if n and k not in calls}
    if stray:
        raise AssertionError(f"{what} launched {stray} besides {calls}")
    for k, n in calls.items():
        record(runs, counts, n, [k], what)
        if counts[k] != n:
            raise AssertionError(f"{what}: {k} launched {counts[k]} times "
                                 f"in {n} calls")


def script_rows(module, argv, tmp: Path):
    """The script's main(argv + --out) through drive(): (its JSON rows,
    its launches).  It must exit 0."""
    out = tmp / f"{module.__name__.rsplit('.', 1)[1]}.json"
    rc, _, counts = drive(None, lambda: module.main([*argv, "--out",
                                                     str(out)]))
    if rc != 0:
        raise AssertionError(f"{module.__name__} exited {rc}")
    return json.loads(out.read_text()), counts


def ber_deep_phase(card: str, runs: dict, tmp: Path) -> None:
    """scripts/ber_deep.py at its defaults: 22 points of 4 x 32M bits, each
    configuration on JAX's survivor plan; BEN falls with the SNR at every
    point of a configuration."""
    t0 = time.perf_counter()
    rows, counts = script_rows(ber_deep, [], tmp)
    calls, per_point = Counter(), -(-128_000_000 // CALL_BITS)
    for name, (ch, out, snrs) in ber_deep.CASES.items():
        cfg = ber_common.config(ch, out)
        surv = ber_common.jax_survivor(cfg, ber_deep.DEC_LEN)
        mine = [r for r in rows if r["config"] == name]
        m = cfg.get_message_len(2 * CALL_BITS)
        if [r["snr_db"] for r in mine] != list(snrs) or any(
                r["bits"] != per_point * m or r["survivor"] != surv
                for r in mine):
            raise AssertionError(f"ber_deep {name}: rows {mine}")
        bens = [r["ben"] for r in mine]
        if not 0 < bens[0] < 2e-3 * mine[0]["bits"] or any(
                a <= b for a, b in zip(bens, bens[1:])):
            raise AssertionError(f"ber_deep {name}: BEN {bens} does not "
                                 f"fall with the SNR {list(snrs)}")
        for k in call_kernels(cfg, surv):
            calls[k] += per_point * len(snrs)
    record_calls(runs, counts, calls, "ber_deep")
    say("39 ber_deep", f"{card}: {len(rows)} points x {per_point} calls of "
        f"{CALL_BITS} bits in {time.perf_counter() - t0:.1f} s; " +
        ", ".join(f"{r['config']}@{r['snr_db']} {r['ben']}" for r in rows) +
        f"; launches {dict(calls)}")


def ber_deep_tail_phase(card: str, runs: dict, tmp: Path) -> None:
    """scripts/ber_deep_tail.py at its defaults: each of the 9 rows to 30
    events over at least 512M bits, or to 1.024G bits; the window (K3)
    where JAX's plan took it."""
    t0 = time.perf_counter()
    rows, counts = script_rows(ber_deep_tail, [], tmp)
    calls = Counter()
    if [r["config"] for r in rows] != list(ber_deep_tail.CASES):
        raise AssertionError(f"ber_deep_tail rows {rows}")
    for r in rows:
        ch, out, _, _ = ber_deep_tail.CASES[r["config"]]
        cfg = ber_common.config(ch, out)
        surv = ber_deep_tail.row_survivor(r["config"])
        n, rem = divmod(r["bits"], cfg.get_message_len(2 * CALL_BITS))
        done = (r["ben"] >= ber_deep_tail.TARGET_EVENTS and r["bits"] >=
                ber_deep_tail.MIN_BITS) or r["bits"] >= 1_024_000_000
        gen, dec = call_kernels(cfg, surv)
        if rem or not done or r["survivor"] != surv or \
                dec not in r["kernels"]:
            raise AssertionError(f"ber_deep_tail row {r}")
        calls[gen] += n
        calls[dec] += n
    record_calls(runs, counts, calls, "ber_deep_tail")
    secs = time.perf_counter() - t0
    say("40 ber_deep_tail", f"{card}: 9 rows in {secs:.1f} s; " + ", ".join(
        f"{r['config']} {r['ben']}/{r['bits']} [{r['kernels']}]"
        for r in rows))


def tail_kernels_phase(card: str) -> None:
    """One 32M-bit call of each ber_deep_tail row (its first seed): the
    simulation's words and BEN (K7/K8 and the row's decode kernel) equal
    to the plain decode's on the same generated words on the card.  Then
    the other survivor mode on those words: the window's departures from
    the full store at this SNR, a measurement (not a check)."""
    parts = []
    for name in ber_deep_tail.CASES:
        r = ber_deep_tail.row_against_plain(name, "cuda")
        if r.got.shape != r.want.shape or not torch.equal(r.got, r.want) \
                or r.ben != r.plain_ben:
            raise AssertionError(
                f"{name}: the kernels' call (BEN {r.ben}) differs from "
                f"the plain decode (BEN {r.plain_ben}) on "
                f"{int((r.got != r.want).sum())} words")
        other = core_cuda.decode_packed_cuda(r.words, r.cfg, r.plan,
                                             window=not r.window)
        m = r.plan.message_len
        other_ben = int(count_errors(other, r.ref32, r.cfg.bits_per_pack, m))
        parts.append(f"{name} ({core_cuda.kernel_for(r.cfg, r.window).name})"
                     f" BEN {r.plain_ben}, "
                     f"{'full' if r.window else 'window'} {other_ben} "
                     f"({int((other != r.got).sum())} words differ)")
    say("40b tail rows vs plain", f"{card}: one {CALL_BITS}-bit call a row, "
        f"kernels == plain versions (words and BEN); " + "; ".join(parts))


def check_gen_ber_phase(card: str, runs: dict, tmp: Path) -> None:
    """scripts/check_gen_ber.py: K7 against the element chain at 0.0,
    0.5 and 1.0 dB, 32M bits each; exit 0 means the 25 % rule held."""
    rows, counts = script_rows(check_gen_ber, [], tmp)
    if [(r["snr_db"], r["generator"]) for r in rows] != [
            (s, g) for s in check_gen_ber.SNRS
            for g in check_gen_ber.GENERATORS]:
        raise AssertionError(f"check_gen_ber rows {rows}")
    n = len(check_gen_ber.SNRS)
    record_calls(runs, counts, Counter({"K7": n, "K1": 2 * n}),
                 "check_gen_ber")
    say("41 check_gen_ber", f"{card}: " + ", ".join(
        f"{r['snr_db']} dB {r['generator']} BEN {r['ben']}" for r in rows) +
        " (the 25 % rule held where both BERs exceed 1e-4)")


def fuzz_phase(card: str, runs: dict) -> None:
    """scripts/fuzz_gpu.py at its defaults (24 trials from seed 5000, 12
    window trials): every one bit-equal."""
    plain, window = fuzz_gpu.seeds()
    rc, text, counts = drive(None, lambda: fuzz_gpu.main([]))
    total = len(plain) + len(window)
    if rc != 0 or f"{total}/{total} trials OK" not in text:
        raise AssertionError(f"fuzz_gpu: rc {rc}")
    calls = Counter()
    for s in plain:
        calls[core_cuda.kernel_for(fuzz_gpu.trial_case(s)[0], False).name] += 1
    for s in window:
        cfg = fuzz_gpu.wtrial_case(s)[0]
        for w in (False, True):
            calls[core_cuda.kernel_for(cfg, w).name] += 1
    record_calls(runs, counts, calls, "fuzz_gpu")
    say("42 fuzz_gpu", f"{card}: {total}/{total} trials bit-equal (K1/K2 "
        f"== decode_packed_torch on random words, K3 == the full store on "
        f"coded streams); launches {dict(calls)}")


def profile_phase(card: str, runs: dict, tmp: Path) -> None:
    """--e2e-device at the headline with -v and --profile: the trace holds
    K7's and K1's launches (ranges under their names, and their kernels on
    the device).  Printed: the device-busy share over the whole traced
    call and over the -v steady-state call (generate .. count), each
    window's longest idle gap and the host ranges that cover it, the
    host's synchronize time, the kernels' times.  The profiler slows the
    host, so the steady call's kernel time is also set against the same
    call untraced (CUDA events, TURNS_UNTRACED calls)."""
    d = tmp / "profile"
    rc, text, counts = drive(["-n", str(HEADLINE_BITS), "-s", "5.5", "-i",
                              "s8", "--seed", str(SEED), "-v",
                              "--e2e-device", "--profile", str(d)])
    files = list(d.glob("*.pt.trace.json"))
    if rc != 0 or len(files) != 1:
        raise AssertionError(f"--profile: rc {rc}, traces {files}")
    record_calls(runs, counts, Counter({"K7": 2, "K1": 2}),
                 "--e2e-device --profile")
    whole = trace.summarize(files[0])
    steady = trace.summarize(files[0], between=("generate", "count"))
    ann = whole["annotations"]
    names = {trace.short_name(n) for n in whole["kernel_ms"]}
    if ann.get("K7") != 2 or ann.get("K1") != 2 or not all(
            any(n.endswith(k) for n in names)
            for k in ("::gen_words_kernel", "::viterbi_kernel")):
        raise AssertionError(f"--profile trace: ranges {ann}, kernels "
                             f"{sorted(names)}")
    fn, _ = build_sharded_simulation(HEADLINE, HEADLINE_BITS, snr_db=5.5,
                                     scale=CLI_SCALE, dec_len=DEC_LEN)
    untraced, _, _ = cuda_ms(lambda: fn(SEED), TURNS_UNTRACED)

    def line(s):
        host = ", ".join(f"{n} {ms:.4f}" for n, ms in s["gap_host"][:3])
        kern = Counter()
        for n, ms in s["kernel_ms"].items():
            kern[trace.short_name(n)] += ms
        return (f"window {s['window_ms']:.4f} ms, device busy "
                f"{s['busy_ms']:.4f} ms = {100 * s['busy_share']:.2f} %, "
                f"longest idle gap {s['gap_ms']:.4f} ms at +"
                f"{s['gap_at_ms']:.4f} ms (host: {host}), host in "
                f"synchronize {s['sync_ms']:.4f} ms; kernels " + ", ".join(
                    f"{n} {ms:.4f}" for n, ms in kern.most_common()))
    say("43 --profile", f"{card}: --e2e-device -n {HEADLINE_BITS} -s 5.5 "
        f"-i s8 -v --profile: trace {files[0].stat().st_size} bytes, ranges "
        f"K7 x2, K1 x2; whole call: {line(whole)}; steady call (generate "
        f".. count): {line(steady)}; the call untraced {untraced:.4f} ms "
        f"(median of {TURNS_UNTRACED}): its kernels' traced time is "
        f"{100 * steady['busy_ms'] / untraced:.2f} % of it")


# --- phases 44-46: the multi-rank checks (the JAX package's
# scripts/ber_sharded.py and ber_sharded_mp.py, pod_runbook.py and
# pod_decode_example.py) through their entry points on the card


def plain_digests(n: int, snrs) -> list:
    """The (one-device, split) word digests of each ber_sharded point at
    ``n`` bits, from the plain versions on the card (ViterbiGPU and
    decode_all_ranks with backend 'torch', the rows' own words)."""
    out = []
    for ch, _, _, _, packed in ber_sharded.workloads(n, snrs):
        cfg = DecoderConfig(ch)
        one, _ = ViterbiGPU(cfg, dec_len=ber_sharded.DEC_LEN,
                            backend="torch").run(packed, 2 * n)
        split, _ = split_blocks.decode_all_ranks(
            packed, 2 * n, cfg, ber_sharded.RANKS, "cuda",
            ber_sharded.DEC_LEN, backend="torch")
        out.append((ber_sharded.sha(one), ber_sharded.sha(split)))
    return out


def ber_sharded_phase(card: str, runs: dict, tmp: Path) -> None:
    """scripts/ber_sharded.py as 8 rank processes sharing the card (gloo):
    the 8 points at 400,000 bits and the _mp script's 4 at 200,000; every
    row within the 2 % check, each point's one-device and split words
    bit-equal to the plain version's on the card (``plain_digests``,
    computed in a thread of this process while the ranks run), each BEN
    printed beside the JAX run's count (bench/ber_sharded.json)."""
    t0 = time.perf_counter()
    recorded = json.loads((ROOT / "bench" / "ber_sharded.json").read_text())
    sizes = ((400_000, ber_sharded.SNRS), (200_000, ber_sharded.MP_SNRS))
    parts = []
    with ThreadPoolExecutor(1) as pool:
        plain = [pool.submit(plain_digests, n, snrs) for n, snrs in sizes]
        for (n, snrs), digests in zip(sizes, plain):
            out = tmp / f"ber_sharded_{n}.json"
            rc, _, _ = drive(None, lambda: ber_sharded.main([
                "-n", str(n), "--snrs", ",".join(map(str, snrs)), "--out",
                str(out)]))
            rows = json.loads(out.read_text())
            if rc != 0 or len(rows) != 2 * len(snrs):
                raise AssertionError(f"ber_sharded -n {n}: rc {rc}, rows "
                                     f"{rows}")
            points = [(ch.name, snr) for ch, _ in ber_sharded.CHANNELS
                      for snr in snrs]
            for row, (ch, snr), (one, split) in zip(rows, points,
                                                    digests.result()):
                if (row["channel"], row["snr_db"], row["devices"],
                        row["processes"], row["backend"], row["device"],
                        row["words_single"], row["words_sharded"]) != (
                        ch, snr, ber_sharded.RANKS, ber_sharded.RANKS,
                        "gloo", "cuda:0", one, split) or \
                        not row["within_2pct"]:
                    raise AssertionError(f"ber_sharded row {row} differs "
                                         f"from the plain versions on the "
                                         f"card")
                record_calls(runs, Counter(row["launches_rank0"]),
                             Counter({"K1": 2}),
                             f"ber_sharded {ch} {snr} dB, rank 0")
                jax = next(r for r in recorded if r["channel"] == ch and
                           r["snr_db"] == snr and r["bits"] == row["bits"])
                parts.append(
                    f"{ch} {snr} dB {row['bits']} bits: one device "
                    f"{row['ben_single']} [JAX "
                    f"{round(jax['ber_single'] * jax['bits'])}], split "
                    f"{row['ben_sharded']} [JAX "
                    f"{round(jax['ber_sharded'] * jax['sharded_bits'])}]")
    say("44 ber_sharded", f"{card}: 8 rank processes sharing the card "
        f"(gloo), {len(parts)} rows in {time.perf_counter() - t0:.1f} s, "
        f"each one-device and split decode (K1, the split's with its tail "
        f"halo) bit-equal to the plain versions on the card; BEN " +
        "; ".join(parts))


def runbook_report(argv, tmp: Path, tag: str):
    """pod_runbook.main(argv + --out) through drive(): (its report, the
    counts in this process, read_counts()'s).  It must exit 0 with every
    step passed."""
    out = tmp / f"runbook_{tag}.json"
    rc, _, _ = drive(None, lambda: pod_runbook.main([*argv, "--out",
                                                     str(out)]))
    counts = read_counts()              # with K1's tail-halo launches
    report = json.loads(out.read_text())
    if rc != 0 or not report["ok"] or list(report["steps"]) != [
            "bringup", "aligned_decode", "collective_census", "linearity"]:
        raise AssertionError(f"pod_runbook {tag}: rc {rc}, report {report}")
    return report, counts


def pod_runbook_phase(card: str, runs: dict, tmp: Path) -> None:
    """scripts/pod_runbook.py on the headline (32M bits a rank, dec_len
    2048): at one rank with nccl in this process, with --probe-smem (K9),
    every step passed and linearity timed beside K10's canary; then at 2
    rank processes sharing the card (gloo): the census the expected one,
    linearity 'modeled'."""
    report, counts = runbook_report(
        ["--coordinator", f"localhost:{launch.free_port()}",
         "--num-processes", "1", "--process-id", "0", "--probe-smem"],
        tmp, "one")
    steps = report["steps"]
    lin = steps["linearity"]
    if steps["bringup"]["backend"] != "nccl" or "ratio" not in lin or \
            not steps["aligned_decode"]["aligned"]:
        raise AssertionError(f"pod_runbook at one rank: {report}")
    # K1: the aligned decode, then 1 + LINEARITY_RUNS of the split and of
    # the one-rank decode; K4: the canary's one untimed and CANARY_REPS
    runs_k1 = 1 + 2 * (pod_runbook.LINEARITY_RUNS + 1)
    record(runs, counts, runs_k1, ["K1", HALO_ROWS[0]],
           "pod_runbook, one rank")
    record(runs, counts, 1, ["K9"], "pod_runbook --probe-smem")
    record(runs, {"K10": counts["K4"]}, 1, ["K10"], "pod_runbook canary")
    say("45 pod_runbook", f"{card}: one rank (nccl), --probe-smem: 4 steps "
        f"PASS; {steps['bringup']['cards']}; probed smem "
        f"{steps['bringup']['probed_smem_bytes']} bytes; aligned decode of "
        f"{steps['aligned_decode']['message_bits']} bits BEN "
        f"{steps['aligned_decode']['ben']}, bit-equal to the plain path; "
        f"linearity: split {lin['split_ms']} ms, one-rank decode "
        f"{lin['one_rank_ms']} ms (median of {lin['runs']}), "
        f"{lin['aggregate_gbps']} Gb/s aggregate, {lin['per_rank_gbps']} a "
        f"rank, ratio {lin['ratio']}, {lin['cards_for_100gbps']} cards for "
        f"100 Gb/s; canary {lin['canary_ns']} ns/stage/tile; launches K1 "
        f"{counts['K1']}, K9 {counts['K9']}, K4 (K10) {counts['K4']}")
    report, _ = runbook_report(["--ranks", "2"], tmp, "two")
    steps = report["steps"]
    if steps["bringup"]["backend"] != "gloo" or \
            steps["linearity"].get("modeled") is not True or \
            steps["collective_census"].get("skipped"):
        raise AssertionError(f"pod_runbook at two ranks: {report}")
    # rank 0: the aligned decode, the census' decode and simulation
    record_calls(runs, Counter(report["launches_rank0"]),
                 Counter({"K1": 3, "K7": 1}), "pod_runbook, two ranks, rank 0")
    say("45b pod_runbook", f"{card}: 2 rank processes sharing the card "
        f"(gloo): 4 steps PASS; aligned decode of "
        f"{steps['aligned_decode']['message_bits']} bits BEN "
        f"{steps['aligned_decode']['ben']}; census decoder "
        f"{steps['collective_census']['decoder']}, simulation "
        f"{steps['collective_census']['simulation']}; linearity modeled; "
        f"rank 0's launches {report['launches_rank0']}")


def pod_decode_example_phase(card: str, runs: dict, tmp: Path) -> None:
    """scripts/pod_decode_example.py at 32M bits, 5.5 dB, SOFT8 (scale
    32): in this process at one rank (K7 + K1) and as 2 rank processes
    sharing the card (gloo; K7 at each rank's offset, K1 with the tail
    halo), BEN 0 both."""
    argv = ["-n", str(HEADLINE_BITS), "-s", "5.5", "-i", "s8", "--seed",
            str(SEED)]
    out = tmp / "example_one.json"
    rc, _, counts = drive(None, lambda: pod_decode_example.main(
        [*argv, "--out", str(out)]))
    one = json.loads(out.read_text())
    if rc != 0 or one["ben"] or one["ranks"] != 1:
        raise AssertionError(f"pod_decode_example at one rank: rc {rc}, "
                             f"{one}")
    record_calls(runs, counts, Counter({"K7": 1, "K1": 1}),
                 "pod_decode_example, one rank")
    out = tmp / "example_two.json"
    res = launch.spawn_ranks(lambda r: [
        sys.executable, "-m", "tpu_viterbi_torch.scripts.pod_decode_example",
        *argv, "--out", str(out)], 2, "cuda", WORKER_WAIT_S)
    for line in res[0].out.splitlines():
        print(f"    | {line}")
    if launch.failed(res):
        raise AssertionError(f"pod_decode_example at two ranks failed: "
                             f"{[(r.rank, r.rc, r.err[-2000:]) for r in res]}")
    two = json.loads(out.read_text())
    if two["ben"] or (two["ranks"], two["backend"]) != (2, "gloo"):
        raise AssertionError(f"pod_decode_example at two ranks: {two}")
    record_calls(runs, Counter(two["launches_rank0"]),
                 Counter({"K7": 1, "K1": 1}),
                 "pod_decode_example, two ranks, rank 0")
    say("46 pod_decode_example", f"{card}: {one['bits']} bits at 5.5 dB "
        f"on one rank BEN 0 ({one['seconds'] * 1e3:.1f} ms, the first call "
        f"with the build), on 2 ranks sharing the card (gloo) BEN 0 over "
        f"{two['bits']} bits; launches one rank "
        f"{ {k: n for k, n in counts.items() if n} }, "
        f"rank 0 of two {two['launches_rank0']}")


def sweep_phase(tag: str, card: str, runs: dict, module, gen_calls: Counter):
    """A timing sweep's ``run`` at its full table on the card, each row said
    on one line beside the card, the counts set to 0 just before and read
    just after: each decode call launched its row's kernel once, and the
    generator launched ``gen_calls``.  -> (rows, launches, seconds)."""
    t0 = time.perf_counter()
    reset_counts()
    rows = module.run(device="cuda",
                      log=lambda msg: say(tag, f"{card}: {msg}"))
    counts = read_counts()
    calls = Counter(gen_calls)
    for r in rows:
        calls[r["kernel"]] += r["calls"]
    record_calls(runs, counts, calls, module.__name__.rsplit(".", 1)[1])
    return rows, dict(calls), time.perf_counter() - t0


def fastest(rows: list) -> dict:
    """{message_len: the dec_len of its row marked ``fastest``}."""
    return {r["message_len"]: r["dec_len"] for r in rows if r["fastest"]}


def channel_phase(card: str, runs: dict) -> None:
    """scripts/channel_throughput.py at the JAX workload (32M bits, 5.5 dB,
    seeds 7-12): every format at every candidate dec_len of the JAX
    script, each row's first call equal to the plain decode and its BER
    at most 1e-2 (run raises otherwise), JAX's pick where the TPU's VMEM
    put it, every row timed."""
    ct = channel_throughput
    tag = "47 channel_throughput"
    gen = Counter(genkernel.kernel_for(ChannelIn[name]).name
                  for name in ct.CHANNELS for _ in range(ct.N_INPUTS))
    rows, calls, secs = sweep_phase(tag, card, runs, ct, gen)
    want = [(name, dl) for name in ct.CHANNELS
            for dl in ct.candidates(DecoderConfig(ChannelIn[name]))]
    picks = {r["channel"]: r["dec_len"] for r in rows if r["jax_pick"]}
    if [(r["channel"], r["dec_len"]) for r in rows] != want or picks != {
            "HARD": 8192, "SOFT4": 8192, "SOFT8": 8192, "SOFT16": 4096,
            "FP32": 2048} or any(r["kernel_seconds"] is None for r in rows):
        raise AssertionError(f"channel_throughput rows {rows}")
    best = {c: min((r for r in rows if r["channel"] == c),
                   key=lambda r: r["kernel_seconds"]) for c in ct.CHANNELS}
    pick_ms = {r["channel"]: r["kernel_seconds"] * 1e3 for r in rows
               if r["jax_pick"]}
    say(tag, f"{card}: {len(rows)} rows in {secs:.1f} s, each first call "
        f"== the plain decode, BER <= {ct.MAX_BER}; fastest dec_len a "
        f"format " + ", ".join(
            f"{c} {r['dec_len']} ({r['kernel_seconds'] * 1e3:.4f} ms; "
            f"JAX's pick {picks[c]} {pick_ms[c]:.4f} ms)"
            for c, r in best.items()) + f"; launches {calls}")


def small_msg_phase(card: str, runs: dict) -> None:
    """scripts/small_msg_sweep.py at the JAX table and the card's short
    blocks: every row's first call equal to the plain decode (run raises
    otherwise), timed queued and, to 4M bits, replayed from a graph, which
    must capture on every such row (the kernels launch on the current
    stream); one fastest row a size."""
    sm = small_msg_sweep
    tag = "48 small_msg_sweep"
    rows, calls, secs = sweep_phase(tag, card, runs, sm, Counter())
    want = [(m, plan_blocks(m, 32, dl).dec_len, c)
            for m, dl, c in sm.row_table()]
    if [(r["message_len"], r["dec_len"], r["card_only"]) for r in rows] != \
            want or sum(r["fastest"] for r in rows) != len(sm.SIZES) + 1 \
            or any(r["message_len"] <= 4_000_000 and not r["graph_seconds"]
                   for r in rows):
        raise AssertionError(f"small_msg_sweep rows {rows}")
    say(tag, f"{card}: {len(rows)} rows in {secs:.1f} s, each first call "
        f"== the plain decode, every row to 4M bits replayed from a graph; "
        f"fastest dec_len a size (graph time to 4M bits, queued above) "
        f"{fastest(rows)}; non-positive slopes "
        f"{sum(bool(r.get('slope_nonpositive')) for r in rows)}; "
        f"launches {calls}")


def scaling_phase(card: str, runs: dict) -> None:
    """scripts/scaling_curve.py at the JAX sizes, 99,968 to 128M bits, at
    JAX's auto_dec_len and at 2048: every row's first call equal to the
    plain decode to 32M bits, BEN 0 on K7's 5.5-dB words at 64M and 128M
    (run raises otherwise)."""
    sc = scaling_curve
    tag = "49 scaling_curve"
    big = sum(m > sc.PLAIN_MAX_BITS for m, _, _ in sc.row_table())
    rows, calls, secs = sweep_phase(tag, card, runs, sc,
                                    Counter({"K7": big}))
    if [(r["message_len"], r["dec_len_policy"], r["dec_len"]) for r in
            rows] != sc.row_table() or sum(
                r.get("ben_at_5p5dB") == 0 for r in rows) != big or \
            any(r["message_len"] <= 4_000_000 and not r["graph_seconds"]
                for r in rows):
        raise AssertionError(f"scaling_curve rows {rows}")
    say(tag, f"{card}: {len(rows)} rows in {secs:.1f} s, each first call "
        f"== the plain decode to {sc.PLAIN_MAX_BITS} bits, BEN 0 at 5.5 dB "
        f"above; fastest dec_len a size (graph time to 4M bits, queued "
        f"above) {fastest(rows)}; launches {calls}")


def main() -> int:
    card = device_phase()
    build_phase()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    times, runs = {}, {}
    tally = new_tally()
    err = compare_phase(gen, tally)
    worst = window_compare_phase(gen, tally)
    worst.update(generator_compare_phase())
    main_path_phase(runs)
    err = max(err, noisy_chain_phase())
    k1_ms, plain_ms, k1_bound = timing_phase(card)
    k1_ab = int16_ab_phase("5b K1 A/B", card, gen, K1, K1_I32, HEADLINE,
                           False, extreme_words)
    k2_ab = int16_ab_phase("5c K2 A/B", card, gen, K2, K2_I32, FP32, False,
                           extreme_wire_values, "auto")
    k3_ab = int16_ab_phase("5d K3 A/B", card, gen, K3, K3_I32, HEADLINE,
                           True, extreme_words, "window")
    with tempfile.TemporaryDirectory() as tmp:
        serve_phase(Path(tmp), "s8", HEADLINE,
                    [([], "K1"), (["--survivor", "window"], "K3"),
                     (["--stream-words", "1048576"], "K1")], "soft8", runs)
        serve_phase(Path(tmp), "f", FP32, [([], "K2")], "fp32", runs)
        multi_file_phase(Path(tmp), card, runs)
    steady = e2e_phase(runs)
    staged_path_phase(runs)
    times.update(kernel_times_phase(card))
    times["K1"] = (k1_ms, plain_ms, err, k1_bound, None, k1_ab)
    times["K2"] += (None, k2_ab)
    times["K3"] += (None, k3_ab)
    gen_times, e2e = generator_times_phase(card)
    gen_ab = gen_ab_phase(card)
    for k, ch in (("K7", "SOFT8"), ("K8", "FP32")):
        gen_ab[k].update(in_graph_ms=e2e[f"{ch} cuda"],
                         old_in_graph_ms=e2e[f"{ch} cuda first design"])
    times.update({k: (*t, None, gen_ab[k]) for k, t in gen_times.items()})
    say("12 e2e summary", f"{card}: CLI steady-state lines {steady}; "
        f"simulate() medians {e2e} ms")
    staged_times = staged_times_phase(card)
    times.update({k: staged_times[k] for k in ("K4", "K5", "K6")})
    times["K9"] = hardware_phase(card, gen, runs)
    times["K11"] = op_cost_phase(card, runs)
    times["K10"] = canary_phase(card, runs)
    times["K12"] = layout_phase(card, runs)
    times["K13"] = ablation_phase(card, runs, times["K10"][0])
    times["K14"] = acs_variants_phase(card, runs)
    times["K15"] = ilp_phase(card, runs)
    times["K16"] = microbench_phase(card, runs)
    times["K17"] = dtype_phase(card, runs)
    times["K18"] = swar_phase(card, runs)
    times["K19"] = opt_bench_phase(card, runs)
    times["K20"] = genkernel_probe_phase(card, runs)
    times["K21"] = bench_profile_phase(card, runs)
    times["K22"] = bench_split_phase(card, runs)
    times["K23"] = staging_cost_phase(card, runs)
    times["K24"] = soft16_pieces_phase(card, runs)
    ud_reader_phase(gen, runs)
    times["K25"] = soft16_ablation_phase(card, runs)
    times["K26"] = transpose_phase(card, runs)
    times["K27"] = fp32_routes_phase(card, runs)
    times["K28"] = interleave_phase(card, runs)
    times.update(tail_halo_phase(card, gen))
    one_rank_out, split_ms = one_rank_split_phase(card, runs)
    times[HALO_ROWS[0]][5].update(split_ms)
    two_rank_phase(card, one_rank_out)
    with tempfile.TemporaryDirectory() as tmp:
        ber_deep_phase(card, runs, Path(tmp))
        ber_deep_tail_phase(card, runs, Path(tmp))
        tail_kernels_phase(card)
        check_gen_ber_phase(card, runs, Path(tmp))
        fuzz_phase(card, runs)
        profile_phase(card, runs, Path(tmp))
        ber_sharded_phase(card, runs, Path(tmp))
        pod_runbook_phase(card, runs, Path(tmp))
        pod_decode_example_phase(card, runs, Path(tmp))
    channel_phase(card, runs)
    small_msg_phase(card, runs)
    scaling_phase(card, runs)
    # launches a call, measured in the main-path runs: where the design
    # fixes it, it must be so (one a decode or a generation; the op-cost
    # ILP and dtype probes' two step counts, the layout, microbenchmark,
    # SWAR and 16-bit ACS probes' two array counts, of one warm-up and REPS
    # timed launches a variant; time_in_graph's one untimed and CANARY_REPS
    # timed); K9's is the search's, which depends on the card
    want = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
                          *HALO_ROWS), 1)
    want["K10"] = CANARY_REPS + 1
    want["K11"] = 2 * len(op_cost_probe.VARIANTS) * (op_cost_probe.REPS + 1)
    # K12: A and B at both grids at each lane count in turn, and C
    want["K12"] = 2 * (len(layout_probe.SPLIT) * len(TURNS) + 1) * (
        layout_probe.REPS + 1)
    # K13: every variant at both counts at each lane count in turn; K19
    # likewise at every lt, then i16 at the counts between at each lane
    # count; K25 every variant at both counts and s16/unpack at the counts
    # between at each lane count
    want["K13"] = 2 * len(kernel_ablation.VARIANTS) * len(TURNS) * (
        kernel_ablation.REPS + 1)
    # K14 every variant at each lane count in turn; K16 likewise at both
    # counts
    want["K14"] = len(acs_variants_bench.VARIANTS) * len(TURNS) * (
        acs_variants_bench.REPS + 1)
    want["K15"] = 2 * len(ilp_probe.OCCUPANCIES) * len(ilp_probe.CHAINS) * \
        (ilp_probe.REPS + 1)
    want["K16"] = 2 * len(kernel_microbench.VARIANTS) * len(TURNS) * (
        kernel_microbench.REPS + 1)
    want["K17"] = 2 * len(dtype_throughput.OCCUPANCIES) * len(
        dtype_throughput.DTYPES) * (dtype_throughput.REPS + 1)
    want["K18"] = 2 * len(swar_probe.VARIANTS) * len(TURNS) * (
        swar_probe.REPS + 1)
    want["K19"] = (2 * len(opt_bench.LTS) * len(opt_bench.VARIANTS) *
                   len(TURNS) + len(opt_bench.CROSSOVER_ARRAYS) *
                   len(LANES)) * (opt_bench.REPS + 1)
    # K20: tf, the 3 known answers and log_sqrt, then each rate (queued,
    # and GRAPH_CALLS captured); K21-K24:
    # one warm-up and PIECE_RUNS timed calls a piece (K21: K6 + 3 K1 pieces
    # a dec_len; K22: K6, K4, K6 + K4, and the kernel piece's staging; K23:
    # the roll variant at each lane count in turn; K24: 2 pieces and the BEN
    # call a configuration)
    runs_a_piece = PIECE_RUNS + 1
    want["K20"] = 5 + len(genkernel_probe.ROUNDS_LIST) * len(
        genkernel_probe.REPS_LIST) * (
            genkernel_probe.REPS * genkernel_probe.LAUNCHES_A_SAMPLE + 1 +
            genkernel_probe.GRAPH_CALLS)
    want["K21"] = len(bench_profile.DEC_LENS) * 4 * runs_a_piece
    want["K22"] = 4 * runs_a_piece + 1
    want["K23"] = len(TURNS) * runs_a_piece
    want["K24"] = len(soft16_pieces.CONFIGS) * (2 * runs_a_piece + 1)
    # K26: torch + consume, each tiling and the consumer, one warm-up and
    # REPS timed each, and each tiling's GRAPH_CALLS captured; K27: the
    # check's 4 decodes, then one warm-up and RUNS timed calls a decoding
    # route; K28: the check's one launch a variant, then the JAX shape
    # (regs, smem and concat at each lane count in turn, shfl once) and the
    # full grid (each variant once)
    want["K25"] = (2 * len(soft16_ablation.VARIANTS) + len(
        soft16_ablation.CROSSOVER_PROGRAMS)) * len(LANES) * (
            soft16_ablation.REPS + 1)
    want["K26"] = (len(transpose_bench.TILINGS) + 2) * (
        transpose_bench.REPS + 1) + len(transpose_bench.TILINGS) * \
        transpose_bench.GRAPH_CALLS
    want["K27"] = 4 + sum(kind != "staging" for *_, kind in
                          fp32_fused_value_probe.ROUTES) * (
        fp32_fused_value_probe.RUNS + 1)
    want["K28"] = len(interleave_bench.VARIANTS) + (
        len(interleave_bench.SPLIT) * len(TURNS) + 1 +
        len(interleave_bench.VARIANTS)) * (interleave_bench.RUNS + 1)
    rows = [(k.name, str(k.source.relative_to(ROOT))) for k in KERNELS
            if k not in AB_ONLY]
    rows += [(name, str(K1.source.relative_to(ROOT)))
             for name in ("K10", "K21", "K22", "K24", "K27", *HALO_ROWS)]
    rows.sort(key=lambda r: (int(r[0][1:].split()[0]), r[0]))
    per_call = {name: launches_per_call(runs, name, want.get(name))
                for name, _ in rows}
    # a row's extra keys (K1's, K2's and K3's A/B, K7's and K8's, K20's and
    # K26's graph readings, K26's consumer) ride in times[name][5]; none
    # may take the place of a key of the contract
    kernels = []
    for name, source in rows:
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": REPLACES[name], "launches": per_call[name][0],
               "launches_per_call": per_call[name][1],
               "max_abs_err": max(times[name][2], worst.get(name, 0)),
               "ms": times[name][0], "plain_ms": times[name][1],
               "bound_ms": times[name][3][0], "bound_by": times[name][3][1],
               "library_ms": times[name][4] if len(times[name]) > 4
               else None}
        extra = times[name][5] if len(times[name]) > 5 else {}
        if row.keys() & extra.keys():
            raise AssertionError(f"{name}'s extra keys "
                                 f"{sorted(row.keys() & extra.keys())} "
                                 f"would replace the row's own")
        kernels.append({**row, **extra})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
