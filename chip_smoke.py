"""Smoke run of the PyTorch/CUDA port on one GPU: builds kernels K1, K2, K3
(decode) and K7, K8 (workload generator) from the checkout into one library
(one nvcc per source, started together, one link), holds each against its
plain PyTorch version, drives the simulation chain, the file-serving paths
(one-shot, windowed, streamed, FP32, several files) and the in-graph
simulation (--e2e-device: SOFT8, FP32, windowed, and a noisy run) through
the port's CLI at the reference's default size, and times each kernel
against its plain version and the in-graph simulation end to end.

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
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
if not (ROOT / "tpu_viterbi_torch" / "csrc" / "viterbi.cu").is_file():
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(tpu_viterbi_torch/ is not beside it)")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from tpu_viterbi_torch import ViterbiGPU, cli  # noqa: E402
from tpu_viterbi_torch.chain import (AddNoise, ConvolutionalEncoder,  # noqa: E402
                                     RandBitGen, SoftDecisionPacker,
                                     genkernel, snr_to_sigma,
                                     unpack_to_soft)
from tpu_viterbi_torch.chain.decoder_element import ViterbiDecoder  # noqa: E402
from tpu_viterbi_torch.config import (ChannelIn, DecodeOut,  # noqa: E402
                                      DecoderConfig)
from tpu_viterbi_torch.decoder import core_cuda  # noqa: E402
from tpu_viterbi_torch.decoder.core_torch import (  # noqa: E402
    decode_blocks_torch, decode_packed_torch, needs_int32_renorm,
    plan_blocks)
from tpu_viterbi_torch.sharding.simulate import (  # noqa: E402
    DEFAULT_SCALES, build_sharded_simulation)
from tpu_viterbi_torch.utils.bits import (count_bit_errors,  # noqa: E402
                                          pack_msb_first)

HEADLINE_BITS = 32_000_000          # the reference's default -n (main.cpp:176)
HEADLINE = DecoderConfig(ChannelIn.SOFT8)   # SOFT8, int32 metrics, b32 packs
FP32 = DecoderConfig(ChannelIn.FP32)
DEC_LEN = 2048                      # ViterbiGPU.DEFAULT_DEC_LEN
SEED = 7
K1, K2, K3 = core_cuda.K1, core_cuda.K2, core_cuda.K3
K7, K8 = genkernel.K7, genkernel.K8
KERNELS = core_cuda.KERNELS + genkernel.KERNELS
REPLACES = {"K1": "tpu_viterbi/decoder/core_pallas.py:638",
            "K2": "tpu_viterbi/decoder/core_pallas.py:683",
            "K3": "tpu_viterbi/decoder/core_pallas.py:440",
            "K7": "tpu_viterbi/chain/genkernel.py:157",
            "K8": "tpu_viterbi/chain/genkernel.py:294"}
CLI_SCALE = 40000.0                 # the CLI's channel scale (main.cpp:137)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def device_phase():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the smoke "
                           "run needs a CUDA GPU and never falls back to "
                           "the CPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0].strip()
    say("1 device", f"{torch.cuda.get_device_name(0)} x "
                    f"{torch.cuda.device_count()}; torch {torch.__version__} "
                    f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    return card


def build_phase():
    """One nvcc per source, all started together, and one link build the
    library of the five kernels; each binds its entry point."""
    t0 = time.perf_counter()
    for k in KERNELS:
        k.build()
    secs = time.perf_counter() - t0
    log = core_cuda.build_log or ""
    regs = sorted(set(re.findall(r"Used (\d+) registers", log)), key=int)
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
    sources = sorted({str(k.source.relative_to(ROOT)) for k in KERNELS})
    say("2 build", f"{', '.join(k.name for k in KERNELS)} built from "
                   f"{' + '.join(sources)} and bound in {secs:.2f} s "
                   f"(registers per thread {regs or 'cached'}, spill stores "
                   f"{spills or '-'})")


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


def compare_phase(gen) -> int:
    """K1 against decode_blocks_torch on the same CUDA tensors."""
    cases = []
    for ch in (ChannelIn.HARD, ChannelIn.SOFT4, ChannelIn.SOFT8,
               ChannelIn.SOFT16):
        for out in (DecodeOut.O_B32, DecodeOut.O_B16):
            cfg = DecoderConfig(ch, decode_out=out)
            bpp = cfg.bits_per_pack
            for dl in (32, 96, 2048):       # below 64, overlap > 0, default
                cases.append((cfg, plan_blocks(dl * 300 - bpp, bpp, dl)))
            cases.append((cfg, plan_blocks(DEC_LEN, bpp, DEC_LEN)))  # 1 block
    soft16 = DecoderConfig(ChannelIn.SOFT16)
    cases.append((soft16, plan_blocks(16384 * 40, 32, 16384)))     # renorm
    worst, n_renorm, n_single, n_overlap = 0, 0, 0, 0
    for cfg, plan in cases:
        x = random_words(cfg, plan, gen)
        got = K1(x, cfg, plan)
        torch.cuda.synchronize()
        want = decode_blocks_torch(x, cfg, plan)
        err = max_abs_diff(got, want)
        if got.shape != want.shape or err:
            raise AssertionError(
                f"K1 disagrees with its plain version: {cfg.channel_in.name}"
                f" b{cfg.bits_per_pack} dec_len {plan.dec_len} blocks "
                f"{plan.num_blocks}: max |diff| {err}")
        worst = max(worst, err)
        n_renorm += needs_int32_renorm(cfg, plan)
        n_single += plan.num_blocks == 1
        n_overlap += plan.overlap_bits > 0
    if not (n_renorm and n_single and n_overlap):
        raise AssertionError("comparison cases miss a framing edge")
    say("3 kernel vs plain", f"K1 bit-equal to core_torch on {len(cases)} "
        f"plans (HARD/SOFT4/SOFT8/SOFT16 x b32/b16 x dec_len 32/96/2048, "
        f"{n_single} single-block, {n_overlap} with overlap, {n_renorm} "
        f"with int32 renorm at dec_len 16384); max |diff| {worst}")
    return worst


def drive(argv):
    """Run the port's CLI in this process with every kernel's launch count
    set to 0 just before, and read the counts just after.  Returns (rc,
    stdout, {kernel name: launches})."""
    for k in KERNELS:
        k.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in KERNELS}
    text = buf.getvalue()
    for line in text.splitlines():
        if line.strip():
            print(f"    | {line}")
    return rc, text, counts


def main_path_phase() -> int:
    """The port's CLI at the reference's default size, in this process."""
    rc, text, counts = drive(["-n", str(HEADLINE_BITS), "-s", "5.5", "-i",
                              "s8", "-m", "b32", "--seed", str(SEED), "-v"])
    launches = counts["K1"]
    m = re.search(r"Final results -> BEN: (\d+)\s+BER: (\S+)", text)
    if rc != 0 or m is None:
        raise AssertionError(f"CLI main path failed: rc {rc}")
    if int(m.group(1)) != 0:
        raise AssertionError(f"BEN {m.group(1)} at 5.5 dB (expected 0)")
    if launches < 1:
        raise AssertionError("the main path never launched K1")
    say("4 main path", f"cli.main -n {HEADLINE_BITS} -s 5.5 -i s8 -m b32 "
        f"--seed {SEED}: rc 0, BEN 0, K1 launches {launches}")
    return launches


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


def cuda_ms(fn, runs: int):
    ts = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts), ts, out


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
    say("5 times", f"{card}: headline {plan.message_len} bits SOFT8 b32 "
        f"dec_len {plan.dec_len} ({threads} blocks = threads, "
        f"{-(-threads // 64)} CUDA blocks of 64 on {sms} SMs): K1 median "
        f"{k1_ms:.4f} ms of {[round(t, 4) for t in k1_all]} = "
        f"{plan.message_len / k1_ms / 1e6:.2f} Gb/s decoded; core_torch "
        f"median {plain_ms:.1f} ms of {[round(t, 1) for t in plain_all]} "
        f"({plain_ms / k1_ms:.0f}x); outputs bit-equal")
    return k1_ms, plain_ms


def window_compare_phase(gen) -> int:
    """K2 (FP32, full store) and K3 (every channel, window) against
    decode_blocks_torch on the same CUDA tensors.  Random words: the
    windowed decode is held against the plain windowed core, not against
    the full store, from which it legitimately differs on noise."""
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
    for cfg, plan, window in cases:
        x = random_words(cfg, plan, gen)
        k = core_cuda.kernel_for(cfg, window)
        got = k(x, cfg, plan)
        torch.cuda.synchronize()
        want = decode_blocks_torch(x, cfg, plan, window)
        err = max_abs_diff(got, want)
        if got.shape != want.shape or err:
            raise AssertionError(
                f"{k.name} disagrees with its plain version: "
                f"{cfg.channel_in.name} b{cfg.bits_per_pack} dec_len "
                f"{plan.dec_len} blocks {plan.num_blocks}: max |diff| {err}")
        worst[k.name] = max(worst[k.name], err)
        n_plans[k.name] += 1
    say("3b kernel vs plain", f"K2 bit-equal to core_torch on "
        f"{n_plans['K2']} FP32 plans (b32/b16 x dec_len 32/96/2048 with "
        f"overlap, and a single block; wire of N(0, 81) values with 5 % NaN "
        f"and 2 % each of +-inf); max |diff| {worst['K2']}")
    say("3c kernel vs plain", f"K3 bit-equal to the plain windowed core on "
        f"{n_plans['K3']} plans (HARD/SOFT4/SOFT8/SOFT16/FP32 x b32/b16 x "
        f"dec_len 32/96/224/2048, random words); max |diff| "
        f"{worst['K3']}")
    return worst


def source_words(cfg, n_bits: int, seed: int) -> np.ndarray:
    """The words a decode without error gives for the CLI's message of
    n_bits drawn from ``seed``: message bits extra_l .. extra_l + m packed
    MSB first (the source is the chain's own RandBitGen)."""
    bits = RandBitGen(n_bits, seed=seed, device="cuda").process(None)
    m = cfg.get_message_len(2 * n_bits)
    return pack_msb_first(bits[cfg.extra_l: cfg.extra_l + m].cpu().numpy(),
                          cfg.bits_per_pack)


def serve_phase(tmp: Path, flag: str, cfg, runs, tag: str):
    """Emit the headline stream through cli.main, then decode it back with
    --decode-file once per ``runs`` entry (extra flags, the kernel that
    must carry it); every .dec must equal the source's words."""
    emit = tmp / f"{tag}.bin"
    rc, text, counts = drive(["-n", str(HEADLINE_BITS), "-s", "5.5", "-i",
                              flag, "--seed", str(SEED), "--emit-file",
                              str(emit)])
    if rc != 0 or "BEN: 0 " not in text:
        raise AssertionError(f"{tag}: the emitting run failed (rc {rc})")
    want = source_words(cfg, HEADLINE_BITS, SEED)
    launches = {}
    for i, (extra, kernel) in enumerate(runs):
        out = tmp / f"{tag}_{i}.dec"
        rc, text, counts = drive(["-i", flag, "--decode-file", str(emit),
                                  "--out-file", str(out), "-v", *extra])
        got = np.fromfile(out, dtype=np.uint32)
        if rc != 0 or not np.array_equal(got, want):
            raise AssertionError(f"{tag} {extra}: rc {rc}, .dec differs from "
                                 f"the source's words")
        if counts[kernel] < 1:
            raise AssertionError(f"{tag} {extra}: {kernel} never launched")
        launches[kernel] = max(launches.get(kernel, 0), counts[kernel])
        say(f"6 serve {tag}", f"--decode-file {' '.join(extra) or '(full)'}"
            f": rc 0, {got.size} words byte-equal to the source's, BEN 0; "
            f"launches {counts}")
    emit.unlink()
    return launches


def multi_file_phase(tmp: Path, card: str):
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
    if rc != 0 or m is None or counts["K1"] != 4:
        raise AssertionError(f"multi-file decode failed: rc {rc}, {counts}")
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
    pipe = (RandBitGen(HEADLINE_BITS, seed=seed, device="cuda")
            | ConvolutionalEncoder()
            | AddNoise(snr_to_sigma(5.5), seed=seed + 1, device="cuda")
            | SoftDecisionPacker(cfg.channel_in, scale=40000.0))
    packed = pipe.run().final_output
    input_num = packed.shape[0] * cfg.enc_data_per_pack
    return packed, plan_blocks(cfg.get_message_len(input_num),
                               cfg.bits_per_pack, DEC_LEN)


def kernel_times_phase(card: str):
    """K2 at the 32M-bit FP32 headline and K3 at the SOFT8 headline, CUDA
    events, each beside its plain version on the same stream."""
    times = {}
    for kernel, cfg, window in ((K2, FP32, False), (K3, HEADLINE, True)):
        packed, plan = headline_packed(cfg, 21)
        kernel(packed, cfg, plan)                            # warm-up
        k_ms, k_all, k_out = cuda_ms(lambda: kernel(packed, cfg, plan), 5)
        decode_blocks_torch(packed, cfg, plan, window)       # warm-up
        p_ms, p_all, p_out = cuda_ms(
            lambda: decode_blocks_torch(packed, cfg, plan, window), 3)
        err = max_abs_diff(k_out, p_out)
        if err:
            raise AssertionError(f"headline shape: {kernel.name} and its "
                                 f"plain version differ (max |diff| {err})")
        times[kernel.name] = (k_ms, p_ms, err)
        say("8 times", f"{card}: {kernel.name} at {plan.message_len} bits "
            f"{cfg.channel_in.name} b32 dec_len {plan.dec_len}"
            f"{' window' if window else ''}: median {k_ms:.4f} ms of "
            f"{[round(t, 4) for t in k_all]} = "
            f"{plan.message_len / k_ms / 1e6:.2f} Gb/s decoded; plain median "
            f"{p_ms:.1f} ms of {[round(t, 1) for t in p_all]} "
            f"({p_ms / k_ms:.0f}x); outputs bit-equal")
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
        kernel = K8 if ch == ChannelIn.FP32 else K7
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


def e2e_phase():
    """--e2e-device through cli.main at the reference's default size:
    SOFT8 (K7 + K1), FP32 (K8 + K2), --survivor window (K7 + K3), each BEN 0
    at 5.5 dB; then a noisy 4M-bit run whose BER must lie in the decoder's
    band.  Returns ({generator kernel: launches of its first run},
    {run: (steady-state ms, Gb/s) of the CLI's -v line})."""
    launches, steady = {}, {}
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
        if counts[gk] < 1 or counts[dk] < 1:
            raise AssertionError(f"--e2e-device {tag}: {gk} or {dk} never "
                                 f"launched ({counts})")
        launches.setdefault(gk, counts[gk])
        steady[tag] = (float(st.group(1)), float(st.group(2)))
        say("10 e2e", f"cli.main -n {HEADLINE_BITS} -s 5.5 --seed {SEED} "
            f"--e2e-device {' '.join(extra)}: rc 0, BEN 0; launches {counts}")
    n = 4_000_000
    rc, text, counts = drive(["-n", str(n), "-s", "1.125", "-i", "s8",
                              "--seed", str(SEED), "--e2e-device"])
    m = re.search(r"Final results -> BEN: (\d+)\s", text)
    if rc != 0 or m is None or counts["K7"] < 1 or counts["K1"] < 1:
        raise AssertionError(f"noisy --e2e-device failed: rc {rc}, {counts}")
    ber = int(m.group(1)) / n
    # the band of phase 4b: scale 40000 saturates SOFT8 to hard decisions;
    # a generator that forgets the noise gives 0, a broken decode ~0.5
    if not 5e-4 < ber < 5e-3:
        raise AssertionError(f"noisy --e2e-device BER {ber:g} out of band")
    say("10b noisy e2e", f"--e2e-device -n {n} -s 1.125 -i s8: BEN "
        f"{m.group(1)} BER {ber:g}; launches {counts}")
    return launches, steady


def generator_times_phase(card: str):
    """K7 (SOFT8) and K8 at the headline (32M bits, 5.5 dB, the CLI's scale)
    beside their plain version, CUDA events; then the in-graph simulation
    end to end per call with each generator."""
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
        times[kernel.name] = (k_ms, p_ms, err)
        n_out = got[1].numel()
        say("11 times", f"{card}: {kernel.name} at {HEADLINE_BITS} bits "
            f"{ch.name} 5.5 dB ({n_out} {'values' if cfg is FP32 else 'words'}"
            f", {got[0].numel()} bit packs): median {k_ms:.4f} ms of "
            f"{[round(t, 4) for t in k_all]} = "
            f"{HEADLINE_BITS / k_ms / 1e6:.2f} Gb/s generated; plain median "
            f"{p_ms:.1f} ms of {[round(t, 1) for t in p_all]} "
            f"({p_ms / k_ms:.0f}x)")
    e2e = {}
    for generator in ("cuda", "torch"):
        fn, m = build_sharded_simulation(HEADLINE, HEADLINE_BITS, snr_db=5.5,
                                         scale=CLI_SCALE, generator=generator,
                                         device="cuda")
        fn(SEED)
        ms, all_ms, ben = cuda_ms(lambda: fn(SEED + 1), 5)
        if int(ben) != 0:
            raise AssertionError(f"e2e generator {generator}: BEN {int(ben)}")
        e2e[generator] = ms
        say("11 e2e", f"{card}: in-graph simulation, generator {generator}, "
            f"SOFT8 b32 {HEADLINE_BITS} bits 5.5 dB: median {ms:.4f} ms of "
            f"{[round(t, 4) for t in all_ms]} per call = "
            f"{m / ms / 1e6:.3f} Gb/s e2e; BEN 0")
    return times, e2e


def main() -> int:
    card = device_phase()
    build_phase()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    err = compare_phase(gen)
    worst = window_compare_phase(gen)
    worst.update(generator_compare_phase())
    launches = {"K1": main_path_phase()}
    err = max(err, noisy_chain_phase())
    k1_ms, plain_ms = timing_phase(card)
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(serve_phase(
            Path(tmp), "s8", HEADLINE,
            [([], "K1"), (["--survivor", "window"], "K3"),
             (["--stream-words", "1048576"], "K1")], "soft8"))
        launches.update(serve_phase(Path(tmp), "f", FP32, [([], "K2")],
                                    "fp32"))
        multi_file_phase(Path(tmp), card)
    gen_launches, steady = e2e_phase()
    launches.update(gen_launches)
    times = kernel_times_phase(card)
    times["K1"] = (k1_ms, plain_ms, err)
    gen_times, e2e = generator_times_phase(card)
    times.update(gen_times)
    say("12 e2e summary", f"{card}: CLI steady-state lines {steady}; "
        f"simulate() medians {e2e} ms")
    print(json.dumps({"kernels": [{
        "name": k.name, "route": "cuda",
        "source": str(k.source.relative_to(ROOT)),
        "replaces": REPLACES[k.name], "launches": launches[k.name],
        "max_abs_err": max(times[k.name][2], worst.get(k.name, 0)),
        "ms": times[k.name][0], "plain_ms": times[k.name][1]}
        for k in KERNELS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
