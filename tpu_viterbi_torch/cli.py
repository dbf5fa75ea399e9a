"""Command-line entry point for the simulation chain: the same flags and
output lines as the JAX package's CLI and the reference CLI (reference:
src/main.cpp:174-264 parseArg, :14-172 main/runPipeline), so runs are
drop-in comparable.

Usage:  python -m tpu_viterbi_torch -n 1000000 -s 5.5 -i s8 -m b32 -v
        python -m tpu_viterbi_torch -i s8 --decode-file stream.bin -v
        python -m tpu_viterbi_torch -n 32000000 -s 5.5 -i s8 --e2e-device -v

The chain, the file decodes and the in-graph simulation (--e2e-device:
kernels K7/K8 generate, K1, K2 or K3 decode, the error count stays on the
device) run on the GPU; with --device cpu they run the plain torch
versions on the CPU.  Without a GPU and without --device cpu the CLI
refuses to run.  Launched under ``torchrun`` (WORLD_SIZE > 1),
--e2e-device runs over every rank (sharding/: each rank generates and
decodes its shard, the count is all-reduced) and only rank 0 prints:

        torchrun --nproc-per-node 2 -m tpu_viterbi_torch -n 1000000 \
            -s 5.5 -i s8 --seed 3 --e2e-device -v --device cpu

--profile DIR writes a torch.profiler trace of the run (the chain, the
file decodes or --e2e-device) into DIR as a Chrome trace, with the
kernels' launches under their names (K1 ... K8).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from .chain import (AddNoise, ConvolutionalEncoder, RandBitGen,
                    SoftDecisionPacker, snr_to_sigma)
from .chain.decoder_element import ViterbiDecoder
from .config import (ChannelIn, CompMode, ConfigResolutionError, DecodeOut,
                     DecoderConfig, Metric)
from .decoder.api import DEFAULT_DEC_LEN, ViterbiGPU
from .decoder.streaming import StreamingViterbi
from .hardware import resolve_device
from .utils.bits import count_bit_errors
from .utils.profile import ProfileError, Trace

_CHANNEL_NAMES = {"HARD": ChannelIn.HARD, "h": ChannelIn.HARD,
                  "SOFT4": ChannelIn.SOFT4, "s4": ChannelIn.SOFT4,
                  "SOFT8": ChannelIn.SOFT8, "s8": ChannelIn.SOFT8,
                  "SOFT16": ChannelIn.SOFT16, "s16": ChannelIn.SOFT16,
                  "FP32": ChannelIn.FP32, "f": ChannelIn.FP32}
_METRIC_NAMES = {"b16": Metric.M_B16, "b32": Metric.M_B32,
                 "f16": Metric.M_FP16}
_OUTPUT_NAMES = {"b16": DecodeOut.O_B16, "b32": DecodeOut.O_B32}
_COMP_NAMES = {"REG": CompMode.REG, "reg": CompMode.REG,
               "DPX": CompMode.DPX, "dpx": CompMode.DPX}

_CHANNEL_PRETTY = {ChannelIn.HARD: "Hard Decision",
                   ChannelIn.SOFT4: "4-bit Soft Decision",
                   ChannelIn.SOFT8: "8-bit Soft Decision",
                   ChannelIn.SOFT16: "16-bit Soft Decision",
                   ChannelIn.FP32: "32-bit Floating Point"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="tpu_viterbi_torch",
        description="Viterbi decoder simulation chain on PyTorch/CUDA")
    p.add_argument("-n", "--num", type=int, default=None,
                   help="message length (default 32000000)")
    p.add_argument("-s", "--snr", type=float, default=None,
                   help="SNR in dB (sigma = 10^(-SNR/5); default 15.0)")
    p.add_argument("-i", "--input", choices=sorted(_CHANNEL_NAMES),
                   default="HARD", help="input channel type")
    p.add_argument("-m", "--metric", choices=sorted(_METRIC_NAMES),
                   default="b32", help="metric type")
    p.add_argument("-o", "--output", choices=sorted(_OUTPUT_NAMES),
                   default="b32", help="output pack type")
    p.add_argument("-c", "--compMode", choices=sorted(_COMP_NAMES),
                   default="reg", help="computation mode")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--seed", type=int, default=None,
                   help="fixed seed for deterministic runs")
    p.add_argument("--dec-len", default=None,
                   type=lambda s: s if s == "auto" else int(s),
                   help="output bits decoded per block (int, or 'auto' "
                        "for the JAX package's message-size-aware choice)")
    p.add_argument("--backend", choices=["auto", "cuda", "torch"],
                   default="auto",
                   help="'cuda' = the CUDA kernels K1/K2/K3 (needs "
                        "--device cuda); 'torch' = the plain torch core; "
                        "'auto' = the kernels on --device cuda, the torch "
                        "core on --device cpu")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where everything runs: 'cuda' = the GPU (refused "
                        "when there is none); 'cpu' = the plain torch "
                        "versions on the CPU")
    p.add_argument("--survivor", choices=["auto", "full", "window"],
                   default="auto",
                   help="survivor-buffer mode: 'window' = the reference's "
                        "one-pointer circular buffer (viterbi.cu:99-100); "
                        "'auto' uses it when the full store would take "
                        "more than half of the GPU's total memory")
    p.add_argument("--decode-file", metavar="PATH", default=None,
                   nargs="+",
                   help="decode real packed channel stream(s) from PATH(s) "
                        "instead of simulating: raw little-endian words in "
                        "the getInputSize layout (int32 for HARD/SOFT*, "
                        "float32 for FP32; viterbi.cu:64-84), inputNum "
                        "derived from the file size exactly as the "
                        "reference adapter does (viterbiDF.h:190); several "
                        "files decode back to back through one decoder")
    p.add_argument("--out-file", metavar="PATH", default=None,
                   help="with a single --decode-file: where to write the "
                        "packed decoded words (uint32 for -o b32, uint16 "
                        "for b16; default <decode-file>.dec)")
    p.add_argument("--emit-file", metavar="PATH", default=None,
                   help="simulation mode: also write the packed channel "
                        "stream the chain produced to PATH, in the exact "
                        "format --decode-file reads back")
    p.add_argument("--stream-words", type=int, default=None, metavar="N",
                   help="with --decode-file: decode in chunks of N packed "
                        "words through the streaming decoder "
                        "(decoder/streaming.py overlap-save carry) — "
                        "fixed host memory for arbitrarily long files, "
                        "bit-identical output to the one-shot decode; N "
                        "must be a multiple of 1024")
    p.add_argument("--e2e-device", action="store_true",
                   help="run the whole chain (generate -> decode -> BER) "
                        "on the device; only the error count leaves it "
                        "(sharding/simulate.py)")
    p.add_argument("--generator", choices=["auto", "cuda", "torch"],
                   default="auto",
                   help="with --e2e-device: in-graph workload generator — "
                        "'cuda' = fused counter-mode kernels K7/K8 "
                        "(chain/genkernel.py), 'torch' = element chain, "
                        "'auto' = cuda on --device cuda, torch on --device "
                        "cpu")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run to DIR as "
                        "a Chrome trace (*.pt.trace.json): CPU activity, "
                        "and CUDA activity on --device cuda (the "
                        "reference's -lineinfo/Nsight analog)")
    return p.parse_args(argv)


def _too_short(path: str, n_words: int, cfg: DecoderConfig,
               input_num=None) -> int:
    bits = "" if input_num is None else f" ({input_num} encoded bits)"
    print(f"Error: {path} holds {n_words} words{bits} — no decodable bits "
          f"after the {cfg.extra_l}+{cfg.extra_r}-bit overlap-save "
          f"framing.", file=sys.stderr)
    return 1


def _file_words(path: str, in_dtype):
    """Words in the channel file at ``path``, or None (after an error
    line) when it cannot be read or is not a whole number of words — a
    truncated or corrupt capture is refused, not decoded short."""
    try:
        size = os.path.getsize(path)
    except OSError as e:
        print(f"Error: cannot read {path}: {e}", file=sys.stderr)
        return None
    item = np.dtype(in_dtype).itemsize
    if size % item:
        print(f"Error: {path} holds {size} bytes, not a whole number of "
              f"{item}-byte {np.dtype(in_dtype).name} words (truncated or "
              f"corrupt channel file).", file=sys.stderr)
        return None
    return size // item


def _stream_decode_one(args, cfg: DecoderConfig, sv: StreamingViterbi,
                       path: str, n_words: int):
    """--decode-file --stream-words N: chunked decode of one file through
    the overlap-save streaming decoder (decoder/streaming.py) — fixed host
    memory at any file size, output bit-identical to the one-shot decode
    of the same stream.  A stream too short to decode is refused before
    the output file is opened, and a read that fails midway removes the
    partial output.  Returns (rc, decoded_bits)."""
    in_dtype = np.float32 if cfg.channel_in == ChannelIn.FP32 else np.int32
    if cfg.get_message_len(n_words * cfg.enc_data_per_pack) <= 0:
        return _too_short(path, n_words, cfg), 0
    out_path = args.out_file or path + ".dec"
    emitted_words = n_chunks = 0
    try:
        with open(path, "rb") as fi, open(out_path, "wb") as fo:
            while True:
                buf = np.fromfile(fi, dtype=in_dtype,
                                  count=args.stream_words)
                if buf.size == 0:
                    break
                n_chunks += 1
                out = sv.push(buf)
                out.tofile(fo)
                emitted_words += out.size
            out = sv.flush()
            out.tofile(fo)
            emitted_words += out.size
    except OSError as e:
        if os.path.exists(out_path):
            os.remove(out_path)
        print(f"Error: cannot stream {path}: {e}", file=sys.stderr)
        return 1, 0
    if args.verbose:
        print(f"Input file: {path} ({n_words} words in {n_chunks} chunks "
              f"of {args.stream_words})")
    print("Decode executed.")
    print(f"Final results -> {emitted_words * cfg.bits_per_pack} bits "
          f"decoded to {out_path} "
          f"({emitted_words * (cfg.bits_per_pack // 8)} bytes)")
    return 0, emitted_words * cfg.bits_per_pack


def run_decode_file(args, cfg: DecoderConfig) -> int:
    """--decode-file: serve real decodes — read packed channel words, run
    the decoder, write packed output words.  The one mode with no
    simulated ground truth, so it reports size + kernel time instead of
    BEN/BER.  Every file is checked before any is decoded, and all of them
    go through ONE decoder: one ViterbiGPU, or one StreamingViterbi with
    --stream-words."""
    in_dtype = np.float32 if cfg.channel_in == ChannelIn.FP32 else np.int32
    sizes = []
    for path in args.decode_file:
        n = _file_words(path, in_dtype)
        if n is None:
            return 1
        sizes.append(n)
    dec_len = args.dec_len or DEFAULT_DEC_LEN

    if args.stream_words:
        sv = StreamingViterbi(cfg, dec_len=dec_len, backend=args.backend,
                              survivor=args.survivor, device=args.device)
        total_bits = 0
        for path, n in zip(args.decode_file, sizes):
            rc, bits = _stream_decode_one(args, cfg, sv, path, n)
            if rc != 0:
                return rc
            total_bits += bits
        if len(args.decode_file) > 1 and args.verbose:
            print(f"{len(args.decode_file)} files, {total_bits} bits total")
        return 0

    dec = ViterbiGPU(cfg, dec_len=dec_len, backend=args.backend,
                     survivor=args.survivor, device=args.device)
    if len(args.decode_file) > 1 and len(set(sizes)) == 1:
        # equal-sized files queue back to back through run_stream
        # (sustained serving: no synchronize between decodes)
        input_num = sizes[0] * cfg.enc_data_per_pack
        m = cfg.get_message_len(input_num)
        if m <= 0:
            return _too_short(args.decode_file[0], sizes[0], cfg)
        raws = [np.fromfile(path, dtype=in_dtype)
                for path in args.decode_file]
        outs, per = dec.run_stream(raws, input_num, want_time=args.verbose)
        for path, out in zip(args.decode_file, outs):
            out.tofile(path + ".dec")
            print("Decode executed.")
            print(f"Final results -> {m} bits decoded to {path}.dec "
                  f"({out.nbytes} bytes)")
        if args.verbose and per:
            print(f"{len(outs)} files queued back to back: "
                  f"{per * 1e3:.3f} ms/file sustained "
                  f"({m / per / 1e9:.3f} Gb/s)")
        return 0

    total_bits = 0
    for path, n in zip(args.decode_file, sizes):
        # inputNum = packed words x values-per-word (viterbiDF.h:190)
        input_num = n * cfg.enc_data_per_pack
        m = cfg.get_message_len(input_num)
        if m <= 0:
            return _too_short(path, n, cfg, input_num)
        raw = np.fromfile(path, dtype=in_dtype)
        if args.verbose:
            print(f"Input file: {path} ({n} words, {input_num} encoded "
                  f"bits, {m} message bits)")
        out, kernel_s = dec.run(raw, input_num)
        out_path = args.out_file or path + ".dec"
        out.tofile(out_path)
        if args.verbose:
            # reference kernel-time pretty-print (viterbiDF.h:197-208)
            ms = kernel_s * 1e3
            t = (f"{ms * 1e3:.3f} us" if ms < 1.0 else
                 f"{ms:.3f} ms" if ms < 1000.0 else f"{ms / 1e3:.3f} s")
            print(f"Kernel time: {t}  ({m / kernel_s / 1e9:.3f} Gb/s)")
        print("Decode executed.")
        print(f"Final results -> {m} bits decoded to {out_path} "
              f"({out.nbytes} bytes)")
        total_bits += m
    if len(args.decode_file) > 1 and args.verbose:
        print(f"{len(args.decode_file)} files, {total_bits} bits total")
    return 0


def world_size() -> int:
    """The ranks ``torchrun`` launched this process among (WORLD_SIZE),
    1 without it."""
    return int(os.environ.get("WORLD_SIZE") or 1)


def e2e_simulation(cfg: DecoderConfig, num: int, snr: float, scale: float,
                   seed=None, dec_len=None, generator: str = "auto",
                   survivor: str = "auto", device="cuda",
                   coordinator=None, num_processes=None, process_id=None):
    """The in-graph simulation of --e2e-device, built and called once:
    on one device (``device``), or over every rank of the process group
    when there are ranks to join (WORLD_SIZE > 1, as torchrun sets it, or
    ``coordinator`` and ``num_processes`` given; sharding/mesh.py picks
    the collective library: nccl when each rank has a card of its own,
    gloo on the CPU or on a shared card), every rank drawing rank 0's
    seed.  ``seed`` None draws one.  -> (BEN of the first call, the
    simulate function, m, the mesh or None, the seed, the first call's
    seconds, the kernel build included)."""
    from .sharding.mesh import initialize_distributed, make_block_mesh
    from .sharding.simulate import build_sharded_simulation

    device = resolve_device(device)
    if generator == "cuda" and device.type != "cuda":
        raise ConfigResolutionError(
            f"generator='cuda' needs a CUDA device (--device {device})")
    mesh = None
    if world_size() > 1 or (num_processes or 1) > 1:
        initialize_distributed(coordinator, num_processes, process_id,
                               device=device)
        mesh = make_block_mesh(device)
        device = mesh.device
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2 ** 31))
    if mesh is not None:                 # every rank draws rank 0's seed
        seed = int(mesh.broadcast(torch.tensor(seed)))
    t0 = time.perf_counter()
    fn, m = build_sharded_simulation(
        cfg, num, snr_db=snr, scale=scale,
        dec_len=dec_len or DEFAULT_DEC_LEN, generator=generator,
        survivor=survivor, device=device, mesh=mesh)
    ben = int(fn(seed))
    return ben, fn, m, mesh, seed, time.perf_counter() - t0


def run_e2e_device(args, cfg: DecoderConfig) -> int:
    """--e2e-device: the in-graph simulation on one device (--device), or,
    launched under torchrun (WORLD_SIZE > 1), over every rank's
    (``e2e_simulation``).  Same final output lines as the pipeline path;
    -v adds the first call's time, the kernel build included, and one
    steady-state call's, between CUDA events on a GPU."""
    ben, fn, m, mesh, seed, first_s = e2e_simulation(
        cfg, args.num, args.snr, 40000.0, args.seed, args.dec_len,
        args.generator, args.survivor, args.device)
    if args.verbose:
        over = "1 device(s)" if mesh is None else (
            f"{mesh.size} rank(s) (torch.distributed backend "
            f"{mesh.backend})")
        print(f"\nIn-graph chain over {over}: {m} bits decoded")
        print(f"  - first call (includes the kernel build): {first_s:.2f} s")
        if resolve_device(args.device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ben2 = fn(seed + 1)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            ben2 = fn(seed + 1)
            dt = time.perf_counter() - t0
        print(f"  - steady-state per call: {dt * 1e3:.1f} ms "
              f"({m / dt / 1e9:.3g} Gb/s e2e)   [BEN {int(ben2)}]\n")
    print("Pipeline executed.")
    print(f"Final results -> BEN: {ben}   BER: {ben / args.num:g}")
    return 0


def run_pipeline(message_len: int, snr: float, cfg: DecoderConfig,
                 verbose: bool = False, seed=None, dec_len=None,
                 backend: str = "auto", survivor: str = "auto",
                 device="cuda", emit_file=None):
    """Build and run the full chain; returns (BEN, pipeline, decoded_words)
    with the decoded int32 words left on the device.  ``emit_file``: also
    write the packed channel stream there, as --decode-file reads it.
    (reference: main.cpp:119-172 runPipeline)"""
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2 ** 31))
    kwargs = {"dec_len": dec_len} if dec_len else {}
    viterbi = ViterbiDecoder(cfg, backend=backend, survivor=survivor,
                             device=device, **kwargs)
    rand_gen = RandBitGen(message_len, seed=seed, device=device)
    conv_enc = ConvolutionalEncoder()
    noise = AddNoise(snr_to_sigma(snr), seed=seed + 1, device=device)
    packer = SoftDecisionPacker(cfg.channel_in, scale=40000.0)

    if emit_file:
        packer.probe()   # capture the packed stream mid-pipeline
    pipe = rand_gen.probe() | conv_enc | noise | packer | viterbi
    result = pipe.run()
    if emit_file:
        # raw little-endian words in the getInputSize layout, exactly what
        # --decode-file reads back (probed_outputs[1]: the packer sits
        # after the probed source)
        result.probed_outputs[1].cpu().numpy().tofile(emit_file)

    if verbose:
        print()
        pipe.print_status()
        print()

    decoded = result.final_output
    gen_bits = result.probed_outputs[0]
    ben = count_bit_errors(decoded, cfg.bits_per_pack, gen_bits, cfg.extra_l)
    return ben, pipe, decoded


def main(argv=None) -> int:
    """The CLI; under torchrun (WORLD_SIZE > 1) only rank 0 writes to
    standard output."""
    if world_size() > 1 and int(os.environ.get("RANK") or 0) != 0:
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            return _main(argv)
    return _main(argv)


def _main(argv=None) -> int:
    args = parse_args(argv)
    cfg_fields = dict(channel_in=_CHANNEL_NAMES[args.input],
                      metric=_METRIC_NAMES[args.metric],
                      decode_out=_OUTPUT_NAMES[args.output],
                      comp_mode=_COMP_NAMES[args.compMode])

    # runtime validity checks with the reference's error strings
    # (main.cpp:26-41), mirroring config.options_valid on purpose
    ci, mt = cfg_fields["channel_in"], cfg_fields["metric"]
    if mt == Metric.M_B16 and ci == ChannelIn.SOFT16:
        print("Error: 16-bit metric does not support 16-bit soft decision "
              "input.", file=sys.stderr)
        return -1
    if mt == Metric.M_FP16 and ci == ChannelIn.SOFT16:
        print("Error: fp16 metric does not support 16-bit soft decision "
              "input.", file=sys.stderr)
        return -1
    if mt == Metric.M_FP16 and ci == ChannelIn.SOFT8:
        print("Error: fp16 metric does not support 8-bit soft decision "
              "input.", file=sys.stderr)
        return -1
    if mt == Metric.M_FP16 and cfg_fields["comp_mode"] == CompMode.DPX:
        print("Error: fp16 metric does not support DPX computation mode.",
              file=sys.stderr)
        return -1

    cfg = DecoderConfig(**cfg_fields)

    if args.decode_file:
        # file mode is a real decode — the simulation knobs make no sense
        # here; reject rather than silently ignore (OptionsValid
        # philosophy, viterbi.h:22-41)
        for bad, flag in ((args.num is not None, "-n/--num"),
                          (args.snr is not None, "-s/--snr"),
                          (args.seed is not None, "--seed"),
                          (args.emit_file is not None, "--emit-file"),
                          (args.e2e_device, "--e2e-device"),
                          (args.generator != "auto", "--generator")):
            if bad:
                print(f"Error: {flag} is not applicable with --decode-file "
                      "(the file IS the channel stream).", file=sys.stderr)
                return -1
        if args.out_file is not None and len(args.decode_file) > 1:
            print("Error: --out-file takes a single output path; with "
                  "several --decode-file inputs each writes <file>.dec.",
                  file=sys.stderr)
            return -1
        if args.stream_words is not None and (
                args.stream_words <= 0 or args.stream_words % 1024):
            print("Error: --stream-words must be a positive multiple "
                  "of 1024 (whole-pack alignment across chunks for "
                  "every channel width).", file=sys.stderr)
            return -1
    elif args.stream_words is not None:
        print("Error: --stream-words requires --decode-file.",
              file=sys.stderr)
        return -1
    elif args.out_file is not None:
        print("Error: --out-file requires --decode-file (simulation mode "
              "verifies in memory; use --emit-file to dump its packed "
              "stream).", file=sys.stderr)
        return -1
    # the in-graph path has no per-element backend and keeps its channel
    # stream on the device: reject those flags rather than ignore them;
    # conversely --generator only exists in-graph
    if args.e2e_device:
        if args.backend != "auto":
            print("Error: --backend is not applicable with --e2e-device "
                  "(the in-graph simulation selects its decode kernel via "
                  "--survivor / device-memory fit).", file=sys.stderr)
            return -1
        if args.emit_file is not None:
            print("Error: --emit-file is not applicable with --e2e-device "
                  "(the in-graph channel stream never leaves the device; "
                  "emit from the pipeline path instead).", file=sys.stderr)
            return -1
    elif args.generator != "auto":
        print("Error: --generator requires --e2e-device (the pipeline path "
              "always uses the host element chain).", file=sys.stderr)
        return -1
    if args.num is None:
        args.num = 32_000_000        # reference default (main.cpp:176)
    if args.snr is None:
        args.snr = 15.0              # reference default (main.cpp:177)

    if not args.decode_file and cfg.get_message_len(2 * args.num) <= 0:
        print(f"Error: message length {args.num} too short — no decodable "
              f"bits after the {cfg.extra_l}+{cfg.extra_r}-bit overlap-save "
              f"framing.", file=sys.stderr)
        return 1

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        # no card and no --device cpu: refused, never run on the CPU
        print(f"Error: {e}.", file=sys.stderr)
        return -1

    if args.verbose:
        if not args.decode_file:
            print(f"Message Length: {args.num}")
            print(f"SNR: {args.snr} dB")
        print(f"Input Channel Type: {_CHANNEL_PRETTY[cfg.channel_in]}")
        metric_pretty = {"M_B16": "16-bit", "M_B32": "32-bit",
                         "M_FP16": "FP16"}[cfg.metric.name]
        print(f"Metric Type: {metric_pretty}")
        out_pretty = "16-bit" if cfg.decode_out == DecodeOut.O_B16 else "32-bit"
        print(f"Output Type: {out_pretty}")
        comp_pretty = "Regular" if cfg.comp_mode == CompMode.REG else "DPX"
        print(f"Computation Mode: {comp_pretty}")
        print()

    try:
        # the trace wraps the same runs as the JAX CLI's (cli.py:470-486)
        trace = Trace(args.profile, resolve_device(args.device)) \
            if args.profile else contextlib.nullcontext()
        with trace:
            if args.decode_file:
                return run_decode_file(args, cfg)
            if args.e2e_device:
                return run_e2e_device(args, cfg)
            ben, _, _ = run_pipeline(args.num, args.snr, cfg,
                                     verbose=args.verbose, seed=args.seed,
                                     dec_len=args.dec_len,
                                     backend=args.backend,
                                     survivor=args.survivor,
                                     device=args.device,
                                     emit_file=args.emit_file)
    except (ConfigResolutionError, ProfileError) as e:
        # flag combinations the resolved backend cannot honor (--backend
        # or --generator cuda with --device cpu), a trace that cannot be
        # taken or written: reference-style error line; any other error is
        # a real bug and keeps its traceback
        print(f"Error: {e}", file=sys.stderr)
        return -1
    ber = ben / args.num

    print("Pipeline executed.")
    print(f"Final results -> BEN: {ben}   BER: {ber:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
