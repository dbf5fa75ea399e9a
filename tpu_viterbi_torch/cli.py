"""Command-line entry point for the simulation chain: the same flags and
output lines as the JAX package's CLI and the reference CLI (reference:
src/main.cpp:174-264 parseArg, :14-172 main/runPipeline), so runs are
drop-in comparable.

Usage:  python -m tpu_viterbi_torch -n 1000000 -s 5.5 -i s8 -m b32 -v

The chain runs on the GPU when there is one (kernel K1 decodes), else on
the CPU with the plain torch core.  File serving, the in-graph e2e mode
and profiling are not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .chain import (AddNoise, ConvolutionalEncoder, RandBitGen,
                    SoftDecisionPacker, snr_to_sigma)
from .chain.decoder_element import ViterbiDecoder
from .config import (ChannelIn, CompMode, ConfigResolutionError, DecodeOut,
                     DecoderConfig, Metric)
from .utils.bits import count_bit_errors

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
    p.add_argument("-n", "--num", type=int, default=32_000_000,
                   help="message length (default 32000000)")
    p.add_argument("-s", "--snr", type=float, default=15.0,
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
                   help="'cuda' = kernel K1 (needs a GPU); 'torch' = the "
                        "plain torch core; 'auto' = K1 on a GPU, else the "
                        "torch core on the CPU")
    p.add_argument("--survivor", choices=["auto", "full", "window"],
                   default="auto",
                   help="survivor-buffer mode: 'window' = the reference's "
                        "one-pointer circular buffer (viterbi.cu:99-100), "
                        "which needs the not yet ported kernel K3")
    return p.parse_args(argv)


def run_pipeline(message_len: int, snr: float, cfg: DecoderConfig,
                 verbose: bool = False, seed=None, dec_len=None,
                 backend: str = "auto", survivor: str = "auto",
                 device=None):
    """Build and run the full chain; returns (BEN, pipeline, decoded_words)
    with the decoded int32 words left on the device.
    (reference: main.cpp:119-172 runPipeline)"""
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % (2 ** 31))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    kwargs = {"dec_len": dec_len} if dec_len else {}
    viterbi = ViterbiDecoder(cfg, backend=backend, survivor=survivor,
                             device=device, **kwargs)
    rand_gen = RandBitGen(message_len, seed=seed, device=device)
    conv_enc = ConvolutionalEncoder()
    noise = AddNoise(snr_to_sigma(snr), seed=seed + 1, device=device)
    packer = SoftDecisionPacker(cfg.channel_in, scale=40000.0)

    pipe = rand_gen.probe() | conv_enc | noise | packer | viterbi
    result = pipe.run()

    if verbose:
        print()
        pipe.print_status()
        print()

    decoded = result.final_output
    gen_bits = result.probed_outputs[0]
    ben = count_bit_errors(decoded, cfg.bits_per_pack, gen_bits, cfg.extra_l)
    return ben, pipe, decoded


def main(argv=None) -> int:
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

    if cfg.get_message_len(2 * args.num) <= 0:
        print(f"Error: message length {args.num} too short — no decodable "
              f"bits after the {cfg.extra_l}+{cfg.extra_r}-bit overlap-save "
              f"framing.", file=sys.stderr)
        return 1

    if args.verbose:
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
        ben, _, _ = run_pipeline(args.num, args.snr, cfg,
                                 verbose=args.verbose, seed=args.seed,
                                 dec_len=args.dec_len, backend=args.backend,
                                 survivor=args.survivor)
    except ConfigResolutionError as e:
        # flag combinations the resolved backend cannot honor (no GPU for
        # --backend cuda, a kernel not ported yet): reference-style error
        # line; any other error is a real bug and keeps its traceback
        print(f"Error: {e}", file=sys.stderr)
        return -1
    ber = ben / args.num

    print("Pipeline executed.")
    print(f"Final results -> BEN: {ben}   BER: {ber:g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
