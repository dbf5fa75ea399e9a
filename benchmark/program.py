"""The system under test: the entries of ``tpu_viterbi_torch`` that the
kinds drive, set up from a configuration file.  The only module of the
benchmark, with the kinds, that imports the program; the reference and the
yardstick never do.
"""

from __future__ import annotations

from tpu_viterbi_torch import (ChannelIn, CompMode, DecodeOut, DecoderConfig,
                               Metric, ViterbiGPU)
from tpu_viterbi_torch.sharding.simulate import build_sharded_simulation


def decoder_config(config: dict) -> DecoderConfig:
    """The program's option word from a configuration file's names."""
    return DecoderConfig(ChannelIn[config["channel_in"]],
                         Metric[config["metric"]],
                         DecodeOut[config["decode_out"]],
                         CompMode[config["comp_mode"]])


def decoder(config: dict, input_num: int, device) -> ViterbiGPU:
    """The receiver's decoder, pre-sized for ``input_num`` coded values
    (its kernel built and its plan made before the first call)."""
    return ViterbiGPU(decoder_config(config), input_num=input_num,
                      dec_len=config["dec_len"],
                      survivor=config["survivor"], device=device)


def simulation(config: dict, traffic: dict, device):
    """-> (simulate(seed) -> (bit-error count, decoded words), decoded
    bits): the in-graph simulation of ``traffic``'s message."""
    return build_sharded_simulation(
        decoder_config(config), traffic["message_bits"],
        snr_db=traffic["snr_db"], scale=config["scale"],
        dec_len=config["dec_len"], generator=traffic["generator"],
        survivor=config["survivor"], device=device, return_output=True)
