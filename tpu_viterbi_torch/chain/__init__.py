from .channel import AddNoise, add_awgn, bpsk, snr_to_sigma
from .encode import ConvolutionalEncoder, conv_encode, conv_encode_np
from .pipeline import ComputeElement, Pipeline, PipelineResult
from .quantize import (SoftDecisionPacker, quantize_and_pack,
                       quantize_fields, unpack_to_soft)
from .source import RandBitGen, random_bits

__all__ = [
    "AddNoise", "add_awgn", "bpsk", "snr_to_sigma",
    "ConvolutionalEncoder", "conv_encode", "conv_encode_np",
    "ComputeElement", "Pipeline", "PipelineResult",
    "SoftDecisionPacker", "quantize_and_pack", "quantize_fields",
    "unpack_to_soft",
    "RandBitGen", "random_bits",
]
