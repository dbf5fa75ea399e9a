"""tpu_viterbi_torch — the PyTorch/CUDA port of ``tpu_viterbi``.

The K=7 rate-1/2 convolutional code SDR chain (bit source -> encoder ->
AWGN -> quantize/pack -> decode -> BER) in plain PyTorch, with the
block-parallel decoder's fused unpack + branch metric + add-compare-select
+ traceback written by hand in CUDA C++ for Hopper (kernels K1-K5, with the
staging transpose K6, ``csrc/``), a streaming decoder, file serving, the
values-in entry, and the in-graph simulation whose workload generators
K7/K8 are CUDA C++ too.  Module names mirror the
JAX package's, so each
counterpart sits at the same relative path.  Imports torch and numpy,
never jax.
"""

from .config import (ChannelIn, CompMode, ConfigResolutionError, DecodeOut,
                     DecoderConfig, Metric, from_reference, options_valid)
from .decoder.api import ViterbiGPU

__all__ = [
    "ChannelIn", "CompMode", "ConfigResolutionError", "DecodeOut",
    "DecoderConfig", "Metric", "from_reference", "options_valid",
    "ViterbiGPU",
]

__version__ = "0.1.0"
