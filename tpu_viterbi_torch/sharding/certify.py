"""The recipe that certifies the sharded decode (the counterpart of
``tpu_viterbi/sharding/certify.py``): a coded workload
(``coded_workload``) through ``run_sharded`` on a ``BlockMesh``.
``run_sharded`` is the per-rank step of ``blocks.decode_sharded``, which
the tests, the multi-process worker and ``chip_smoke.py`` run, so the
framing and fill contract that certifies the decode is the one that they
run.

The workload is drawn as the JAX recipe draws it (numpy's generator:
message bits, then the noise), encoded by ``conv_encode_np`` and packed by
the port's ``quantize_and_pack``, so for one seed both packages decode the
same words.
"""

from __future__ import annotations

import numpy as np
import torch

from ..chain.encode import conv_encode_np
from ..chain.quantize import quantize_and_pack
from ..config import ChannelIn
from .blocks import run_sharded

__all__ = ["coded_workload", "run_sharded"]


def coded_workload(n_bits: int, sigma: float, seed: int,
                   channel: ChannelIn = ChannelIn.SOFT8,
                   scale: float = 32.0):
    """(message bits, packed channel words) for ``n_bits`` message bits
    through encode -> BPSK -> AWGN(sigma) -> quantize/pack, both numpy.
    Coded input is required where windowed and full-store survivors are
    compared: on random words the two legitimately differ."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_bits).astype(np.uint8)
    sym = 2 * conv_encode_np(bits).astype(np.float32) - 1
    if sigma:
        sym = sym + rng.normal(0, sigma, sym.shape).astype(np.float32)
    packed = quantize_and_pack(torch.from_numpy(sym), channel, scale)
    return bits, packed.numpy()
