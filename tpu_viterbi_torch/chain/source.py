"""Random message-bit source (reference: src/viterbiDF.h:20-33, RandBitGen).

Bits come from a seeded ``torch.Generator`` on the decoding device, in
place of the JAX package's threefry keys and the reference's mt19937:
parity is statistical (the same Bernoulli(1/2) bit stream), and the seed
makes runs deterministic (reference: main.cpp:132 fixed-seed mode).
"""

from __future__ import annotations

import torch

from ..hardware import resolve_device
from .pipeline import ComputeElement


def random_bits(generator: torch.Generator, n: int) -> torch.Tensor:
    """(n,) uint8 tensor of uniform bits on the generator's device."""
    return torch.randint(0, 2, (n,), generator=generator,
                         device=generator.device, dtype=torch.uint8)


class RandBitGen(ComputeElement):
    def __init__(self, n: int, seed: int = 0, device="cuda"):
        super().__init__()
        self.n = int(n)
        self.generator = torch.Generator(device=resolve_device(device))
        self.generator.manual_seed(seed)

    def process(self, data):
        del data
        # the generator advances: repeated pipe.run() draws fresh messages
        return random_bits(self.generator, self.n)
