"""BPSK map + AWGN channel (reference: src/viterbiDF.h:66-95, AddNoise).

Conventions kept exactly:
  - BPSK: bit 1 -> +1.0, bit 0 -> -1.0 (viterbiDF.h:81-92);
  - noise stddev sigma = 10^(-SNR/5), the project's own SNR convention set by
    the reference main program (main.cpp:135);
  - sigma = inf (or 0) means noiseless passthrough (viterbiDF.h:79-85).
The noise comes from a seeded ``torch.Generator`` on the device.
"""

from __future__ import annotations

import math

import torch

from ..hardware import resolve_device
from .pipeline import ComputeElement


def snr_to_sigma(snr_db: float) -> float:
    """sigma = 10^(-SNR/5) (reference: main.cpp:135)."""
    return float(10.0 ** (-snr_db / 5.0))


def bpsk(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.float32) * 2.0 - 1.0


def add_awgn(generator: torch.Generator, coded_bits: torch.Tensor,
             sigma: float) -> torch.Tensor:
    """Map coded bits to +-1.0 and add N(0, sigma^2); sigma in {0, inf}
    disables noise."""
    symbols = bpsk(coded_bits)
    if sigma == 0.0 or math.isinf(sigma):
        return symbols
    noise = torch.randn(symbols.shape, generator=generator,
                        device=symbols.device, dtype=torch.float32)
    return symbols + noise * sigma


class AddNoise(ComputeElement):
    def __init__(self, sigma: float = math.inf, seed: int = 0,
                 device="cuda"):
        super().__init__()
        self.sigma = float(sigma)
        self.generator = torch.Generator(device=resolve_device(device))
        self.generator.manual_seed(seed)

    def process(self, coded_bits):
        # the generator advances: repeated pipe.run() draws fresh noise
        return add_awgn(self.generator, coded_bits, self.sigma)
