"""Pipeline adapter wrapping ViterbiGPU as a ComputeElement
(reference: src/viterbiDF.h:170-209, ViterbiDecoder<options>)."""

from __future__ import annotations

from ..config import DecoderConfig
from ..decoder.api import DEFAULT_DEC_LEN, ViterbiGPU
from .pipeline import ComputeElement


class ViterbiDecoder(ComputeElement):
    def __init__(self, config: DecoderConfig = DecoderConfig(),
                 dec_len: int = DEFAULT_DEC_LEN, backend: str = "auto",
                 survivor: str = "auto", device="cuda"):
        super().__init__()
        self.viterbi = ViterbiGPU(config, dec_len=dec_len, backend=backend,
                                  survivor=survivor, device=device)
        self.config = config

    def process(self, packed):
        # inputNum = packed words x values-per-word (viterbiDF.h:190); the
        # stream and the decoded words stay on the device
        input_num = packed.shape[0] * self.config.enc_data_per_pack
        out, kernel_s = self.viterbi.run_on_device(packed, input_num)
        self.set_status("kernel time", kernel_s)
        message_len = self.config.get_message_len(input_num)
        if kernel_s > 0:
            self.set_status("throughput",
                            f"{message_len / kernel_s / 1e9:.3f} Gb/s")
        return out

    def get_status_string(self, key: str) -> str:
        # deliberately NOT the generic pipeline formatting: this reproduces
        # the reference's exact us/ms/s pretty-print for this one status key
        # (viterbiDF.h:197-208) so CLI output stays drop-in comparable
        if key == "kernel time":
            ms = self.status[key] * 1e3
            if ms < 1.0:
                return f"{ms * 1000.0:.3f} us"
            if ms < 1000.0:
                return f"{ms:.3f} ms"
            return f"{ms / 1000.0:.3f} s"
        return super().get_status_string(key)
