"""Public decoder API: the GPU counterpart of ``tpu_viterbi``'s ViterbiTPU,
itself the analog of the reference's ViterbiCUDA class (reference:
src/viterbi/viterbi.h:91-152, src/viterbi/viterbi.cu:210-238).

Surface kept: constructor (optionally pre-sized), ``run(input, input_num)``
returning packed decoded words plus a kernel time, and the size calculators
``get_input_size`` / ``get_message_len`` / ``get_output_size``.  The
framing constants live on the DecoderConfig.

``run`` copies the packed input to the device, then times only the decode
launch between two CUDA events, as the reference times its kernel
(viterbi.cu:224-232): host-to-device copies stay outside the timed region.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import ChannelIn, ConfigResolutionError, DecoderConfig
from .core_cuda import K1, check_supported
from .core_torch import (BlockPlan, assemble_output, auto_dec_len,
                         decode_blocks_torch, plan_blocks)

# kept equal to the JAX package's default so both stacks frame messages
# alike; the GPU's own default awaits a measurement on the card
DEFAULT_DEC_LEN = 2048

BACKENDS = ("auto", "cuda", "torch")
SURVIVORS = ("auto", "full", "window")


class ViterbiGPU:
    """Block-parallel Viterbi decoder on a CUDA device (or the CPU)."""

    def __init__(self, config: DecoderConfig = DecoderConfig(),
                 input_num: Optional[int] = None,
                 dec_len: int = DEFAULT_DEC_LEN,
                 backend: str = "auto",
                 survivor: str = "auto",
                 device=None):
        """backend: 'auto' | 'cuda' | 'torch' — 'auto' launches kernel K1
        on a CUDA device and runs the plain torch core on the CPU; 'cuda'
        requires a GPU; 'torch' runs the plain core on either device.

        survivor: 'auto' | 'full' | 'window' — 'auto' and 'full' keep the
        full survivor store; 'window' (the reference's one-pointer circular
        buffer, viterbi.cu:99-100) needs kernel K3 and raises until it is
        ported.

        device: where decoding runs; default the GPU when there is one."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if survivor not in SURVIVORS:
            raise ValueError(f"survivor must be one of {SURVIVORS}, "
                             f"got {survivor!r}")
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        if backend == "cuda" and (self.device.type != "cuda"
                                  or not torch.cuda.is_available()):
            raise ConfigResolutionError(
                f"backend='cuda' needs a CUDA device (device={device!r}, "
                f"torch.cuda.is_available()={torch.cuda.is_available()})")
        self.config = config
        self.dec_len = dec_len if dec_len == "auto" else int(dec_len)
        self.backend = backend
        self.survivor = survivor
        self.use_kernel = self.device.type == "cuda" and backend != "torch"
        if self.use_kernel:
            check_supported(config, survivor)
        elif survivor == "window":
            raise ConfigResolutionError(
                "survivor='window' needs CUDA kernel K3; the plain torch "
                "core always stores the full survivor history")
        self._plan_cache: Tuple[int, BlockPlan] = (-1, None)
        if input_num is not None:
            # pre-sizing hook (reference pre-allocating ctor,
            # viterbi.cu:31-36): plan now, and build the kernel
            self.plan(input_num)
            if self.use_kernel:
                K1.build()

    # --- size API (reference: viterbi.cu:64-92) ---
    def get_input_size(self, input_num: int) -> int:
        return self.config.get_input_size(input_num)

    def get_message_len(self, input_num: int) -> int:
        return self.config.get_message_len(input_num)

    def get_output_size(self, input_num: int) -> int:
        return self.config.get_output_size(input_num)

    def plan(self, input_num: int) -> BlockPlan:
        """The block plan for ``input_num`` encoded bits."""
        if self._plan_cache[0] != input_num:
            cfg = self.config
            message_len = cfg.get_message_len(input_num)
            dl = auto_dec_len(message_len, cfg.bits_per_pack) \
                if self.dec_len == "auto" else self.dec_len
            self._plan_cache = (input_num, plan_blocks(
                message_len, cfg.bits_per_pack, dl))
        return self._plan_cache[1]

    # --- decode ---
    def run_on_device(self, packed_input, input_num: int
                      ) -> Tuple[torch.Tensor, float]:
        """Decode ``input_num`` encoded bits from packed channel words
        (numpy array or tensor) and keep the result on the device.

        Returns (flat int32 packed output words on ``self.device``,
        seconds of the decode launch)."""
        cfg = self.config
        if cfg.get_message_len(input_num) <= 0:
            raise ValueError(
                f"input_num={input_num} yields no decodable message bits "
                f"(need > {2 * (cfg.extra_l + cfg.extra_r)} encoded bits)")
        words = cfg.get_input_words(input_num)
        n_in = packed_input.shape[0]
        if n_in < words:
            # the reference would read out of bounds here (caller contract:
            # buffer sized by getInputSize, viterbi.cu:64-84); fail loudly
            raise ValueError(
                f"packed_input has {n_in} words, need {words} for "
                f"input_num={input_num} ({cfg.channel_in.name})")
        plan = self.plan(input_num)
        is_float = cfg.channel_in == ChannelIn.FP32
        if isinstance(packed_input, np.ndarray):
            packed_input = torch.from_numpy(np.ascontiguousarray(
                packed_input[:words]).astype(
                    np.float32 if is_float else np.int32, copy=False))
        x = packed_input[:words].to(
            device=self.device,
            dtype=torch.float32 if is_float else torch.int32).contiguous()
        decode = K1 if self.use_kernel else decode_blocks_torch
        if self.use_kernel:
            K1.build()      # a first-use build must not fall between events
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            packs = decode(x, cfg, plan)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            packs = decode(x, cfg, plan)
            seconds = time.perf_counter() - t0
        return assemble_output(packs, cfg, plan), seconds

    def run(self, packed_input, input_num: int
            ) -> Tuple[np.ndarray, float]:
        """Decode ``input_num`` encoded bits from packed channel words.

        Returns (packed_output_words, kernel_seconds).  Output dtype is
        uint32 for O_B32 and uint16 for O_B16 (reference decPack_t)."""
        out, seconds = self.run_on_device(packed_input, input_num)
        words = out.cpu().numpy()
        if self.config.bits_per_pack == 16:
            return words.astype(np.uint16), seconds
        return words.view(np.uint32), seconds
