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
``run_stream`` queues many equal-sized messages back to back, the serving
form of ``run``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import ChannelIn, ConfigResolutionError, DecoderConfig
from ..hardware import resolve_device
from ..utils.profile import span
from .core_cuda import SURVIVORS, kernel_for, resolve_window
from .core_torch import (BlockPlan, assemble_output, auto_dec_len,
                         decode_blocks_torch, plan_blocks)

# kept equal to the JAX package's default so both stacks frame messages
# alike; the GPU's own default awaits a measurement on the card
DEFAULT_DEC_LEN = 2048

BACKENDS = ("auto", "cuda", "torch")


class ViterbiGPU:
    """Block-parallel Viterbi decoder on a CUDA device, or on the CPU when
    the caller asks for it."""

    def __init__(self, config: DecoderConfig = DecoderConfig(),
                 input_num: Optional[int] = None,
                 dec_len: int = DEFAULT_DEC_LEN,
                 backend: str = "auto",
                 survivor: str = "auto",
                 device="cuda"):
        """backend: 'auto' | 'cuda' | 'torch' — 'auto' launches the CUDA
        kernels on a CUDA device (K1 for the integer channels, K2 for FP32,
        K3 for the windowed survivor) and runs their plain torch versions
        on a CPU device, as the JAX package's 'pallas-interpret' runs its
        kernel anywhere; 'cuda' requires a CUDA device; 'torch' runs the
        plain versions on either device.

        survivor: 'auto' | 'full' | 'window' — 'window' is the reference's
        one-pointer circular buffer (viterbi.cu:99-100); 'auto' keeps the
        full survivor store unless it would take more than half of the
        GPU's total memory (core_cuda.resolve_window).

        device: where decoding runs, the GPU unless the caller passes
        'cpu'; a CUDA device with no GPU present raises RuntimeError."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if survivor not in SURVIVORS:
            raise ValueError(f"survivor must be one of {SURVIVORS}, "
                             f"got {survivor!r}")
        self.device = resolve_device(device)
        if backend == "cuda" and self.device.type != "cuda":
            raise ConfigResolutionError(
                f"backend='cuda' needs a CUDA device (device={device!r})")
        self.config = config
        self.dec_len = dec_len if dec_len == "auto" else int(dec_len)
        self.backend = backend
        self.survivor = survivor
        self.use_kernel = self.device.type == "cuda" and backend != "torch"
        self._plan_cache: Tuple[int, BlockPlan, bool] = (-1, None, False)
        if input_num is not None:
            # pre-sizing hook (reference pre-allocating ctor,
            # viterbi.cu:31-36): plan now, and build the kernel
            self.plan(input_num)
            self._decoder(input_num)

    # --- size API (reference: viterbi.cu:64-92) ---
    def get_input_size(self, input_num: int) -> int:
        return self.config.get_input_size(input_num)

    def get_message_len(self, input_num: int) -> int:
        return self.config.get_message_len(input_num)

    def get_output_size(self, input_num: int) -> int:
        return self.config.get_output_size(input_num)

    def plan(self, input_num: int) -> BlockPlan:
        """The block plan for ``input_num`` encoded bits."""
        return self._resolve(input_num)[0]

    def window(self, input_num: int) -> bool:
        """Whether ``input_num`` encoded bits decode with the windowed
        survivor (the survivor knob resolved for this plan)."""
        return self._resolve(input_num)[1]

    def _resolve(self, input_num: int) -> Tuple[BlockPlan, bool]:
        if self._plan_cache[0] != input_num:
            cfg = self.config
            message_len = cfg.get_message_len(input_num)
            dl = auto_dec_len(message_len, cfg.bits_per_pack) \
                if self.dec_len == "auto" else self.dec_len
            plan = plan_blocks(message_len, cfg.bits_per_pack, dl)
            self._plan_cache = (input_num, plan, resolve_window(
                self.survivor, cfg, plan, self.device))
        return self._plan_cache[1:]

    def _decoder(self, input_num: int):
        """The decode function for this size: the CUDA kernel (built here,
        so a first-use build never falls between timing events) or the
        plain torch core."""
        window = self.window(input_num)
        if not self.use_kernel:
            return lambda x, cfg, plan: decode_blocks_torch(x, cfg, plan,
                                                            window)
        kernel = kernel_for(self.config, window)
        kernel.build()
        return kernel

    def _stage(self, packed_input, input_num: int,
               what: str = "packed_input") -> torch.Tensor:
        """Check the input's length and put its first get_input_words
        words on the device, contiguous, in the wire's dtype."""
        cfg = self.config
        words = cfg.get_input_words(input_num)
        n_in = packed_input.shape[0]
        if n_in < words:
            # the reference would read out of bounds here (caller contract:
            # buffer sized by getInputSize, viterbi.cu:64-84); fail loudly
            raise ValueError(
                f"{what} has {n_in} words, need {words} for "
                f"input_num={input_num} ({cfg.channel_in.name})")
        dtype = torch.float32 \
            if cfg.channel_in == ChannelIn.FP32 else torch.int32
        if isinstance(packed_input, np.ndarray):
            packed_input = torch.from_numpy(np.ascontiguousarray(
                packed_input[:words]).astype(
                    np.float32 if dtype == torch.float32 else np.int32,
                    copy=False))
        x = packed_input[:words].to(device=self.device,
                                    dtype=dtype).contiguous()
        # the FP32 kernels read the wire as float4: a view that starts
        # off a 16-byte boundary is copied to a fresh (aligned) tensor
        return x.clone() if x.data_ptr() % 16 else x

    def _check_message(self, input_num: int) -> None:
        cfg = self.config
        if cfg.get_message_len(input_num) <= 0:
            raise ValueError(
                f"input_num={input_num} yields no decodable message bits "
                f"(need > {2 * (cfg.extra_l + cfg.extra_r)} encoded bits)")

    def _to_host(self, out: torch.Tensor) -> np.ndarray:
        """Flat int32 output words -> uint32 (O_B32) or uint16 (O_B16), the
        reference's decPack_t."""
        words = out.cpu().numpy()
        if self.config.bits_per_pack == 16:
            return words.astype(np.uint16)
        return words.view(np.uint32)

    # --- decode ---
    def run_on_device(self, packed_input, input_num: int
                      ) -> Tuple[torch.Tensor, float]:
        """Decode ``input_num`` encoded bits from packed channel words
        (numpy array or tensor) and keep the result on the device.

        Returns (flat int32 packed output words on ``self.device``,
        seconds of the decode launch).  In a trace: ``api.call`` holding
        ``api.stage``, ``decode`` (``api.launch``, ``api.wait``) and
        ``api.assemble`` (``utils/profile.py``)."""
        cfg = self.config
        with span("api.call"):
            with span("api.stage"):
                self._check_message(input_num)
                x = self._stage(packed_input, input_num)
                plan = self.plan(input_num)
                decode = self._decoder(input_num)
            with span("decode"):
                if self.device.type == "cuda":
                    with span("api.launch"):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        packs = decode(x, cfg, plan)
                        end.record()
                    with span("api.wait"):
                        end.synchronize()
                        seconds = start.elapsed_time(end) / 1e3
                else:
                    with span("api.launch"):
                        t0 = time.perf_counter()
                        packs = decode(x, cfg, plan)
                        seconds = time.perf_counter() - t0
            with span("api.assemble"):
                return assemble_output(packs, cfg, plan), seconds

    def run(self, packed_input, input_num: int
            ) -> Tuple[np.ndarray, float]:
        """Decode ``input_num`` encoded bits from packed channel words.

        Returns (packed_output_words, kernel_seconds).  Output dtype is
        uint32 for O_B32 and uint16 for O_B16 (reference decPack_t)."""
        out, seconds = self.run_on_device(packed_input, input_num)
        return self._to_host(out), seconds

    def run_stream(self, packed_inputs, input_num: int,
                   want_time: bool = True
                   ) -> Tuple[List[np.ndarray], Optional[float]]:
        """Sustained serving: decode equal-sized messages back to back
        (counterpart of ViterbiTPU.run_stream, api.py:242-288).

        All inputs are staged on the device first, untimed, like the
        reference's host-to-device copies outside its cudaEvent pair.  Then
        one decode per message is queued on the current stream with no
        synchronize in between, between two CUDA events (on the CPU, the
        host clock).

        Returns (outputs in input order, seconds per message or None).
        In a trace: ``api.call`` holding ``api.stage``, ``api.launch``,
        ``api.wait`` and ``api.assemble``, as ``run_on_device``'s."""
        cfg = self.config
        cuda = self.device.type == "cuda"
        with span("api.call"):
            with span("api.stage"):
                self._check_message(input_num)
                xs = [self._stage(p, input_num, "packed input")
                      for p in packed_inputs]
                plan = self.plan(input_num)
                decode = self._decoder(input_num)
                if cuda:
                    # staging stays untimed
                    torch.cuda.synchronize(self.device)
            if cuda:
                with span("api.launch"):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    packs = [decode(x, cfg, plan) for x in xs]
                    end.record()
                with span("api.wait"):
                    end.synchronize()
                    seconds = start.elapsed_time(end) / 1e3
            else:
                with span("api.launch"):
                    t0 = time.perf_counter()
                    packs = [decode(x, cfg, plan) for x in xs]
                    seconds = time.perf_counter() - t0
            per = seconds / max(1, len(packs)) if want_time else None
            with span("api.assemble"):
                return [self._to_host(assemble_output(p, cfg, plan))
                        for p in packs], per
