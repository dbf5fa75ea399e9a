"""Kernels K1-K6 on Hopper: build, bind and launch ``csrc/``.

- K1: the integer word channels, full survivor store — the TPU kernel
  ``_viterbi_kernel_fused``; int16x2 path metrics on HARD, SOFT4, SOFT8
  and the u/d words, int32 on SOFT16 (``csrc/acs.cuh``);
- K2: the FP32 channel's raw f32 wire, full store, int16x2 metrics — the
  TPU kernel ``_viterbi_kernel_fused_f32v``;
- K3: every channel with the windowed survivor — the ``window=True`` branch
  of the TPU kernels' ``_decode_core``; int16x2 metrics as K1 and K2 run
  them, int32 on SOFT16;
- ``K1_I32`` (SOFT8), ``K2_I32`` and ``K3_I32`` (SOFT8 and the FP32 wire,
  window): each kernel with int32 metrics, its earlier arithmetic, the
  other side of the int16x2 A/B for ``chip_smoke.py`` and the GPU tests;
  no decode path launches them;
- K4: the decode from staged input (word mode or value mode), full store or
  window — ``_viterbi_kernel`` through ``_run_kernel``; int16x2 metrics on
  HARD, SOFT4 and SOFT8 words and values, int32 on SOFT16 and on the
  unclamped f32 values;
- K5: the FP32 decode from two clamped f32 planes, int16x2 metrics —
  ``_viterbi_kernel_f32_2s``;
- K6: the overlapped-window transpose into the word-major layout that feeds
  K4 and K5 — ``_stage_tr_kernel`` through ``stage_words_pallas``.

All six live in ``csrc/viterbi.cu`` (the decode kernels instantiate one
kernel template), which exports one plain C entry point per kernel
(``viterbi_k1_launch`` ...), bound from the package's one shared library
(``tpu_viterbi_torch/library.py``).

K1-K3 take none of the TPU staging (``_body_and_edge``, the lane-roll
halo, ``padded_input_words``, ``LANE_TILE``): each thread reads its
block's words straight from the flat stream, halo included, with zero
fill past its end.  K1 and K3 take the JAX entry's ``tail_halo`` on the
integer channels: the wph words that follow the stream, read in place
(``Source.p1``), so the sharded decoder (``sharding/blocks.py``) decodes a
rank's shard with its neighbour's halo and no copy of the shard.  K1 and
K3 also read the FP32 channel's u/d words (``decode_ud_words_cuda`` on
``core_torch.fp32_ud_words_torch``), the JAX kernel's ``ud_mode``.  The staged entries
(``decode_packed_cuda(fused=False)``, ``fp32_words=False``,
``decode_blocks_cuda``) stage through K6 first, as the JAX package's
A/B paths do; ``b_pad`` is B on the GPU.

The window kernels' survivor ring lives in shared memory: before a window
launch ``check_smem`` holds it against ``hardware.smem_budget_bytes``, and
``resolve_window`` reads both budgets of the hardware model.

On a CPU tensor a wrapper runs its plain version (``core_torch``); on a
CUDA tensor it launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .. import hardware, library
from ..config import ChannelIn, ConfigResolutionError, DecoderConfig
from ..utils.profile import span
from .core_torch import (BlockPlan, assemble_output, check_tail_halo,
                         clamp_split, decode_blocks_torch, decode_planes_torch,
                         decode_staged_torch, decode_ud_words_torch,
                         needs_int32_renorm, stage_transpose,
                         staged_word_mode, survivor_window_slots,
                         traceback_shape, ud_words_per_block,
                         words_per_block)

SOURCE = library.CSRC / "viterbi.cu"        # K1 ... K6
SURVIVORS = ("auto", "full", "window")
# time-blocks (threads) a CUDA block: viterbi.cu's kThreads (a test holds
# the two equal)
K_THREADS = 64


class CudaKernel:
    """Wrapper of one kernel, bound to its entry point ``viterbi_<name>_
    launch`` of the shared library.  ``launches`` counts kernel launches
    and nothing else (plain-version calls on CPU tensors do not count)."""

    ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                *[ctypes.c_int] * 8, ctypes.c_void_p]

    def __init__(self, name: str):
        self.name = name
        self.entry = f"viterbi_{name.lower()}_launch"
        self.source = SOURCE
        self.launches = 0
        self._fn = None

    def build(self) -> None:
        """Build and load the library (once a process), bind the entry."""
        if self._fn is None:
            self._fn = library.bind(self.entry, self.ARGTYPES)

    def _check_device(self, *tensors: torch.Tensor) -> bool:
        """True for CPU tensors (run the plain version), False for CUDA
        tensors on one device (launch); raises ValueError otherwise."""
        devs = {t.device for t in tensors}
        if len(devs) == 1 and next(iter(devs)).type == "cpu":
            return True
        if len(devs) != 1 or next(iter(devs)).type != "cuda":
            raise ValueError(f"{self.name} takes CPU or CUDA tensors on one "
                             f"device, got {sorted(map(str, devs))}")
        return False

    def _launch(self, dev: torch.device, *args) -> None:
        """Launch on the current stream of ``dev`` (no synchronize), a
        range under the kernel's name in a trace; raise if the launch was
        refused."""
        self.build()
        with torch.cuda.device(dev), span(self.name):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError_t "
                               f"{err}")
        self.launches += 1

    def _decode(self, dev, p0: int, p1, n: int, stride: int,
                cfg: DecoderConfig, plan: BlockPlan, width: int,
                window: bool) -> torch.Tensor:
        """One launch of a decode entry on a reader's Source (p0, p1, n,
        stride) -> (B, n_emit) int32 output packs (uint32 bit patterns)."""
        if window:
            check_smem(cfg)
        n_conv, n_emit = traceback_shape(cfg, plan)
        b = plan.num_blocks
        surv = None if window else torch.empty(
            (plan.n_packs, 64, b), dtype=torch.int32, device=dev)
        out = torch.empty((b, n_emit), dtype=torch.int32, device=dev)
        self._launch(dev, p0, p1, n, stride,
                     None if surv is None else surv.data_ptr(),
                     out.data_ptr(), b, plan.n_packs, n_conv, n_emit, width,
                     plan.bits_per_pack, int(needs_int32_renorm(cfg, plan)),
                     survivor_window_slots(cfg))
        return out


class StreamKernel(CudaKernel):
    """K1, K2, K3: the decode straight from the flat channel stream, halo
    included.  ``fp32``: True for the FP32 wire only, False for the integer
    channels only, None for both; ``window``: the survivor mode it
    decodes."""

    def __init__(self, name: str, fp32, window: bool):
        super().__init__(name)
        self.fp32 = fp32
        self.window = window
        # launches with a tail halo (each also counts in ``launches``)
        self.halo_launches = 0

    def check_config(self, cfg: DecoderConfig) -> None:
        """Raise ConfigResolutionError for a channel this kernel does not
        decode (the other full-store kernel does)."""
        is_float = cfg.channel_in == ChannelIn.FP32
        if self.fp32 is not None and is_float != self.fp32:
            other = "K2" if is_float else "K1"
            raise ConfigResolutionError(
                f"kernel {self.name} does not decode the "
                f"{cfg.channel_in.name} channel; {other} does")

    def __call__(self, packed: torch.Tensor, cfg: DecoderConfig,
                 plan: BlockPlan, tail_halo: torch.Tensor = None
                 ) -> torch.Tensor:
        """Packed channel words (f32 values for FP32) -> (B, n_emit) int32
        output packs (uint32 bit patterns).  ``tail_halo``: the wph words
        that follow the stream (integer channels, dec_len >= 64;
        ``core_torch.check_tail_halo``), read in place.  Launches on the
        current stream, does not synchronize."""
        self.check_config(cfg)
        tensors = (packed,)
        if tail_halo is not None:
            check_tail_halo(tail_halo, cfg, plan)
            tensors += (tail_halo,)
        if self._check_device(*tensors):
            return decode_blocks_torch(packed, cfg, plan, self.window,
                                       tail_halo)
        is_float = cfg.channel_in == ChannelIn.FP32
        dtype = torch.float32 if is_float else torch.int32
        if packed.dtype != dtype or packed.dim() != 1 \
                or not packed.is_contiguous():
            raise ValueError(f"{self.name} takes a contiguous 1-D {dtype} "
                             f"stream, got {packed.dtype} "
                             f"{tuple(packed.shape)}")
        if is_float and packed.data_ptr() % 16:
            raise ValueError(f"{self.name} reads the f32 wire as float4: "
                             f"its data must be 16-byte aligned")
        halo = None
        if tail_halo is not None:
            if tail_halo.dtype != torch.int32 \
                    or not tail_halo.is_contiguous():
                raise ValueError(f"{self.name} takes a contiguous int32 "
                                 f"tail_halo, got {tail_halo.dtype}")
            halo = tail_halo.data_ptr()
        wpb, _ = words_per_block(cfg, plan)
        out = self._decode(packed.device, packed.data_ptr(), halo,
                           packed.numel(), wpb, cfg, plan,
                           0 if is_float else cfg.enc_data_width,
                           self.window)
        self.halo_launches += halo is not None
        return out


class StagedKernel(CudaKernel):
    """K4: the decode from staged input, full store or ``window``: (Lw, B)
    word-major channel words of an integer channel (word mode, K6's output
    at (wpb, Lw)), or (2 * block_len, B) values with r0 and r1 of stage t
    in rows 2t and 2t + 1 (value mode: int32, or f32 for FP32, not
    clamped; K6's output on the (S, 2) values).  Path metrics: int16x2 on
    HARD, SOFT4 and SOFT8, words or values, which therefore must lie in
    the channel's field range (``decode_blocks_cuda``'s contract; the
    plain int16 version is ``core_torch.decode_staged_i16_torch``); int32
    on SOFT16 and on the f32 values, which saturate at +-2^31.  Integer
    values pass the channel's width as ``VALUE_WIDTH`` + width, so the
    entry routes the metrics' width by it."""

    def __call__(self, staged: torch.Tensor, cfg: DecoderConfig,
                 plan: BlockPlan, window: bool = False) -> torch.Tensor:
        words = staged_word_mode(staged, cfg, plan)
        if self._check_device(staged):
            return decode_staged_torch(staged, cfg, plan, window)
        is_float = cfg.channel_in == ChannelIn.FP32
        dtype = torch.float32 if is_float else torch.int32
        if staged.dtype != dtype or not staged.is_contiguous():
            raise ValueError(f"{self.name} takes contiguous {dtype} staged "
                             f"input for {cfg.channel_in.name}, got "
                             f"{staged.dtype}")
        b = plan.num_blocks
        if words:
            return self._decode(staged.device, staged.data_ptr(), None,
                                staged.shape[0], b, cfg, plan,
                                cfg.enc_data_width, window)
        p0 = staged.data_ptr()
        return self._decode(staged.device, p0, p0 + 4 * b, plan.block_len,
                            2 * b, cfg, plan,
                            0 if is_float else VALUE_WIDTH +
                            cfg.enc_data_width, window)


class PlaneKernel(CudaKernel):
    """K5: the FP32 decode from two f32 planes (r0, r1), full store or
    ``window``: each (n_packs, bpp, B) or (block_len, B), rows evenly
    strided and the blocks contiguous (``stage_floats_2streams``' views of
    K6's output, or two contiguous planes).  The clamp to [-8, 7] is the
    staging's: values outside it (NaN aside) are outside K5's contract,
    and unclamped values go to K4's value mode.  Path metrics: int16x2,
    under the FP32 wire's bound that the clamp gives (the plain int16
    version is ``core_torch.decode_planes_i16_torch``)."""

    def __call__(self, r0: torch.Tensor, r1: torch.Tensor,
                 cfg: DecoderConfig, plan: BlockPlan,
                 window: bool = False) -> torch.Tensor:
        if cfg.channel_in != ChannelIn.FP32:
            raise ConfigResolutionError(
                f"kernel {self.name} decodes the FP32 channel only, not "
                f"{cfg.channel_in.name}")
        shp = (plan.block_len, plan.num_blocks)
        for r in (r0, r1):
            if r.numel() != shp[0] * shp[1] or r.shape[-1] != shp[1]:
                raise ValueError(f"{self.name} takes two planes of "
                                 f"{shp[0]} x {shp[1]} values, got "
                                 f"{tuple(r.shape)}")
        if self._check_device(r0, r1):
            return decode_planes_torch(r0, r1, cfg, plan, window)
        r0, r1 = r0.reshape(shp), r1.reshape(shp)
        if r0.dtype != torch.float32 or r1.dtype != torch.float32 \
                or r0.stride() != r1.stride() or r0.stride(1) != 1:
            raise ValueError(f"{self.name} takes two float32 planes with "
                             f"contiguous blocks and one row stride, got "
                             f"{r0.dtype} {r0.stride()} and {r1.dtype} "
                             f"{r1.stride()}")
        return self._decode(r0.device, r0.data_ptr(), r1.data_ptr(),
                            plan.block_len, r0.stride(0), cfg, plan, 0,
                            window)


K6_VECS = (4, 2, 1)          # words a load: viterbi.cu's K6 instances
K6_TILE_ROWS = (32, 16, 8)   # words i a tile (TI; TK = K6_TILE_WORDS / TI)
K6_TILE_WORDS = 4096         # viterbi.cu's kTrTileWords: 16 KB a tile


def transpose_route(data_ptr: int, stride: int, win: int):
    """(vec, ti): K6's instance for a stream at ``data_ptr``.  vec is the
    widest load (4, 2 or 1 words) that every row start k * stride + i,
    i a multiple of vec, keeps aligned: vec divides the stride and the
    address is a multiple of 4 * vec bytes.  ti is the tile's rows that
    pad win least (the larger on a tie), so a thin window does not idle
    most of a tile: 8 at win 6 (HARD, dec_len 32), 32 at 1,056."""
    vec = next(v for v in K6_VECS
               if stride % v == 0 and data_ptr % (4 * v) == 0)
    ti = min(K6_TILE_ROWS, key=lambda t: -(-win // t) * t)
    return vec, ti


class TransposeKernel(CudaKernel):
    """K6: a flat stream of 32-bit words (int32 or float32) -> the
    contiguous (win, num) word-major layout out[i, k] = x[k*stride + i],
    zero past the stream's end (``core_torch.stage_transpose``).
    ``route_launches`` counts the launches of each (vec, ti) instance
    (``transpose_route``)."""

    ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]

    def __init__(self, name: str):
        super().__init__(name)
        self.route_launches = Counter()

    def __call__(self, x: torch.Tensor, stride: int, win: int,
                 num: int) -> torch.Tensor:
        if min(stride, win, num) <= 0:
            raise ValueError(f"{self.name}: stride, win and num must be "
                             f"positive, got {stride}, {win}, {num}")
        if self._check_device(x):
            return stage_transpose(x, stride, win, num)
        if x.dtype not in (torch.int32, torch.float32) or x.dim() != 1 \
                or not x.is_contiguous():
            raise ValueError(f"{self.name} takes a contiguous 1-D int32 or "
                             f"float32 stream, got {x.dtype} "
                             f"{tuple(x.shape)}")
        route = transpose_route(x.data_ptr(), stride, win)
        out = torch.empty((win, num), dtype=x.dtype, device=x.device)
        self._launch(x.device, x.data_ptr(), x.numel(), out.data_ptr(),
                     stride, win, num, *route)
        self.route_launches[route] += 1
        return out


class Int32Kernel(StreamKernel):
    """K1_I32, K2_I32, K3_I32, bound to ``viterbi_k<i>_i32_launch``: a
    kernel's int32-metric instances on ``channels``, b32 and b16 (the
    int16x2 A/B).  Its plain version is ``decode_blocks_torch``, as its
    kernel's is."""

    def __init__(self, name: str, window: bool, channels):
        super().__init__(name, fp32=None, window=window)
        self.channels = channels

    def __call__(self, packed: torch.Tensor, cfg: DecoderConfig,
                 plan: BlockPlan, tail_halo: torch.Tensor = None
                 ) -> torch.Tensor:
        """StreamKernel's, without a tail halo: the A/B instances have no
        halo reader."""
        if tail_halo is not None:
            raise ValueError(f"{self.name} takes no tail_halo")
        return super().__call__(packed, cfg, plan)

    def check_config(self, cfg: DecoderConfig) -> None:
        if cfg.channel_in not in self.channels:
            raise ConfigResolutionError(
                f"kernel {self.name} decodes "
                f"{' and '.join(c.name for c in self.channels)} only, not "
                f"{cfg.channel_in.name}")


# viterbi.cu's kValueWidth: K4's integer values pass it + the field width
VALUE_WIDTH = 32

K1 = StreamKernel("K1", fp32=False, window=False)
K2 = StreamKernel("K2", fp32=True, window=False)
K3 = StreamKernel("K3", fp32=None, window=True)
K1_I32 = Int32Kernel("K1_I32", False, (ChannelIn.SOFT8,))
K2_I32 = Int32Kernel("K2_I32", False, (ChannelIn.FP32,))
K3_I32 = Int32Kernel("K3_I32", True, (ChannelIn.SOFT8, ChannelIn.FP32))
K4 = StagedKernel("K4")
K5 = PlaneKernel("K5")
K6 = TransposeKernel("K6")
KERNELS = (K1, K2, K3, K4, K5, K6)


def kernel_for(cfg: DecoderConfig, window: bool) -> StreamKernel:
    """The kernel that decodes ``cfg`` in this survivor mode from the flat
    stream."""
    if window:
        return K3
    return K2 if cfg.channel_in == ChannelIn.FP32 else K1


def runs_pm16(kernel, cfg: DecoderConfig) -> bool:
    """Whether ``kernel`` (a kernel wrapper) decodes ``cfg`` on int16x2
    path metrics: K1, K2 and K3 on every channel but SOFT16, K4 on HARD,
    SOFT4 and SOFT8 (not on SOFT16, nor on the FP32 channel's unclamped
    f32 values), K5 always.  The int32 instances K1_I32, K2_I32 and
    K3_I32 never."""
    name = kernel.name
    ch = cfg.channel_in
    return (name in ("K1", "K2", "K3") and ch != ChannelIn.SOFT16) or (
        name == "K4" and ch not in (ChannelIn.SOFT16, ChannelIn.FP32)) or \
        name == "K5"


def decode_bound_ms(in_bytes: int, cfg: DecoderConfig, plan: BlockPlan,
                    pm16: bool = False):
    """A decode's bound (``hardware.bound_ms``): its input and its
    (B, n_emit) int32 packs, the ACS of every stage of every block,
    int16x2 where ``pm16`` (the full store is an intermediate and not
    counted)."""
    n_emit = traceback_shape(cfg, plan)[1]
    return hardware.bound_ms(
        in_bytes + plan.num_blocks * n_emit * 4,
        (hardware.ACS_OPS16 if pm16 else hardware.ACS_OPS) *
        plan.num_blocks * plan.block_len)


def ring_bytes(cfg: DecoderConfig) -> int:
    """Dynamic shared memory of the window kernels' survivor ring for one
    CUDA block: survivor_window_slots(cfg) slots x 64 states x K_THREADS
    threads x 4 bytes (64 KB at W = 4, 96 KB at W = 6)."""
    return survivor_window_slots(cfg) * 64 * K_THREADS * 4


def check_smem(cfg: DecoderConfig) -> None:
    """Raise ValueError when the survivor ring of a window launch (K3, and
    K4/K5 with ``window``) exceeds ``hardware.smem_budget_bytes()``:
    refused before the launch, not at it.  Counterpart of
    ``core_pallas._check_vmem`` (:178-191)."""
    need, budget = ring_bytes(cfg), hardware.smem_budget_bytes()
    if need > budget:
        raise ValueError(
            f"survivor ring does not fit shared memory: W = "
            f"{survivor_window_slots(cfg)} slots x 64 states x {K_THREADS} "
            f"threads needs {need} bytes per CUDA block (budget {budget} "
            f"bytes, hardware.smem_budget_bytes); use the full store")


def resolve_window(survivor: str, cfg: DecoderConfig, plan: BlockPlan,
                   device="cuda") -> bool:
    """Map the survivor knob to the window flag (counterpart of
    core_pallas.resolve_window, :155-175).  'full' and 'window' say it;
    'auto' keeps the full store while its n_packs * 64 * B * 4 bytes fit
    ``hardware.survivor_store_budget_bytes`` (half of the card's total
    memory), and takes the window only where the store does not fit and
    the ring does (``hardware.smem_budget_bytes``); where neither fits it
    raises.  'auto' on the CPU (device 'cpu') keeps the full store."""
    if survivor not in SURVIVORS:
        raise ValueError(f"survivor must be one of {SURVIVORS}, "
                         f"got {survivor!r}")
    if survivor != "auto":
        return survivor == "window"
    device = hardware.resolve_device(device)
    if device.type != "cuda":
        return False
    store = plan.n_packs * 64 * plan.num_blocks * 4
    store_budget = hardware.survivor_store_budget_bytes(device)
    if store <= store_budget:
        return False
    need, budget = ring_bytes(cfg), hardware.smem_budget_bytes()
    if need <= budget:
        return True
    raise ValueError(
        f"neither survivor mode fits: the full store needs {store} bytes of "
        f"device memory (budget {store_budget}) and the window ring {need} "
        f"bytes of shared memory (budget {budget})")


S16_LAYOUTS = ("pack", "halves", "lazy", "group")


def stage_words_cuda(packed: torch.Tensor, cfg: DecoderConfig,
                     plan: BlockPlan) -> torch.Tensor:
    """Packed channel words -> (Lw, B) word-major block layout through K6
    (counterpart of ``stage_words_pallas`` at b_pad = B); on a CPU tensor
    its plain version, ``core_torch.stage_words``."""
    wpb, wph = words_per_block(cfg, plan)
    return K6(packed, wpb, wpb + wph, plan.num_blocks)


def decode_blocks_cuda(r: torch.Tensor, cfg: DecoderConfig,
                       plan: BlockPlan) -> torch.Tensor:
    """Full decode from the global (S, 2) soft stage array -> flat int32
    packed output words: K6 stages its 2S values as words into the (2 *
    block_len, B) layout, K4 decodes them in value mode with the full
    store.  Counterpart of ``decode_blocks_pallas``.

    Values are cast to int32 (integer channels) or float32 (FP32), as the
    JAX entry casts them; FP32 values are not clamped.  Integer values
    must lie within the channel's field range (HARD +-1, SOFTw the w-bit
    two's-complement range): K4's int16x2 metrics (HARD, SOFT4, SOFT8) and
    ``needs_int32_renorm`` (SOFT16) bound the path metrics by that range,
    so values outside it are outside the contract, as they are for the
    JAX kernel."""
    is_float = cfg.channel_in == ChannelIn.FP32
    flat = r.to(torch.float32 if is_float else torch.int32) \
        .contiguous().reshape(-1)
    staged = K6(flat, 2 * plan.dec_len, 2 * plan.block_len,
                plan.num_blocks)
    return assemble_output(K4(staged, cfg, plan), cfg, plan)


UD_WIDTH = -8       # viterbi.cu's kUdWidth: K1's and K3's u/d-word reader


def decode_ud_words_cuda(udw: torch.Tensor, cfg: DecoderConfig,
                         plan: BlockPlan, window: bool = False
                         ) -> torch.Tensor:
    """The FP32 channel's u/d words (``core_torch.fp32_ud_words_torch``) ->
    flat int32 packed output words: K1's reader in ``ud`` mode (K3's with
    ``window``), the counterpart of ``_run_kernel_fused(..., vpw=4,
    width=8, ud_mode=True)`` (core_pallas.py:1167-1177).  The words are
    framed as SOFT8's (``ud_words_per_block``); ``cfg`` is the FP32
    configuration.  On a CPU tensor its plain version,
    ``decode_ud_words_torch``."""
    if cfg.channel_in != ChannelIn.FP32:
        raise ConfigResolutionError(
            f"u/d words are the FP32 channel's wire, not "
            f"{cfg.channel_in.name}'s")
    kernel = K3 if window else K1
    if kernel._check_device(udw):
        packs = decode_ud_words_torch(udw, cfg, plan, window)
    else:
        if udw.dtype != torch.int32 or udw.dim() != 1 \
                or not udw.is_contiguous():
            raise ValueError(f"{kernel.name} takes contiguous 1-D int32 u/d "
                             f"words, got {udw.dtype} {tuple(udw.shape)}")
        wpb, _ = ud_words_per_block(plan)
        packs = kernel._decode(udw.device, udw.data_ptr(), None, udw.numel(),
                               wpb, cfg, plan, UD_WIDTH, window)
    return assemble_output(packs, cfg, plan)


def decode_packed_cuda(packed: torch.Tensor, cfg: DecoderConfig,
                       plan: BlockPlan, fused: bool = True,
                       fp32_words: bool = True, window: bool = False,
                       s16: str = "pack",
                       tail_halo: torch.Tensor = None) -> torch.Tensor:
    """Full decode straight from packed channel words -> flat int32 packed
    output words; counterpart of ``decode_packed_pallas``, with its
    routing:

    - integer channels, ``fused=True``: K1 (K3 with ``window``) on the
      flat stream; ``fused=False``: K6 stages the words word-major, K4
      decodes them in word mode (the staging pass kept for A/B);
    - FP32, ``fp32_words=True``: K2 (K3 with ``window``) on the raw f32
      wire at every ``dec_len``; ``fp32_words=False``: K6 stages the wire,
      the clamp and the even/odd row split of ``stage_floats_2streams``
      make two planes, K5 decodes them.  The JAX entry takes its u/d-word
      route (``fp32_ud_words`` and the kernel's ``ud_mode``) where the f32
      value blocks do not fit VMEM (:1153-1177); K2 reads the flat wire and
      keeps no such block, so no limit forces that route here.  It is
      ``decode_ud_words_cuda``, and decodes the same bits.

    ``s16``: the JAX kernel's SOFT16 unpack layouts decode identically by
    construction; the GPU has one unpack, so any of the four names is
    accepted and another raises as the JAX kernel does.

    ``tail_halo``: the wph words that logically follow ``packed`` (the
    sharded decoder's neighbour halo), read in place by K1 or K3; the
    decode equals that of the stream with the halo appended.  FP32,
    ``fused=False`` and dec_len < 64 refuse it with the JAX entry's words
    (``core_torch.check_tail_halo``)."""
    if s16 not in S16_LAYOUTS:
        raise ValueError(f"unknown s16 layout {s16!r}")
    if tail_halo is not None:
        check_tail_halo(tail_halo, cfg, plan, fused)
        return assemble_output(kernel_for(cfg, window)(
            packed, cfg, plan, tail_halo), cfg, plan)
    if cfg.channel_in == ChannelIn.FP32:
        if fp32_words:
            packs = kernel_for(cfg, window)(packed, cfg, plan)
        else:
            wt = stage_words_cuda(packed.to(torch.float32), cfg, plan)
            packs = K5(*clamp_split(wt, plan), cfg, plan, window)
    elif fused:
        packs = kernel_for(cfg, window)(packed, cfg, plan)
    else:
        packs = K4(stage_words_cuda(packed.to(torch.int32), cfg, plan), cfg,
                   plan, window)
    return assemble_output(packs, cfg, plan)
