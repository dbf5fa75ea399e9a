"""Kernels K1-K6 on Hopper: build, bind and launch ``csrc/``.

- K1: the integer word channels, full survivor store — the TPU kernel
  ``_viterbi_kernel_fused``;
- K2: the FP32 channel's raw f32 wire, full store — the TPU kernel
  ``_viterbi_kernel_fused_f32v``;
- K3: every channel with the windowed survivor — the ``window=True`` branch
  of the TPU kernels' ``_decode_core``;
- K4: the decode from staged input (word mode or value mode), full store or
  window — ``_viterbi_kernel`` through ``_run_kernel``;
- K5: the FP32 decode from two clamped f32 planes — ``_viterbi_kernel_f32_2s``;
- K6: the overlapped-window transpose into the word-major layout that feeds
  K4 and K5 — ``_stage_tr_kernel`` through ``stage_words_pallas``.

All six live in ``csrc/viterbi.cu`` (the decode kernels instantiate one
kernel template), which exports one plain C entry point per kernel
(``viterbi_k1_launch`` ...).  Every ``csrc/*.cu`` (this file's kernels and
the generator kernels K7/K8 of ``csrc/genkernel.cu``) goes into ONE shared
library, loaded with ``ctypes``: ``nvcc`` compiles the sources in
parallel, one process per source and build part, and links them once — a
build of seconds,
where an extension that includes PyTorch's headers takes minutes.  The
library is built at first use from the package's own sources into
``tpu_viterbi_torch/_build/``, keyed by a hash of the sources and the
flags.

K1-K3 take none of the TPU staging (``_body_and_edge``, the lane-roll
halo, ``padded_input_words``, ``LANE_TILE``, ``fp32_ud_words``): each
thread reads its block's words straight from the flat stream, halo
included, with zero fill past its end.  The staged entries
(``decode_packed_cuda(fused=False)``, ``fp32_words=False``,
``decode_blocks_cuda``) stage through K6 first, as the JAX package's
A/B paths do; ``b_pad`` is B on the GPU.

On a CPU tensor a wrapper runs its plain version (``core_torch``); on a
CUDA tensor it launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

from ..config import ChannelIn, ConfigResolutionError, DecoderConfig
from .core_torch import (BlockPlan, assemble_output, clamp_split,
                         decode_blocks_torch, decode_planes_torch,
                         decode_staged_torch, needs_int32_renorm,
                         stage_transpose, staged_word_mode,
                         survivor_window_slots, traceback_shape,
                         words_per_block)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "viterbi.cu"        # K1 ... K6
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
SURVIVORS = ("auto", "full", "window")
_PARTS = re.compile(r"^// nvcc parts: (\d+)$", re.M)

_library = None     # the loaded ctypes.CDLL of every csrc/*.cu
build_log = None    # nvcc's -Xptxas -v report of this process' build


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, the PATH, or the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on the "
                       "PATH): the CUDA kernels cannot be built")


def build_parts(source: Path) -> int:
    """How many objects ``source`` compiles into: the count on its
    ``// nvcc parts: N`` line, else 1.  Part i is compiled with
    ``-DBUILD_PART=i``."""
    m = _PARTS.search(source.read_text())
    return int(m.group(1)) if m else 1


def load_library() -> ctypes.CDLL:
    """Compile every ``csrc/*.cu`` (once per hash of the sources and the
    flags) into one library and load it: one ``nvcc -c`` per source and
    build part (``build_parts``), all started together, then one ``nvcc
    -shared`` link.  Sets ``build_log`` to ptxas's register/spill report
    when this process compiled it; it stays None when the library was
    cached."""
    global _library, build_log
    if _library is not None:
        return _library
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib_path = BUILD_DIR / f"libtpu_viterbi_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        jobs = [(src, i, tmp.with_name(f"{tmp.name}.{src.stem}.{i}.o"))
                for src in sources for i in range(build_parts(src))]
        objs = [obj for _, _, obj in jobs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, f"-DBUILD_PART={i}", "-c", "-o", str(obj),
             str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for src, i, obj in jobs]
        logs = [p.communicate()[1] for p in procs]     # waits for every one
        try:
            for (src, i, _), p, log in zip(jobs, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed building {src.name} "
                                       f"part {i} (rc {p.returncode}):\n"
                                       f"{log}")
            res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                                  *map(str, objs)], capture_output=True,
                                 text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed linking {lib_path.name} "
                                   f"(rc {res.returncode}):\n{res.stderr}")
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        build_log = "".join(logs)
        os.replace(tmp, lib_path)       # atomic: concurrent builds
    _library = ctypes.CDLL(str(lib_path))
    return _library


def bind(entry: str, argtypes):
    """Entry point ``entry`` of the library (built and loaded once a
    process), with its argument types; it returns the cudaError_t."""
    fn = getattr(load_library(), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


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
            self._fn = bind(self.entry, self.ARGTYPES)

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
        """Launch on the current stream of ``dev`` (no synchronize); raise
        if the launch was refused."""
        self.build()
        with torch.cuda.device(dev):
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
                 plan: BlockPlan) -> torch.Tensor:
        """Packed channel words (f32 values for FP32) -> (B, n_emit) int32
        output packs (uint32 bit patterns).  Launches on the current
        stream, does not synchronize."""
        self.check_config(cfg)
        if self._check_device(packed):
            return decode_blocks_torch(packed, cfg, plan, self.window)
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
        wpb, _ = words_per_block(cfg, plan)
        return self._decode(packed.device, packed.data_ptr(), None,
                            packed.numel(), wpb, cfg, plan,
                            0 if is_float else cfg.enc_data_width,
                            self.window)


class StagedKernel(CudaKernel):
    """K4: the decode from staged input, full store or ``window``: (Lw, B)
    word-major channel words of an integer channel (word mode, K6's output
    at (wpb, Lw)), or (2 * block_len, B) values with r0 and r1 of stage t
    in rows 2t and 2t + 1 (value mode: int32, or f32 for FP32, not
    clamped; K6's output on the (S, 2) values)."""

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
                            2 * b, cfg, plan, 0 if is_float else 32, window)


class PlaneKernel(CudaKernel):
    """K5: the FP32 decode from two f32 planes (r0, r1), full store or
    ``window``: each (n_packs, bpp, B) or (block_len, B), rows evenly
    strided and the blocks contiguous (``stage_floats_2streams``' views of
    K6's output, or two contiguous planes).  The clamp to [-8, 7] is the
    staging's: values outside it (NaN aside) are outside K5's contract,
    and unclamped values go to K4's value mode."""

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


class TransposeKernel(CudaKernel):
    """K6: a flat stream of 32-bit words (int32 or float32) -> the
    contiguous (win, num) word-major layout out[i, k] = x[k*stride + i],
    zero past the stream's end (``core_torch.stage_transpose``)."""

    ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]

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
        out = torch.empty((win, num), dtype=x.dtype, device=x.device)
        self._launch(x.device, x.data_ptr(), x.numel(), out.data_ptr(),
                     stride, win, num)
        return out


K1 = StreamKernel("K1", fp32=False, window=False)
K2 = StreamKernel("K2", fp32=True, window=False)
K3 = StreamKernel("K3", fp32=None, window=True)
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


def resolve_window(survivor: str, plan: BlockPlan, device=None) -> bool:
    """Map the survivor knob to the window flag (counterpart of
    core_pallas.resolve_window, :155-175).  'full' and 'window' say it;
    'auto' keeps the full store unless its n_packs * 64 * B * 4 bytes
    exceed half of the CUDA device's total memory, the GPU's reading of
    "fits VMEM".  The limit is fixed for a card, as the TPU's VMEM budget
    is for a chip, so a plan decodes alike whatever else holds memory at
    the time (live free memory would make the output depend on it: window
    and full store differ on noisy input).  On the CPU 'auto' keeps the
    full store."""
    if survivor not in SURVIVORS:
        raise ValueError(f"survivor must be one of {SURVIVORS}, "
                         f"got {survivor!r}")
    if survivor != "auto":
        return survivor == "window"
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return False
    total = torch.cuda.get_device_properties(device).total_memory
    return plan.n_packs * 64 * plan.num_blocks * 4 > total // 2


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
    two's-complement range): ``needs_int32_renorm`` bounds the path
    metrics by that range, so values outside it are outside the contract,
    as they are for the JAX kernel."""
    is_float = cfg.channel_in == ChannelIn.FP32
    flat = r.to(torch.float32 if is_float else torch.int32) \
        .contiguous().reshape(-1)
    staged = K6(flat, 2 * plan.dec_len, 2 * plan.block_len,
                plan.num_blocks)
    return assemble_output(K4(staged, cfg, plan), cfg, plan)


def decode_packed_cuda(packed: torch.Tensor, cfg: DecoderConfig,
                       plan: BlockPlan, fused: bool = True,
                       fp32_words: bool = True, window: bool = False,
                       s16: str = "pack") -> torch.Tensor:
    """Full decode straight from packed channel words -> flat int32 packed
    output words; counterpart of ``decode_packed_pallas``, with its
    routing:

    - integer channels, ``fused=True``: K1 (K3 with ``window``) on the
      flat stream; ``fused=False``: K6 stages the words word-major, K4
      decodes them in word mode (the staging pass kept for A/B);
    - FP32, ``fp32_words=True``: K2 (K3 with ``window``) on the raw f32
      wire; ``fp32_words=False``: K6 stages the wire, the clamp and the
      even/odd row split of ``stage_floats_2streams`` make two planes, K5
      decodes them.

    ``s16``: the JAX kernel's SOFT16 unpack layouts decode identically by
    construction; the GPU has one unpack, so any of the four names is
    accepted and another raises as the JAX kernel does."""
    if s16 not in S16_LAYOUTS:
        raise ValueError(f"unknown s16 layout {s16!r}")
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
