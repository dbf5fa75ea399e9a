"""Kernels K1, K2 and K3 on Hopper: build, bind and launch ``csrc/``.

- K1: the integer word channels, full survivor store — the TPU kernel
  ``_viterbi_kernel_fused``;
- K2: the FP32 channel's raw f32 wire, full store — the TPU kernel
  ``_viterbi_kernel_fused_f32v``;
- K3: every channel with the windowed survivor — the ``window=True`` branch
  of the TPU kernels' ``_decode_core``.

All three instantiate one kernel template in ``csrc/viterbi.cu``, which
exports one plain C entry point per kernel (``viterbi_k1_launch`` ...).
The source is compiled once by ``nvcc`` into a shared library, loaded with
``ctypes`` — a build of seconds, where an extension that includes
PyTorch's headers takes minutes.  The library is built at first use from
the package's own source into ``tpu_viterbi_torch/_build/``, keyed by a
hash of the source and the flags.

None of the TPU staging is ported (``_body_and_edge``, the lane-roll halo,
``padded_input_words``, ``LANE_TILE``, ``fp32_ud_words``): each thread
reads its block's words straight from the flat stream, halo included, with
zero fill past its end.

On a CPU tensor a wrapper runs its plain version
(``core_torch.decode_blocks_torch``); on a CUDA tensor it launches the
kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..config import ChannelIn, ConfigResolutionError, DecoderConfig
from .core_torch import (BlockPlan, assemble_output, decode_blocks_torch,
                         needs_int32_renorm, survivor_window_slots,
                         traceback_shape, words_per_block)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCE = CSRC / "viterbi.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
SURVIVORS = ("auto", "full", "window")

_library = None     # the loaded ctypes.CDLL of SOURCE
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


def load_library() -> ctypes.CDLL:
    """Compile SOURCE (once per hash of the source and the flags) and load
    it.  Sets ``build_log`` to ptxas's register/spill report when this
    process compiled it; it stays None when the library was cached."""
    global _library, build_log
    if _library is not None:
        return _library
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{SOURCE.stem}_{tag}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {SOURCE.name} "
                               f"(rc {res.returncode}):\n{res.stderr}")
        build_log = res.stderr
        os.replace(tmp, lib_path)       # atomic: concurrent builds
    _library = ctypes.CDLL(str(lib_path))
    return _library


class CudaKernel:
    """Wrapper of one kernel, bound to its entry point ``viterbi_<name>_
    launch`` of the shared library.  ``launches`` counts kernel launches
    and nothing else (plain-version calls on CPU tensors do not count).

    ``fp32``: True for the FP32 wire only, False for the integer channels
    only, None for both; ``window``: the survivor mode it decodes."""

    def __init__(self, name: str, fp32, window: bool):
        self.name = name
        self.entry = f"viterbi_{name.lower()}_launch"
        self.fp32 = fp32
        self.window = window
        self.launches = 0
        self._fn = None

    def check_config(self, cfg: DecoderConfig) -> None:
        """Raise ConfigResolutionError for a channel this kernel does not
        decode (the other full-store kernel does)."""
        is_float = cfg.channel_in == ChannelIn.FP32
        if self.fp32 is not None and is_float != self.fp32:
            other = "K2" if is_float else "K1"
            raise ConfigResolutionError(
                f"kernel {self.name} does not decode the "
                f"{cfg.channel_in.name} channel; {other} does")

    def build(self) -> None:
        """Build and load the library (once a process), bind the entry."""
        if self._fn is not None:
            return
        fn = getattr(load_library(), self.entry)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ctypes.c_longlong, vp, vp, i32, i32, i32, i32,
                       i32, i32, i32, i32, i32, vp]
        fn.restype = ctypes.c_int
        self._fn = fn

    def __call__(self, packed: torch.Tensor, cfg: DecoderConfig,
                 plan: BlockPlan) -> torch.Tensor:
        """Packed channel words (f32 values for FP32) -> (B, n_emit) int32
        output packs (uint32 bit patterns).  Launches on the current
        stream, does not synchronize."""
        self.check_config(cfg)
        if packed.device.type == "cpu":
            return decode_blocks_torch(packed, cfg, plan, self.window)
        if packed.device.type != "cuda":
            raise ValueError(f"{self.name} takes CPU or CUDA tensors, got "
                             f"{packed.device}")
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
        self.build()
        n_conv, n_emit = traceback_shape(cfg, plan)
        wpb, _ = words_per_block(cfg, plan)
        b = plan.num_blocks
        dev = packed.device
        surv = None if self.window else torch.empty(
            (plan.n_packs, 64, b), dtype=torch.int32, device=dev)
        out = torch.empty((b, n_emit), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(packed.data_ptr(), packed.numel(),
                           None if surv is None else surv.data_ptr(),
                           out.data_ptr(), b, plan.n_packs, wpb, n_conv,
                           n_emit, 0 if is_float else cfg.enc_data_width,
                           plan.bits_per_pack,
                           int(needs_int32_renorm(cfg, plan)),
                           survivor_window_slots(cfg), stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError_t "
                               f"{err}")
        self.launches += 1
        return out


K1 = CudaKernel("K1", fp32=False, window=False)
K2 = CudaKernel("K2", fp32=True, window=False)
K3 = CudaKernel("K3", fp32=None, window=True)
KERNELS = (K1, K2, K3)


def kernel_for(cfg: DecoderConfig, window: bool) -> CudaKernel:
    """The kernel that decodes ``cfg`` in this survivor mode."""
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


def decode_packed_cuda(packed: torch.Tensor, cfg: DecoderConfig,
                       plan: BlockPlan) -> torch.Tensor:
    """Full decode straight from packed channel words through K1 or K2
    (full store) -> flat int32 packed output words.  Counterpart of
    ``decode_packed_pallas``."""
    return assemble_output(kernel_for(cfg, False)(packed, cfg, plan), cfg,
                           plan)
