"""Kernel K1 on Hopper: build, bind and launch ``csrc/viterbi_k1.cu``.

Counterpart of ``tpu_viterbi/decoder/core_pallas.py``'s
``decode_packed_pallas`` on its integer fused path (the TPU kernel
``_viterbi_kernel_fused``).  The CUDA source is compiled by ``nvcc`` into a
shared library with a plain C entry point, loaded with ``ctypes`` — a build
of seconds, where an extension that includes PyTorch's headers takes
minutes.  The library is built at first use from the package's own source
into ``tpu_viterbi_torch/_build/``, keyed by a hash of the source and the
flags.

None of the TPU staging is ported (``_body_and_edge``, the lane-roll halo,
``padded_input_words``, ``LANE_TILE``): each thread reads its block's words
straight from the flat stream, halo included, with zero fill past its end.

On a CPU tensor the wrapper runs the plain version
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
                         needs_int32_renorm, traceback_shape,
                         words_per_block)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "viterbi_k1.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, the PATH, or the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on the "
                       "PATH): kernel K1 cannot be built")


def check_supported(cfg: DecoderConfig, survivor: str = "auto") -> None:
    """Raise ConfigResolutionError for what K1 does not decode yet."""
    if cfg.channel_in == ChannelIn.FP32:
        raise ConfigResolutionError(
            "the FP32 channel needs CUDA kernel K2, which is not ported "
            "yet; use backend='torch' for FP32")
    if survivor == "window":
        raise ConfigResolutionError(
            "survivor='window' needs CUDA kernel K3 (the windowed "
            "survivor), which is not ported yet; use survivor='auto' or "
            "'full'")


class K1Kernel:
    """Wrapper of kernel K1.  ``launches`` counts kernel launches and
    nothing else (plain-version calls on CPU tensors do not count);
    ``build_log`` keeps nvcc's ``-Xptxas -v`` report of the last build in
    this process (registers, spills), or None when the library was cached."""

    def __init__(self):
        self.launches = 0
        self.build_log = None
        self._fn = None

    def build(self) -> None:
        """Compile (once per source hash) and load the library."""
        if self._fn is not None:
            return
        src = SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
            .hexdigest()[:16]
        lib_path = BUILD_DIR / f"libviterbi_k1_{tag}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed building K1 "
                                   f"(rc {res.returncode}):\n{res.stderr}")
            self.build_log = res.stderr
            os.replace(tmp, lib_path)       # atomic: concurrent builds
        fn = ctypes.CDLL(str(lib_path)).viterbi_k1_launch
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ctypes.c_longlong, vp, vp, i32, i32, i32, i32,
                       i32, i32, i32, i32, vp]
        fn.restype = ctypes.c_int
        self._fn = fn

    def __call__(self, packed: torch.Tensor, cfg: DecoderConfig,
                 plan: BlockPlan) -> torch.Tensor:
        """Packed channel words -> (B, n_emit) int32 output packs (uint32
        bit patterns).  Launches on the current stream, does not
        synchronize."""
        if packed.device.type == "cpu":
            return decode_blocks_torch(packed, cfg, plan)
        if packed.device.type != "cuda":
            raise ValueError(f"K1 takes CPU or CUDA tensors, got "
                             f"{packed.device}")
        check_supported(cfg)
        if packed.dtype != torch.int32 or packed.dim() != 1 \
                or not packed.is_contiguous():
            raise ValueError(f"K1 takes a contiguous 1-D int32 word "
                             f"stream, got {packed.dtype} "
                             f"{tuple(packed.shape)}")
        self.build()
        n_conv, n_emit = traceback_shape(cfg, plan)
        wpb, _ = words_per_block(cfg, plan)
        b = plan.num_blocks
        dev = packed.device
        surv = torch.empty((plan.n_packs, 64, b), dtype=torch.int32,
                           device=dev)
        out = torch.empty((b, n_emit), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(packed.data_ptr(), packed.numel(),
                           surv.data_ptr(), out.data_ptr(), b, plan.n_packs,
                           wpb, n_conv, n_emit, cfg.enc_data_width,
                           plan.bits_per_pack,
                           int(needs_int32_renorm(cfg, plan)), stream)
        if err != 0:
            raise RuntimeError(f"K1 launch failed: cudaError_t {err}")
        self.launches += 1
        return out


K1 = K1Kernel()


def decode_packed_cuda(packed: torch.Tensor, cfg: DecoderConfig,
                       plan: BlockPlan) -> torch.Tensor:
    """Full decode straight from packed channel words through K1 -> flat
    int32 packed output words.  Counterpart of ``decode_packed_pallas``."""
    return assemble_output(K1(packed, cfg, plan), cfg, plan)
