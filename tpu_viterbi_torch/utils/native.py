"""ctypes bindings to the host ops (``csrc/host_ops.cpp``, the port's own
copy); the counterpart of ``tpu_viterbi/utils/native.py``.

The reference keeps its host-side hot loops (bit packing, BER accounting)
in C++ (src/main.cpp:151-171, src/viterbiDF.h).  These are the native
equivalents: BER accounting over packed decoded words, and the host-side
quantize/pack and unpack of channel words for callers that ingest sample
streams on the host (the simulation itself quantizes on the device:
``chain/quantize.py``).

The library is built with g++ at first use into ``tpu_viterbi_torch/_build/``,
keyed by a hash of the source, the flags and the host's machine type, as
``library.py`` keys the CUDA library.  The flags name no ``-march``, so a
cached build runs on any host of that machine type.  Where the JAX module
returns None (no compiler, a failed build or load, an unknown width), this
one raises: a failed build carries g++'s message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

from ..library import BUILD_DIR, CSRC

SOURCE = CSRC / "host_ops.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
WIDTHS = (1, 4, 8, 16)            # the packed channels' field widths

_lock = threading.Lock()
_lib = None


def find_gxx() -> str:
    """g++ from $CXX or the PATH."""
    for cand in (os.environ.get("CXX"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("g++ not found (set CXX or put g++ on the PATH): the "
                       "host ops cannot be built")


def library_path():
    """Where the build of this source, these flags and this machine type
    lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" +
                            platform.machine().encode() + b"\0" +
                            SOURCE.read_bytes())
    return BUILD_DIR / f"libviterbi_host_{digest.hexdigest()[:16]}.so"


def _build_and_load() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        res = subprocess.run([find_gxx(), *GXX_FLAGS, str(SOURCE), "-o",
                              str(tmp)], capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed building {SOURCE.name} (rc "
                               f"{res.returncode}):\n{res.stderr}")
        os.replace(tmp, path)           # atomic: concurrent builds
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    i64, vp = ctypes.c_longlong, ctypes.c_void_p
    for name, restype, argtypes in (
            ("count_bit_errors_u32", i64, [vp, i64, vp, i64]),
            ("count_bit_errors_u16", i64, [vp, i64, vp, i64]),
            ("quantize_pack_f32", i64, [vp, i64, ctypes.c_float,
                                        ctypes.c_int, vp]),
            ("unpack_soft_words", None, [vp, i64, ctypes.c_int, vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def get_lib() -> ctypes.CDLL:
    """The host-ops library, built and loaded once a process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build_and_load()
        return _lib


def _check_width(width: int) -> None:
    if width not in WIDTHS:
        raise ValueError(f"field width must be one of {WIDTHS}, got {width}")


def native_count_bit_errors(decoded_words: np.ndarray, bits_per_pack: int,
                            ref_bits: np.ndarray) -> int:
    """Bit errors of the decoded packs (MSB = earliest bit) against the
    {0,1} bytes ``ref_bits`` (already offset by extra_l), over
    min(len(decoded_words) * bits_per_pack, len(ref_bits)) bits."""
    if bits_per_pack == 32:
        w = np.ascontiguousarray(decoded_words, dtype=np.uint32)
        fn = get_lib().count_bit_errors_u32
    elif bits_per_pack == 16:
        w = np.ascontiguousarray(decoded_words, dtype=np.uint16)
        fn = get_lib().count_bit_errors_u16
    else:
        raise ValueError(f"bits_per_pack must be 32 or 16, got "
                         f"{bits_per_pack}")
    ref = np.ascontiguousarray(ref_bits, dtype=np.uint8)
    return int(fn(w.ctypes.data, len(w), ref.ctypes.data, len(ref)))


def native_quantize_pack(values: np.ndarray, width: int,
                         scale: float = 1.0) -> np.ndarray:
    """Host-side quantize + MSB-first pack of float soft values into int32
    channel words (reference SoftDecisionPacker, src/viterbiDF.h:98-167).
    width: 1 (HARD) / 4 / 8 / 16; a partial last word's trailing fields
    are zero."""
    _check_width(width)
    v = np.ascontiguousarray(values, dtype=np.float32)
    per_word = 32 // width
    out = np.empty((len(v) + per_word - 1) // per_word, dtype=np.int32)
    get_lib().quantize_pack_f32(v.ctypes.data, len(v), ctypes.c_float(scale),
                                width, out.ctypes.data)
    return out


def native_unpack_soft(words: np.ndarray, width: int) -> np.ndarray:
    """Packed channel words -> sign-extended int32 soft values (HARD ->
    +-1); the host-side inverse of native_quantize_pack."""
    _check_width(width)
    w = np.ascontiguousarray(words, dtype=np.int32)
    out = np.empty(len(w) * (32 // width), dtype=np.int32)
    get_lib().unpack_soft_words(w.ctypes.data, len(w), width,
                                out.ctypes.data)
    return out
