"""The package's one shared library: every ``csrc/*.cu`` (the decode
kernels K1-K6, the generators K7/K8, the shared-memory probe K9, the
probes' kernels K11-K20, K23, K25, K26 and K28) built with ``nvcc`` and
loaded with ``ctypes``.

Each source exports plain C entry points that return a ``cudaError_t``.
``nvcc`` compiles the sources in parallel, one process per source and build
part, and links them once: a build of seconds, where an extension that
includes PyTorch's headers takes minutes.  The library is built at first
use from the package's own sources into ``tpu_viterbi_torch/_build/``,
keyed by a hash of the sources, the headers they include (``csrc/*.cuh``)
and the flags.

Every wrapper binds its entry through ``bind``; this module imports
nothing else of the package, so the hardware model and the kernels'
modules can all import it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
_PARTS = re.compile(r"^// nvcc parts: (\d+)$", re.M)

_library = None     # the loaded ctypes.CDLL of every csrc/*.cu
build_log = None    # nvcc's -Xptxas -v report of this process' build
build_seconds = {}  # {"source part i": seconds from the build's start to
                    # that nvcc's end} of this process' build


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
    """Compile every ``csrc/*.cu`` (once per hash of the sources, the
    ``csrc/*.cuh`` headers and the flags) into one library and load it:
    one ``nvcc -c`` per source and build part (``build_parts``), all
    started together, then one ``nvcc -shared`` link.  Sets ``build_log``
    to ptxas's register/spill report and ``build_seconds`` to each nvcc's
    time when this process compiled it; they stay None and empty when the
    library was cached."""
    global _library, build_log
    if _library is not None:
        return _library
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib_path = BUILD_DIR / f"libtpu_viterbi_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        jobs = [(src, i, tmp.with_name(f"{tmp.name}.{src.stem}.{i}.o"))
                for src in sources for i in range(build_parts(src))]
        objs = [obj for _, _, obj in jobs]
        start = time.monotonic()
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, f"-DBUILD_PART={i}", "-c", "-o", str(obj),
             str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for src, i, obj in jobs]

        def finish(p):       # one thread a job: its report and its end
            log = p.communicate()[1]
            return log, time.monotonic() - start
        with ThreadPoolExecutor(len(procs)) as pool:
            done = list(pool.map(finish, procs))    # waits for every one
        logs = [log for log, _ in done]
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
        build_seconds.update({f"{src.name} part {i}": sec for (src, i, _),
                              (_, sec) in zip(jobs, done)})
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
