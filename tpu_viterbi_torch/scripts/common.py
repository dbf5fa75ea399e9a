"""What the probes' kernels (K11-K15) share: the wrapper that binds a
kernel's entry point and counts its launches, the timing of a launch, the
ACS' branch signs, and what the SASS of the built library says of a kernel
(its loops' instructions, its registers and stack frame).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .. import library
from ..trellis import branch_sign_table
from ..utils.timing import cuda_ms

LT = 128    # arrays (lanes) of a TPU program: the probes' unit of arrays


class ProbeKernel:
    """Wrapper of one probe kernel's C entry point in the package's
    library.  ``launches`` counts kernel launches and nothing else (the
    plain version's calls on CPU tensors do not count)."""

    def __init__(self, name: str, entry: str, source: str, argtypes):
        self.name = name
        self.entry = entry
        self.source = library.CSRC / source
        self.argtypes = list(argtypes) + [ctypes.c_void_p]    # the stream
        self.launches = 0
        self._fn = None

    def build(self) -> None:
        """Build and load the library (once a process), bind the entry."""
        if self._fn is None:
            self._fn = library.bind(self.entry, self.argtypes)

    def check_device(self, t: torch.Tensor) -> bool:
        """True for a CUDA tensor (launch), False for a CPU one (plain
        version); anything else raises."""
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{self.name} runs on CPU or CUDA tensors, got "
                             f"{t.device}")
        return t.device.type == "cuda"

    def launch(self, device: torch.device, *args) -> None:
        """One launch on the current stream of ``device``, not
        synchronized; a refused launch raises."""
        self.build()
        with torch.cuda.device(device):
            err = self._fn(*args,
                           torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError_t {err}")
        self.launches += 1


def branch_signs() -> Tuple[np.ndarray, np.ndarray]:
    """(s0, s1): the +-1 sign of each coded bit on the j=0 branch into the
    even child 2q of predecessor q = 0..31 (trellis.branch_sign_table, the
    JAX probes' _TAP_MASK0/1 parities)."""
    t = branch_sign_table()[0::2, 0]
    return t[:, 0].astype(np.int64), t[:, 1].astype(np.int64)


def timed(fn: Callable, reps: int):
    """One untimed launch, then the CUDA-event times of ``reps``: (median
    ms, all ms, the last result)."""
    fn()
    return cuda_ms(fn, reps)


# --- what the SASS says ---

_FUNCTION = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_BRANCH = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)")
_RES_FUNCTION = re.compile(r"Function ([^\s:]+):")
_RES_FIELD = re.compile(r"(\w+(?:\[\d+\])?):(\d+)")


def loop_spans(sass: str) -> Dict[str, List[Tuple[int, int, int]]]:
    """{mangled kernel name: [(first address, branch address, instructions)
    of each loop]} from a ``cuobjdump -sass`` listing: a loop runs from a
    backward branch's target to the branch (a branch to itself, the trap
    after EXIT, is no loop)."""
    spans = {}
    pieces = _FUNCTION.split(sass)
    for name, body in zip(pieces[1::2], pieces[2::2]):
        addrs, labels, branches = [], {}, []
        pending = []
        for line in body.splitlines():
            lab = _LABEL.match(line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = _INSTR.search(line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            addrs.append(addr)
            b = _BRANCH.search(m.group(2))
            if b:
                branches.append((addr, b.group(1)))
        found = []
        for addr, target in branches:
            t = int(target, 16) if target.startswith("0x") \
                else labels.get(target)
            if t is not None and t < addr:
                found.append((t, addr, sum(t <= a <= addr for a in addrs)))
        if found:
            spans[name] = found
    return spans


def loop_instructions(sass: str) -> Dict[str, int]:
    """{mangled kernel name: SASS instructions of its shortest loop}."""
    return {name: min(n for _, _, n in s)
            for name, s in loop_spans(sass).items()}


def stage_loop_instructions(sass: str) -> Dict[str, int]:
    """{mangled kernel name: SASS instructions of its stage loop}: the
    longest innermost loop (one that holds no other loop's branch), so a
    short traceback loop beside the stage loop, or a pack loop around it,
    is not taken for it."""
    counts = {}
    for name, spans in loop_spans(sass).items():
        inner = [n for t, a, n in spans
                 if not any((t2, a2) != (t, a) and t <= t2 and a2 <= a
                            for t2, a2, _ in spans)]
        counts[name] = max(inner)
    return counts


def resource_usage(text: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel name: {"REG": registers a thread, "STACK": bytes of
    stack frame (where spills go), "LOCAL": ..., ...}} from a ``cuobjdump
    -res-usage`` listing."""
    usage = {}
    pieces = _RES_FUNCTION.split(text)
    for name, body in zip(pieces[1::2], pieces[2::2]):
        usage[name] = {k: int(v) for k, v in _RES_FIELD.findall(body)}
    return usage


def _tool(name: str) -> str:
    return str(Path(library.find_nvcc()).with_name(name))


def cubin_listings(marker: str) -> Tuple[str, Dict[str, Dict[str, int]]]:
    """(the ``cuobjdump -sass`` listing, the ``-res-usage`` table) of the
    one cubin of the built library that holds ``marker`` (a kernel's
    namespace): the cubins are extracted and only that one is read (the
    decode kernels' listings take seconds)."""
    lib = library.load_library()
    tool = _tool("cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([tool, "-xelf", "all", lib._name], cwd=tmp,
                       capture_output=True, check=True, timeout=120)
        cubins = [p for p in Path(tmp).iterdir()
                  if marker.encode() in p.read_bytes()]
        if len(cubins) != 1:
            raise RuntimeError(f"{len(cubins)} cubins of the library hold "
                               f"{marker}")
        sass, res = [subprocess.run([tool, flag, str(cubins[0])],
                                    capture_output=True, text=True,
                                    check=True, timeout=120).stdout
                     for flag in ("-sass", "-res-usage")]
    return sass, resource_usage(res)


def pick(table: Dict[str, object], *parts: str):
    """The one entry of a {mangled kernel name: ...} table whose name holds
    every one of ``parts``."""
    hits = [v for name, v in table.items() if all(p in name for p in parts)]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} kernels of the listing match "
                           f"{parts}")
    return hits[0]
