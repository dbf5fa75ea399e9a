"""What the probes' kernels (K11-K28) share: the wrapper that binds a
kernel's entry point and counts its launches, the timing of a launch, the
decode-attribution probes' piece timer and attribution block (K21-K24), the
ACS' branch signs, and what the SASS of the built library says of a kernel
(its loops' instructions and opcodes, its registers and stack frame).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import tempfile
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .. import library
from ..trellis import branch_sign_table
from ..utils.timing import cuda_ms

LT = 128    # arrays (lanes) of a TPU program: the probes' unit of arrays
BPP = 32    # stages a pack of the stage-pair input


def check_stage_pairs(name: str, rs: torch.Tensor) -> None:
    """Raise unless rs is the stage-pair input of K14, K16 and K19:
    (n_packs, 32, 2, width) int32, n_packs and width > 0; stage t = 32 p + s
    of array c reads rs[p, s, :, c]."""
    if rs.dim() != 4 or rs.shape[1:3] != (BPP, 2) or rs.shape[0] == 0 or \
            rs.shape[3] == 0 or rs.dtype != torch.int32:
        raise ValueError(f"{name} takes (n_packs, {BPP}, 2, width) int32, "
                         f"got {rs.dtype} {tuple(rs.shape)}")


def stage_pairs_input(n_packs: int, width: int, device,
                      seed: int = 0) -> torch.Tensor:
    """(n_packs, 32, 2, width) int32 values -100..100 from numpy's
    generator (the JAX probes' randint range; drawn as int64 and cast, as
    K14's inputs always were, so a seed keeps its values).

    Every state of an array sees its stage's one bm = r0 + r1, and the
    probes start every state at zero, so the 64 path metrics stay equal
    at every stage: the work a stage needs is one state's metric update
    plus one update a distinct survivor row.  The probes' OPS count
    that."""
    x = np.random.default_rng(seed).integers(-100, 101,
                                             (n_packs, BPP, 2, width))
    return torch.from_numpy(x.astype(np.int32)).to(device)


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


PIECE_RUNS = 5      # CUDA-event samples of a decode-attribution piece


def time_piece(label: str, fn: Callable, stages: int = 0,
               runs: int = PIECE_RUNS) -> float:
    """Time one piece of a decode (K21-K24's probes) with ``timed``, one
    warmed launch a sample, and print its line: the median and every
    sample, and ns per stage per 128-block tile where ``stages`` (tiles x
    packs x 32) is given.  Returns the median ms."""
    ms, all_ms, _ = timed(fn, runs)
    per = f"  {ms * 1e6 / stages:7.3f} ns/stage" if stages else ""
    print(f"{label:28s} {ms:8.4f} ms{per}   (of "
          f"{[round(t, 4) for t in all_ms]})", flush=True)
    return ms


def print_attribution(rows) -> None:
    """The probes' attribution block: a header, then one line per (label,
    ms, note) row."""
    print("---- attribution ----", flush=True)
    for label, ms, note in rows:
        print(f"{label:28s} {ms:8.4f} ms{note}", flush=True)


def stage_tiles(plan) -> int:
    """Stages of a plan counted as the JAX probes count them: 128-block
    tiles x packs x 32 (the ns/stage of their lines)."""
    return -(-plan.num_blocks // LT) * plan.n_packs * BPP


def check_names(names, allowed, what: str = "variant") -> None:
    """Raise on a name that is not one of ``allowed``."""
    for n in names:
        if n not in allowed:
            raise ValueError(f"unknown {what} {n!r}; one of {allowed}")


def time_stages(fn: Callable, reps: int, stages: int, arrays: int,
                sass: tuple, loop_stages: int, **keys) -> dict:
    """Time ``fn``, one launch of a stage-loop kernel over ``stages``
    stages of ``arrays`` arrays, with ``timed``: ``keys`` plus its ms, ns
    per stage per 128-array tile, and what ``sass`` (a ``sass_table``
    entry) says of its stage loop of ``loop_stages`` stages."""
    ms, all_ms, _ = timed(fn, reps)
    loop, res, mix = sass
    return dict(keys, arrays=arrays, ms=ms, all_ms=all_ms,
                ns_per_stage_tile=ms * 1e6 * LT / (stages * arrays),
                sass_loop=loop, sass_per_stage=loop / loop_stages, mix=mix,
                regs=res.get("REG"), stack=res.get("STACK"),
                local=res.get("LOCAL"))


def describe_stages(r: dict, label: str) -> str:
    """One line of a ``time_stages`` result, after ``label``."""
    return (f"{label}: median {r['ms']:.4f} ms of "
            f"{[round(t, 4) for t in r['all_ms']]} = "
            f"{r['ns_per_stage_tile']:.4f} ns/stage/tile; SASS "
            f"{r['sass_per_stage']:g} a stage ({r['sass_loop']} in the stage "
            f"loop: {describe_mix(r['mix'])}); registers {r['regs']}, stack "
            f"{r['stack']} B, local {r['local']} B")


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


def _stage_span(spans: List[Tuple[int, int, int]]) -> Tuple[int, int, int]:
    """The stage loop of one kernel's loops: the longest innermost loop
    (one that holds no other loop's branch), so a short traceback loop
    beside the stage loop, or a pack loop around it, is not taken for
    it."""
    inner = [(t, a, n) for t, a, n in spans
             if not any((t2, a2) != (t, a) and t <= t2 and a2 <= a
                        for t2, a2, _ in spans)]
    return max(inner, key=lambda span: span[2])


def stage_loop_instructions(sass: str) -> Dict[str, int]:
    """{mangled kernel name: SASS instructions of its stage loop}
    (``_stage_span``)."""
    return {name: _stage_span(spans)[2]
            for name, spans in loop_spans(sass).items()}


def stage_loop_opcodes(sass: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel name: {opcode with its modifiers, e.g.
    "VIADD.16x2": count}} of the instructions of its stage loop, most
    frequent first: what ptxas made of each construct."""
    spans = loop_spans(sass)
    pieces = _FUNCTION.split(sass)
    mixes = {}
    for name, body in zip(pieces[1::2], pieces[2::2]):
        if name not in spans:
            continue
        first, last, _ = _stage_span(spans[name])
        counts = Counter()
        for m in _INSTR.finditer(body):
            if first <= int(m.group(1), 16) <= last:
                words = m.group(2).split()
                counts[words[1] if words[0].startswith("@") else
                       words[0]] += 1
        mixes[name] = dict(counts.most_common())
    return mixes


def describe_mix(mix: Dict[str, int], top: int = 8) -> str:
    """'VIADD.16x2 64, PRMT 96, ...': the ``top`` most frequent opcodes."""
    return ", ".join(f"{op} {n}" for op, n in list(mix.items())[:top])


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


def sass_table(marker: str, parts: Dict[object, Tuple[str, ...]]) -> dict:
    """{key: (SASS instructions of its stage loop, {REG, STACK, ...}, its
    stage loop's opcode mix)} of the kernels of the cubin that holds
    ``marker``, each the one kernel whose name holds all of parts[key]."""
    sass, res = cubin_listings(marker)
    loops, mixes = stage_loop_instructions(sass), stage_loop_opcodes(sass)
    return {key: (pick(loops, *p), pick(res, *p), pick(mixes, *p))
            for key, p in parts.items()}


def pick(table: Dict[str, object], *parts: str):
    """The one entry of a {mangled kernel name: ...} table whose name holds
    every one of ``parts``."""
    hits = [v for name, v in table.items() if all(p in name for p in parts)]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} kernels of the listing match "
                           f"{parts}")
    return hits[0]
