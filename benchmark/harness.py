"""What every kind of traffic shares: the cell as ``BENCHMARK.json`` names
it, the run's context, the closed loop that times the window, the sample of
answers kept for the comparison, and the seeds derived from ``--seed``.

Everything a cell is made of is found by name: its configuration through
the manifest's ``file``, its traffic mix as ``traffic/<name>.json``, the
kind of that mix as the module ``kinds/<kind>.py`` and each per-layer
metric as ``metrics/<name>.py``.  None of it imports the program.
"""

from __future__ import annotations

import gc
import hashlib
import json
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import framing
from .reference_stream import CHANNELS
from .trace import CALL_SPAN, Trace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    """One entry of the manifest's ``workloads``, with its files read and
    the metrics that it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str) -> Cell:
    """The cell ``name`` of the manifest; KeyError names an unknown cell,
    ValueError a traffic mix this harness cannot run."""
    m = json.loads(MANIFEST.read_text())
    works = {w["name"]: w for w in m["workloads"]}
    if name not in works:
        raise KeyError(f"no workload {name!r} in {MANIFEST.name} "
                       f"(has {', '.join(sorted(works))})")
    work = works[name]
    entry = {c["name"]: c for c in m["configs"]}[work["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    config["name"] = entry["name"]
    traffic = json.loads(
        (BENCH_DIR / "traffic" / f"{work['traffic']}.json").read_text())
    traffic["name"] = work["traffic"]
    if traffic.get("in_flight", 1) != 1:
        raise ValueError(f"traffic {work['traffic']}: the closed loop keeps "
                         f"one call in flight")
    return Cell(name, int(work["chips"]), config, traffic,
                [x for x in m["end_to_end"] if _reports(x, name)],
                [x for x in m["per_layer"] if _reports(x, name)])


def shape(cell: Cell):
    """(channel, framing.Plan) of the cell's messages."""
    config = cell.config
    return CHANNELS[config["channel_in"]], framing.plan(
        cell.traffic["message_bits"], config["dec_len"],
        config["bits_per_pack"])


def derive(seed: int, *parts) -> int:
    """A 32-bit number drawn from ``seed`` and ``parts``: the same seed
    gives the same numbers, for any size of seed."""
    text = "/".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:4], "little")


@dataclass
class Context:
    """A run's settings: ``start`` is the host clock at the process'
    start, from which set-up is counted; ``program`` a factory (cell,
    device) -> the object a kind drives in the program's place, None for
    the program itself."""

    seed: int
    seconds: float
    trace: bool
    device: object
    start: float
    program: Optional[Callable] = None
    marks: list = field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note that the set-up step ``name`` has ended (host clock)."""
        synchronize(self.device)
        self.marks.append((name, time.perf_counter()))


@dataclass
class Check:
    """A number compared with the plain reference and its limit: correct
    where ``value`` <= ``limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a kind hands back: the window's calls and end-to-end metrics,
    the shapes the per-layer metrics need, the peak memory read when the
    window closed, the trace, and ``check``, the comparison with the
    reference, run once the program's state is freed."""

    attempted: int
    end_to_end: dict
    shapes: dict
    memory_peak_bytes: int
    check: Callable
    window: "Window"
    trace: object = None


class Reservoir:
    """A uniform sample of ``size`` items of a stream of unknown length,
    drawn by ``rng`` (Algorithm R): the answers kept for the comparison."""

    def __init__(self, size: int, rng):
        self.size, self.rng = size, rng
        self.items, self.seen = [], 0

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


@dataclass
class Window:
    """A closed loop's record: ``latencies`` of every call in seconds, and
    the window from the first call to the end of the last one's work."""

    latencies: list
    start: float
    end: float
    trace_path: Optional[Path] = None
    trace_dir: Optional[str] = field(default=None, repr=False)
    notes: list = field(default_factory=list)

    @property
    def calls(self) -> int:
        return len(self.latencies)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def summary(self) -> str:
        """The calls' host times, and any notes of the kind."""
        return (f"{self.calls} calls in {self.seconds:.3f} s; call ms "
                f"{distribution(self.latencies)}"
                + "".join(f"; {n}" for n in self.notes))


def distribution(seconds) -> str:
    """Times in ms: their 5th, 50th, 95th and 99th percentiles, the
    largest, and the mean of each half of the sequence."""
    ms = np.array(seconds) * 1e3
    q = np.percentile(ms, [5, 50, 95, 99])
    halves = " ".join(f"{h.mean():.4f}" for h in np.array_split(ms, 2)
                      if h.size)
    return (f"p5 {q[0]:.4f} p50 {q[1]:.4f} p95 {q[2]:.4f} p99 {q[3]:.4f} "
            f"max {ms.max():.4f}; mean of each half {halves}")


def synchronize(device) -> None:
    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(call: Callable, ctx: Context, trace_calls: int = 0,
                trace_from: int = 0) -> Window:
    """Call ``call(i)`` back to back, one in flight, from i = 0 until
    ``ctx.seconds`` have passed, each timed on the host clock; then wait
    for the device.  With ``ctx.trace``, calls ``trace_from`` ..
    ``trace_from + trace_calls - 1`` run under ``torch.profiler``, each in
    a range named ``trace.CALL_SPAN``, and the loop runs until they are
    done; the Chrome trace goes into a fresh directory under the
    temporary directory."""
    want = trace_calls if ctx.trace else 0
    lat, prof, done = [], None, want == 0
    start = time.perf_counter()
    deadline = start + ctx.seconds
    i = 0
    while True:
        if want and i == trace_from:
            acts = [ProfilerActivity.CPU]
            if getattr(ctx.device, "type", "cpu") == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        t0 = time.perf_counter()
        if prof is not None:
            with record_function(CALL_SPAN):
                call(i)
        else:
            call(i)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        i += 1
        if prof is not None and i == trace_from + want:
            synchronize(ctx.device)
            prof.stop()
            done = True
        if t1 >= deadline and done:
            break
    synchronize(ctx.device)
    window = Window(lat, start, time.perf_counter())
    if prof is not None:
        window.trace_dir = tempfile.mkdtemp(prefix="bench-trace-")
        window.trace_path = Path(window.trace_dir) / "run.pt.trace.json"
        prof.export_chrome_trace(str(window.trace_path))
    return window


def read_trace(window: Window):
    """The window's trace as a ``trace.Trace``, its directory removed."""
    if window.trace_path is None:
        return None
    try:
        return Trace.load(window.trace_path)
    finally:
        shutil.rmtree(window.trace_dir, ignore_errors=True)


def memory_peak_bytes(device) -> int:
    if getattr(device, "type", "cpu") == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    """Return the program's freed blocks, so the reference has the card."""
    gc.collect()
    if getattr(device, "type", "cpu") == "cuda":
        torch.cuda.empty_cache()
