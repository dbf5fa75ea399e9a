"""``--profile DIR``: a ``torch.profiler`` trace of a run, written into DIR
as a Chrome trace; the counterpart of the JAX CLI's ``jax.profiler.trace``
(``tpu_viterbi/cli.py:470-474``).  And the reading of such a trace: the
device's busy share over the traced window, its longest idle gap and what
the host was doing in it.

``span(name)`` marks a host range in the trace (a ``record_function``
range, a ``user_annotation`` event) only while a profiler records;
outside a trace it costs a flag test and hands back one shared
``nullcontext``, where a range costs microseconds.  Ranges of one thread
nest.  The spans:

- each element of a chain (``Pipeline.run``), under its class name;
- ``ViterbiGPU.run_on_device`` and ``run_stream``: ``api.call``, the whole
  call, holding in turn ``api.stage`` (the message's checks, its staging on
  the device, the plan and the kernel's lookup), ``api.launch`` (the host's
  time between the two timing events: making them, recording the first,
  the decode's launch, recording the second; on the CPU the plain decode),
  ``api.wait`` (on a CUDA device: the wait for the second event and the
  events' elapsed time) and ``api.assemble`` (the output words put
  together, and in ``run_stream`` copied to the host); in
  ``run_on_device`` ``api.launch`` and ``api.wait`` lie inside ``decode``;
- ``simulate`` (``build_sharded_simulation``'s call), holding
  ``generate`` (the message and its channel words), ``ref`` (the words a
  decode without error gives), the decode's ``api.call`` and ``count``
  (the bit errors);
- every launch of K1-K8 under the kernel's name (``K1`` ... ``K8``).

A device operation is put down to a range through the runtime call that
launched it: a trace carries the same ``correlation`` on both.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

# device activity in a Chrome trace of torch.profiler (Kineto's categories)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("user_annotation", "cpu_op", "cuda_runtime",
                   "cuda_driver")


class ProfileError(RuntimeError):
    """The trace could not be taken or written."""


_OFF = contextlib.nullcontext()     # reusable and reentrant


class _Range:
    """The range ``record_function`` opens (a user-scope record
    function), entered through torch's own binding, which skips the
    operator dispatch ``record_function`` goes through: about a third of
    its host cost under a profiler, where every range adds to a traced
    call's time."""

    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(
            self.name)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)


def span(name: str):
    """A host range named ``name`` in the trace while a profiler records,
    else nothing (one shared context manager)."""
    if torch.autograd._profiler_enabled():
        return _Range(name)
    return _OFF


class Trace:
    """Context manager: a torch.profiler trace of its block, CPU activity
    always and CUDA activity on a CUDA device, exported on a clean exit as
    ``DIR/<host>_<pid>.<ns>.pt.trace.json`` (``path``).  DIR is created
    and probed for writing when the Trace is made, so an unwritable DIR
    fails before the run (ProfileError).  On a CUDA device a trace that
    recorded no device activity is an error: the profiler did not reach
    the card."""

    def __init__(self, directory, device: torch.device):
        self.directory = Path(directory)
        self.device = torch.device(device)
        self.path = None
        try:
            self.directory.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryFile(dir=self.directory):
                pass
        except OSError as e:
            raise ProfileError(f"cannot write a trace to {directory}: "
                               f"{e}") from e
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)

    def __enter__(self) -> "Trace":
        self._prof.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        path = self.directory / (f"{os.uname().nodename}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
        try:
            self._prof.export_chrome_trace(str(path))
        except OSError as e:
            raise ProfileError(f"cannot write the trace {path}: {e}") from e
        self.path = path
        if self.device.type == "cuda" and not device_events(
                load_events(path)):
            raise ProfileError(f"the trace {path} holds no device activity: "
                               f"torch.profiler did not trace the card")
        return False


def short_name(kernel: str) -> str:
    """A device kernel's qualified name without its template arguments,
    parameters and return type."""
    m = re.search(r"([A-Za-z_][\w:]*)\s*[<(]", kernel)
    return m.group(1) if m else kernel


def load_events(path) -> list:
    """The complete events ("ph": "X") of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_events(events: list) -> list:
    return [e for e in events if e.get("cat") in DEVICE_CATEGORIES]


def _merged(intervals):
    """Sorted, overlapping (start, end) intervals merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(e: dict, lo: float, hi: float) -> float:
    return max(0.0, min(e["ts"] + e["dur"], hi) - max(e["ts"], lo))


def summarize(path, between=None) -> dict:
    """The reading of a trace (times in ms):

    - ``window_ms``: the traced window, the profiler's own span (the
      "Trace" event), else the first to the last event; with ``between``
      = (first, last), from the start of the last range named ``first`` to
      the end of the last range named ``last`` (one call's span);
    - ``busy_ms``, ``busy_share``: the union of the device's kernels,
      copies and sets over the window;
    - ``kernel_ms``: {kernel name: summed time} of the device events in
      the window;
    - ``gap_ms``, ``gap_at_ms``: the longest stretch of the window with no
      device activity, and where it starts after the window's start;
    - ``gap_host``: [(host range name, ms of the gap it covers)], the five
      that cover most of it (annotations, ops and runtime calls);
    - ``sync_ms``: the host's time in the runtime's synchronize calls
      (an event's, a stream's, the device's) within the window;
    - ``annotations``: {user range name: count}."""
    events = load_events(path)
    if between is not None:
        first, last = ([e for e in events if e["name"] == name]
                       for name in between)
        lo = max(e["ts"] for e in first)
        hi = max(e["ts"] + e["dur"] for e in last)
    else:
        spans = [e for e in events if e.get("cat") == "Trace"] or events
        lo = min(e["ts"] for e in spans)
        hi = max(e["ts"] + e["dur"] for e in spans)
    dev = [e for e in device_events(events)
           if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = _merged((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                   for e in dev)
    busy = [(s, e) for s, e in busy if e > s]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]
    g_lo, g_hi = max(gaps, key=lambda g: g[1] - g[0])
    cover = Counter()
    for e in events:
        if e.get("cat") in HOST_CATEGORIES:
            ov = _overlap(e, g_lo, g_hi)
            if ov > 0:
                cover[e["name"]] += ov / 1e3
    kernels = Counter()
    for e in dev:
        kernels[e["name"]] += e["dur"] / 1e3
    sync = sum(_overlap(e, lo, hi) for e in events
               if e.get("cat") == "cuda_runtime" and "Synchronize" in
               e["name"]) / 1e3
    window = (hi - lo) / 1e3
    busy_ms = sum(e - s for s, e in busy) / 1e3
    return {"window_ms": window, "busy_ms": busy_ms,
            "busy_share": busy_ms / window if window else 0.0,
            "kernel_ms": dict(kernels), "gap_ms": (g_hi - g_lo) / 1e3,
            "gap_at_ms": (g_lo - lo) / 1e3,
            "gap_host": cover.most_common(5), "sync_ms": sync,
            "annotations": dict(Counter(
                e["name"] for e in events
                if e.get("cat") == "user_annotation"))}
