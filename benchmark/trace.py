"""Reading the ``torch.profiler`` Chrome trace of a run's traced calls: the
window they span, the device's busy time in it, each kernel's device time,
the host's time in the runtime's synchronize calls, and where the device
idled.  The busy union is the arithmetic of the program's
``utils/profile.summarize``, copied so that the yardstick stays here.

The window runs from the start of the first range named ``CALL_SPAN`` (the
benchmark's own range around each traced call) to the end of the last.
"""

from __future__ import annotations

import json
import re
from collections import Counter

CALL_SPAN = "bench.call"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver",
                   "user_annotation")
TOP = 10


def load_events(path) -> list:
    """The complete events ("ph": "X") of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def merged(intervals) -> list:
    """Sorted, overlapping (start, end) intervals merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(kernel: str) -> str:
    """A kernel's name without its template arguments, parameters and
    return type."""
    m = re.search(r"([A-Za-z_][\w:]*)\s*[<(]", kernel)
    return m.group(1) if m else kernel


def op_name(name: str) -> str:
    """A device operation's name with its template arguments, without its
    return type and parameters."""
    name = name.replace("(anonymous namespace)", "{anon}")
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            return name[:i]
    return name


class Trace:
    """The traced calls of one run, read from its Chrome trace."""

    def __init__(self, events: list):
        calls = [e for e in events if e["name"] == CALL_SPAN
                 and e.get("cat") == "user_annotation"]
        if not calls:
            raise ValueError(f"the trace holds no {CALL_SPAN!r} range")
        self.calls = len(calls)
        self.lo = min(e["ts"] for e in calls)
        self.hi = max(e["ts"] + e["dur"] for e in calls)
        self.call_host_s = sum(e["dur"] for e in calls) / 1e6
        self.window_s = (self.hi - self.lo) / 1e6
        thread = {(e.get("pid"), e.get("tid")) for e in calls}
        self.host = [e for e in events if e.get("cat") in HOST_CATEGORIES
                     and (e.get("pid"), e.get("tid")) in thread
                     and e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo]
        self.device = [e for e in events
                       if e.get("cat") in DEVICE_CATEGORIES
                       and e["ts"] < self.hi
                       and e["ts"] + e["dur"] > self.lo]
        busy = merged((max(e["ts"], self.lo), min(e["ts"] + e["dur"],
                                                   self.hi))
                      for e in self.device)
        self.busy = [(s, e) for s, e in busy if e > s]
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6

    @classmethod
    def load(cls, path) -> "Trace":
        return cls(load_events(path))

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose short name, without its
        namespaces, is in ``names``."""
        return sum(e["dur"] for e in self.device if e.get("cat") == "kernel"
                   and short_name(e["name"]).split("::")[-1] in names) / 1e6

    def sync_s(self) -> float:
        """The host's seconds in the runtime's synchronize calls (an
        event's, a stream's, the device's) within the window."""
        return sum(min(e["ts"] + e["dur"], self.hi) - max(e["ts"], self.lo)
                   for e in self.host if e.get("cat") == "cuda_runtime"
                   and "Synchronize" in e["name"]) / 1e6

    def gaps(self) -> list:
        """The window's stretches with no device activity, (start, end)."""
        edges = [self.lo] + [x for iv in self.busy for x in iv] + [self.hi]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def innermost(self) -> list:
        """The host thread's timeline as (start, end, name) segments, each
        named by the innermost host range open in it (None where none is);
        ranges of one thread nest, so a stack of the open ones gives it."""
        segments, stack, cur = [], [], self.lo

        def close_until(t):
            nonlocal cur
            while stack and stack[-1][0] <= t:
                end, name = stack.pop()
                if end > cur:
                    segments.append((cur, end, name))
                    cur = end
        for e in sorted(self.host, key=lambda e: (e["ts"], -e["dur"])):
            close_until(e["ts"])
            if e["ts"] > cur:
                segments.append((cur, e["ts"], stack[-1][1] if stack
                                 else None))
                cur = e["ts"]
            stack.append((e["ts"] + e["dur"], e["name"]))
        close_until(float("inf"))
        if self.hi > cur:
            segments.append((cur, self.hi, None))
        return segments

    def breakdown(self) -> dict:
        """``device_ops``: the device operations that took most time, and
        ``idle_gaps``: the idle time by what the host was doing in it (the
        innermost host range at each moment; ``host outside traced ops``
        where none), each [[name, seconds], ...] at most ``TOP`` long."""
        ops = Counter()
        for e in self.device:
            ops[op_name(e["name"])] += (min(e["ts"] + e["dur"], self.hi)
                                        - max(e["ts"], self.lo)) / 1e6
        idle = Counter()
        segments, i = self.innermost(), 0
        for g_lo, g_hi in self.gaps():
            while i < len(segments) and segments[i][1] <= g_lo:
                i += 1
            j = i
            while j < len(segments) and segments[j][0] < g_hi:
                s, e, name = segments[j]
                idle[name or "host outside traced ops"] += (
                    min(e, g_hi) - max(s, g_lo)) / 1e6
                j += 1
        return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(TOP)]}
