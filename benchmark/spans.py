"""The program's own ranges in the trace of a run's traced calls, and the
device operations each range launched.

The program opens its ranges with ``tpu_viterbi_torch.utils.profile.span``
(``api.call``, ``api.stage``, ``api.launch``, ``api.wait``,
``api.assemble``, ``simulate``, ``generate``, ``ref``, ``count``, ...); they
are ``user_annotation`` events of the calling thread, nested.  A device
operation is linked to the runtime call that launched it by the
``args["correlation"]`` the trace writes on both, and belongs to every
range of the calling thread whose interval holds that call's start; an
operation whose launch call is missing belongs to none.  Everything here
reads a ``trace.Trace``'s ``host`` and ``device`` lists (times in us).
"""

from __future__ import annotations

from bisect import bisect_right

from .trace import DEVICE_CATEGORIES, merged

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def ranges(trace, name: str) -> list:
    """The ranges named ``name``, (start, end) sorted by start."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in trace.host
                  if e.get("cat") == "user_annotation"
                  and e["name"] == name)


def total_ms(intervals) -> float:
    return sum(e - s for s, e in intervals) / 1e3


def _holder(spans: list, t: float):
    """The interval of the sorted, disjoint ``spans`` that holds ``t``,
    or None."""
    i = bisect_right(spans, (t, float("inf"))) - 1
    if i >= 0 and t <= spans[i][1]:
        return spans[i]
    return None


def own_ms(trace, name: str, less: str = "api.wait"):
    """Mean ms a traced call of the ranges ``name``, less the ranges
    ``less`` that lie inside them; None where no range is named
    ``name``."""
    outer = [tuple(iv) for iv in merged(ranges(trace, name))]
    if not outer:
        return None
    inner = [(s, e) for s, e in ranges(trace, less)
             if (h := _holder(outer, s)) is not None and e <= h[1]]
    return (total_ms(outer) - total_ms(inner)) / trace.calls


def linked(trace) -> list:
    """(device operation, start of its launch call or None) for every
    device operation of the window: the runtime or driver call of the
    traced thread that carries the operation's correlation."""
    starts = {e["args"]["correlation"]: e["ts"] for e in trace.host
              if e.get("cat") in LAUNCH_CATEGORIES
              and "correlation" in (e.get("args") or {})}
    return [(op, starts.get((op.get("args") or {}).get("correlation")))
            for op in trace.device]


def launched_in(trace, names, categories=DEVICE_CATEGORIES):
    """The device operations of ``categories`` whose launch call starts
    inside a range named in ``names``; None where no range has one of the
    names."""
    spans = [tuple(iv) for iv in merged(
        iv for name in names for iv in ranges(trace, name))]
    if not spans:
        return None
    return [op for op, t in linked(trace)
            if t is not None and op.get("cat") in categories
            and _holder(spans, t) is not None]
