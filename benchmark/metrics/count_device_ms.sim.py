"""``count_device_ms.sim``: the device time a simulation call of the
kernels, copies and sets launched inside its ``ref`` or ``count`` range
(the reference words and the bit-error count), in ms."""

from benchmark import spans
from benchmark.metrics import DECODE_KERNELS, per_call


def read(trace, shapes):
    ops = spans.launched_in(trace, ("ref", "count"))
    if not per_call(trace, DECODE_KERNELS) or ops is None:
        return None
    return sum(op["dur"] for op in ops) / trace.calls / 1e3
