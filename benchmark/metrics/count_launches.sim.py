"""``count_launches.sim``: the device kernels a simulation call launched
inside its ``ref`` or ``count`` range (the reference words and the
bit-error count)."""

from benchmark import spans
from benchmark.metrics import DECODE_KERNELS, per_call


def read(trace, shapes):
    ops = spans.launched_in(trace, ("ref", "count"), ("kernel",))
    if not per_call(trace, DECODE_KERNELS) or ops is None:
        return None
    return len(ops) / trace.calls
