"""``launch_host_ms.rx``: the host's time between a receiver call's two
timing events, in ms: the mean ``api.launch`` range a traced call (making
the events, recording them, the decode's launch)."""

from benchmark import spans
from benchmark.metrics import DECODE_KERNELS, per_call


def read(trace, shapes):
    launch = spans.ranges(trace, "api.launch")
    if not per_call(trace, DECODE_KERNELS) or not launch:
        return None
    return spans.total_ms(launch) / trace.calls
