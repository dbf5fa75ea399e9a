"""``api_own_ms.rx``: the decoder API's own host time a receiver call, in
ms, taken inside the program: the mean over the traced calls of
``run_on_device``'s ``api.call`` range less the ``api.wait`` inside it
(the staging, the host's time between the two events, the assembly)."""

from benchmark import spans
from benchmark.metrics import DECODE_KERNELS, per_call


def read(trace, shapes):
    if not per_call(trace, DECODE_KERNELS):
        return None
    return spans.own_ms(trace, "api.call")
