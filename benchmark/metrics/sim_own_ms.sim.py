"""``sim_own_ms.sim``: the in-graph simulation's host time a call outside
its one wait, in ms: the mean ``simulate`` range a traced call less the
decode's ``api.wait`` inside it."""

from benchmark import spans
from benchmark.metrics import DECODE_KERNELS, per_call


def read(trace, shapes):
    if not per_call(trace, DECODE_KERNELS):
        return None
    return spans.own_ms(trace, "simulate")
