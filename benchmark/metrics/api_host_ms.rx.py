"""``api_host_ms.rx``: a receiver call's host time outside the decode
kernel, in ms: the mean host-clock time of a traced ``run_on_device`` call
less the decode kernel's mean device time (the staging checks, the events,
the launch, the synchronize and ``assemble_output``)."""

from benchmark.metrics import DECODE_KERNELS, per_call


def read(trace, shapes):
    seconds = per_call(trace, DECODE_KERNELS)
    if not seconds:
        return None
    return (trace.call_host_s / trace.calls - seconds) * 1e3
