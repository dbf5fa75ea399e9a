"""Per-layer metrics, one module each, named as in ``BENCHMARK.json`` and
found by that name: ``read(trace, shapes) -> float | None`` takes the
traced calls (``trace.Trace``) and the cell's shapes (``channel``,
``plan``, ``noisy``) and returns None where it finds nothing to read, as
where no kernel of its name ran.  The helpers they share are here."""

from benchmark import rooflines

DECODE_KERNELS = ("viterbi_kernel",)        # K1, K2 (and K3)


def per_call(trace, kernels) -> float:
    """Device seconds of ``kernels`` a traced call, 0 where none ran."""
    return trace.kernel_s(kernels) / trace.calls


def decode_share(trace, shapes):
    """The decode kernel's share of its bound, in %, or None."""
    seconds = per_call(trace, DECODE_KERNELS)
    if not seconds:
        return None
    bound = rooflines.bound_s(rooflines.decode_terms(shapes["channel"],
                                                     shapes["plan"]))
    return 100.0 * bound / seconds


def idle_pct(trace) -> float:
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
