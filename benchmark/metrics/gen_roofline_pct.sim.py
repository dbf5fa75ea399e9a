"""``gen_roofline_pct.sim``: the generator kernel's share of its roofline,
in %: the bound for one call's message (``rooflines.generate_terms``: the
stream and message packs written once, a threefry call and a Box-Muller a
stage) over the generator kernel's device time a traced call."""

from benchmark import rooflines
from benchmark.metrics import per_call

GEN_KERNELS = ("gen_words_kernel", "gen_values_kernel")   # K7, K8


def read(trace, shapes):
    seconds = per_call(trace, GEN_KERNELS)
    if not seconds:
        return None
    bound = rooflines.bound_s(rooflines.generate_terms(
        shapes["channel"], shapes["plan"].stages, shapes["noisy"]))
    return 100.0 * bound / seconds
