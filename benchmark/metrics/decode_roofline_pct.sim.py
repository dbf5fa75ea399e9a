"""``decode_roofline_pct.sim``: the decode kernel's share of its roofline
in the in-graph simulation, in %: the bound for one call's message over
the decode kernel's device time a traced call."""

from benchmark.metrics import decode_share


def read(trace, shapes):
    return decode_share(trace, shapes)
