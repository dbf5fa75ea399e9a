"""``device_idle_pct.sim``: the share of the traced calls' window in which
no kernel, copy or set ran on the card, in %, in the in-graph
simulation."""

from benchmark.metrics import idle_pct


def read(trace, shapes):
    return idle_pct(trace)
