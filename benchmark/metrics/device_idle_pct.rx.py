"""``device_idle_pct.rx``: the share of the traced calls' window in which
no kernel, copy or set ran on the card, in %, in a receiver cell."""

from benchmark.metrics import idle_pct


def read(trace, shapes):
    return idle_pct(trace)
