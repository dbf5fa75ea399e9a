"""``decode_roofline_pct.rx``: the decode kernel's share of its roofline
in a receiver cell, in %: the benchmark's bound for one message
(``rooflines.decode_terms``) over the decode kernel's device time a traced
call."""

from benchmark.metrics import decode_share


def read(trace, shapes):
    return decode_share(trace, shapes)
