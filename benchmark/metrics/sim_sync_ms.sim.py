"""``sim_sync_ms.sim``: the host's time a ``simulate`` call inside the
runtime's synchronize calls (the decode's event, the count's read-back),
in ms."""


def read(trace, shapes):
    return trace.sync_s() / trace.calls * 1e3
