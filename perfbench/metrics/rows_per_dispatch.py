"""Engine rows a row-cycle dispatch of the service, from its stats() counters."""


def read(rec):
    n = rec.counters.get("dispatches")
    return rec.counters["rows_dispatched"] / n if n else None
